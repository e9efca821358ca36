"""Vision-language training entry point.

Port of ``tasks/train_vlm.py``: parse the config, construct the
``VLMTrainer``, train. It runs on the card unless the config asks for the
CPU (``train.platform: cpu``)::

    python -m veomni_tpu_torch.tasks.train_vlm config.yaml --train.platform=cpu

The model is a qwen2_vl or qwen2_5_vl config (``model.config_overrides``
with a ``vision`` dict, or an HF directory in ``model.config_path``), the
rows carry ``images`` (HWC arrays or paths) beside ``input_ids`` or text,
and ``data.max_patches`` is the patch budget of a micro-batch.
"""

from __future__ import annotations

from typing import List, Optional

from veomni_tpu_torch.trainer.base import run_entry_point
from veomni_tpu_torch.trainer.vlm_trainer import VLMTrainer


def main(argv: Optional[List[str]] = None) -> Optional[VLMTrainer]:
    """Train as the command line (or ``argv``) says; returns the trainer
    (None when ``train.num_virtual_devices`` started CPU ranks that trained)."""
    return run_entry_point(VLMTrainer, argv, "veomni_tpu_torch.tasks.train_vlm")


if __name__ == "__main__":
    main()

"""Vision-language DPO (preference) training entry point.

Port of ``tasks/train_vlm_dpo.py``: parse the config (the same YAML and
``--section.key=value`` arguments as ``tasks/train_vlm.py``), build
``VLMDPOTrainer`` (``trainer/dpo_trainer.py``), train. Rows are
``{"messages": [...], "chosen": ..., "rejected": ...}`` with image parts in
the messages; it runs on the card unless the config asks for the CPU
(``train.platform: cpu``)::

    python -m veomni_tpu_torch.tasks.train_vlm_dpo config.yaml [--train.platform=cpu]
"""

from __future__ import annotations

from typing import List, Optional

from veomni_tpu_torch.trainer.base import run_entry_point
from veomni_tpu_torch.trainer.dpo_trainer import VLMDPOTrainer


def main(argv: Optional[List[str]] = None) -> Optional[VLMDPOTrainer]:
    """Train as the command line (or ``argv``) says; returns the trainer
    (None when ``train.num_virtual_devices`` started CPU ranks that trained)."""
    return run_entry_point(VLMDPOTrainer, argv, "veomni_tpu_torch.tasks.train_vlm_dpo")


if __name__ == "__main__":
    main()

"""Omni (audio + vision + text) training entry point.

Port of ``tasks/omni/train_omni_model.py``: parse the config, construct the
``OmniTrainer``, train. It runs on the card unless the config asks for the
CPU (``train.platform: cpu``)::

    python -m veomni_tpu_torch.tasks.train_omni_model config.yaml --train.platform=cpu

The model is a ``qwen3_omni_moe`` config (``model.config_overrides`` with
``vision`` and ``audio`` dicts, or an HF directory in ``model.config_path``),
the rows carry ``images`` and ``audios`` (wav or ``.npy`` paths, arrays,
or mel features [n_mels, T]) beside ``input_ids`` or text, and
``data.max_patches`` / ``data.max_audio_chunks`` are a micro-batch's patch
and audio chunk budgets (on the card the tower attentions take the flash
kernels when ``max_audio_chunks * 13`` and ``max_patches`` are multiples of
128).
"""

from __future__ import annotations

from typing import List, Optional

from veomni_tpu_torch.trainer.base import run_entry_point
from veomni_tpu_torch.trainer.omni_trainer import OmniTrainer


def main(argv: Optional[List[str]] = None) -> Optional[OmniTrainer]:
    """Train as the command line (or ``argv``) says; returns the trainer
    (None when ``train.num_virtual_devices`` started CPU ranks that trained)."""
    return run_entry_point(OmniTrainer, argv, "veomni_tpu_torch.tasks.train_omni_model")


if __name__ == "__main__":
    main()

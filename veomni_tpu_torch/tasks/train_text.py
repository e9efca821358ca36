"""Text LLM training entry point.

Port of ``tasks/train_text.py``: parse the config, construct the trainer,
train. It runs on the card unless the config asks for the CPU
(``train.platform: cpu``)::

    python -m veomni_tpu_torch.tasks.train_text config.yaml --train.lr=1e-4 ...

The reference's configs run as they are once the knobs the port's trainer
does not have yet are set off (``trainer/base.py::check_supported`` names
them, e.g. ``--train.save_hf_weights=false --train.prefetch_depth=0``).
"""

from __future__ import annotations

from typing import List, Optional

from veomni_tpu_torch.trainer.base import run_entry_point
from veomni_tpu_torch.trainer import TextTrainer


def main(argv: Optional[List[str]] = None) -> Optional[TextTrainer]:
    """Train as the command line (or ``argv``) says; returns the trainer
    (None when ``train.num_virtual_devices`` started CPU ranks that trained)."""
    return run_entry_point(TextTrainer, argv, "veomni_tpu_torch.tasks.train_text")


if __name__ == "__main__":
    main()

"""Text RL (PPO-style) post-training entry point.

Port of ``tasks/train_text_rl.py``: parse the config (the same YAML and
``--section.key=value`` arguments as ``tasks/train_text.py``), build
``BaseRLTrainer`` (``trainer/rl_trainer.py``), train. It runs on the card
unless the config asks for the CPU (``train.platform: cpu``)::

    python -m veomni_tpu_torch.tasks.train_text_rl config.yaml [--train.platform=cpu]
"""

from __future__ import annotations

from typing import List, Optional

from veomni_tpu_torch.trainer.base import run_entry_point
from veomni_tpu_torch.trainer.rl_trainer import BaseRLTrainer


def main(argv: Optional[List[str]] = None) -> Optional[BaseRLTrainer]:
    """Train as the command line (or ``argv``) says; returns the trainer
    (None when ``train.num_virtual_devices`` started CPU ranks that trained)."""
    return run_entry_point(BaseRLTrainer, argv, "veomni_tpu_torch.tasks.train_text_rl")


if __name__ == "__main__":
    main()

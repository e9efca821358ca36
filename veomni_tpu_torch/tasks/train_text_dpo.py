"""Text DPO (preference) training entry point.

Port of ``tasks/train_text_dpo.py``: parse the config (the same YAML and
``--section.key=value`` arguments as ``tasks/train_text.py``), build
``TextDPOTrainer`` (``trainer/dpo_trainer.py``), train. It runs on the card
unless the config asks for the CPU (``train.platform: cpu``)::

    python -m veomni_tpu_torch.tasks.train_text_dpo config.yaml [--train.platform=cpu]
"""

from __future__ import annotations

from typing import List, Optional

from veomni_tpu_torch.arguments import VeOmniArguments, parse_args, save_args
from veomni_tpu_torch.trainer.dpo_trainer import TextDPOTrainer


def main(argv: Optional[List[str]] = None) -> TextDPOTrainer:
    """Train as the command line (or ``argv``) says; returns the trainer."""
    args = parse_args(VeOmniArguments, argv)
    save_args(args, args.train.output_dir)
    trainer = TextDPOTrainer(args)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

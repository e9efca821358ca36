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

from veomni_tpu_torch.arguments import VeOmniArguments, parse_args, save_args
from veomni_tpu_torch.trainer import TextTrainer


def main(argv: Optional[List[str]] = None) -> TextTrainer:
    """Train as the command line (or ``argv``) says; returns the trainer."""
    args = parse_args(VeOmniArguments, argv)
    save_args(args, args.train.output_dir)
    trainer = TextTrainer(args)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

"""TextTrainer: chat-template / plaintext text SFT-pretrain trainer.

Port of ``veomni_tpu/trainer/text_trainer.py`` — a thin specialization of
BaseTrainer wiring the text data path; everything heavy lives in base.
"""

from __future__ import annotations

from veomni_tpu_torch.trainer.base import BaseTrainer


class TextTrainer(BaseTrainer):
    pass

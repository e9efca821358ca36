from veomni_tpu_torch.trainer.base import BaseTrainer
from veomni_tpu_torch.trainer.text_trainer import TextTrainer

__all__ = ["BaseTrainer", "TextTrainer"]

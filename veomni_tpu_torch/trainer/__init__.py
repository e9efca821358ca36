from veomni_tpu_torch.trainer.base import BaseTrainer
from veomni_tpu_torch.trainer.text_trainer import TextTrainer
from veomni_tpu_torch.trainer.vlm_trainer import VLMTrainer

__all__ = ["BaseTrainer", "TextTrainer", "VLMTrainer"]

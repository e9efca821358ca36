from veomni_tpu_torch.trainer.base import BaseTrainer
from veomni_tpu_torch.trainer.distill_trainer import DistillTrainer
from veomni_tpu_torch.trainer.dpo_trainer import DPOTrainer, TextDPOTrainer, VLMDPOTrainer
from veomni_tpu_torch.trainer.omni_trainer import OmniTrainer
from veomni_tpu_torch.trainer.rl_trainer import BaseRLTrainer, RLTrainer
from veomni_tpu_torch.trainer.text_trainer import TextTrainer
from veomni_tpu_torch.trainer.vlm_trainer import VLMTrainer

__all__ = ["BaseTrainer", "TextTrainer", "VLMTrainer", "DPOTrainer", "TextDPOTrainer", "VLMDPOTrainer",
           "DistillTrainer", "RLTrainer", "BaseRLTrainer", "OmniTrainer"]

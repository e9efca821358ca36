from veomni_tpu_torch.optim.lr_scheduler import build_lr_scheduler
from veomni_tpu_torch.optim.optimizer import build_optimizer

__all__ = ["build_optimizer", "build_lr_scheduler"]

from veomni_tpu_torch.checkpoint.checkpointer import Checkpointer, build_checkpointer

__all__ = ["Checkpointer", "build_checkpointer"]

from veomni_tpu_torch.lora.config import LoraConfig
from veomni_tpu_torch.lora.lora import (
    LoraAdapters,
    apply_lora_to_loss_fn,
    init_lora_params,
    load_adapter,
    merge_lora_params,
    save_adapter,
    save_merged_hf,
)

__all__ = [
    "LoraAdapters",
    "LoraConfig",
    "apply_lora_to_loss_fn",
    "init_lora_params",
    "load_adapter",
    "merge_lora_params",
    "save_adapter",
    "save_merged_hf",
]

from veomni_tpu_torch.data.data_collator import TextPackingCollator, stack_micro_batches
from veomni_tpu_torch.data.data_loader import DATALOADER_REGISTRY, build_dataloader
from veomni_tpu_torch.data.dataset import DATASET_REGISTRY, build_dataset

__all__ = ["DATALOADER_REGISTRY", "DATASET_REGISTRY", "TextPackingCollator",
           "build_dataloader", "build_dataset", "stack_micro_batches"]

from veomni_tpu_torch.data.data_collator import TextPackingCollator, stack_micro_batches

__all__ = ["TextPackingCollator", "stack_micro_batches"]

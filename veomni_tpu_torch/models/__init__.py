from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.transformer import Transformer

__all__ = ["Transformer", "TransformerConfig"]

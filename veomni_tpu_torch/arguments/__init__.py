from veomni_tpu_torch.arguments.arguments_types import (
    DataArguments,
    ModelArguments,
    TrainingArguments,
    VeOmniArguments,
)
from veomni_tpu_torch.arguments.compat import translate_reference_schema
from veomni_tpu_torch.arguments.parser import parse_args, save_args

__all__ = [
    "translate_reference_schema",
    "DataArguments",
    "ModelArguments",
    "TrainingArguments",
    "VeOmniArguments",
    "parse_args",
    "save_args",
]

"""Model registry and build entry points, text branch.

Port of ``veomni_tpu/models/auto.py``: ``build_config`` (``:303``),
``FoundationModel`` (``:411``), ``build_foundation_model`` (``:446``) and
``build_tokenizer``, for the text families the port implements. A family
here is the port's ``Transformer`` module (``models/transformer.py``), which
raises ``NotImplementedError`` for any configured feature it does not have
(``check_supported``). The reference's other families (VLM, omni, janus,
deepseek_v4, diffusion) belong to slice F of the port; loading a config or
weights from an HF directory (``config_path``/``model_path``) needs
``hf_io``, the next slice. Both raise here instead of building something
else.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.transformer import Transformer
from veomni_tpu_torch.utils.device import DeviceLike
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the reference's text families (auto.py:57-62), all built by the port's
# Transformer: it runs the llama/qwen3 dialect and the softmax MoE, and
# raises for the features of the others
TEXT_MODEL_TYPES = (
    "llama", "qwen2", "qwen3", "qwen3_moe",
    "gemma3", "gemma3_text",
    "deepseek_v2", "deepseek_v3",
    "gpt_oss", "seed_oss", "glm_moe", "glm4_moe", "glm_moe_dsa",
)

# the reference's other families (auto.py:66-297), slice F of the port
NOT_PORTED_MODEL_TYPES = (
    "qwen3_next", "deepseek_v4", "slot_vlm", "qwen2_vl", "qwen2_5_vl", "qwen3_vl",
    "qwen3_vl_moe", "janus", "qwen2_5_omni", "qwen3_omni_moe", "wan_t2v", "qwen_image",
    "flux", "ltx2",
)


def build_config(model_type: str = "", **overrides) -> TransformerConfig:
    """The config of a text model_type from keyword fields (the reference's
    last branch, ``auto.py:408``)."""
    overrides.pop("model_type", None)
    if model_type in NOT_PORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {model_type!r}: only the text families are ported "
            f"({', '.join(TEXT_MODEL_TYPES)}); the others are slice F of the port")
    return TransformerConfig(model_type=model_type or "llama", **overrides)


@dataclass
class FoundationModel:
    """What build_foundation_model returns: the config and, once
    :meth:`init` ran, the model (the reference's ``params``)."""

    config: TransformerConfig
    module: Optional[Transformer] = None

    def init(self, generator: torch.Generator, *, device: DeviceLike = None) -> Transformer:
        """Build the model with random weights drawn from ``generator``."""
        self.module = Transformer(self.config, generator, device=device)
        return self.module

    def loss_fn(self, module: Transformer, batch):
        return module.loss_fn(batch)

    def load_hf(self, model_dir: str):
        raise NotImplementedError(
            "loading HF weights (model_path) needs models/hf_io.py, not ported yet "
            "(queue 1, item 3)")

    def save_hf(self, out_dir: str):
        raise NotImplementedError(
            "saving HF weights (save_hf_weights) needs models/hf_io.py, not ported yet "
            "(queue 1, item 3)")


def build_foundation_model(
    config_path: Optional[str] = None,
    *,
    config: Optional[TransformerConfig] = None,
    weights_path: Optional[str] = None,
    ops_implementation: Optional[Dict[str, str]] = None,
    **config_overrides,
) -> FoundationModel:
    """Reference ``build_foundation_model``: resolve the config, pin ops,
    return the (not yet initialized) model."""
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config

    if config is None:
        if config_path is None:
            raise ValueError("need config_path or config")
        raise NotImplementedError(
            "config_path: building a config from an HF config.json needs models/hf_io.py "
            "and TransformerConfig.from_hf_config, not ported yet (queue 1, item 3); "
            "give model.config_overrides instead")
    if config.model_type not in TEXT_MODEL_TYPES:
        logger.warning_rank0(
            "model_type %r not registered; using llama-family core", config.model_type
        )
    apply_ops_config(ops_implementation)
    model = FoundationModel(config=config)
    if weights_path:
        model.load_hf(weights_path)
    return model


def build_tokenizer(path: str):
    """HF tokenizer from a local directory (reference ``build_tokenizer``),
    its read retried like the other I/O edges. A hub id would need the
    network, which the port never uses: it raises."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"tokenizer path {path!r} is not a local directory")
    from transformers import AutoTokenizer

    from veomni_tpu_torch.resilience.retry import retry_call

    return retry_call(
        AutoTokenizer.from_pretrained, path, trust_remote_code=True,
        description=f"tokenizer load {path}",
    )

"""Model registry and build entry points, text branch.

Port of ``veomni_tpu/models/auto.py``: ``build_config`` (``:303``),
``FoundationModel`` (``:411``), ``build_foundation_model`` (``:446``) and
``build_tokenizer`` (through ``data/tokenizer.py``), for the text families
the port implements. A family here is the port's ``Transformer`` module
(``models/transformer.py``), which raises ``NotImplementedError`` for any
configured feature it does not have (``check_supported``). The reference's other families (VLM, omni, janus,
deepseek_v4, diffusion) belong to slice F of the port and raise here
instead of building something else. A config and weights from an HF
directory (``config_path``, ``weights_path``) go through
``TransformerConfig.from_hf_config`` and ``models/hf_io.py``, the family's
``load_hf`` and ``save_hf`` (reference ``:40-41``, ``:445-453``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from veomni_tpu_torch.models import hf_io
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.transformer import Transformer
from veomni_tpu_torch.utils.device import DeviceLike
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the reference's text families (auto.py:57-63), all built by the port's
# Transformer: it runs the llama, qwen2, qwen3, gemma3, qwen3_moe,
# deepseek_v2/v3 and gpt_oss dialects, and raises for the features of the
# others (glm_moe_dsa's DSA)
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

    def load_hf(self, model_dir: str, *, device: DeviceLike = None) -> Transformer:
        """Build the model on ``device`` with the weights of the HF
        checkpoint in ``model_dir`` (no random init first)."""
        self.module = hf_io.hf_to_params(
            model_dir, self.config, Transformer(self.config, None, device=device))
        return self.module

    def save_hf(self, out_dir: str, module: Optional[Transformer] = None) -> None:
        """HF-format export of ``module`` (default: this model's) with its
        config.json."""
        hf_io.save_hf_checkpoint(module if module is not None else self.module,
                                 self.config, out_dir)


def build_foundation_model(
    config_path: Optional[str] = None,
    *,
    config: Optional[TransformerConfig] = None,
    weights_path: Optional[str] = None,
    ops_implementation: Optional[Dict[str, str]] = None,
    device: DeviceLike = None,
    **config_overrides,
) -> FoundationModel:
    """Reference ``build_foundation_model``: resolve the config (from
    ``config_path``/config.json with ``config_overrides`` on top, or
    ``config``), pin ops, return the model; with ``weights_path`` its
    weights are loaded onto ``device``, else it is not yet initialized."""
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config

    if config is None:
        if config_path is None:
            raise ValueError("need config_path or config")
        with open(os.path.join(config_path, "config.json")) as f:
            hf_dict = json.load(f)
        model_type = hf_dict.get("model_type", "")
        if (model_type in NOT_PORTED_MODEL_TYPES + ("qwen2_5_omni_thinker", "qwen3_omni_moe_thinker")
                or hf_dict.get("_class_name")):
            raise NotImplementedError(
                f"{config_path}: model_type {model_type or hf_dict.get('_class_name')!r}: "
                f"only the text families are ported ({', '.join(TEXT_MODEL_TYPES)}); the "
                "others are slice F of the port")
        config = TransformerConfig.from_hf_config(hf_dict, **config_overrides)
    if config.model_type not in TEXT_MODEL_TYPES:
        logger.warning_rank0(
            "model_type %r not registered; using llama-family core", config.model_type
        )
    apply_ops_config(ops_implementation)
    model = FoundationModel(config=config)
    if weights_path:
        model.load_hf(weights_path, device=device)
    return model


def build_tokenizer(path: str):
    """The tokenizer of a local HF directory (reference ``auto.py:535``,
    ``transformers.AutoTokenizer``): ``data/tokenizer.py`` wraps the
    ``tokenizers`` library's reader of its ``tokenizer.json`` with the
    special tokens and chat template of its ``tokenizer_config.json``. The
    read retries like the reference's local loads (``resilience/retry.py``).
    A hub id would need a download, which the port does not do: it raises."""
    from veomni_tpu_torch.data.tokenizer import Tokenizer

    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"tokenizer {path!r}: the port reads a local HF tokenizer directory (tokenizer.json "
            "and tokenizer_config.json); it downloads nothing")
    if not os.path.exists(os.path.join(path, "tokenizer.json")):
        raise FileNotFoundError(f"tokenizer {path!r}: no tokenizer.json (a sentencepiece "
                                "tokenizer.model alone is not read)")
    from veomni_tpu_torch.resilience.retry import retry_call

    return retry_call(Tokenizer.from_pretrained, path, description=f"tokenizer load {path}")

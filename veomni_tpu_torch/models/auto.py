"""Model registry and build entry points: the text families and the
Qwen2-VL / Qwen2.5-VL vision-language composites.

Port of ``veomni_tpu/models/auto.py``: ``build_config`` (``:303``, the VLM
branch ``:329-357``), ``FoundationModel`` (``:411``),
``build_foundation_model`` (``:446``, its VLM ``config.json`` readers
``:471-``) and ``build_tokenizer`` (through ``data/tokenizer.py``). A text
family is the port's ``Transformer`` module (``models/transformer.py``),
which raises ``NotImplementedError`` for any configured feature it does not
have (``check_supported``); ``qwen2_vl`` and ``qwen2_5_vl``
(``models/qwen2_vl.py``, ``models/qwen2_5_vl.py``) wrap it with their
vision towers. The reference's other families (qwen3_vl and qwen3_vl_moe,
the slot VLM, omni, janus, deepseek_v4, diffusion) belong to slice F of the
port and raise here instead of building something else. A config and
weights from an HF directory (``config_path``, ``weights_path``) go
through ``TransformerConfig.from_hf_config`` (a VLM's ``config_from_hf``)
and ``models/hf_io.py``, the family's ``load_hf`` and ``save_hf``
(reference ``:40-41``, ``:445-453``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from veomni_tpu_torch.models import hf_io, qwen2_5_vl, qwen2_vl
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

# the vision-language families (auto.py:152-200): model_type -> the module
# with its config classes, model, HF reader and writer
VLM_FAMILIES = {"qwen2_vl": qwen2_vl, "qwen2_5_vl": qwen2_5_vl}
_VLM_CONFIGS = {"qwen2_vl": qwen2_vl.Qwen2VLConfig, "qwen2_5_vl": qwen2_5_vl.Qwen25VLConfig}
_VLM_MODELS = {"qwen2_vl": qwen2_vl.Qwen2VLModel, "qwen2_5_vl": qwen2_5_vl.Qwen25VLModel}
VLMConfig = Union[qwen2_vl.Qwen2VLConfig, qwen2_5_vl.Qwen25VLConfig]

# the reference's other families (auto.py:66-297), slice F of the port: each
# names the ROADMAP.md item that ports it
NOT_PORTED_MODEL_TYPES = {
    "qwen3_vl": "slice F: Qwen3-VL (deepstack, interleaved mrope)",
    "qwen3_vl_moe": "slice F: Qwen3-VL-MoE",
    "slot_vlm": "slice F: the slot VLM, models/{vision,vlm}.py",
    **{mt: "slice F" for mt in ("qwen3_next", "deepseek_v4", "janus", "qwen2_5_omni",
                                "qwen3_omni_moe", "wan_t2v", "qwen_image", "flux", "ltx2")},
}


def _not_ported(model_type: str, where: str = "") -> NotImplementedError:
    item = NOT_PORTED_MODEL_TYPES.get(model_type, "slice F")
    return NotImplementedError(
        f"{where}model_type {model_type!r} is not ported yet ({item} of ROADMAP.md queue 1); "
        f"the port builds the text families "
        f"({', '.join(TEXT_MODEL_TYPES)}) and {', '.join(VLM_FAMILIES)}")


def build_config(model_type: str = "", **overrides) -> Union[TransformerConfig, VLMConfig]:
    """The config of a model_type from keyword fields: a VLM's top-level
    text keys flow into ``text`` (its dialect defaults to qwen2), its
    ``vision`` dict and token ids stay at the top (``auto.py:329-357``);
    a text model_type is the reference's last branch (``:408``)."""
    overrides.pop("model_type", None)
    if model_type in NOT_PORTED_MODEL_TYPES:
        raise _not_ported(model_type)
    if model_type in VLM_FAMILIES:
        kw = {k: overrides.pop(k) for k in ("vision", "image_token_id", "video_token_id",
                                            "vision_start_token_id", "freeze_vision")
              if k in overrides}
        text = dict(overrides.pop("text", {}) or {})
        text.update(overrides)
        text.setdefault("model_type", "qwen2")
        return _VLM_CONFIGS[model_type](text=text, **kw)
    return TransformerConfig(model_type=model_type or "llama", **overrides)


@dataclass
class FoundationModel:
    """What build_foundation_model returns: the config and, once
    :meth:`init` ran, the model (the reference's ``params``): a
    ``Transformer``, or a VLM composite (``language_model`` + ``vision_tower``)."""

    config: Union[TransformerConfig, VLMConfig]
    module: Optional[torch.nn.Module] = None

    @property
    def vlm_family(self):
        """The VLM family's module, or None for a text model."""
        return VLM_FAMILIES.get(self.config.model_type) if self.is_vlm else None

    @property
    def is_vlm(self) -> bool:
        return not isinstance(self.config, TransformerConfig)

    def _build(self, generator: Optional[torch.Generator], device: DeviceLike):
        if self.is_vlm:
            return _VLM_MODELS[self.config.model_type](self.config, generator, device=device)
        return Transformer(self.config, generator, device=device)

    def init(self, generator: torch.Generator, *, device: DeviceLike = None) -> torch.nn.Module:
        """Build the model with random weights drawn from ``generator``."""
        self.module = self._build(generator, device)
        return self.module

    def loss_fn(self, module: torch.nn.Module, batch):
        return module.loss_fn(batch)

    def load_hf(self, model_dir: str, *, device: DeviceLike = None,
                experts: Optional[range] = None) -> torch.nn.Module:
        """Build the model on ``device`` with the weights of the HF
        checkpoint in ``model_dir`` (no random init first); ``experts``, a
        text MoE's experts this rank holds, reads only theirs."""
        module = self._build(None, device)
        if self.is_vlm:
            self.module = self.vlm_family.load_hf_checkpoint(model_dir, module)
        else:
            self.module = hf_io.hf_to_params(model_dir, self.config, module, experts=experts)
        return self.module

    def save_hf(self, out_dir: str, module: Optional[torch.nn.Module] = None) -> None:
        """HF-format export of ``module`` (default: this model's) with its
        config.json."""
        module = module if module is not None else self.module
        if self.is_vlm:
            self.vlm_family.save_hf_checkpoint(module, out_dir)
        else:
            hf_io.save_hf_checkpoint(module, self.config, out_dir)


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
        if (model_type in tuple(NOT_PORTED_MODEL_TYPES) + ("qwen2_5_omni_thinker",
                                                           "qwen3_omni_moe_thinker")
                or hf_dict.get("_class_name")):
            raise _not_ported(model_type or hf_dict.get("_class_name"), f"{config_path}: ")
        if model_type in VLM_FAMILIES:
            config = VLM_FAMILIES[model_type].config_from_hf(hf_dict, **config_overrides)
        else:
            config = TransformerConfig.from_hf_config(hf_dict, **config_overrides)
    if config.model_type not in TEXT_MODEL_TYPES + tuple(VLM_FAMILIES):
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

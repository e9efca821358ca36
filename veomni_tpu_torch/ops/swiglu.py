"""Gated-MLP activations (port of ``veomni_tpu/ops/swiglu.py`` and of
``gated_act``, ``veomni_tpu/models/transformer.py:226-238``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op

# the HF activation names the port's gated MLPs take (gpt_oss_glu is the
# reference's own name for gpt_oss's clamped GLU, which HF spells "silu")
GATED_ACTS = ("silu", "gelu", "gelu_pytorch_tanh", "gpt_oss_glu")
# gpt_oss's clamp and sigmoid slope: fixed in the reference (``:229-230``),
# as in HF's GptOssExperts (the published swiglu_limit is 7.0)
GPT_OSS_LIMIT = 7.0
GPT_OSS_ALPHA = 1.702


@KERNEL_REGISTRY.register("swiglu", "xla")
def _swiglu_plain(gate, up):
    return F.silu(gate) * up


def swiglu(gate, up):
    return resolve_op("swiglu", gate.device)(gate, up)


def gated_act(gate, up, hidden_act: str):
    """act(gate) * up for the dialect's ``hidden_act``: ``gelu`` is the exact
    (erf) GELU, ``gelu_pytorch_tanh`` its tanh approximation (gemma),
    ``silu`` SwiGLU, and ``gpt_oss_glu`` gpt_oss's clamped GLU: gate
    clamped to at most 7 and up to [-7, 7], then (up + 1) * gate *
    sigmoid(1.702 * gate)."""
    if hidden_act == "gpt_oss_glu":
        gate = torch.clamp(gate, max=GPT_OSS_LIMIT)
        up = torch.clamp(up, min=-GPT_OSS_LIMIT, max=GPT_OSS_LIMIT)
        return (up + 1.0) * (gate * torch.sigmoid(gate * GPT_OSS_ALPHA))
    if hidden_act in ("gelu_pytorch_tanh", "gelu"):
        approximate = "none" if hidden_act == "gelu" else "tanh"
        return F.gelu(gate, approximate=approximate) * up
    if hidden_act != "silu":
        raise ValueError(f"unknown hidden_act {hidden_act!r}; the gated MLPs take {GATED_ACTS}")
    return swiglu(gate, up)

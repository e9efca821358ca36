"""Gated-MLP activations (port of ``veomni_tpu/ops/swiglu.py`` and of
``gated_act``, ``veomni_tpu/models/transformer.py:226-238``)."""

from __future__ import annotations

import torch.nn.functional as F

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op

# the HF activation names the port's dense MLP takes
GATED_ACTS = ("silu", "gelu", "gelu_pytorch_tanh")


@KERNEL_REGISTRY.register("swiglu", "xla")
def _swiglu_plain(gate, up):
    return F.silu(gate) * up


def swiglu(gate, up):
    return resolve_op("swiglu", gate.device)(gate, up)


def gated_act(gate, up, hidden_act: str):
    """act(gate) * up for the dialect's ``hidden_act``: ``gelu`` is the exact
    (erf) GELU, ``gelu_pytorch_tanh`` its tanh approximation (gemma), and
    ``silu`` SwiGLU. The gpt_oss clamped GLU is not ported (ROADMAP.md queue
    1, slice B item 4)."""
    if hidden_act in ("gelu_pytorch_tanh", "gelu"):
        approximate = "none" if hidden_act == "gelu" else "tanh"
        return F.gelu(gate, approximate=approximate) * up
    if hidden_act != "silu":
        raise NotImplementedError(
            f"hidden_act {hidden_act!r} is not ported yet (ROADMAP.md queue 1, slice B item 4)")
    return swiglu(gate, up)

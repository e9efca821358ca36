"""SwiGLU activation silu(gate) * up (port of ``veomni_tpu/ops/swiglu.py``)."""

from __future__ import annotations

import torch.nn.functional as F

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op


@KERNEL_REGISTRY.register("swiglu", "xla")
def _swiglu_plain(gate, up):
    return F.silu(gate) * up


def swiglu(gate, up):
    return resolve_op("swiglu", gate.device)(gate, up)

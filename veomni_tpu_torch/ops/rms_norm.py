"""RMSNorm (port of ``veomni_tpu/ops/rms_norm.py``): f32 math, cast back."""

from __future__ import annotations

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op


@KERNEL_REGISTRY.register("rms_norm", "xla")
def _rms_norm_plain(x, weight, eps: float = 1e-6, zero_centered: bool = False):
    """``zero_centered`` (the gemma family stores ``w - 1``) scales by
    ``1 + w``, added in f32 before the cast back, as the reference does."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.reciprocal(torch.sqrt(var + eps))
    w = weight.float()
    if zero_centered:
        w = 1.0 + w
    return (x * w).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6, zero_centered: bool = False):
    return resolve_op("rms_norm", x.device)(x, weight, eps, zero_centered)

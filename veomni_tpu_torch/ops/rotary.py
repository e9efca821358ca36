"""Rotary position embeddings (port of ``veomni_tpu/ops/rotary.py``):
llama-style half rotation driven by position ids. Only the unscaled tables
(``rope_scaling=None``) are ported; scaled variants raise."""

from __future__ import annotations

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op


def rotary_tables(positions, head_dim: int, theta: float = 10000.0, rope_scaling=None):
    """positions [B,S] int -> (cos, sin) each [B,S,head_dim] f32."""
    if rope_scaling:
        raise NotImplementedError(f"rope_scaling {rope_scaling!r} is not ported yet")
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv_freq  # [B,S,D/2]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


@KERNEL_REGISTRY.register("rotary", "xla")
def _apply_rotary_plain(q, k, cos, sin):
    """q [B,S,Hq,D], k [B,S,Hk,D], cos/sin [B,S,D]; f32 math, cast back."""
    dtype = q.dtype
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(dtype), k_out.to(dtype)


def apply_rotary(q, k, cos, sin):
    return resolve_op("rotary", q.device)(q, k, cos, sin)

"""Rotary position embeddings (port of ``veomni_tpu/ops/rotary.py``):
llama-style half rotation driven by position ids, or the pairwise
``interleaved`` layout of the deepseek MLA rope (``_rotate_interleave``,
``:157``), with HF ``rope_scaling`` (``linear``, ``llama3``, ``yarn``;
``default``/``dynamic``/``mrope`` keep the base frequencies), and the
qwen-vl ``mrope`` tables (``rotary_tables``, ``:84-132``): positions
[B, 3, S] (the temporal, height and width streams), the frequency dim split
by ``mrope_section`` (Qwen2-VL's [16, 24, 24] sums to 64 = 128 / 2), section
*i* reading stream ``i % 3``, or the ``mrope_interleaved`` layout of
qwen3-vl. Partial rotary is the caller's: it asks for tables of
``rope_dim < head_dim``.

The inverse frequencies are f32 and computed in the reference's order of
operations: at position 4096 and theta 5e5 another order already shows at
bf16 in the tables."""

from __future__ import annotations

import math

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op


def _rope_type(rope_scaling) -> str:
    return rope_scaling.get("rope_type", rope_scaling.get("type", "default"))


def yarn_get_mscale(factor: float, mscale: float = 1.0) -> float:
    if factor <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def _scale_inv_freq(inv_freq, rope_scaling, head_dim: int, theta: float):
    """HF rope_scaling applied to the base frequencies (``rotary.py:24-70``).
    Returns (inv_freq, attention-scale multiplier). Yarn's correction range
    is rounded out to whole dims unless ``truncate`` is false, as in
    transformers' ``_compute_yarn_parameters``."""
    if not rope_scaling:
        return inv_freq, 1.0
    rtype = _rope_type(rope_scaling)
    factor = float(rope_scaling.get("factor", 1.0))
    if rtype == "linear":
        return inv_freq / factor, 1.0
    if rtype == "llama3":
        low = float(rope_scaling.get("low_freq_factor", 1.0))
        high = float(rope_scaling.get("high_freq_factor", 4.0))
        orig = float(rope_scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2 * math.pi / inv_freq
        # long wavelengths fully scaled, short ones untouched, a ramp between
        smooth = torch.clamp((orig / wavelen - low) / (high - low), 0.0, 1.0)
        scaled = inv_freq / factor
        return (1 - smooth) * scaled + smooth * inv_freq, 1.0
    if rtype == "yarn":
        orig = float(rope_scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(rope_scaling.get("beta_fast", 32))
        beta_slow = float(rope_scaling.get("beta_slow", 1))

        def correction_dim(num_rot):
            return (head_dim / 2) * math.log(orig / (num_rot * 2 * math.pi)) / math.log(theta)

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if rope_scaling.get("truncate", True):
            # the reference always rounds; transformers skips the rounding
            # where the config sets truncate false (gpt-oss; ROADMAP.md
            # queue 3, diverges on purpose)
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, head_dim // 2 - 1)
        idx = torch.arange(head_dim // 2, dtype=torch.float32, device=inv_freq.device)
        ramp = torch.clamp((idx - low) / max(high - low, 1e-3), 0.0, 1.0)
        extrap_mask = 1.0 - ramp  # 1 where high-frequency (keep the base)
        inv = inv_freq / factor * (1 - extrap_mask) + inv_freq * extrap_mask
        return inv, yarn_attention_factor(rope_scaling, head_dim)
    if rtype in ("default", "dynamic", "mrope"):
        # mrope keeps the base frequencies; rotary_tables mixes the sections
        return inv_freq, 1.0
    raise ValueError(f"unsupported rope_scaling type {rtype!r}")


def yarn_attention_factor(rope_scaling, head_dim: int) -> float:
    """Softmax-scale multiplier for yarn (the deepseek mscale^2 correction)."""
    if not rope_scaling or _rope_type(rope_scaling) != "yarn":
        return 1.0
    factor = float(rope_scaling.get("factor", 1.0))
    mscale_all_dim = float(rope_scaling.get("mscale_all_dim", 0.0))
    if not mscale_all_dim:
        return 1.0
    return yarn_get_mscale(factor, mscale_all_dim) ** 2


def mrope_stream_of_frequency(mrope_section, half: int, interleaved: bool) -> torch.Tensor:
    """[half] int64: the position stream (0 temporal, 1 height, 2 width)
    each rotary frequency reads. Sectioned (qwen2-vl, qwen2.5-vl): section
    *i* of ``mrope_section`` reads stream ``i % 3``. Interleaved (qwen3-vl,
    HF ``apply_interleaved_mrope``): frequency j reads stream 1 when j % 3 ==
    1 and j < 3 sec[1], stream 2 when j % 3 == 2 and j < 3 sec[2], else the
    temporal stream."""
    if sum(mrope_section) != half:
        raise ValueError(f"mrope_section {list(mrope_section)} must sum to head_dim/2 = {half}")
    if interleaved:
        js = torch.arange(half)
        sec = torch.zeros(half, dtype=torch.int64)
        sec[(js % 3 == 1) & (js < 3 * mrope_section[1])] = 1
        sec[(js % 3 == 2) & (js < 3 * mrope_section[2])] = 2
        return sec
    return torch.cat([torch.full((n,), i % 3, dtype=torch.int64)
                      for i, n in enumerate(mrope_section)])


def rotary_tables(positions, head_dim: int, theta: float = 10000.0, rope_scaling=None,
                  interleaved: bool = False):
    """positions [B,S] int -> (cos, sin) each [B,S,head_dim] f32; yarn
    scales both by its mscale ratio (``rotary.py:141-148``). ``interleaved``
    repeats each frequency on adjacent channels (the pairs the interleaved
    rotation turns) where the default concatenates two halves. With an
    ``mrope_section`` and positions [B,3,S] each frequency takes its angle
    from its own stream (``:101-132``); [B,S] positions of an mrope config
    (text-only rows, all three streams equal) give the plain tables."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    inv_freq, _ = _scale_inv_freq(inv_freq, rope_scaling, head_dim, theta)
    msec = (rope_scaling or {}).get("mrope_section")
    if msec and positions.ndim == 3:
        # [B,3,S] -> per-stream angles [B,3,S,D/2], each frequency from its stream
        ang3 = positions.float()[..., None] * inv_freq
        stream = mrope_stream_of_frequency(
            msec, head_dim // 2, bool(rope_scaling.get("mrope_interleaved"))).to(positions.device)
        ang = ang3.gather(1, stream.view(1, 1, 1, -1).expand(
            ang3.shape[0], 1, ang3.shape[2], -1)).squeeze(1)
        ang = torch.cat([ang, ang], -1)
        return torch.cos(ang), torch.sin(ang)
    ang = positions.float()[..., None] * inv_freq  # [B,S,D/2]
    ang = torch.repeat_interleave(ang, 2, dim=-1) if interleaved else torch.cat([ang, ang], -1)
    scale = 1.0
    if rope_scaling and _rope_type(rope_scaling) == "yarn":
        factor = float(rope_scaling.get("factor", 1.0))
        mscale = float(rope_scaling.get("mscale", 1.0))
        mscale_all = float(rope_scaling.get("mscale_all_dim", 0.0))
        if mscale_all:
            scale = yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor, mscale_all)
        else:
            scale = yarn_get_mscale(factor, 1.0)
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_interleave(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...): each adjacent pair
    turned by a quarter (``:157-160``)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


@KERNEL_REGISTRY.register("rotary", "xla")
def _apply_rotary_plain(q, k, cos, sin, interleaved: bool = False):
    """q [B,S,Hq,D], k [B,S,Hk,D], cos/sin [B,S,D]; f32 math, cast back."""
    dtype = q.dtype
    rot = _rotate_interleave if interleaved else _rotate_half
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rot(qf) * sin
    k_out = kf * cos + rot(kf) * sin
    return q_out.to(dtype), k_out.to(dtype)


def apply_rotary(q, k, cos, sin, interleaved: bool = False):
    """Rotate q and k by the tables; tables narrower than the head (partial
    rotary) rotate its leading dims and pass the rest through
    (``transformer.py:390-395``)."""
    rot = cos.shape[-1]
    if rot < q.shape[-1]:
        q_r, k_r = resolve_op("rotary", q.device)(q[..., :rot], k[..., :rot], cos, sin,
                                                  interleaved)
        return (torch.cat([q_r, q[..., rot:]], dim=-1), torch.cat([k_r, k[..., rot:]], dim=-1))
    return resolve_op("rotary", q.device)(q, k, cos, sin, interleaved)

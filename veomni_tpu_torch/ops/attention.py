"""Attention facade with packing (segment-id) support.

Port of ``veomni_tpu/ops/attention.py``: the plain impls ``_attention_dense``
and ``_attention_xla`` (registered as ``attention``/``xla``, the name the
reference uses) and the ``attention()`` facade without the sequence-parallel
branch (the parallel layer is a later slice). ``xla_twopass`` is TPU-only in
the reference and has no port; ``xla_chunked`` is not ported yet, so
``_attention_xla`` always takes the dense path.

Layouts: q [B, S, Hq, D]; k/v [B, S, Hkv, D]; segment_ids [B, S] int32.
Returns [B, S, Hq, D].
"""

from __future__ import annotations

from typing import Optional

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op

_NEG = -1e30


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _normalize_mask_mod(mm):
    """Lift [Sq,Sk] / [B,Sq,Sk] / [B,H,Sq,Sk] masks to [B,H,q,k] rank."""
    if mm.ndim == 3:
        mm = mm[:, None]
    while mm.ndim < 4:
        mm = mm[None]
    return mm


def _attention_dense(
    q,
    k,
    v,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    mask_mod=None,
):
    """Materialized [B,H,Sq,Sk] f32 scores (``attention.py:327``).
    ``mask_mod(q_idx, k_idx) -> bool`` (broadcastable position grids)
    composes with the causal and segment masks. A row with every key masked
    out emits 0 (``attention.py:380-383``)."""
    _, sq, hq, d = q.shape
    sk = k.shape[1]
    n_rep = hq // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = (qi >= ki)[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]  # [B,1,q,k]
        mask = seg if mask is None else (mask & seg)
    if mask_mod is not None:
        pos_q = torch.arange(sq, device=q.device)[:, None]
        pos_k = torch.arange(sk, device=q.device)[None, :]
        mm = _normalize_mask_mod(mask_mod(pos_q, pos_k))
        mask = mm if mask is None else (mask & mm)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if mask is not None:
        probs = torch.where(mask.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


@KERNEL_REGISTRY.register("attention", "xla", priority=1)
def _attention_xla(
    q,
    k,
    v,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    sliding_window=None,
    sinks: Optional[torch.Tensor] = None,
):
    """Plain attention (``attention.py:305``). The reference switches to its
    blockwise ``xla_chunked`` form above ``VEOMNI_ATTN_CHUNK_THRESHOLD``;
    that memory optimisation is not ported, so this is always dense."""
    if sliding_window is not None or sinks is not None:
        raise NotImplementedError("sliding windows and attention sinks are not ported yet")
    return _attention_dense(q, k, v, segment_ids, causal, softmax_scale)


def attention(
    q,
    k,
    v,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    sliding_window=None,
    sinks: Optional[torch.Tensor] = None,
):
    """Registry-dispatched attention (``attention.py:387``) for tensors on
    ``q.device``: ``cuda_flash`` on a Hopper card, the plain impl elsewhere
    (or wherever a pin / ``VEOMNI_FORCE_EAGER_OPS`` asks for it)."""
    inner = resolve_op("attention", q.device)
    return inner(q, k, v, segment_ids=segment_ids, causal=causal,
                 softmax_scale=softmax_scale, sliding_window=sliding_window,
                 sinks=sinks)

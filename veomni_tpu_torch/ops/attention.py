"""Attention facade with packing (segment-id) support.

Port of ``veomni_tpu/ops/attention.py``: the plain impls ``_attention_dense``
(``:327``) and ``_attention_xla`` (registered as ``attention``/``xla``, the
name the reference uses, ``:305``), the blockwise ``_attention_xla_chunked``
(``attention``/``xla_chunked``, ``:65``) that ``_attention_xla`` switches to
above ``VEOMNI_ATTN_CHUNK_THRESHOLD`` tokens, and the ``attention()`` facade
without the sequence-parallel branch (the parallel layer is a later slice).
``xla_twopass`` is registered for TPUs only in the reference and has no
port. Every impl takes a causal sliding window and per-head sink logits.

Layouts: q/k [B, S, Hq/Hkv, D]; v [B, S, Hkv, Dv] (Dv = D but for MLA);
segment_ids [B, S] int32. Returns [B, S, Hq, Dv].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op
from veomni_tpu_torch.utils.env import get_env

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


def _in_window(qpos, kpos, sliding_window):
    """Keys less than ``sliding_window`` positions behind the query; a
    window <= 0 is full attention (``:360-363``)."""
    if sliding_window <= 0:
        return torch.ones_like(qpos >= kpos)
    return qpos - kpos < sliding_window


def _best_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (the chunked block size)."""
    best = 1
    for c in range(1, min(n, target) + 1):
        if n % c == 0:
            best = c
    return best


def _kv_block(acc, m, l, qi, kj, vj, mask, scale: float):
    """One (q block, kv block) step of the online softmax (``kv_block``,
    ``:110-138``): acc [B,H,Cq,D], m/l [B,H,Cq] f32; mask [B,H,Cq,Ck]."""
    s_blk = torch.einsum("bhqd,bhkd->bhqk", qi.float(), kj.float()) * scale
    s_blk = torch.where(mask, s_blk, torch.full_like(s_blk, _NEG))
    m_new = torch.maximum(m, s_blk.amax(-1))
    p = torch.where(mask, torch.exp(s_blk - m_new[..., None]), torch.zeros_like(s_blk))
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(qi.dtype).float(), vj.float())
    return acc, m_new, l


@KERNEL_REGISTRY.register("attention", "xla_chunked")
def _attention_xla_chunked(
    q,
    k,
    v,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    sliding_window=None,
    sinks: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
    mask_mod=None,
):
    """Blockwise online-softmax attention in plain torch (``:65-180``):
    O(S * chunk) live memory instead of the dense impl's [B, H, S, S] f32
    scores. Blocks wholly above the causal diagonal are skipped, and each
    block step runs under ``torch.utils.checkpoint`` when autograd records,
    so the backward recomputes block scores as a flash backward does.

    V keeps its own head dim ``dv`` (MLA: 128 against q/k's 192), where the
    reference reshapes V and sizes the accumulator with q's (``:105``) and
    raises on any ``dv != d`` (ROADMAP.md queue 3, diverges on purpose)."""
    b, sq, hq, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    cq = _best_chunk(sq, q_chunk)
    ck = _best_chunk(sk, k_chunk)
    if cq < 128 or ck < 128:
        # pathological (prime-ish) lengths: blockwise gains nothing
        return _attention_dense(q, k, v, segment_ids, causal, softmax_scale,
                                sliding_window, sinks, mask_mod=mask_mod)
    n_rep = hq // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    nq, nk = sq // cq, sk // ck
    # [B,H,n,C,D] block layout
    qt = q.transpose(1, 2).reshape(b, hq, nq, cq, d)
    kt = k.transpose(1, 2).reshape(b, hq, nk, ck, d)
    vt = v.transpose(1, 2).reshape(b, hq, nk, ck, dv)
    seg_q = seg_k = None
    if segment_ids is not None:
        seg_q = segment_ids.reshape(b, nq, cq)
        seg_k = segment_ids.reshape(b, nk, ck)
    recompute = torch.is_grad_enabled()
    out_blocks = []
    for i in range(nq):
        qi = qt[:, :, i]
        acc = torch.zeros((b, hq, cq, dv), dtype=torch.float32, device=q.device)
        m = torch.full((b, hq, cq), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hq, cq), dtype=torch.float32, device=q.device)
        qpos = i * cq + torch.arange(cq, device=q.device)[:, None]
        for j in range(nk):
            if causal and j * ck > i * cq + cq - 1:
                continue  # the whole block lies above the diagonal
            kpos = j * ck + torch.arange(ck, device=q.device)[None, :]
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask = qpos >= kpos
                if sliding_window is not None:
                    mask = mask & _in_window(qpos, kpos, sliding_window)
            mask = mask[None, None].expand(b, hq, cq, ck)
            if seg_q is not None:
                mask = mask & (seg_q[:, i][:, None, :, None] == seg_k[:, j][:, None, None, :])
            if mask_mod is not None:
                mask = mask & _normalize_mask_mod(mask_mod(qpos, kpos))
            args = (acc, m, l, qi, kt[:, :, j], vt[:, :, j], mask, scale)
            if recompute:
                acc, m, l = checkpoint(_kv_block, *args, use_reentrant=False)
            else:
                acc, m, l = _kv_block(*args)
        if sinks is not None:
            l = l + torch.exp(sinks.float()[None, :, None] - m)
        out_blocks.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    # nq x [B,H,Cq,D] -> [B,S,H,D]
    return torch.cat(out_blocks, dim=2).transpose(1, 2)


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
    mask_mod=None,
):
    """Plain attention (``:305-325``): dense up to
    ``VEOMNI_ATTN_CHUNK_THRESHOLD`` query tokens, blockwise above."""
    if q.shape[1] > int(get_env("VEOMNI_ATTN_CHUNK_THRESHOLD")):
        return _attention_xla_chunked(q, k, v, segment_ids, causal, softmax_scale,
                                      sliding_window, sinks, mask_mod=mask_mod)
    return _attention_dense(q, k, v, segment_ids, causal, softmax_scale, sliding_window,
                            sinks, mask_mod=mask_mod)


def _attention_dense(
    q,
    k,
    v,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    sliding_window=None,
    sinks: Optional[torch.Tensor] = None,
    mask_mod=None,
):
    """Materialized [B,H,Sq,Sk] f32 scores (``:327-385``).
    ``mask_mod(q_idx, k_idx) -> bool`` (broadcastable position grids)
    composes with the causal, window and segment masks. ``sinks`` [Hq] are
    per-head logits that join the softmax denominator only. Without sinks a
    row with every key masked out emits 0 (``:380-383``)."""
    b, sq, hq, d = q.shape
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
        mask = qi >= ki
        if sliding_window is not None:
            mask = mask & _in_window(qi, ki, sliding_window)
        mask = mask[None, None]
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
    if sinks is not None:
        sink = sinks.float()[None, :, None, None].expand(b, hq, sq, 1)
        probs = torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :sk].to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        if mask is not None:
            probs = torch.where(mask.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


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

"""Paged KV-cache attention: attend decode queries against gathered blocks.

Port of ``veomni_tpu/ops/paged_attention.py``: ``cache_attend`` (``:32``),
``gather_block_kv`` (``:71``), ``gather_block_kv_q8`` (``:86``) and the ops
``paged_attention`` and ``paged_prefill_attention``, each with impls
``xla_gather`` (``:104``, ``:170``) and ``xla_gather_q8`` (``:122``,
``:189``), dispatched by ``paged_attend`` (``:155``) and
``paged_prefill_attend`` (``:210``) through ``_resolve_paged``'s rule
(``:143-152``): a pin wins, otherwise the pool's type picks the impl. The serving engine carves the KV cache
into a pool of fixed-size blocks ``[num_blocks, block_size, hkv, d]`` with
per-sequence block tables; ``gather_block_kv`` gathers each slot's blocks
into a contiguous context (block-table order is sequence order, so gathered
index ``j`` sits at absolute position ``j``) and ``cache_attend`` runs the
masked dense softmax the contiguous decode cache uses too. The reference
runs this as XLA, not Pallas, so it is plain torch here.

Numerics as the reference's ``preferred_element_type=f32``: both products
take their operands upcast to f32 (a product of two bf16 values is exact in
f32, so this is bf16 x bf16 with f32 accumulation), and the probabilities
are rounded to the query dtype before the value product. The GQA repeat is
a reshape of the queries into their kv-head groups rather than a broadcast
of the keys: the same dot products, without materializing the repeat.
"""

from __future__ import annotations

from typing import Optional

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op
from veomni_tpu_torch.ops.quantization import QuantizedKV


def cache_attend(q, k_cache, v_cache, valid_mask, *, num_rep: int = 1, scale: float,
                 sinks: Optional[torch.Tensor] = None):
    """q [B,T,hq,d] against a cache [B,M,hkv,d]; valid_mask [B,T,M] bool
    (broadcastable over B/T). ``sinks`` [hq] are learned attention-sink
    logits folded into the softmax denominator. Returns [B,T,hq,d] in q's
    dtype.

    A row with no valid key emits 0, as ``ops/attention.py::_attention_dense``
    does, where the reference's exp(-inf - -inf) emits NaN. Only padding
    rows reach it: a padded row of a prefill chunk whose sliding window ends
    before the gathered context begins (bucket > window). Its NaN would be
    written into the null block's K/V, and from there reach real rows as 0 *
    NaN through their masked keys (ROADMAP.md queue 3). Every row with a
    valid key computes exactly what the reference computes."""
    b, t, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.float().view(b, t, hkv, num_rep, d)
    s = torch.einsum("btgrd,bmgd->bgrtm", qg, k_cache.float()).reshape(b, hq, t, -1) * scale
    s = s.masked_fill(~valid_mask[:, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = m.masked_fill(m == float("-inf"), 0.0)  # rows with no valid key
    if sinks is not None:
        sink = sinks.float()[None, :, None, None]
        m = torch.maximum(m, sink)
    p = torch.exp(s - m)
    denom = p.sum(-1)
    if sinks is not None:
        denom = denom + torch.exp(sink[..., 0] - m[..., 0])
    pg = p.to(q.dtype).float().view(b, hkv, num_rep, t, -1)
    o = torch.einsum("bgrtm,bmgd->btgrd", pg, v_cache.float()).reshape(b, t, hq, d)
    denom = denom.masked_fill(denom == 0, 1.0)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def gather_block_kv(k_pool, v_pool, block_tables):
    """k_pool/v_pool [NB, BS, hkv, d]; block_tables [S, nb] int (padded with
    the null block 0) -> (k [S, nb*BS, hkv, d], v [S, nb*BS, hkv, d]). Rows
    gathered through padding entries hold garbage; the caller's valid mask
    hides them."""
    _, bs, hkv, d = k_pool.shape
    s, nb = block_tables.shape
    k = k_pool[block_tables].reshape(s, nb * bs, hkv, d)
    v = v_pool[block_tables].reshape(s, nb * bs, hkv, d)
    return k, v


def gather_block_kv_q8(k_pool: QuantizedKV, v_pool: QuantizedKV, block_tables, dtype):
    """:func:`gather_block_kv` for int8 pools: gather payload and scale
    through the table first (a quarter of the bytes of a dense gather),
    then dequantize the gathered context to ``dtype``."""
    _, bs, hkv, d = k_pool.shape
    s, nb = block_tables.shape

    def one(pool):
        ctx = pool.data[block_tables].float() * pool.scale[block_tables][..., None]
        return ctx.to(dtype).reshape(s, nb * bs, hkv, d)

    return one(k_pool), one(v_pool)


@KERNEL_REGISTRY.register("paged_attention", "xla_gather")
def _paged_attend_xla(q, k_pool, v_pool, block_tables, valid_mask, *, num_rep: int = 1,
                      scale: float, sinks: Optional[torch.Tensor] = None):
    k_ctx, v_ctx = gather_block_kv(k_pool, v_pool, block_tables)
    return cache_attend(q, k_ctx, v_ctx, valid_mask, num_rep=num_rep, scale=scale, sinks=sinks)


@KERNEL_REGISTRY.register("paged_attention", "xla_gather_q8")
def _paged_attend_xla_q8(q, k_pool, v_pool, block_tables, valid_mask, *, num_rep: int = 1,
                         scale: float, sinks: Optional[torch.Tensor] = None):
    """int8-KV attention: gathered-dequantize, then the same
    ``cache_attend`` as ``xla_gather`` (prefill chunks attend over their own
    rows as the scatter before this attend quantized them)."""
    k_ctx, v_ctx = gather_block_kv_q8(k_pool, v_pool, block_tables, q.dtype)
    return cache_attend(q, k_ctx, v_ctx, valid_mask, num_rep=num_rep, scale=scale, sinks=sinks)


# the same math under their own op name, so a fused prefill kernel can later
# replace the gather without touching the decode op's pin
KERNEL_REGISTRY.register("paged_prefill_attention", "xla_gather")(_paged_attend_xla)
KERNEL_REGISTRY.register("paged_prefill_attention", "xla_gather_q8")(_paged_attend_xla_q8)


def _resolve_paged(op: str, k_pool, device):
    """A pin wins; otherwise a ``QuantizedKV`` pool takes ``xla_gather_q8``
    and a dense one the op's priority-resolved impl."""
    if KERNEL_REGISTRY.pinned(op) is None and isinstance(k_pool, QuantizedKV):
        return KERNEL_REGISTRY.impls(op)["xla_gather_q8"].fn
    return resolve_op(op, device)


def paged_attend(q, k_pool, v_pool, block_tables, valid_mask, *, num_rep: int = 1,
                 scale: float, sinks: Optional[torch.Tensor] = None):
    """q [S,T,hq,d] + pool [NB,BS,hkv,d] + block_tables [S,nb] -> [S,T,hq,d].
    valid_mask [S,T,nb*BS] in gathered (== absolute) positions. T is 1 for
    the plain decode step and KB for the speculative verify step."""
    return _resolve_paged("paged_attention", k_pool, q.device)(
        q, k_pool, v_pool, block_tables, valid_mask, num_rep=num_rep, scale=scale, sinks=sinks)


def paged_prefill_attend(q, k_pool, v_pool, block_tables, valid_mask, *, num_rep: int = 1,
                         scale: float, sinks: Optional[torch.Tensor] = None):
    """Chunked-prefill attention: a T-token chunk of ONE sequence attends
    over its whole context (cached prefix blocks + the chunk's own freshly
    written rows) through the block table. q [1,T,hq,d], block_tables
    [1,nb], valid_mask [1,T,nb*BS] -> [1,T,hq,d]."""
    return _resolve_paged("paged_prefill_attention", k_pool, q.device)(
        q, k_pool, v_pool, block_tables, valid_mask, num_rep=num_rep, scale=scale, sinks=sinks)

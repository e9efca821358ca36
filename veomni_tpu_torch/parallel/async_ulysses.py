"""Async Ulysses: head chunks whose all-to-all overlaps the previous
chunk's attention.

Port of ``veomni_tpu/parallel/async_ulysses.py``. The reference builds a
``lax.scan`` software pipeline whose structure lets XLA's scheduler overlap
each chunk's all-to-all with its neighbour's attention. Eager torch
overlaps by issuing the collective itself: the (GQA-repeated) head dim is
split into K chunks (``UlyssesLayout.max_chunks`` keeps each chunk's head
counts divisible by ulysses and its q heads on their own kv heads), chunk
0's scatter all-to-all is issued first, and in the loop chunk i+1's
scatter is issued with ``async_op=True`` before chunk i attends and is
gathered back. Each chunk's attention is the monolithic computation
restricted to its heads, so the result equals the monolithic path's.
Sinks are sliced per (chunk, rank). ``cp > 1`` runs the ring on each
chunk, as the monolithic path does.

The backward of each exchange is the reverse all-to-all, synchronous (the
reference's backward is whatever XLA schedules).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY
from veomni_tpu_torch.parallel.functional import (
    _a2a,
    all_gather,
    group_rank,
    group_size,
)
from veomni_tpu_torch.parallel.parallel_state import AXIS_ULYSSES, ParallelState
from veomni_tpu_torch.parallel.sequence_parallel import (
    UlyssesLayout,
    _repeat_heads,
    a2a_gather_heads,
    local_attention,
    ulysses_monolithic,
)


def _start_scatter(x: torch.Tensor, group):
    """Issue the head-scatter all-to-all of x [b, s, h, d] asynchronously:
    (work, receive buffer)."""
    n = group_size(group)
    send = torch.stack(x.chunk(n, dim=2)).contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return work, recv


class _FinishScatter(torch.autograd.Function):
    """The scatter's result once its exchange has landed; its backward is
    the reverse (gather-heads) all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, x, work, recv, group):
        ctx.group = group
        work.wait()
        return torch.cat(recv.unbind(0), dim=1)

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, ctx.group, 1, 2), None, None, None


def _scatter_async(tensors, group):
    return [(t, *_start_scatter(t.detach(), group)) for t in tensors]


def _finish(pending, group):
    return [_FinishScatter.apply(t, work, recv, group) for t, work, recv in pending]


@KERNEL_REGISTRY.register("ulysses", "ulysses_async")
def async_ulysses_attention(inner_attention: Callable, q, k, v, segment_ids,
                            pstate: ParallelState, *, chunks: int = 4, **attn_kwargs):
    """Chunked-pipeline Ulysses attention with the contract of
    :func:`~veomni_tpu_torch.parallel.sequence_parallel.ulysses_monolithic`;
    ``chunks`` is clamped to the head layout, and an effective count of 1
    (or ulysses 1) is the monolithic path."""
    u = pstate.ulysses_size
    if u == 1:
        return ulysses_monolithic(inner_attention, q, k, v, segment_ids, pstate, **attn_kwargs)
    layout = UlyssesLayout(u=u, hq=q.shape[2], hkv=k.shape[2])
    n_chunks = layout.clamp_chunks(max(int(chunks), 1))
    if n_chunks < 2:
        return ulysses_monolithic(inner_attention, q, k, v, segment_ids, pstate, **attn_kwargs)
    sinks = attn_kwargs.pop("sinks", None)
    if segment_ids is None:
        segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    group = pstate.group((AXIS_ULYSSES,))
    rank = group_rank(group)
    k = _repeat_heads(k, layout.kv_rep)
    v = _repeat_heads(v, layout.kv_rep)
    seg = all_gather(segment_ids, group, dim=1)  # chunk-invariant: once
    qc = q.chunk(n_chunks, dim=2)
    kc = k.chunk(n_chunks, dim=2)
    vc = v.chunk(n_chunks, dim=2)
    pending = _scatter_async((qc[0], kc[0], vc[0]), group)  # warm-up
    outs = []
    for c in range(n_chunks):
        qg, kg, vg = _finish(pending, group)
        if c + 1 < n_chunks:  # chunk c+1's exchange runs while chunk c attends
            pending = _scatter_async((qc[c + 1], kc[c + 1], vc[c + 1]), group)
        snk = None if sinks is None else layout.sink_slice(sinks, c, n_chunks, rank)
        out = local_attention(inner_attention, qg, kg, vg, seg, pstate, snk, **attn_kwargs)
        outs.append(a2a_gather_heads(out, group))
    return torch.cat(outs, dim=2)  # the original head order

"""Ulysses sequence parallelism: all-to-all head-scatter / seq-gather.

Port of ``veomni_tpu/parallel/sequence_parallel.py``. The reference runs
one ``shard_map`` region in which ``jax.lax.all_to_all`` swaps the head and
sequence dims over the ``ulysses`` axis and JAX's AD transposes it. Here
each rank holds its sequence chunk ``[b, s/sp, h, d]`` (cp outer, ulysses
inner) and ``parallel/functional.py::all_to_all`` is the exchange, whose
backward is the reverse exchange. The GQA head repeat (when ulysses does
not divide the kv heads) is the reference's (``:52``, ``UlyssesLayout``).

Two implementations share the layout math, selected through the kernel
registry (op ``"ulysses"``):

* ``monolithic`` (this module) — one all-to-all per q/k/v tensor over all
  heads, then the inner attention on the rank's heads at once;
* ``ulysses_async`` (``parallel/async_ulysses.py``) — head chunks whose
  all-to-all is issued while the previous chunk attends.

The inner attention is the registry's ``attention`` op for the rank's
tensors: on a Hopper card the ``cuda_flash`` kernels K1–K3 at ``Hq/u`` q
heads and ``Hkv·rep/u`` kv heads, under the same ``Hq % Hkv`` dispatch
rule as without sequence parallelism. With ``cp > 1`` the ring
(``parallel/ring_attention.py``) runs over the cp group on each cp chunk.

The loss needs no counterpart of its own: each rank sums its tokens' loss
and the train step all-reduces the token count and the sums over dp×sp
(``train/train_step.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY
from veomni_tpu_torch.parallel.functional import all_gather, all_to_all, group_rank
from veomni_tpu_torch.parallel.parallel_state import AXIS_CP, AXIS_ULYSSES, ParallelState
from veomni_tpu_torch.utils.env import env_bool, get_env
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _repeat_heads(x, factor: int):
    if factor == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, factor, d).reshape(b, s, h * factor, d)


def a2a_scatter_heads(x, group):
    """[b, s_local, h, d] -> [b, s_local*u, h/u, d]: heads scattered over the
    group, the sequence gathered in rank order (each rank reassembles the
    full sequence, or under cp its cp chunk, for its head slice)."""
    return all_to_all(x, group, split_dim=2, concat_dim=1)


def a2a_gather_heads(x, group):
    """Inverse of :func:`a2a_scatter_heads`: [b, s_local*u, h/u, d] ->
    [b, s_local, h, d]."""
    return all_to_all(x, group, split_dim=1, concat_dim=2)


@dataclass(frozen=True)
class UlyssesLayout:
    """Head/sequence layout of one Ulysses region (the reference's, ``:78``).

    Every tensor's head dim must divide by ``u``; GQA kv heads are first
    repeated by ``kv_rep``, the least factor that makes ``hkv * kv_rep`` a
    multiple of ``u``. Head chunks of the async path must keep both the
    all-to-all divisibility and the q->kv group mapping (:meth:`max_chunks`)."""

    u: int
    hq: int
    hkv: int

    def __post_init__(self):
        if self.hq % self.u:
            raise ValueError(
                f"num_attention_heads {self.hq} must be divisible by ulysses {self.u}")

    @property
    def kv_rep(self) -> int:
        return self.u // math.gcd(self.hkv, self.u)

    @property
    def hkv_rep(self) -> int:
        return self.hkv * self.kv_rep

    @property
    def hq_local(self) -> int:
        return self.hq // self.u

    @property
    def max_chunks(self) -> int:
        """Largest head-chunk count whose chunks keep head counts divisible
        by u and cover whole GQA groups."""
        return math.gcd(self.hq // self.u, self.hkv_rep // self.u)

    def clamp_chunks(self, requested: int) -> int:
        """Largest feasible K <= requested (>= 1)."""
        best = 1
        for k in range(1, min(requested, self.max_chunks) + 1):
            if self.max_chunks % k == 0:
                best = k
        return best

    def sink_slice(self, sinks, chunk: int, n_chunks: int, rank: int):
        """This rank's slice of the per-q-head sink logits [hq] for head
        chunk ``chunk`` of ``n_chunks``."""
        per_chunk = self.hq // n_chunks
        per_rank = per_chunk // self.u
        start = chunk * per_chunk + rank * per_rank
        return sinks[start:start + per_rank]


def local_attention(inner: Callable, q, k, v, seg, pstate: ParallelState, sinks=None,
                    **attn_kwargs):
    """Attention of this rank's gathered (cp chunk of the) sequence: the ring
    over the cp group when cp > 1, else ``inner`` on the whole sequence."""
    if pstate.cp_size > 1:
        from veomni_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, seg, group=pstate.group((AXIS_CP,)), sinks=sinks,
                              **attn_kwargs)
    return inner(q, k, v, segment_ids=seg, sinks=sinks, **attn_kwargs)


@KERNEL_REGISTRY.register("ulysses", "monolithic", priority=1)
def ulysses_monolithic(inner_attention: Callable, q, k, v, segment_ids, pstate: ParallelState,
                       **attn_kwargs):
    """q [B, S/sp, Hq, D], k/v [B, S/sp, Hkv, D] and segment_ids [B, S/sp]:
    this rank's sequence chunk (cp outer, ulysses inner). The ulysses
    all-to-all trades the chunk for a head slice of the cp chunk; the ring
    (cp > 1) or ``inner_attention`` attends; the reverse all-to-all brings
    the rank's sequence chunk back with every head: [B, S/sp, Hq, D]."""
    u = pstate.ulysses_size
    if u == 1 and pstate.cp_size == 1:
        return inner_attention(q, k, v, segment_ids=segment_ids, **attn_kwargs)
    sinks = attn_kwargs.pop("sinks", None)
    if segment_ids is None:
        segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    if u == 1:
        return local_attention(inner_attention, q, k, v, segment_ids, pstate, sinks,
                               **attn_kwargs)
    layout = UlyssesLayout(u=u, hq=q.shape[2], hkv=k.shape[2])
    group = pstate.group((AXIS_ULYSSES,))
    k = _repeat_heads(k, layout.kv_rep)
    v = _repeat_heads(v, layout.kv_rep)
    q, k, v = (a2a_scatter_heads(t, group) for t in (q, k, v))  # [b, s/cp, h/u, d]
    seg = all_gather(segment_ids, group, dim=1)
    if sinks is not None:
        rank = group_rank(group)
        sinks = sinks[rank * layout.hq_local:(rank + 1) * layout.hq_local]
    out = local_attention(inner_attention, q, k, v, seg, pstate, sinks, **attn_kwargs)
    return a2a_gather_heads(out, group)  # [b, s/sp, hq, d]


def _resolve_async_chunks(async_chunks: Optional[int]) -> int:
    """Requested head-chunk count for the async path; 0 means monolithic.
    Precedence: registry pin > explicit ``async_chunks`` (the model config)
    > ``VEOMNI_ULYSSES_ASYNC`` (``:236-260``)."""
    pin = KERNEL_REGISTRY.pinned("ulysses")
    if pin == "monolithic":
        return 0

    def default_k():
        return int(get_env("VEOMNI_ULYSSES_ASYNC_CHUNKS"))

    if pin == "ulysses_async":
        return async_chunks if async_chunks else default_k()
    if async_chunks is not None:
        return async_chunks if async_chunks > 1 else 0
    if env_bool("VEOMNI_ULYSSES_ASYNC"):
        return default_k()
    return 0


def sp_attention(inner_attention: Callable, q, k, v, segment_ids, pstate: ParallelState,
                 async_chunks: Optional[int] = None, **attn_kwargs):
    """SP attention dispatcher: the monolithic Ulysses wrap or the chunked
    async pipeline, per the registry pin, ``async_chunks`` and the env
    knobs; the chunk count is clamped to the head layout (``:226``)."""
    from veomni_tpu_torch.parallel import async_ulysses

    chunks = _resolve_async_chunks(async_chunks)
    if chunks > 1 and pstate.ulysses_size > 1:
        layout = UlyssesLayout(u=pstate.ulysses_size, hq=q.shape[2], hkv=k.shape[2])
        eff = layout.clamp_chunks(chunks)
        if eff > 1:
            return async_ulysses.async_ulysses_attention(
                inner_attention, q, k, v, segment_ids, pstate, chunks=eff, **attn_kwargs)
        logger.info_once(
            "ulysses_async requested (chunks=%d) but head layout (hq=%d, hkv=%d, u=%d) "
            "admits no chunking; using monolithic", chunks, layout.hq, layout.hkv, layout.u)
    return ulysses_monolithic(inner_attention, q, k, v, segment_ids, pstate, **attn_kwargs)


def sp_pad_length(seq_len: int, sp_size: int) -> int:
    """Pad target so the sequence divides evenly across SP ranks."""
    return (-seq_len) % sp_size


def sp_slice(x: torch.Tensor, pstate: ParallelState, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of a global-sequence tensor along ``dim`` (the
    chunk index is :meth:`ParallelState.sp_rank`, cp outer)."""
    sp = pstate.sp_size
    if sp == 1:
        return x
    pad = sp_pad_length(x.shape[dim], sp)
    if pad:
        raise ValueError(f"sequence length {x.shape[dim]} is not a multiple of sp {sp}: "
                         f"pad it by {pad} (the collators' seq_len must be)")
    n = x.shape[dim] // sp
    return x.narrow(dim, pstate.sp_rank() * n, n)

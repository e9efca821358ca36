"""Ring-attention context parallelism over the ``cp`` group.

Port of ``veomni_tpu/parallel/ring_attention.py``. Each cp rank holds one
contiguous chunk of q/k/v (chunk index = its cp coordinate); the K/V chunks
and their segment ids rotate around the ring (``isend``/``irecv`` through
``parallel/functional.py::send_recv``) while each rank carries the
online-softmax state (acc, m, l) of its own q chunk, so the ring is the
outer KV loop of flash attention. Chunk pairs strictly above the causal
diagonal are skipped (rank r attends r + 1 of cp chunks), and within a pair
q/k blocks of at most ``q_chunk``/``k_chunk`` tokens keep the live scores
O(S_local · block). Masks use global positions (the chunk offsets), so
segments, causal and sliding windows hold across chunk boundaries; sinks
join the denominator once, at the end.

The reference lets JAX differentiate its ``lax.scan`` (the ``ppermute``
transposes itself). Here :class:`_RingAttention` is a
``torch.autograd.Function``: the forward keeps the output and the
log-sum-exp, and the backward is the flash backward around the same ring,
with the dK/dV accumulators rotating with their K/V chunk so that after
cp rotations each rank holds the gradient of its own chunk. The reference's
ring is plain XLA, not Pallas; this one is plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch

from veomni_tpu_torch.parallel.functional import group_rank, group_size, send_recv

_NEG = -1e30


def _best_chunk(n: int, target: int) -> int:
    best = 1
    for c in range(1, min(n, target) + 1):
        if n % c == 0:
            best = c
    return best


def _expand(x, n_rep: int):
    """[b, s, hkv, d] -> [b, hkv*n_rep, s, d] (head h reads kv head h // n_rep)."""
    b, s, h, d = x.shape
    if n_rep > 1:
        x = x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)
    return x.transpose(1, 2)


class _Ring:
    """Block geometry and masks of one rank's q chunk against the chunks
    rotating past it."""

    def __init__(self, q, k, seg, group, causal, scale, window, q_chunk, k_chunk):
        self.group = group
        self.cp = group_size(group)
        self.my = group_rank(group)
        self.sl = q.shape[1]
        self.n_rep = q.shape[2] // k.shape[2]
        self.causal = causal
        self.scale = scale
        self.window = window
        self.cq = _best_chunk(self.sl, q_chunk)
        self.ck = _best_chunk(self.sl, k_chunk)
        self.seg = seg

    def rotate(self, tensors):
        if self.cp == 1:
            return tensors
        return send_recv(tensors, self.group, (self.my + 1) % self.cp,
                         (self.my - 1) % self.cp)

    def blocks(self, src: int):
        """(q slice, k slice, q positions, k positions) of every block pair
        of this rank's q chunk against the chunk of ring rank ``src`` that
        the causal mask leaves any work in."""
        q_off, k_off = self.my * self.sl, src * self.sl
        dev = self.seg.device
        for i in range(0, self.sl, self.cq):
            for j in range(0, self.sl, self.ck):
                if self.causal and k_off + j > q_off + i + self.cq - 1:
                    continue
                qpos = q_off + i + torch.arange(self.cq, device=dev)[:, None]
                kpos = k_off + j + torch.arange(self.ck, device=dev)[None, :]
                yield slice(i, i + self.cq), slice(j, j + self.ck), qpos, kpos

    def mask(self, qpos, kpos, seg_q, seg_k):
        """[b, 1, cq, ck] bool."""
        m = torch.ones_like(qpos >= kpos)
        if self.causal:
            m = qpos >= kpos
            if self.window:
                m = m & (qpos - kpos < self.window)
        return m[None, None] & (seg_q[:, None, :, None] == seg_k[:, None, None, :])

    def visits(self, src: int) -> bool:
        return not self.causal or src <= self.my


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, sinks, group, causal, scale, window, q_chunk, k_chunk):
        ring = _Ring(q, k, seg, group, causal, scale, window, q_chunk, k_chunk)
        b, sl, hq, d = q.shape
        qt = q.transpose(1, 2).float()  # [b, hq, sl, d]
        acc = torch.zeros(b, hq, sl, v.shape[-1], dtype=torch.float32, device=q.device)
        m = torch.full((b, hq, sl), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hq, sl), dtype=torch.float32, device=q.device)
        k_t, v_t, seg_t = k, v, seg
        for t in range(ring.cp):
            src = (ring.my - t) % ring.cp
            if ring.visits(src):
                kt = _expand(k_t, ring.n_rep).float()
                vt = _expand(v_t, ring.n_rep).float()
                for qs, ks, qpos, kpos in ring.blocks(src):
                    mask = ring.mask(qpos, kpos, seg[:, qs], seg_t[:, ks])
                    s = torch.einsum("bhqd,bhkd->bhqk", qt[:, :, qs], kt[:, :, ks]) * scale
                    s = torch.where(mask, s, torch.full_like(s, _NEG))
                    m_new = torch.maximum(m[:, :, qs], s.amax(-1))
                    p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
                    alpha = torch.exp(m[:, :, qs] - m_new)
                    l[:, :, qs] = l[:, :, qs] * alpha + p.sum(-1)
                    acc[:, :, qs] = acc[:, :, qs] * alpha[..., None] + torch.einsum(
                        "bhqk,bhkd->bhqd", p.to(q.dtype).float(), vt[:, :, ks])
                    m[:, :, qs] = m_new
            if t < ring.cp - 1:
                k_t, v_t, seg_t = ring.rotate([k_t, v_t, seg_t])
        if sinks is not None:
            l = l + torch.exp(sinks.float()[None, :, None] - m)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [b, hq, sl, dv]
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, seg, sinks, out, lse)
        ctx.ring = ring
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, seg, sinks, out, lse = ctx.saved_tensors
        ring: _Ring = ctx.ring
        scale = ring.scale
        b, sl, hq, d = q.shape
        hkv = k.shape[2]
        qt = q.transpose(1, 2).float()
        do = grad_out.transpose(1, 2).float()  # [b, hq, sl, dv]
        delta = (do * out).sum(-1)  # [b, hq, sl]
        dq = torch.zeros_like(qt)
        k_t, v_t, seg_t = k, v, seg
        dk_t = torch.zeros(b, hq, sl, d, dtype=torch.float32, device=q.device)
        dv_t = torch.zeros(b, hq, sl, v.shape[-1], dtype=torch.float32, device=q.device)
        for t in range(ring.cp):
            src = (ring.my - t) % ring.cp
            if ring.visits(src):
                kt = _expand(k_t, ring.n_rep).float()
                vt = _expand(v_t, ring.n_rep).float()
                for qs, ks, qpos, kpos in ring.blocks(src):
                    mask = ring.mask(qpos, kpos, seg[:, qs], seg_t[:, ks])
                    s = torch.einsum("bhqd,bhkd->bhqk", qt[:, :, qs], kt[:, :, ks]) * scale
                    p = torch.where(mask, torch.exp(s - lse[:, :, qs, None]),
                                    torch.zeros_like(s))
                    dv_t[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", p, do[:, :, qs])
                    dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, qs], vt[:, :, ks])
                    ds = p * (dp - delta[:, :, qs, None]) * scale
                    dq[:, :, qs] += torch.einsum("bhqk,bhkd->bhqd", ds, kt[:, :, ks])
                    dk_t[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", ds, qt[:, :, qs])
            # the accumulators travel with their chunk: after cp rotations
            # each rank holds its own chunk's dK/dV again
            if t < ring.cp - 1:
                k_t, v_t, seg_t, dk_t, dv_t = ring.rotate([k_t, v_t, seg_t, dk_t, dv_t])
            else:
                dk_t, dv_t = ring.rotate([dk_t, dv_t])

        def fold(g):  # [b, hq, sl, d] -> [b, sl, hkv, d], summing each GQA group
            g = g.view(b, hkv, ring.n_rep, sl, g.shape[-1]).sum(2)
            return g.transpose(1, 2)

        dsinks = None
        if sinks is not None:
            p_sink = torch.exp(sinks.float()[None, :, None] - lse)
            dsinks = -(p_sink * delta).sum((0, 2)).to(sinks.dtype)
        return (dq.transpose(1, 2).to(q.dtype), fold(dk_t).to(k.dtype), fold(dv_t).to(v.dtype),
                None, dsinks, None, None, None, None, None, None)


def ring_attention(q, k, v, segment_ids: Optional[torch.Tensor], *, group, causal: bool = True,
                   softmax_scale: Optional[float] = None, sliding_window=None,
                   sinks: Optional[torch.Tensor] = None, q_chunk: int = 1024,
                   k_chunk: int = 1024):
    """This rank's q chunk attended over the whole ring.

    q [B, Sl, Hq, D]; k/v [B, Sl, Hkv, D(v)]; segment_ids [B, Sl]: the local
    contiguous chunk of the global sequence, chunk index = this rank's place
    in ``group``. ``sliding_window`` <= 0 or None is full (causal) attention.
    Returns [B, Sl, Hq, Dv]."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if segment_ids is None:
        segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    window = sliding_window if sliding_window and sliding_window > 0 else 0
    return _RingAttention.apply(q, k, v, segment_ids, sinks, group, causal, scale, window,
                                q_chunk, k_chunk)

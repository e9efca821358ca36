"""Flash attention on Hopper: CUDA C++ kernels K1-K3 + their plain versions.

Port of ``veomni_tpu/ops/pallas/flash_attention.py``. The kernels live in
``veomni_tpu_torch/csrc/flash_attention.cu`` (its header says what bounds
them on the H100 and how the design answers it: all three are Hopper
kernels with TMA, an mbarrier ring and ``wgmma`` on two consumer
warpgroups, K1 and K3 on 128-row q tiles, K2 on 128-key tiles):

* K1 ``vt_flash_fwd``     <- ``_fwd_kernel``     (reference ``:49-106``, ``_fwd`` ``:109``)
* K2 ``vt_flash_bwd_dkv`` <- ``_bwd_dkv_kernel`` (``:155-205``, ``_bwd`` ``:255``)
* K3 ``vt_flash_bwd_dq``  <- ``_bwd_dq_kernel``  (``:208-252``, ``_bwd`` ``:255``)

Beside each kernel sits its plain PyTorch version (``flash_fwd_plain``,
``flash_bwd_plain``) with the same inputs and outputs. A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises. ``LAUNCHES`` counts kernel launches, one per launch, and
``LAUNCHES_BY_HEAD_DIM`` the same by head dim. The kernels take head dims
64, 72, 80, 128 and 256 (``HEAD_DIMS``) in bf16; other head dims and dtypes
raise, naming the ``ops_config`` pin to the plain attention. Head dims 72
(the Qwen3-VL vision towers) and 80 (the Qwen2-VL / Qwen2.5-VL towers) run
D = 128's tiles over 3-D tensor maps [B*S, H, D] whose boxes read zeros
past the head's D columns and store none of them (the .cu's header).

``flash_attention`` (registered as ``attention``/``cuda_flash``) keeps the
reference's feature rule (``:367-380``): sliding window, sinks, an
asymmetric v-dim, ``S % 128`` or ``Hq % Hkv`` dispatch explicitly to the
plain ``_attention_xla``. That is the reference's semantics, not a failure
fallback; ``FALLBACK_CALLS`` counts those dispatches.

Numerics. Fully masked query rows give O = 0 and LSE = -1e30 (reference
``:99-106``); the kernels and the plain version zero P on masked keys, which
leaves every row with at least one visible key bit-for-bit the same math as
the reference. On the card the kernels feed P and dS to the tensor cores as
bf16 (f32 accumulation), where the reference's backward multiplies them in
f32: agreement with the plain version is bf16-level, not f32-level.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from veomni_tpu_torch.observability import cost
from veomni_tpu_torch.ops.attention import _attention_xla
from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 72, 80, 128, 256)  # the head dims the kernels are built for
BLOCK = 128      # the reference's block size: S must be a multiple of it
# tokens per segment-range block; the .cu's RB, checked when the library loads
SEG_RANGE_BLOCK = 32
_NEG = -1e30

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
# the same launches split by the head dim they ran at
LAUNCHES_BY_HEAD_DIM = {d: dict.fromkeys(LAUNCHES, 0) for d in HEAD_DIMS}
FALLBACK_CALLS = 0
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global FALLBACK_CALLS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for counts in LAUNCHES_BY_HEAD_DIM.values():
            counts[name] = 0
    FALLBACK_CALLS = 0


# --------------------------------------------------------------------------
# Plain versions (the CPU path and the on-card reference for the kernels)
# --------------------------------------------------------------------------
def _scores(q, k, seg, scale, causal):
    """f32 scores [B,Hkv,G,Sq,Sk] and visibility mask [B,1,1,Sq,Sk]."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = (seg[:, :, None] == seg[:, None, :])[:, None, None]
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = mask & (pos[:, None] >= pos[None, :])
    return sc, mask


def flash_fwd_plain(q, k, v, seg, scale: float, causal: bool):
    """(O [B,S,Hq,D] in q's dtype, LSE [B,Hq,S] f32), as K1 computes them."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    sc, mask = _scores(q, k, seg, scale, causal)
    sc = torch.where(mask, sc, torch.full_like(sc, _NEG))
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(-1)  # [B,Hkv,G,S]
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    l_bq = l.permute(0, 3, 1, 2)[..., None]  # [B,S,Hkv,G,1]
    out = torch.where(l_bq == 0, torch.zeros_like(acc), acc / l_bq)
    lse = torch.where(l == 0, torch.full_like(l, _NEG), m[..., 0] + torch.log(l))
    return out.reshape(b, s, hq, d).to(q.dtype), lse.reshape(b, hq, s)


def flash_bwd_plain(q, k, v, seg, dout, lse, delta, scale: float, causal: bool):
    """(dQ, dK, dV) in the input dtypes, as K2 and K3 compute them: P is
    recomputed from the LSE (masked rows use LSE 0, reference ``:188``) and
    ``delta = rowsum(dO * O)`` [B,Hq,S] comes from the caller."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    sc, mask = _scores(q, k, seg, scale, causal)
    lse_safe = torch.where(lse <= _NEG / 2, torch.zeros_like(lse), lse)
    lse_safe = lse_safe.reshape(b, hkv, g, s)[..., None]
    p = torch.where(mask, torch.exp(sc - lse_safe), torch.zeros_like(sc))
    do = dout.float().reshape(b, s, hkv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - delta.reshape(b, hkv, g, s)[..., None]) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(b, s, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(b, s, hkv, g, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    from veomni_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_vt_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vt_flash_fwd.argtypes = [ptr] * 7 + [i32] * 5 + [f32, i32, ptr]
        lib.vt_flash_bwd_dkv.argtypes = [ptr] * 11 + [i32] * 6 + [f32, i32, ptr]
        lib.vt_flash_bwd_dq.argtypes = [ptr] * 9 + [i32] * 5 + [f32, i32, ptr]
        for fn in (lib.vt_flash_fwd, lib.vt_flash_bwd_dkv, lib.vt_flash_bwd_dq,
                   lib.vt_seg_range_block):
            fn.restype = ctypes.c_int
        lib.vt_seg_range_block.argtypes = []
        if lib.vt_seg_range_block() != SEG_RANGE_BLOCK:
            raise RuntimeError(f"{SOURCE} reads {lib.vt_seg_range_block()}-token segment "
                               f"ranges, the wrapper builds {SEG_RANGE_BLOCK}-token ones")
        lib._vt_typed = True
    return lib


# what a caller whose shapes or dtypes the kernels do not take sets instead
PLAIN_PIN = "ops_config: {attention: xla} (the plain attention)"


def _check(q, k, v, seg, *extra):
    """Raise on anything the kernels do not take."""
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"flash kernels: q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} mismatch")
    if d not in HEAD_DIMS or s % BLOCK or hq % k.shape[2]:
        raise ValueError(f"flash kernels take D in {HEAD_DIMS}, S % {BLOCK} == 0, Hq % Hkv == 0; "
                         f"got {tuple(q.shape)}, Hkv={k.shape[2]}; for other shapes set {PLAIN_PIN}")
    for t in (q, k, v, *extra):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernels take bfloat16, got {t.dtype}; for other dtypes set "
                            f"{PLAIN_PIN}")
    if seg.dtype != torch.int32 or tuple(seg.shape) != (b, s):
        raise TypeError(f"segment ids must be int32 [B,S], got {seg.dtype} {tuple(seg.shape)}")
    for t in (q, k, v, seg, *extra):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash kernels: all tensors must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous [B,S,H,D] tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels take 16-byte aligned tensors (TMA and bulk copies)")


# K2's work items: DKV_KEYS keys of one kv head; at least SPLIT_ITEMS_PER_SM
# items per SM before the q-head group is split across items. Qwen3-30B-A3B
# at micro-batch 1 and seq 4096 (configs/text/qwen3_moe_ep.yaml) gives 128
# items for 132 SMs and splits 4 ways; micro-batch 4 (512 items) and
# Qwen3-0.6B at micro-batch 4 (1024) do not split. At D = 256 K2 computes dK
# and dV in two 128-column halves, each in work items of its own.
DKV_KEYS = 128
SPLIT_ITEMS_PER_SM = 2


def dkv_halves(d: int) -> int:
    """Work items per key tile and q heads in K2: 2 at D = 256, else 1."""
    return 2 if d == 256 else 1


def dkv_group_split(b: int, s: int, hq: int, hkv: int, n_sm: int, d: int = 128) -> int:
    """How many work items share one kv head's q-head group in K2: the
    smallest divisor ``split`` of the group (Hq / Hkv) that gives at least
    SPLIT_ITEMS_PER_SM items per SM, the whole group if none does. With
    ``split`` > 1 each item sums its Hq / Hkv / split heads into an f32
    workspace ``[2, split, B, S, Hkv, D]`` (dkv_workspace_shape) that K2 then
    sums in a fixed order."""
    group = hq // hkv
    items = b * hkv * (s // DKV_KEYS) * dkv_halves(d)
    for split in range(1, group + 1):
        if group % split == 0 and items * split >= SPLIT_ITEMS_PER_SM * n_sm:
            return split
    return group


def dkv_workspace_shape(b: int, s: int, hkv: int, split: int, d: int = 128):
    """f32 workspace of K2 at ``split`` (None: no workspace): dK's partials,
    then dV's."""
    return None if split == 1 else (2, split, b, s, hkv, d)


def seg_ranges(seg):
    """[B, S/SEG_RANGE_BLOCK, 2] int32: min and max segment id of each block
    of tokens, so the kernels can skip tile pairs whose segments cannot meet.
    One call serves K1, K2 and K3 of the same segment ids."""
    b, s = seg.shape
    blk = seg.view(b, s // SEG_RANGE_BLOCK, SEG_RANGE_BLOCK)
    return torch.stack([blk.amin(-1), blk.amax(-1)], dim=-1).contiguous()


def _check_ranges(seg, seg_rng):
    want = (seg.shape[0], seg.shape[1] // SEG_RANGE_BLOCK, 2)
    if (seg_rng.dtype != torch.int32 or tuple(seg_rng.shape) != want
            or not seg_rng.is_contiguous() or seg_rng.device != seg.device):
        raise ValueError(f"seg_rng must be contiguous int32 {want} on the segment ids' device "
                         f"(see seg_ranges), got {seg_rng.dtype} {tuple(seg_rng.shape)}")


def _check_rows(q, lse, delta):
    b, s, hq, _ = q.shape
    for t in (lse, delta):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, hq, s) or not t.is_contiguous():
            raise ValueError(f"lse/delta must be contiguous f32 [B,Hq,S], got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("lse/delta must be on q's device")
        if t.data_ptr() % 16:
            raise ValueError("lse/delta must be 16-byte aligned (K2 reads them by bulk copies)")


def _launch(name: str, tensors, q, k, scale: float, causal: bool, ints=()) -> None:
    """Launch ``vt_<name>`` on the current stream, raise on a CUDA error,
    count the launch. ``tensors`` may hold None (a null pointer); ``ints``
    go before the shape."""
    b, s, hq, d = q.shape
    err = getattr(_lib(), "vt_" + name)(
        *(0 if t is None else t.data_ptr() for t in tensors), *ints, b, s, hq, k.shape[2], d,
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _COUNT_LOCK:  # serving replicas launch from threads of their own
        LAUNCHES[name] += 1
        LAUNCHES_BY_HEAD_DIM[d][name] += 1
    cost.note_kernel(lambda: flash_work(name, q, k, tensors[3], causal))


def visible_pairs(seg: torch.Tensor, causal: bool = True) -> int:
    """Same-segment (query, key) pairs of a [B, S] segment-id batch, causal
    (each id's c tokens give c (c + 1) / 2) or all (c²): the work this data
    needs."""
    total = 0
    for row in seg:
        c = torch.unique(row, return_counts=True)[1].double()
        total += int((c * (c + 1) / 2 if causal else c * c).sum())
    return total


def flash_work(name: str, q, k, seg, causal: bool):
    """(FLOPs, bytes) of one K1/K2/K3 launch, the formulas of the Bound
    column of PERF.md's kernel table: 2 D-wide products per visible pair
    and q head forward, 4 for dK/dV (S recomputed, dP, dV, dK), 3 for dQ;
    each input read once and each output written once."""
    b, s, hq, d = q.shape
    pairs = visible_pairs(seg, causal)
    nq, nkv = b * s * hq * d * 2, b * s * k.shape[2] * d * 2  # bf16
    rows, segb = b * hq * s * 4, b * s * 4  # f32 LSE / delta rows, i32 ids
    if name == "flash_fwd":
        return 4 * d * hq * pairs, nq + 2 * nkv + segb + nq + rows
    if name == "flash_bwd_dkv":
        return 8 * d * hq * pairs, 2 * nq + 2 * nkv + segb + 2 * rows + 2 * nkv
    return 6 * d * hq * pairs, 2 * nq + 2 * nkv + segb + 2 * rows + nq


# ``seg_rng`` is ``seg_ranges(seg)``, computed once for the kernels of one
# attention call.
def flash_fwd_cuda(q, k, v, seg, scale: float, causal: bool, seg_rng):
    """K1: (O [B,S,Hq,D] bf16, LSE [B,Hq,S] f32)."""
    _check(q, k, v, seg)
    _check_ranges(seg, seg_rng)
    b, s, hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, seg, seg_rng, out, lse), q, k, scale, causal)
    return out, lse


def flash_bwd_dkv_cuda(q, k, v, seg, dout, lse, delta, scale: float, causal: bool,
                       seg_rng):
    """K2: (dK, dV) [B,S,Hkv,D] bf16, summed over each kv head's q-head group."""
    _check(q, k, v, seg, dout)
    _check_rows(q, lse, delta)
    _check_ranges(seg, seg_rng)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    split = dkv_group_split(b, s, hq, hkv, n_sm, d)
    shape = dkv_workspace_shape(b, s, hkv, split, d)
    ws = None if shape is None else torch.empty(shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", (q, k, v, seg, seg_rng, dout, lse, delta, dk, dv, ws),
            q, k, scale, causal, ints=(split,))
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, seg, dout, lse, delta, scale: float, causal: bool,
                      seg_rng):
    """K3: dQ [B,S,Hq,D] bf16."""
    _check(q, k, v, seg, dout)
    _check_rows(q, lse, delta)
    _check_ranges(seg, seg_rng)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q, k, v, seg, seg_rng, dout, lse, delta, dq),
            q, k, scale, causal)
    return dq


def flash_fwd(q, k, v, seg, scale: float, causal: bool, seg_rng):
    """K1 on CUDA tensors, its plain version on CPU tensors (which need no
    ``seg_rng``)."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, seg, scale, causal, seg_rng)
    return flash_fwd_plain(q, k, v, seg, scale, causal)


def flash_bwd(q, k, v, seg, dout, lse, delta, scale: float, causal: bool, seg_rng):
    """K2 then K3 on CUDA tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        dk, dv = flash_bwd_dkv_cuda(q, k, v, seg, dout, lse, delta, scale, causal, seg_rng)
        dq = flash_bwd_dq_cuda(q, k, v, seg, dout, lse, delta, scale, causal, seg_rng)
        return dq, dk, dv
    return flash_bwd_plain(q, k, v, seg, dout, lse, delta, scale, causal)


class _FlashAttention(torch.autograd.Function):
    """Forward K1; backward K2 then K3 (the reference's ``custom_vjp``,
    ``:324-339``). Saves q, k, v, O, the LSE and the segment ranges, so
    backward never reruns the forward kernel nor recomputes the ranges."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal):
        seg_rng = seg_ranges(seg) if q.is_cuda else None
        out, lse = flash_fwd(q, k, v, seg, scale, causal, seg_rng)
        ctx.save_for_backward(q, k, v, seg, out, lse, seg_rng)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse, seg_rng = ctx.saved_tensors
        dout = dout.contiguous()
        # delta = rowsum(dO * O) in plain torch, as the reference does in XLA (:263)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, seg, dout, lse, delta, ctx.scale, ctx.causal, seg_rng)
        return dq, dk, dv, None, None, None


@KERNEL_REGISTRY.register(
    "attention", "cuda_flash", device_types=("cuda",), priority=10, min_sm=(9, 0)
)
def flash_attention(
    q,
    k,
    v,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    sliding_window=None,
    sinks: Optional[torch.Tensor] = None,
):
    """[B, S, H, D] facade-layout flash attention (reference ``:348-388``)."""
    global FALLBACK_CALLS
    b, s, hq, d = q.shape
    if (
        sliding_window is not None
        or sinks is not None
        or v.shape[-1] != d
        or s % BLOCK  # the reference's lane-aligned block tiling (also S < 128)
        or hq % k.shape[2]
    ):
        with _COUNT_LOCK:
            FALLBACK_CALLS += 1
        return _attention_xla(
            q, k, v, segment_ids=segment_ids, causal=causal,
            softmax_scale=softmax_scale, sliding_window=sliding_window, sinks=sinks,
        )
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if segment_ids is None:
        segment_ids = torch.zeros((b, s), dtype=torch.int32, device=q.device)
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        segment_ids.to(torch.int32).contiguous(), scale, causal,
    )

"""The port's CUDA kernels against their plain versions, on the card:
flash attention (K1-K3, at head dims 64, 72, 80, 128 and 256), grouped GEMM (K4-K6,
at K and N multiples of the tiles and of 8 only) and the probe (K7).

Every test here needs an NVIDIA Hopper GPU and skips without one: a CUDA
kernel has no CPU mode. This file imports no JAX, so it runs where the port
runs; on a machine with a card (the repo's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances, element by element (bf16 kernels vs the f32 plain math; P and
dS enter the tensor cores as bf16, outputs are stored as bf16):
``|got - ref| <= 2e-2 * rms(ref row) + 1e-4 * max|ref| + 1.6e-2 * |ref|``
with a row one token's head vector, the rule of ``chip_smoke.py``; the LSE
within 1e-4. Grouped GEMM (bf16 products accumulated in f32 and rounded once
to bf16 on both sides, so an output may land on the neighbouring bf16
value): ``|got - ref| <= 1e-4 * max|ref| + 2^-7 * |ref|``. The probe: exact.
"""

import numpy as np
import pytest
import torch

from veomni_tpu_torch.ops.cuda import flash_attention as fa
from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
from veomni_tpu_torch.ops.cuda import probe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, b=2, s=256, hq=4, hkv=2, d=128, packed=True, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(device, torch.bfloat16)
                   for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    seg = np.ones((b, s), np.int32)
    if packed:
        seg[:, s // 3:] = 2
        seg[:, 2 * s // 3:] = 3
        seg[:, -7:] = 0  # trailing padding segment
    return q, k, v, do, torch.from_numpy(seg).to(device)


RTOL, ATOL_ROW, ATOL_MAX, TOL_LSE = 1.6e-2, 2e-2, 1e-4, 1e-4


def _close(got, ref, atol=None, rtol=RTOL):
    ref = ref.float()
    if atol is None:
        atol = ATOL_ROW * ref.pow(2).mean(-1, keepdim=True).sqrt() + ATOL_MAX * ref.abs().max()
    err = (got.float() - ref).abs()
    n_over = int((~(err <= atol + rtol * ref.abs())).sum())  # NaN counts as over
    assert n_over == 0, f"{n_over} elements over the tolerance, max abs err {err.max().item()}"


@pytest.mark.parametrize("heads", [(4, 2), (32, 4)], ids=["gqa2", "gqa8"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernels_match_plain_on_card(cuda_device, packed, causal, heads):
    """gqa8 is the Qwen3-30B-A3B head layout: K2 sums a group of 8 q heads
    (split across work items at B = 2, S = 256)."""
    q, k, v, do, seg = _inputs(cuda_device, hq=heads[0], hkv=heads[1], packed=packed)
    scale = q.shape[-1] ** -0.5
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=causal)
    out.backward(do)
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, scale, causal, fa.seg_ranges(seg))
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, scale, causal)
    _close(out, o_p)
    _close(o_k, o_p)
    _close(lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
    delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
    for got, ref in zip((qg.grad, kg.grad, vg.grad),
                        fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale, causal)):
        _close(got, ref)


@pytest.mark.parametrize("split", ["wrapper", 2], ids=["wrapper-split", "split2"])
@pytest.mark.parametrize("heads", [(4, 2), (32, 4)], ids=["gqa2", "gqa8"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 72, 80, 256], ids=["d64", "d72", "d80", "d256"])
def test_kernels_match_plain_on_card_at_head_dims(cuda_device, monkeypatch, d, causal, heads,
                                                  split):
    """K1-K3 at head dims 64 (TinyLlama), 72 and 80 (the Qwen3-VL and the
    Qwen2-VL / Qwen2.5-VL vision towers: D = 128's tiles over 3-D maps that
    read zeros past the head's columns; split 2 writes the f32 workspace at
    72 or 80 columns) and
    256 (Gemma-7B; K1 on 64-key tiles, K2 in two 128-column halves, 1-stage
    rings) on packed segments,
    with the wrapper's group split and with the group split in two; K2 and
    K3 launched twice give bit-identical dQ, dK and dV."""
    if split != "wrapper":
        monkeypatch.setattr(fa, "dkv_group_split", lambda *a, **k: split)
    q, k, v, do, seg = _inputs(cuda_device, hq=heads[0], hkv=heads[1], d=d, seed=d)
    scale = d ** -0.5
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=causal)
    out.backward(do)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, scale, causal)
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, scale, causal, fa.seg_ranges(seg))
    _close(out, o_p)
    _close(lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
    delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
    refs = fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale, causal)
    for got, ref in zip((qg.grad, kg.grad, vg.grad), refs):
        _close(got, ref)
    runs = [fa.flash_bwd(q, k, v, seg, do, lse_k, delta, scale, causal, fa.seg_ranges(seg))
            for _ in range(2)]
    for got, again in zip(*runs):
        assert torch.equal(got, again)


def _edge_segments(layout):
    """[1, S] segment ids of one K1 edge case (K1's tiles are 128 rows)."""
    if layout == "one-tile":  # S = 128: the diagonal tile is the only tile
        return np.ones((1, 128), np.int32)
    if layout == "one-segment":
        return np.ones((1, 512), np.int32)
    if layout == "short-segments":  # many boundaries inside each 128-row tile
        lengths = np.resize([5, 17, 40, 3, 60, 1, 33, 96], 64)
        return np.repeat(np.arange(1, 65, dtype=np.int32), lengths)[None, :512]
    if layout == "tile-edge":  # boundaries exactly on tile edges
        seg = np.ones((1, 512), np.int32)
        seg[:, 128:384] = 2
        seg[:, 384:] = 3
        return seg
    if layout == "three-k-tiles":  # S = 384: an odd number of 128-key tiles
        seg = np.ones((1, 384), np.int32)
        seg[:, 200:] = 2
        return seg
    raise ValueError(layout)


@pytest.mark.parametrize("heads", [(4, 2), (32, 4)], ids=["gqa2", "gqa8"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["one-tile", "one-segment", "short-segments", "tile-edge",
                                    "three-k-tiles"])
def test_flash_fwd_edge_cases_on_card(cuda_device, layout, causal, heads):
    """K1 decides per k tile whether it needs the per-element mask (the causal
    diagonal, more than one segment) and skips disjoint tiles: each layout
    here puts a segment boundary somewhere else relative to its tiles."""
    seg = torch.from_numpy(_edge_segments(layout)).to(cuda_device)
    rng = np.random.default_rng(3)
    s = seg.shape[1]
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, h, 128)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for h in (heads[0], heads[1], heads[1]))
    scale = 128 ** -0.5
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, scale, causal, fa.seg_ranges(seg))
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, scale, causal)
    _close(o_k, o_p)
    _close(lse_k, lse_p, atol=TOL_LSE, rtol=0.0)


@pytest.mark.parametrize("heads", [(4, 2), (32, 4)], ids=["gqa2", "gqa8"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["one-tile", "one-segment", "short-segments", "tile-edge",
                                    "three-k-tiles"])
def test_flash_bwd_edge_cases_on_card(cuda_device, layout, causal, heads):
    """K2 and K3 where their per-tile decisions can break; at B = 1 K2 splits
    the q-head group (2 and 8 ways). Two launches on the same inputs give
    bit-identical dQ, dK and dV."""
    seg = torch.from_numpy(_edge_segments(layout)).to(cuda_device)
    rng = np.random.default_rng(4)
    s = seg.shape[1]
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, h, 128)).astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for h in (heads[0], heads[1], heads[1], heads[0]))
    scale = 128 ** -0.5
    seg_rng = fa.seg_ranges(seg)
    o, lse = fa.flash_fwd_cuda(q, k, v, seg, scale, causal, seg_rng)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [fa.flash_bwd(q, k, v, seg, do, lse, delta, scale, causal, seg_rng) for _ in range(2)]
    for got, again, ref in zip(*runs, fa.flash_bwd_plain(q, k, v, seg, do, lse, delta, scale, causal)):
        _close(got, ref)
        assert torch.equal(got, again)


@pytest.mark.parametrize("split", [1, 2, 4, 8], ids=["whole-group", "split2", "split4",
                                                  "split8"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_bwd_every_group_split_on_card(cuda_device, monkeypatch, causal, split):
    """K2 at the Qwen3-30B-A3B head layout (a group of 8 q heads) with every
    split of the group over work items: split 1 walks all 8 heads in one item
    and stores dK/dV by TMA, as the MoE main path's micro-batch 4 does; the
    others sum f32 partials in a fixed order. Each matches the plain version
    and gives bit-identical dK and dV over two launches."""
    monkeypatch.setattr(fa, "dkv_group_split", lambda *shape: split)
    q, k, v, do, seg = _inputs(cuda_device, hq=32, hkv=4)
    scale = q.shape[-1] ** -0.5
    seg_rng = fa.seg_ranges(seg)
    o, lse = fa.flash_fwd_cuda(q, k, v, seg, scale, causal, seg_rng)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse, delta, scale, causal, seg_rng)
            for _ in range(2)]
    _, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, seg, do, lse, delta, scale, causal)
    for got, again, ref in zip(*runs, (dk_p, dv_p)):
        _close(got, ref)
        assert torch.equal(got, again)


def test_cuda_tensors_never_reach_the_plain_path(cuda_device, monkeypatch):
    """On CUDA tensors the wrapper launches K1-K3 or raises; it never takes
    the plain version."""

    def forbidden(*a, **k):
        raise AssertionError("plain path reached with CUDA tensors")

    monkeypatch.setattr(fa, "flash_fwd_plain", forbidden)
    monkeypatch.setattr(fa, "flash_bwd_plain", forbidden)
    q, k, v, do, seg = _inputs(cuda_device)
    qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
    fa.reset_counts()
    fa.flash_attention(qg, kg, vg, segment_ids=seg).backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    with pytest.raises(TypeError):  # f32 is not a kernel input: raise, never fall back
        fa.flash_attention(q.detach().float(), k.detach().float(), v.detach().float())


_EDGE_128 = [0] * 128  # 128 experts, most empty; a boundary on the tile edge at row 128
_EDGE_128[5], _EDGE_128[64], _EDGE_128[127] = 128, 200, 156
# group sizes and the row count M (None: as many as the groups hold)
GMM_CASES = {"even": ([128, 128, 128, 128], None), "ragged-empty": ([100, 156, 0, 256], None),
             "single": ([0, 512, 0, 0], None), "mid-tile": ([37, 0, 219, 64, 192], None),
             "unaligned-m": ([37, 0, 219, 64, 100], None),  # M = 420: the last row tile is masked
             "m-below-tile": ([20, 0, 45], None),  # M = 65: one partial tile
             "past-groups": ([100, 0, 200, 0], 512),  # rows 300.. belong to no expert
             "e128-tile-edge": (_EDGE_128, None),
             # K6 reads 64-row chunks: experts that end exactly on a chunk edge
             # (64, 192), one shorter than a chunk (40) and one mid-chunk (100)
             "chunk-edges": ([64, 128, 0, 40, 192, 100], None)}


def _gmm_close(got, ref):
    ref = ref.float()
    err = (got.float() - ref).abs()
    allowed = 1e-4 * ref.abs().max() + 2.0 ** -7 * ref.abs()
    n_over = int((~(err <= allowed)).sum())  # NaN counts as over
    assert n_over == 0, f"{n_over} elements over the tolerance, max abs err {err.max().item()}"


@pytest.mark.parametrize("case", list(GMM_CASES.values()), ids=list(GMM_CASES))
def test_gmm_kernels_match_plain_on_card(cuda_device, case):
    """K4 and K5 write 128-column tiles at 384 columns and 256-column ones at
    256, K6 128-column ones at N = 384; rows past the groups come out exactly
    0 from K4 and K5, and the drhs of an empty expert exactly 0 from K6
    (which writes it: the output is not zeroed beforehand)."""
    sizes, rows = case
    rng = np.random.default_rng(1)
    owned, k, n, e = sum(sizes), 256, 384, len(sizes)
    m = rows or owned
    lhs, rhs, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for shape in ((m, k), (e, k, n), (m, n)))
    group_sizes = torch.tensor(sizes, device=cuda_device)
    starts = gg.group_starts(group_sizes)
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    gg.reset_counts()
    gg.cuda_group_gemm(a, b, group_sizes).backward(g)
    torch.cuda.synchronize()
    assert gg.LAUNCHES == {"gmm_fwd": 1, "gmm_dlhs": 1, "gmm_t": 1}
    out = gg.gmm_cuda(lhs, rhs, starts)
    _gmm_close(out, gg.gmm_plain(lhs, rhs, starts))
    _gmm_close(a.grad, gg.gmm_dlhs_plain(g, rhs, starts))
    _gmm_close(b.grad, gg.gmm_t_plain(lhs, g, starts, e))
    assert not out[owned:].any() and not a.grad[owned:].any()
    empty = torch.tensor(sizes) == 0
    assert not b.grad[empty.to(cuda_device)].any()
    assert not gg.gmm_t_cuda(lhs, g, starts, e)[empty.to(cuda_device)].any()


@pytest.mark.parametrize("kn", [(2048, 776), (776, 2048), (2048, 64), (64, 2048), (136, 200)],
                         ids=["k2048-n776", "k776-n2048", "k2048-n64", "k64-n2048", "k136-n200"])
@pytest.mark.parametrize("case", ["ragged-empty", "past-groups"])
def test_gmm_kernels_match_plain_at_unaligned_widths(cuda_device, case, kn):
    """K and N multiples of 8 but not of the tiles: TMA reads zeros past
    each edge and stores nothing past it; K4's contraction tail reads the
    expert's own rows (its 3-D map of rhs) and K6's K tail writes into the
    expert's own drhs (its 3-D map of drhs). Rows past the groups and the
    drhs of an empty expert are exactly 0."""
    sizes, rows = GMM_CASES[case]
    k, n = kn
    rng = np.random.default_rng(2)
    owned, e = sum(sizes), len(sizes)
    m = rows or owned
    lhs, rhs, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for shape in ((m, k), (e, k, n), (m, n)))
    group_sizes = torch.tensor(sizes, device=cuda_device)
    starts = gg.group_starts(group_sizes)
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = gg.cuda_group_gemm(a, b, group_sizes)
    out.backward(g)
    torch.cuda.synchronize()
    _gmm_close(out, gg.gmm_plain(lhs, rhs, starts))
    _gmm_close(a.grad, gg.gmm_dlhs_plain(g, rhs, starts))
    _gmm_close(b.grad, gg.gmm_t_plain(lhs, g, starts, e))
    assert not out[owned:].any() and not a.grad[owned:].any()
    assert not b.grad[torch.tensor(sizes, device=cuda_device) == 0].any()


def test_gmm_cuda_tensors_never_reach_the_plain_path(cuda_device, monkeypatch):
    """On CUDA tensors the grouped-GEMM wrappers launch K4-K6 or raise."""

    def forbidden(*a, **k):
        raise AssertionError("plain path reached with CUDA tensors")

    for name in ("gmm_plain", "gmm_dlhs_plain", "gmm_t_plain"):
        monkeypatch.setattr(gg, name, forbidden)
    lhs = torch.randn(256, 128, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    rhs = torch.randn(2, 128, 128, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    gg.cuda_group_gemm(lhs, rhs, torch.tensor([100, 156], device=cuda_device)).sum().backward()
    torch.cuda.synchronize()
    with pytest.raises(TypeError):  # f32 is not a kernel input: raise, never fall back
        gg.gmm_cuda(lhs.detach().float(), rhs.detach().float(),
                    gg.group_starts(torch.tensor([100, 156], device=cuda_device)))
    with pytest.raises(ValueError):  # K = 90: not a multiple of 8, raise, never fall back
        gg.cuda_group_gemm(lhs.detach()[:, :90].contiguous(), rhs.detach()[:, :90].contiguous(),
                           torch.tensor([100, 156], device=cuda_device))


def test_probe_kernel_on_card(cuda_device):
    x = torch.randn(8, 128, device=cuda_device)
    probe.reset_counts()
    assert torch.equal(probe.probe_double(x), x * 2.0)
    assert probe.LAUNCHES == {"probe_double": 1}

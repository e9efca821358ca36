"""On-card smoke test of the PyTorch/H100 port (``veomni_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``veomni_tpu_torch/csrc`` with ``nvcc`` and
   print the card, its power limit and the torch/CUDA versions;
2. hold each kernel against its plain PyTorch version on the same inputs,
   in bf16, at the main path's attention shape (B=4, S=4096, Hq=16, Hkv=8,
   D=128, packed segments); time kernel, plain version and the library
   yardstick; compute each kernel's bound from this run's inputs;
3. drive the main path: Qwen3-0.6B (full width, 28 layers, f32 master
   weights, bf16 compute, ``ctx`` remat, AdamW) for 3 SFT train steps on
   packed seq-4096 batches of micro-batch 4, with every kernel launch
   counter set to 0 just before and read just after;
4. parity: at depth 2, full width, S=1024, one train step with the kernels
   against the same step with the plain attention pinned (loss, grad norm),
   and the q/k/v/o projection gradients of one backward, leaf by leaf.

The last three lines are the kernel table as JSON, the card's name and power
limit as ``nvidia-smi`` gives them, and the device record
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

# Kernel vs plain version, held element by element:
#   |got - ref| <= ATOL_ROW * rms(ref row) + ATOL_MAX * max|ref| + RTOL * |ref|,
# where a row is one token's head vector (D values). The kernels feed P and dS
# to the tensor cores as bf16 (2^-9 relative each) where the plain version
# keeps f32, and both store O/dQ/dK/dV as bf16, so an output may land on the
# neighbouring bf16 value (up to 2^-7 relative): RTOL is two bf16 epsilons.
# An output near zero is a sum of larger terms and keeps their rounding, which
# scales with the row's magnitude (not the tensor's, which the first tokens of
# each document dominate): ATOL_ROW is 2% of the row's RMS. A row whose exact
# value is zero (a document's first token sees one key, so its dQ is 0) holds
# only the f32 rounding of dP - delta: ATOL_MAX, 1e-4 of the tensor's largest
# magnitude, covers it. One 64x64 (query, key) tile pair skipped in one head
# of a long document breaks the rule several times over. The LSE is f32 end
# to end.
RTOL = 1.6e-2
ATOL_ROW = 2e-2
ATOL_MAX = 1e-4
TOL_LSE = 1e-4
# One train step, kernels vs plain attention: loss and grad norm (measured
# 1.4e-6 and 2.7e-5 on an H100). Then each q/k/v/o projection gradient after
# one backward, as |g_kernels - g_plain| / |g_plain| (measured 1.0e-2 to
# 1.9e-2 on an H100): with bf16 activations any difference in the attention
# output flips bf16 roundings downstream, and the plain path rounds dP to
# bf16 before it subtracts delta, so this holds the pair at bf16 resolution.
# It catches a wrong mask, scale or head mapping (errors of order 1); the
# kernel phase's elementwise rule catches the small ones.
TOL_LOSS_REL = 1e-4
TOL_GRAD_NORM_REL = 1e-3
TOL_LEAF_REL = 5e-2
LAYERS = 28
MAIN_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_build(sources):
    from veomni_tpu_torch.ops.cuda import build

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        paths = list(pool.map(build.build, sources))
    for p in paths:
        log(f"built {p}")


def visible_pairs(seg: torch.Tensor) -> int:
    """Causal same-segment (query, key) pairs: the work this data needs."""
    total = 0
    for row in seg.cpu().tolist():
        counts = {}
        for s_id in row:
            counts[s_id] = counts.get(s_id, 0) + 1
            total += counts[s_id]
    return total


def kept_tiles(seg: torch.Tensor, bq: int, bk: int) -> float:
    """Share of the causal (q tile, k tile) pairs whose segment-id ranges
    overlap, i.e. that the kernels' segment skip still computes."""
    kept = total = 0
    for row in seg.cpu():
        q_lo, q_hi = row.view(-1, bq).amin(1)[:, None], row.view(-1, bq).amax(1)[:, None]
        k_lo, k_hi = row.view(-1, bk).amin(1)[None, :], row.view(-1, bk).amax(1)[None, :]
        causal = (torch.arange(k_lo.shape[1])[None, :] * bk
                  <= torch.arange(q_lo.shape[0])[:, None] * bq + bq - 1)
        overlap = ~((q_hi < k_lo) | (k_hi < q_lo))
        kept += int((causal & overlap).sum())
        total += int(causal.sum())
    return kept / total


def bound_ms(dev, flops: float, nbytes: float):
    """Least time for the work at the card's data-sheet peaks (bf16 tensor
    cores, device memory), and which of the two bounds it."""
    from veomni_tpu_torch.utils.device import get_device_peak_bandwidth, get_device_peak_flops

    t_ops = flops / get_device_peak_flops(dev)
    t_bytes = nbytes / get_device_peak_bandwidth(dev)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, atol=None, rtol=RTOL) -> float:
    """Hold ``got`` to ``ref`` element by element (``atol`` defaults to
    ATOL_ROW of each row's RMS plus ATOL_MAX of the largest |ref|); log the
    worst error/allowed ratio and return the largest absolute error."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if atol is None:
        atol_txt = f"{ATOL_ROW:g}*rms(row) + {ATOL_MAX:g}*max|ref|"
        atol = (ATOL_ROW * ref.pow(2).mean(-1, keepdim=True).sqrt()
                + ATOL_MAX * ref.abs().max())
    else:
        atol_txt = f"{atol:g}"
    allowed = atol + rtol * ref.abs()
    ratio = (err / allowed.clamp_min(1e-30)).max().item()  # 0 where both are 0
    n_over = int((~(err <= allowed)).sum())  # NaN counts as over
    max_err = err.max().item()
    log(f"  {name}: max_abs_err={max_err:.3e} (ref max {ref.abs().max().item():.3e}); "
        f"worst |err| / ({atol_txt} + {rtol:g}*|ref|) = {ratio:.3f}, {n_over} elements over")
    if not math.isfinite(ratio) or ratio > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({n_over} elements over the tolerance, worst ratio {ratio})")
    return max_err


def phase_kernels(dev, seg):
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    b, s = seg.shape
    hq, hkv, d = 16, 8, 128
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(b, s, hq, d, device=dev, generator=g).bfloat16()
    k = torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
    v = torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
    do = torch.randn(b, s, hq, d, device=dev, generator=g).bfloat16()
    pairs = visible_pairs(seg)
    log(f"kernel phase: B={b} S={s} Hq={hq} Hkv={hkv} D={d}, "
        f"{int(seg.max())} segments max/row, visible causal pairs {pairs} "
        f"({pairs / (b * s * (s + 1) / 2):.3f} of causal); causal tile pairs kept by the "
        f"segment skip: {kept_tiles(seg, 64, 64):.3f} (K1, K3), {kept_tiles(seg, 32, 64):.3f} (K2)")

    # K1 through the autograd Function, then K2 + K3 from its backward
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=True, softmax_scale=scale)
    out.backward(do)
    rng = fa.seg_ranges(seg)  # once per attention call on the main path: outside the timings
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, scale, True, rng)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, scale, True)
    err_o = check_close("K1 O (autograd path)", out, o_p)
    check_close("K1 O (wrapper)", o_k, o_p)
    err_lse = check_close("K1 LSE", lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
    delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale, True)
    err_dq = check_close("K3 dQ", qg.grad, dq_p)
    err_dk = check_close("K2 dK", kg.grad, dk_p)
    err_dv = check_close("K2 dV", vg.grad, dv_p)
    del o_p, lse_p, dq_p, dk_p, dv_p, qg, kg, vg, out
    torch.cuda.empty_cache()

    ms = {
        "fwd": timed_ms(lambda: fa.flash_fwd_cuda(q, k, v, seg, scale, True, rng)),
        "dkv": timed_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse_k, delta, scale,
                                                      True, rng)),
        "dq": timed_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse_k, delta, scale,
                                                    True, rng)),
    }
    plain_fwd = timed_ms(lambda: fa.flash_fwd_plain(q, k, v, seg, scale, True), reps=3, warmup=1)
    plain_bwd = timed_ms(lambda: fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale, True),
                         reps=3, warmup=1)
    torch.cuda.empty_cache()

    # library yardstick (timed only, never called by the port): SDPA on a
    # single-segment batch of the same shape, forward and backward
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_fwd = timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True, scale=scale))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True, scale=scale)
    dot = do.transpose(1, 2)
    lib_bwd = timed_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))

    bf, f32, i32 = 2, 4, 4
    nq, nkv = b * s * hq * d * bf, b * s * hkv * d * bf
    rows, segb = b * hq * s * f32, b * s * i32
    # operations: 2 products of 2*D FLOPs per visible pair (fwd), 4 (dK/dV:
    # recomputed S, dP, dV, dK), 3 (dQ: S, dP, dQ); bytes: inputs once, outputs once
    fwd_bound = bound_ms(dev, 4 * d * hq * pairs, nq + 2 * nkv + segb + nq + rows)
    dkv_bound = bound_ms(dev, 8 * d * hq * pairs, 2 * nq + 2 * nkv + segb + 2 * rows + 2 * nkv)
    dq_bound = bound_ms(dev, 6 * d * hq * pairs, 2 * nq + 2 * nkv + segb + 2 * rows + nq)
    src = "veomni_tpu_torch/csrc/flash_attention.cu"
    ref = "veomni_tpu/ops/pallas/flash_attention.py"
    table = [
        dict(name="flash_fwd", route="cuda", source=src, replaces=f"{ref}:49",
             max_abs_err=max(err_o, err_lse), ms=ms["fwd"], plain_ms=plain_fwd,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd),
        dict(name="flash_bwd_dkv", route="cuda", source=src, replaces=f"{ref}:155",
             max_abs_err=max(err_dk, err_dv), ms=ms["dkv"], plain_ms=plain_bwd,
             bound_ms=dkv_bound[0], bound_by=dkv_bound[1], library_ms=lib_bwd),
        dict(name="flash_bwd_dq", route="cuda", source=src, replaces=f"{ref}:208",
             max_abs_err=err_dq, ms=ms["dq"], plain_ms=plain_bwd,
             bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=lib_bwd),
    ]
    for row in table:
        log(f"  {row['name']}: {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}, plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms)")
    log("  (plain_ms of K2 and K3 is the plain backward computing dQ, dK, dV together; "
        "library_ms of K2 and K3 is SDPA's backward, also all three)")
    return table


def phase_main(dev, card):
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import run_train_steps

    fa.reset_counts()
    records = run_train_steps(4096, 4, MAIN_STEPS, device=dev)
    launches = dict(fa.LAUNCHES)
    fallbacks = fa.FALLBACK_CALLS
    for i, r in enumerate(records):
        log(f"main step {i}: loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
            f"step_ms={r['step_ms']:.1f} tokens_per_s={r['tokens_per_s']:.1f} "
            f"mfu={r['mfu']:.4f} ntokens={int(r['ntokens'])} [{card}]")
    log(f"main path launches: {launches}, FALLBACK_CALLS={fallbacks} "
        f"(Qwen3-0.6B, {LAYERS} layers, seq 4096, micro-batch 4, ctx remat)")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["step_ok"]):
            raise AssertionError(f"non-finite train step: {r}")
    want = LAYERS * MAIN_STEPS  # one micro-batch per step; ctx never reruns K1
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name}: {n} launches on the main path, expected {want}")
    if fallbacks:
        raise AssertionError(f"FALLBACK_CALLS={fallbacks} on the main path")
    return launches


def attention_grads(dev, impl: str):
    """Gradients of the q/k/v/o projections after one ``loss_fn`` backward
    at depth 2, full width, S=1024, B=4, with the ``attention`` op pinned."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.train_text_step import SEED, bench_config, packed_batches

    cfg = bench_config(num_hidden_layers=2)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = {k: torch.from_numpy(v[0]).to(dev)
             for k, v in next(packed_batches(cfg.vocab_size, 1024, 4)).items()}
    apply_ops_config({"attention": impl})
    try:
        loss, _ = model.loss_fn(batch)
        loss.backward()
    finally:
        apply_ops_config(None)
    return {name: p.grad for name, p in model.named_parameters()
            if name.endswith(("q_proj", "k_proj", "v_proj", "o_proj"))}


def phase_parity(dev):
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import run_train_steps

    kern = run_train_steps(1024, 4, 1, num_layers=2, device=dev)[0]
    torch.cuda.empty_cache()
    plain = run_train_steps(1024, 4, 1, num_layers=2, device=dev, attention_impl="xla")[0]
    d_loss = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    d_gn = abs(kern["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    log(f"parity (2 layers, S=1024, B=4): loss kernels {kern['loss']:.6f} plain {plain['loss']:.6f} "
        f"(rel {d_loss:.2e}, tol {TOL_LOSS_REL}); grad_norm kernels {kern['grad_norm']:.6f} "
        f"plain {plain['grad_norm']:.6f} (rel {d_gn:.2e}, tol {TOL_GRAD_NORM_REL})")
    if not (d_loss <= TOL_LOSS_REL and d_gn <= TOL_GRAD_NORM_REL):
        raise AssertionError("kernel step disagrees with the plain-attention step")
    torch.cuda.empty_cache()

    launched = sum(fa.LAUNCHES.values())
    g_kern = attention_grads(dev, "cuda_flash")
    if sum(fa.LAUNCHES.values()) - launched != 2 * 3:  # 2 layers x (K1, K2, K3)
        raise AssertionError(f"kernel leg of the gradient parity launched {fa.LAUNCHES}")
    g_plain = attention_grads(dev, "xla")
    worst = 0.0
    for name, ref in g_plain.items():
        rel = ((g_kern[name] - ref).norm() / ref.norm()).item()
        log(f"  grad {name}: |kernels - plain| / |plain| = {rel:.2e} (tol {TOL_LEAF_REL})")
        worst = max(worst, rel) if math.isfinite(rel) else math.inf
    if worst > TOL_LEAF_REL:
        raise AssertionError(f"attention projection gradients disagree ({worst} > {TOL_LEAF_REL})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import packed_batches
    from veomni_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    phase_build([fa.SOURCE])

    # the main path's first packed micro-batch: the kernels' real segment layout
    seg = torch.from_numpy(next(packed_batches(151936, 4096, 4))["segment_ids"][0]).to(dev)
    table = phase_kernels(dev, seg)
    torch.cuda.empty_cache()
    launches = phase_main(dev, card)
    torch.cuda.empty_cache()
    phase_parity(dev)

    for row in table:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in table]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

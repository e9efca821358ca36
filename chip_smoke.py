"""On-card smoke test of the PyTorch/H100 port (``veomni_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``veomni_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all at once) and print the card, its power limit and
   the torch/CUDA versions;
2. launch the probe kernel K7 (``y = 2x``) and compare it exactly;
3. hold each flash-attention kernel (K1-K3) against its plain PyTorch
   version on the same inputs, in bf16, at the dense main path's attention
   shape (B=4, S=4096, Hq=16, Hkv=8, D=128, packed segments), at the MoE
   main path's (the same batch at Hq=32, Hkv=4: K2 walks each whole group
   of 8 q heads in one work item) and at the MoE model's micro-batch 1 (the
   first row alone, where K2 splits each group over 4 work items); time
   kernel, plain version and the library yardstick; compute each kernel's
   bound from this run's inputs, and time K1-K3 on a single-segment batch of
   the same shape (the function SDPA computes); then K1-K3 on edge cases:
   S = 128 (one tile), one segment, many short segments (boundaries inside
   the 128-row tiles), boundaries on tile edges, S = 384 (three 128-key
   tiles), causal and full, Hq/Hkv 4/2 and 32/4 (K2 splits the group 2 and
   8 ways), and a key tile whose walk is empty (its dK, dV and dQ must come
   out exactly 0); K2 and K3 are launched twice on the same inputs at every
   layout and in every edge case, and their dQ, dK and dV must be
   bit-identical; then the same at head dim 64 on the HF trainer phase's own
   first packed batch at TinyLlama-1.1B's heads (B=4, S=2048, Hq=32, Hkv=4)
   and on its first row (K2 splits each group 8 ways), and at head dim 256
   at Gemma-7B's heads (B=1, S=4096, Hq=16, Hkv=16);
4. the same for the grouped-GEMM kernels K4-K6 at the MoE main path's
   shapes (M = 131072 routed rows, E = 128, K/N = 2048/768 and 768/2048)
   with the group sizes of its real routing (layer 0 on the first packed
   batch), and on small cases with an empty expert, a single expert,
   boundaries in the middle of a tile, a row count that is not a multiple of
   the 128-row tile, fewer rows than one tile, rows that no expert owns
   (which must come out exactly 0 from K4 and K5; K6 must not count them),
   experts that end on an edge of K6's 64-row chunks, inside one, or hold
   fewer rows than one, empty experts (whose drhs K6 must write as exactly
   0) and 128 experts, most of them empty, with a boundary on a tile edge;
   then K and N multiples of 8 but not of the tiles (small cases at K=136
   N=200 and K=776 N=64, and the MoE routing at (K, N) = (2048, 776),
   (776, 2048) and the reference CLI config's (2048, 64));
5. drive the dense main path: Qwen3-0.6B (full width, 28 layers, f32 master
   weights, bf16 compute, ``ctx`` remat, AdamW) for 3 SFT train steps on
   packed seq-4096 batches of micro-batch 4, with every kernel launch
   counter set to 0 just before and read just after;
6. drive the MoE main path the same way: Qwen3-30B-A3B at full width, depth
   cut to 4 of 48 layers (a layer holds ~623 M parameters, ~10 GB with its
   f32 weight, grad and two AdamW moments), 3 steps, printing the router
   aux loss and the peak device memory;
7. the MoE step at micro-batch 1, the micro-batch of the repo's
   Qwen3-30B-A3B config (``configs/text/qwen3_moe_ep.yaml``), where K2 splits
   each q-head group over 4 work items: legs with the split and without it
   alternate, same seed, same batches, and their losses must agree;
8. drive the trainer (``veomni_tpu_torch.tasks.train_text``, the user's
   entry point) at Qwen3-0.6B's full width and depth on a seeded
   pretokenized corpus written to a temporary directory: leg A, six straight
   steps of ``TextTrainer`` from the parsed YAML; leg B1, three steps and an
   (async) checkpoint; leg B2, a fresh ``main()`` that auto-resumes from it
   and runs to six. B2's losses at steps 4-6 and its final parameters, AdamW
   moments and ``num_updates`` must equal leg A's bit for bit, K1-K3 must
   launch 28 times a step with no plain-path dispatch, and A's step-1 loss
   must equal the one ``train_text_step``'s ``build_train_step`` gives on
   the same initial weights and batch; it prints step ms, tokens/s, the
   checkpoint's size, save and restore seconds and peak memory;
9. the HF-directory trainer: TinyLlama-1.1B (the published config.json,
   ``train_text_step.HF_CONFIGS``; 22 layers, hidden 2048, head dim 64,
   nothing cut) as random bf16 weights from seed 0 written by the port's
   ``save_hf_checkpoint`` in three shards with an index, loaded back
   bit-equal; then ``TextTrainer`` on a YAML with ``config_path``,
   ``model_path``, ``dataset_type: streaming`` over 4 jsonl shards,
   ``dyn_bsz``, seq 2048 x micro-batch 4, prefetch 2, ``save_hf_weights``
   and deterministic algorithms for 6 steps: K1-K3 launch 22 times a step
   each, all at head dim 64, flash ``FALLBACK_CALLS`` stays 0, the exported
   HF directory reads back bit-equal to the final parameters, the step-1
   loss equals ``build_train_step``'s on the same weights and batch, and a
   leg with prefetch 0 gives the same losses bit for bit; it prints step ms,
   tokens/s, peak memory and the HF write, load and export seconds;
10. parity: at depth 2, full width, S=1024, one dense train step with the
   kernels against the same step with the plain attention pinned (loss,
   grad norm), and the q/k/v/o projection gradients of one backward, leaf
   by leaf; at depth 1 (where no grouped GEMM feeds the router, so both
   legs route alike), full width, S=1024, one MoE step with the grouped-GEMM
   kernels against the same step with the plain ragged impl pinned, and the
   router and expert gradients of one backward, leaf by leaf;
11. the dense HF dialects, each from an HF directory written by the
   port's ``save_hf_checkpoint`` (random bf16 weights from seed 0, Gemma's
   norm weights at 0 as HF initialises them, and the published config.json
   of ``train_text_step.HF_CONFIGS``) through
   ``TextTrainer`` at full width and depth, seq 4096 x micro-batch 4, f32
   master, bf16 compute, ctx remat, AdamW: Gemma-3-1B (26 layers, 4 full
   attention and 22 with a 512-token window, head dim 256, 4/1 heads) for 6
   steps with its HF export read back bit-equal, then Llama-3.2-1B (llama3
   rope scaling, 32/8 heads, head dim 64) and Qwen2.5-1.5B (q/k/v biases,
   12/2, head dim 128) for 3 steps each. K1-K3 launch once a step per
   full-attention layer, all at the model's head dim; FALLBACK_CALLS counts
   one a step per windowed layer (the reference's feature dispatch to the
   plain attention); the step-1 loss is held to the same step with the
   plain attention pinned (rel 1e-4, nothing cut). After each, K1-K3 are
   held and timed at its head layout on its own first packed batch
   (Gemma-3-1B also on its first row alone);
12. serve: the paged-KV engine (``veomni_tpu_torch.serving``) at Qwen3-0.6B,
   28 layers, over 32 requests in two waves, legs (a) prefix cache and
   512-token chunks, (b) neither, (c) (a) with ngram speculation, (d) (a)
   and (c) sampled; every token held to an f32 teacher-forced re-score
   through the training forward (eps a recorded constant per phase, and
   the engine's first-token spread held under a ceiling), no leaked block,
   pools that keep their storage, cached tokens within the shared prefix;
13. serve: after the dense phase of 12, Gemma-3-1B, all 26
   layers, leg (a) over 32 requests of 208-1921 tokens (16 behind a shared
   512-token prefix), so its 512-token windows bite, under the same gate;
14. the same at Qwen3-30B-A3B, all 48 layers in bf16, leg (a), with K4 on
   every MoE layer of every pass, then K4 alone at the engine's decode and
   prefill-chunk shapes;
15. the deepseek MoE dialect (run after the dense dialects of 11): first
   ``route_tokens`` at DeepSeek-V3's router width (4096 tokens, hidden
   7168, 256 experts in 8 groups, top-4 groups, top-8, sigmoid with a
   nonzero correction bias) on the card against the same call on the CPU
   and against chip_smoke's own routing; then Moonlight-16B-A3B at its
   published widths (the config.json of ``train_text_step.HF_CONFIGS``),
   depth cut to 4 of 27 layers (the leading dense layer and 3 MoE layers,
   ~2.5 B parameters), as random bf16 weights from seed 0 with router
   correction biases drawn nonzero, written to an HF directory: its
   parameter count against the one counted here from the config, its first
   MoE layer (MLA q/k, the MLA block, the MoE block) held token by token to
   chip_smoke's own f32 layer, then ``TextTrainer`` at seq 4096 x
   micro-batch 2 for 4 steps with its HF export read back bit-equal: K4
   launches 6 times, K5 and K6 3 times, per MoE layer and step, K1-K3
   never (MLA's v head dim is not q's: one ``FALLBACK_CALLS`` per layer and
   step), and the step-1 loss, grad norm and router aux loss equal the same
   step's with the plain ragged grouped GEMM pinned; then K4-K6 held and
   timed at its expert widths (K/N 2048/1408 and 1408/2048) on its layer
   1's routing of a packed batch (M = 49152); then DeepSeek-V2-Lite
   (softmax greedy routing without renorm, yarn rope with its mscale on the
   softmax scale) the same way at 2 layers for 3 steps;
16. the SFT path at ``configs/text/lora_sft.yaml``'s knobs (LoRA rank 16,
   alpha 32, conversation data at seq 4096 x micro-batch 2, lr 1e-4, the
   default ``nothing`` remat), run after the serving phases: chat rows
   built from the repo's docs; TinyLlama-1.1B from an HF directory (random
   bf16 weights, the byte-fallback fixture tokenizer of
   ``tests/fixtures/tokenizers``) with the llama2 template, after the label
   mask is checked with it and with the tokenizer's jinja template, 4
   steps: K1 twice and K2, K3 once per layer and step, every adapter
   trained, the base bit-unchanged, the adapter-only checkpoint, the
   adapter save/load round trip bit-equal, the merged HF export against
   ``W + scale * A @ B`` worked out here in f64, step 1 against the plain
   attention; then a full fine-tune with ``freeze_modules`` and
   ``module_lr_scales`` against a plain step (frozen tensor bit-unchanged,
   grad norm, update ratios); then Qwen3-30B-A3B at its preset widths, 16 of
   48 layers, ``moe_capacity_factor`` 2.0 at expert-parallel size 1,
   adapters on the experts and attention, the byte-level fixture tokenizer
   and chatml, 4 steps: K4 6, K5 and K6 3 times per layer and step on the
   merged experts, the base bit-unchanged, the adapter round trip, the
   last layer's merged weights against ``W + scale * A @ B`` worked out
   here in f64 (its merged export, ~42 GB of f32, is off), step 1's loss
   and grad norm against the plain ragged grouped GEMM.

``--phases serve_dense,serve_moe`` runs the build and those phases alone
(after ``main`` or ``trainer``, the dense loop or the trainer, when named
first) and prints no result line; ``--phases
hf_trainer_gemma3,serve_gemma3,dialects`` runs the dense dialects' phases
(11 and 13) alone, ``--phases hf_trainer_moonlight,deepseek_v2_lite`` the
deepseek ones (15), ``--phases sft_lora_dense,sft_lora_moe`` the SFT ones
(16).

The last three lines are the kernel table as JSON, the card's name and power
limit as ``nvidia-smi`` gives them, and the device record
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
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
# kernel phase's elementwise rule catches the small ones. The MoE step parity
# (grouped-GEMM kernels vs the plain ragged impl, depth 1) is held to the
# same limits: measured loss 1.9e-6, grad norm 9.1e-6, router and expert
# gradients 8.5e-4 to 2.3e-3 on an H100 (one bf16 rounding flip per
# differing expert output).
TOL_LOSS_REL = 1e-4
TOL_GRAD_NORM_REL = 1e-3
TOL_LEAF_REL = 5e-2
# Grouped GEMM vs its plain version, element by element:
#   |got - ref| <= GMM_ATOL_MAX * max|ref| + GMM_RTOL * |ref|.
# Both multiply exact bf16 products and accumulate in f32, then round once to
# bf16; only the summation order differs, so an output may land on the
# neighbouring bf16 value: GMM_RTOL is one bf16 epsilon (2^-7). Outputs near
# zero keep the f32 rounding of their larger terms: GMM_ATOL_MAX is 1e-4 of
# the tensor's largest magnitude. A skipped (tile, expert) pair zeroes whole
# outputs, a 64-row chunk of K6 lost moves drhs by ~sqrt(64 / rows of the
# expert) of its size: each breaks the rule many times over.
GMM_RTOL = 2.0 ** -7
GMM_ATOL_MAX = 1e-4
LAYERS = 28
MOE_PRESET = "qwen3_30b_a3b"
MOE_LAYERS = 4
MAIN_STEPS = 3
MB1_STEPS = 6  # per leg of the micro-batch-1 MoE step; the first two warm up
TRAINER_SAVE_AT = 3  # the trainer phase's resumed leg saves here, then runs to 6
# the HF-directory trainer phase: TinyLlama-1.1B (train_text_step.HF_CONFIGS)
HF_PRESET = "tinyllama_1p1b"
HF_STEPS = 6
HF_SEQ = 2048  # the model's own context (max_position_embeddings)
HF_MICRO_BS = 4
HF_DOCS = 512
HF_SHARD_BYTES = 1 << 30  # its 2.2 GB of bf16 weights in three shards: the index path runs
# the numbers of a flash kernel's row that are kept for its other layouts
LAYOUT_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "single_segment_ms")


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
        # ptxas' report per kernel (the .log beside the library): registers,
        # spills, and wgmma serialization warnings
        kernel = None
        if not os.path.exists(p + ".log"):
            continue
        with open(p + ".log") as f:
            for line in f:
                if "Compiling entry function" in line:
                    # the mangled name without its namespace and parameters:
                    # the kernel and its template arguments (ILi64E... = <64, ...>)
                    kernel = re.sub(r"^.*?_cu_[0-9a-f]+\d+", "", line.split("'")[1])
                    kernel = kernel.split("EEv")[0].split("Ev")[0][:60]
                elif kernel and ("registers" in line or "spill" in line or "C75" in line):
                    log(f"  ptxas {kernel}: {line.strip()[:160]}")


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


def check_deterministic(tag, q, k, v, seg, do, lse, delta, scale, causal, rng):
    """K2 and K3 twice on the same inputs: dQ, dK and dV must be bit-identical
    (no atomics, fixed summation orders)."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    runs = [(*fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse, delta, scale, causal, rng),
             fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse, delta, scale, causal, rng))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("K2 dK", "K2 dV", "K3 dQ"), *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} ({tag}): two launches on the same inputs differ in "
                                 f"{int((a != b).sum())} elements")
    log(f"  K2 dK, dV and K3 dQ ({tag}): bit-identical over two launches")


def phase_probe(dev):
    """K7 first: does a kernel run on this card at all? Exact comparison."""
    from veomni_tpu_torch.ops.cuda import probe

    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    y = probe.probe_double_cuda(x)
    torch.cuda.synchronize()
    if not torch.equal(y, probe.probe_double_plain(x)):
        raise AssertionError("K7 probe: kernel output differs from 2 * x")
    log("K7 probe: y = 2x on [8,128] f32, exact")
    bound = bound_ms(dev, 0.0, 2 * x.numel() * 4)
    return dict(name="probe_double", route="cuda", source="veomni_tpu_torch/csrc/probe.cu",
                replaces="scripts/pallas_probe.py:68", max_abs_err=0.0,
                ms=timed_ms(lambda: probe.probe_double_cuda(x), reps=100),
                plain_ms=timed_ms(lambda: probe.probe_double_plain(x), reps=100),
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=timed_ms(lambda: torch.mul(x, 2.0), reps=100))


def phase_flash(dev, seg, hq: int, hkv: int, tag: str, d: int = 128):
    """K1-K3 at head dim ``d`` against their plain versions on packed
    segments ``seg``, timed beside their plain versions and the library
    yardstick."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    b, s = seg.shape
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(b, s, hq, d, device=dev, generator=g).bfloat16()
    k = torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
    v = torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
    do = torch.randn(b, s, hq, d, device=dev, generator=g).bfloat16()
    pairs = visible_pairs(seg)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split = fa.dkv_group_split(b, s, hq, hkv, n_sm, d)
    fwd_keys = 64 if d == 256 else 128  # K1's key tile
    log(f"flash kernels ({tag}): B={b} S={s} Hq={hq} Hkv={hkv} D={d}, "
        f"{int(seg.max())} segments max/row, visible causal pairs {pairs} "
        f"({pairs / (b * s * (s + 1) / 2):.3f} of causal); causal tile pairs kept by the "
        f"segment skip: {kept_tiles(seg, 128, fwd_keys):.3f} (K1: 128 q x {fwd_keys} keys), "
        f"{kept_tiles(seg, 64, 128):.3f} (K2: 64 q x 128 keys), "
        f"{kept_tiles(seg, 128, 64):.3f} (K3: 128 q x 64 keys); "
        f"K2's q-head group split {split}{', dK/dV in two 128-column halves' if d == 256 else ''}")

    # K1 through the autograd Function, then K2 + K3 from its backward
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=True, softmax_scale=scale)
    out.backward(do)
    rng = fa.seg_ranges(seg)  # once per attention call on the main path: outside the timings
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, scale, True, rng)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, scale, True)
    err_o = check_close(f"K1 O (autograd path, {tag})", out, o_p)
    check_close(f"K1 O (wrapper, {tag})", o_k, o_p)
    err_lse = check_close(f"K1 LSE ({tag})", lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
    delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale, True)
    err_dq = check_close(f"K3 dQ ({tag})", qg.grad, dq_p)
    err_dk = check_close(f"K2 dK ({tag})", kg.grad, dk_p)
    err_dv = check_close(f"K2 dV ({tag})", vg.grad, dv_p)
    del o_p, lse_p, dq_p, dk_p, dv_p, qg, kg, vg, out
    torch.cuda.empty_cache()
    check_deterministic(f"{tag}, K2 split {split}", q, k, v, seg, do, lse_k, delta, scale, True, rng)

    ms = {
        "fwd": timed_ms(lambda: fa.flash_fwd_cuda(q, k, v, seg, scale, True, rng)),
        "dkv": timed_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse_k, delta, scale,
                                                      True, rng)),
        "dq": timed_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse_k, delta, scale,
                                                    True, rng)),
    }
    # K1-K3 on a single-segment batch of the same shape: the function SDPA
    # computes below, so their like-for-like yardstick
    seg1 = torch.zeros_like(seg)
    rng1 = fa.seg_ranges(seg1)
    _, lse1 = fa.flash_fwd_cuda(q, k, v, seg1, scale, True, rng1)
    single = {
        "fwd": timed_ms(lambda: fa.flash_fwd_cuda(q, k, v, seg1, scale, True, rng1)),
        "dkv": timed_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, seg1, do, lse1, delta, scale,
                                                      True, rng1)),
        "dq": timed_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, seg1, do, lse1, delta, scale,
                                                    True, rng1)),
    }
    del lse1
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
    held = dict(head_dim=d, layout=f"{tag}: B={b} S={s} Hq={hq} Hkv={hkv} D={d}")
    table = [
        dict(name="flash_fwd", route="cuda", source=src, replaces=f"{ref}:49", **held,
             max_abs_err=max(err_o, err_lse), ms=ms["fwd"], plain_ms=plain_fwd,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
             single_segment_ms=single["fwd"]),
        dict(name="flash_bwd_dkv", route="cuda", source=src, replaces=f"{ref}:155", **held,
             max_abs_err=max(err_dk, err_dv), ms=ms["dkv"], plain_ms=plain_bwd,
             bound_ms=dkv_bound[0], bound_by=dkv_bound[1], library_ms=lib_bwd,
             single_segment_ms=single["dkv"]),
        dict(name="flash_bwd_dq", route="cuda", source=src, replaces=f"{ref}:208", **held,
             max_abs_err=err_dq, ms=ms["dq"], plain_ms=plain_bwd,
             bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=lib_bwd,
             single_segment_ms=single["dq"]),
    ]
    for row in table:
        log(f"  {row['name']} ({tag}): {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}, plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms)")
    full_pairs = b * s * (s + 1) // 2
    log(f"  flash_fwd ({tag}): {4 * d * hq * pairs / ms['fwd'] / 1e9:.1f} TFLOP/s on the "
        f"visible pairs; on a single-segment batch of the same shape (the function SDPA "
        f"computes) {single['fwd']:.3f} ms against SDPA's {lib_fwd:.3f} ms "
        f"({single['fwd'] / lib_fwd:.2f}x), {4 * d * hq * full_pairs / single['fwd'] / 1e9:.1f} "
        f"TFLOP/s")
    bwd = ms["dkv"] + ms["dq"]
    bwd1 = single["dkv"] + single["dq"]
    # useful work of a backward: 5 products of 2*D FLOPs per visible pair (S, dP,
    # dV, dK, dQ), as SDPA's backward does them; K2 and K3 each recompute S and dP
    log(f"  flash backward ({tag}): K2 + K3 {bwd:.3f} ms ({ms['dkv']:.3f} + {ms['dq']:.3f}), "
        f"{10 * d * hq * pairs / bwd / 1e9:.1f} TFLOP/s of useful work on the visible pairs; "
        f"on the single-segment batch {bwd1:.3f} ms ({single['dkv']:.3f} + {single['dq']:.3f}) "
        f"against SDPA's backward {lib_bwd:.3f} ms ({bwd1 / lib_bwd:.2f}x), "
        f"{10 * d * hq * full_pairs / bwd1 / 1e9:.1f} TFLOP/s of useful work")
    log("  (plain_ms of K2 and K3 is the plain backward computing dQ, dK, dV together; "
        "library_ms of K2 and K3 is SDPA's backward, also all three)")
    return table


def edge_segments(layout: str) -> torch.Tensor:
    """[1, S] segment ids of one K1 edge case (K1's tiles are 128 rows)."""
    if layout == "S=128 one tile":
        return torch.ones(1, 128, dtype=torch.int32)
    if layout == "one segment":
        return torch.ones(1, 512, dtype=torch.int32)
    if layout == "short segments":  # many boundaries inside each 128-row tile
        lengths = torch.tensor([5, 17, 40, 3, 60, 1, 33, 96]).repeat(8)
        return torch.repeat_interleave(torch.arange(1, 65, dtype=torch.int32), lengths)[None, :512]
    if layout == "tile edges":  # boundaries exactly on tile edges
        return torch.tensor([1] * 128 + [2] * 256 + [3] * 128, dtype=torch.int32)[None]
    if layout == "three k tiles":  # S = 384: an odd number of 128-key tiles
        return torch.tensor([1] * 200 + [2] * 184, dtype=torch.int32)[None]
    raise ValueError(layout)


def phase_flash_edges(dev):
    """K1 where its per-tile decisions (skip, mask or not) can break: one
    tile, one segment, segment boundaries inside tiles and on tile edges,
    causal and full, at both head layouts; K2 and K3 through the same
    autograd calls."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    log("flash kernels, edge cases (B=1):")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    for layout in ("S=128 one tile", "one segment", "short segments", "tile edges",
                   "three k tiles"):
        seg = edge_segments(layout).to(dev)
        s = seg.shape[1]
        for hq, hkv in ((4, 2), (32, 4)):  # K2 splits the group: 2 and 8 ways
            q = torch.randn(1, s, hq, 128, device=dev, generator=gen).bfloat16()
            k = torch.randn(1, s, hkv, 128, device=dev, generator=gen).bfloat16()
            v = torch.randn(1, s, hkv, 128, device=dev, generator=gen).bfloat16()
            do = torch.randn(1, s, hq, 128, device=dev, generator=gen).bfloat16()
            for causal in (True, False):
                tag = (f"{layout}, S={s} Hq={hq} Hkv={hkv}, {'causal' if causal else 'full'}, "
                       f"K2 split {fa.dkv_group_split(1, s, hq, hkv, n_sm)}")
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=causal)
                out.backward(do)
                o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, 128 ** -0.5, causal)
                o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, 128 ** -0.5, causal, fa.seg_ranges(seg))
                check_close(f"K1 O (edge: {tag})", out, o_p)
                check_close(f"K1 LSE (edge: {tag})", lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
                delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
                refs = fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, 128 ** -0.5, causal)
                for name, got, ref in zip(("K3 dQ", "K2 dK", "K2 dV"),
                                          (qg.grad, kg.grad, vg.grad), refs):
                    check_close(f"{name} (edge: {tag})", got, ref)
                check_deterministic(f"edge: {tag}", q, k, v, seg, do, lse_k, delta, 128 ** -0.5,
                                    causal, fa.seg_ranges(seg))
    phase_flash_empty_walk(dev)


def phase_flash_empty_walk(dev):
    """An item whose walk is empty must write zeros, not leave the
    ``torch.empty`` outputs as they were. No caller can reach that state: in
    self-attention every key tile sees its own q tiles, and every q tile its
    own keys. So this check forges it: tokens 128..255 are a segment of their
    own whose blocks' ranges are given as empty (min 100 > max 99), which
    meets no range. Their dK, dV (K2) and dQ (K3) must come out exactly 0
    (against no reference: the true values are not 0); every other token's
    is held to the plain version, which that segment does not touch."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 128 ** -0.5
    b, hq, hkv = 1, 32, 4
    seg = torch.tensor([[1] * 128 + [7] * 128 + [2] * 256] * b, dtype=torch.int32, device=dev)
    rng = fa.seg_ranges(seg)
    empty = torch.tensor([100, 99], device=dev)  # min > max: meets no range
    rng[:, 128 // fa.SEG_RANGE_BLOCK:256 // fa.SEG_RANGE_BLOCK] = empty
    q, do = (torch.randn(b, 512, hq, 128, device=dev, generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, 512, hkv, 128, device=dev, generator=gen).bfloat16() for _ in range(2))
    o, lse = fa.flash_fwd_cuda(q, k, v, seg, scale, True, fa.seg_ranges(seg))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse, delta, scale, True, rng)
    dq = fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse, delta, scale, True, rng)
    refs = fa.flash_bwd_plain(q, k, v, seg, do, lse, delta, scale, True)
    tag = (f"forged empty walk of tokens 128..255, B={b} S=512 Hq={hq} Hkv={hkv}, "
           f"K2 split {fa.dkv_group_split(b, 512, hq, hkv, n_sm)}")
    other = torch.cat([torch.arange(128), torch.arange(256, 512)]).to(dev)
    for name, got, ref in zip(("K3 dQ", "K2 dK", "K2 dV"), (dq, dk, dv), refs):
        check_close(f"{name} (edge: {tag}, other tokens)", got[:, other], ref[:, other])
        if got[:, 128:256].any():
            raise AssertionError(f"{name} (edge: {tag}): the tokens of the empty walk are "
                                 f"not all 0")
    log(f"  K3 dQ, K2 dK and dV (edge: {tag}): the empty walk's tokens are exactly 0")


def moe_group_sizes(dev, seq_len: int, micro_bs: int):
    """Rows per expert of the MoE main path's layer 0 on its first packed
    micro-batch: the same seeded weights (layer 0 comes first in the init
    order, so it does not depend on depth) and the same batch, routed
    without gradients."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.transformer import expert_counts, route_tokens
    from veomni_tpu_torch.train_text_step import SEED, bench_config, packed_batches

    cfg = bench_config(MOE_PRESET, num_hidden_layers=1)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = {k: torch.from_numpy(v[0]).to(dev)
             for k, v in next(packed_batches(cfg.vocab_size, seq_len, micro_bs)).items()}
    layer = model.layers[0]
    with torch.no_grad():
        hidden, cos, sin = model.embed_and_rotary(batch["input_ids"], batch["position_ids"])
        q, k, v = layer._qkv(hidden, cos, sin)
        _, x = layer.mlp_input(hidden, layer._attend(q, k, v, batch["segment_ids"]))
        idx, _, _ = route_tokens(x.reshape(-1, cfg.hidden_size), layer.router.to(cfg.dtype), cfg)
        return expert_counts(idx.reshape(-1), cfg.num_experts)


def library_gmm(kind: str, lhs, rhs, g, starts):
    """(ms, name) of one PyTorch call computing what kernel ``kind``
    computes (timed only, never called by the port): ``torch._grouped_mm``
    where this torch has it and takes these layouts, else one
    ``torch.matmul`` of the same M x K x N, named so."""
    offs = starts[1:]
    if hasattr(torch, "_grouped_mm"):
        call = {"fwd": lambda: torch._grouped_mm(lhs, rhs, offs=offs),
                "dlhs": lambda: torch._grouped_mm(g, rhs.transpose(1, 2), offs=offs),
                "t": lambda: torch._grouped_mm(lhs.t(), g, offs=offs)}[kind]
        try:
            call()
            return timed_ms(call), "torch._grouped_mm"
        except RuntimeError as e:  # a yardstick only: say so and time the matmul instead
            log(f"  torch._grouped_mm ({kind}) refused these inputs: {str(e).splitlines()[0]}")
    a, b = {"fwd": (lhs, rhs[0]), "dlhs": (g, rhs[0].t()), "t": (lhs.t(), g)}[kind]
    return timed_ms(lambda: torch.matmul(a, b)), "torch.matmul of the same M x K x N"


def gmm_case(dev, sizes, k: int, n: int, tag: str, timed: bool = False, rows=None):
    """K4, K5, K6 against their plain versions for one set of group sizes,
    through the autograd Function and through each wrapper, over ``rows``
    rows (default: as many as the groups hold; rows past the groups must come
    out of K4 and K5 exactly 0); with ``timed``, also their times, bounds and
    library yardsticks (the table rows)."""
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    sizes = sizes.to(dev)
    e = sizes.numel()
    starts = gg.group_starts(sizes)
    owned = int(starts[-1])
    m = owned if rows is None else rows
    gen = torch.Generator(device=dev).manual_seed(2)
    lhs = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    rhs = torch.randn(e, k, n, device=dev, generator=gen).bfloat16()
    g = torch.randn(m, n, device=dev, generator=gen).bfloat16()

    def hold(name, got, ref):
        err = check_close(f"{name} ({tag})", got, ref,
                          atol=GMM_ATOL_MAX * ref.float().abs().max().item(), rtol=GMM_RTOL)
        if name.startswith("K6") and (sizes == 0).any():  # K6 writes them: torch.empty output
            if got[sizes == 0].any():
                raise AssertionError(f"{name} ({tag}): kernel disagrees with its plain version "
                                     f"(the drhs of an empty expert is not all 0)")
            log(f"  {name} ({tag}): the drhs of each of {int((sizes == 0).sum())} empty "
                f"experts is exactly 0")
        if not name.startswith("K6") and m > owned:  # rows no expert owns
            if got[owned:].any():
                raise AssertionError(f"{name} ({tag}): kernel disagrees with its plain version "
                                     f"(rows {owned}.. past the groups are not all 0)")
            log(f"  {name} ({tag}): rows {owned}..{m - 1} past the groups are exactly 0")
        return err

    lhs_g, rhs_g = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = gg.cuda_group_gemm(lhs_g, rhs_g, sizes)
    out.backward(g)
    ref = gg.gmm_plain(lhs, rhs, starts)
    err = {"fwd": hold("K4 out (autograd path)", out, ref)}
    hold("K4 out (wrapper)", gg.gmm_cuda(lhs, rhs, starts), ref)
    ref = gg.gmm_dlhs_plain(g, rhs, starts)
    err["dlhs"] = hold("K5 dlhs (autograd path)", lhs_g.grad, ref)
    hold("K5 dlhs (wrapper)", gg.gmm_dlhs_cuda(g, rhs, starts), ref)
    ref = gg.gmm_t_plain(lhs, g, starts, e)
    err["t"] = hold("K6 drhs (autograd path)", rhs_g.grad, ref)
    hold("K6 drhs (wrapper)", gg.gmm_t_cuda(lhs, g, starts, e), ref)
    del ref, lhs_g, rhs_g, out
    torch.cuda.empty_cache()
    if not timed:
        return None

    used = int((sizes > 0).sum())  # experts whose weights this data needs
    bf, i32 = 2, 4
    flops = 2.0 * m * k * n
    kernels = {
        "fwd": ("gmm_fwd", 37, m * k * bf + used * k * n * bf + m * n * bf,
                lambda: gg.gmm_cuda(lhs, rhs, starts), lambda: gg.gmm_plain(lhs, rhs, starts)),
        "dlhs": ("gmm_dlhs", 104, m * n * bf + used * k * n * bf + m * k * bf,
                 lambda: gg.gmm_dlhs_cuda(g, rhs, starts),
                 lambda: gg.gmm_dlhs_plain(g, rhs, starts)),
        "t": ("gmm_t", 166, m * k * bf + m * n * bf + e * k * n * bf,
              lambda: gg.gmm_t_cuda(lhs, g, starts, e),
              lambda: gg.gmm_t_plain(lhs, g, starts, e)),
    }
    rows = []
    for kind, (name, line, nbytes, kernel, plain) in kernels.items():
        lib_ms, lib_name = library_gmm(kind, lhs, rhs, g, starts)
        bound = bound_ms(dev, flops, nbytes + (e + 1) * i32)
        row = dict(name=name, route="cuda", source="veomni_tpu_torch/csrc/grouped_gemm.cu",
                   replaces=f"veomni_tpu/ops/pallas/grouped_gemm.py:{line}", k=k, n=n,
                   layout=f"{tag}: M={m} E={e}",
                   max_abs_err=err[kind], ms=timed_ms(kernel),
                   plain_ms=timed_ms(plain, reps=3, warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
        log(f"  {name} ({tag}): {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}, plain {row['plain_ms']:.3f} ms, library {lib_ms:.3f} ms "
            f"[{lib_name}]); {flops / row['ms'] / 1e9:.1f} TFLOP/s")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_gmm(dev):
    """K4-K6 on small edge cases, then at the MoE main path's shapes with
    its real routing. Returns the table rows of the gate/up shape; the
    down-projection shape's numbers are printed beside them."""
    sizes = moe_group_sizes(dev, 4096, 4)
    torch.cuda.empty_cache()
    s = sizes.cpu()
    log(f"grouped GEMM kernels: layer-0 routing of the MoE main path's first batch: "
        f"M={int(s.sum())} rows over E={s.numel()} experts, rows/expert min {int(s.min())} "
        f"median {int(s.median())} max {int(s.max())}, empty experts {int((s == 0).sum())}")
    for tag, case in {"ragged+empty": [100, 156, 0, 256], "single": [0, 512, 0, 0],
                      "mid-tile": [37, 0, 219, 64, 192],
                      "unaligned M=420": [37, 0, 219, 64, 100],
                      "M=65 < one tile": [20, 0, 45],
                      # K6's 64-row chunks: experts ending on a chunk edge (64,
                      # 192), shorter than a chunk (40), mid-chunk (100)
                      "chunk edges": [64, 128, 0, 40, 192, 100]}.items():
        gmm_case(dev, torch.tensor(case), 128, 256, f"small {tag}, K=128 N=256")
    gmm_case(dev, torch.tensor([100, 0, 200, 0]), 128, 256,
             "small rows 300..511 past the groups, K=128 N=256", rows=512)
    # E = 128, most experts empty: a boundary on the tile edge at row 128
    # after a run of empty experts, one mid-tile, and the other tile widths
    # (K4 writes 128-column tiles at N = 384, K5 256-column ones at K = 256)
    edge = torch.zeros(128, dtype=torch.int64)
    edge[5], edge[64], edge[127] = 128, 200, 156
    gmm_case(dev, edge, 256, 384, "small E=128 tile-edge, K=256 N=384")
    # K and N multiples of 8 but not of the tiles: the last tiles reach past
    # the tensors' edges (K4's contraction tail, K5's and K6's output tails)
    for tag, case in {"ragged+empty": [100, 156, 0, 256], "unaligned M=420": [37, 0, 219, 64, 100],
                      "chunk edges": [64, 128, 0, 40, 192, 100]}.items():
        gmm_case(dev, torch.tensor(case), 136, 200, f"small {tag}, K=136 N=200")
    gmm_case(dev, torch.tensor([100, 0, 200, 0]), 776, 64,
             "small rows 300..511 past the groups, K=776 N=64", rows=512)
    rows = gmm_case(dev, sizes, 2048, 768, "gate/up: K=2048 N=768", timed=True)
    gmm_case(dev, sizes, 768, 2048, "down: K=768 N=2048", timed=True)
    # the same routing at widths the tiles do not divide: 776 = 6 x 128 + 8
    # (K and N), and the reference CLI config's expert width 64
    # (tests/test_cli_subprocess.py:41), held and timed; no main path runs them
    for k, n, what in ((2048, 776, "gate/up"), (776, 2048, "down"), (2048, 64, "gate/up")):
        for row in gmm_case(dev, sizes, k, n, f"{what} at K={k} N={n}", timed=True):
            row["on_main_path"] = False
            rows.append(row)
    return rows


def reset_all_counts():
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    fa.reset_counts()
    gg.reset_counts()


def read_counts():
    """(launches by kernel, flash attention's plain-path dispatches)."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    return {**fa.LAUNCHES, **gg.LAUNCHES}, {"flash": fa.FALLBACK_CALLS}


def check_steps(records, tag):
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["step_ok"]):
            raise AssertionError(f"non-finite {tag} train step: {r}")


def check_counts(launches, fallbacks, want, tag):
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name}: {n} launches on the {tag} main path, "
                                 f"expected {want.get(name, 0)}")
    if any(fallbacks.values()):
        raise AssertionError(f"FALLBACK_CALLS {fallbacks} on the {tag} main path")


def phase_main(dev, card):
    """The dense main path: Qwen3-0.6B, full depth."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    reset_all_counts()
    records = run_train_steps(4096, 4, MAIN_STEPS, device=dev)
    launches, fallbacks = read_counts()
    for i, r in enumerate(records):
        log(f"main step {i}: loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
            f"step_ms={r['step_ms']:.1f} tokens_per_s={r['tokens_per_s']:.1f} "
            f"mfu={r['mfu']:.4f} ntokens={int(r['ntokens'])} [{card}]")
    log(f"main path launches: {launches}, FALLBACK_CALLS={fallbacks} "
        f"(Qwen3-0.6B, {LAYERS} layers, seq 4096, micro-batch 4, ctx remat)")
    check_steps(records, "dense")
    per_kernel = LAYERS * MAIN_STEPS  # one micro-batch per step; ctx never reruns K1
    check_counts(launches, fallbacks, {"flash_fwd": per_kernel, "flash_bwd_dkv": per_kernel,
                                       "flash_bwd_dq": per_kernel}, "dense")
    return launches


def phase_moe_main(dev, card):
    """The MoE main path: Qwen3-30B-A3B at full width, MOE_LAYERS deep."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    records = run_train_steps(4096, 4, MAIN_STEPS, preset=MOE_PRESET, num_layers=MOE_LAYERS,
                              device=dev)
    launches, fallbacks = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, r in enumerate(records):
        log(f"moe step {i}: loss={r['loss']:.6f} moe_aux_loss={r['moe_aux_loss']:.6f} "
            f"grad_norm={r['grad_norm']:.6f} step_ms={r['step_ms']:.1f} "
            f"tokens_per_s={r['tokens_per_s']:.1f} mfu={r['mfu']:.4f} "
            f"ntokens={int(r['ntokens'])} [{card}]")
    log(f"moe path launches: {launches}, FALLBACK_CALLS={fallbacks}, peak device memory "
        f"{peak / 2**30:.2f} GiB (Qwen3-30B-A3B width, {MOE_LAYERS} layers, seq 4096, "
        f"micro-batch 4, ctx remat)")
    check_steps(records, "MoE")
    n = MOE_LAYERS * MAIN_STEPS
    # per MoE layer and step: K4 runs gate, up and down in the forward and
    # again in the ctx recompute of the post-attention block; backward runs
    # K5 and K6 once per grouped GEMM; the attention forward is not rerun
    check_counts(launches, fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                                       "gmm_fwd": 6 * n, "gmm_dlhs": 3 * n, "gmm_t": 3 * n},
                 "MoE")
    return launches


def phase_moe_micro_batch_1(dev, card):
    """The MoE main path at micro-batch 1, the micro-batch of the repo's
    Qwen3-30B-A3B config (``configs/text/qwen3_moe_ep.yaml``, seq 4096). One
    row gives K2 128 work items (4 kv heads x 32 key tiles), so
    dkv_group_split splits each group of 8 q heads over 4 items. Legs with
    the split and without it (SPLIT_ITEMS_PER_SM 0: the whole group in every
    item, the TMA-store epilogue) alternate, twice each, every leg a fresh
    model from the same seed on the same batches, so all four do the same
    work; their losses and grad norms must agree step by step. Returns the
    median step_ms of the steps after the first two, by leg."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import run_train_steps

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = fa.SPLIT_ITEMS_PER_SM
    n = MOE_LAYERS * MB1_STEPS
    legs = {"split": [], "no split": []}
    try:
        for leg in ("split", "no split", "split", "no split"):
            fa.SPLIT_ITEMS_PER_SM = rule if leg == "split" else 0
            split = fa.dkv_group_split(1, 4096, 32, 4, n_sm)
            if (split > 1) != (leg == "split"):
                raise AssertionError(f"moe micro-batch 1 ({leg}): K2 split {split}")
            reset_all_counts()
            records = run_train_steps(4096, 1, MB1_STEPS, preset=MOE_PRESET,
                                      num_layers=MOE_LAYERS, device=dev)
            launches, fallbacks = read_counts()
            torch.cuda.empty_cache()
            for i, r in enumerate(records):
                log(f"moe micro-batch 1 step {i} ({leg}, K2 split {split}): "
                    f"loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
                    f"step_ms={r['step_ms']:.1f} tokens_per_s={r['tokens_per_s']:.1f} "
                    f"mfu={r['mfu']:.4f} [{card}]")
            check_steps(records, f"MoE micro-batch 1 ({leg})")
            check_counts(launches, fallbacks, {
                "flash_fwd": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                "gmm_fwd": 6 * n, "gmm_dlhs": 3 * n, "gmm_t": 3 * n}, f"MoE micro-batch 1 ({leg})")
            legs[leg].append(records)
    finally:
        fa.SPLIT_ITEMS_PER_SM = rule
    base = legs["split"][0]
    for leg, runs in legs.items():
        for records in runs:
            for r, ref in zip(records, base):
                d_loss = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
                d_gn = abs(r["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
                if not (d_loss <= TOL_LOSS_REL and d_gn <= TOL_GRAD_NORM_REL):
                    raise AssertionError(f"moe micro-batch 1 ({leg}) departs from the first "
                                         f"split leg: loss rel {d_loss}, grad_norm rel {d_gn}")
    ms = {leg: sorted(r["step_ms"] for records in runs for r in records[2:])
          for leg, runs in legs.items()}
    med = {leg: v[len(v) // 2] for leg, v in ms.items()}
    log(f"moe micro-batch 1 (Qwen3-30B-A3B width, {MOE_LAYERS} layers, seq 4096, ctx remat): "
        f"steps 2.. with K2's split {', '.join(f'{x:.1f}' for x in ms['split'])} ms, median "
        f"{med['split']:.1f}; without {', '.join(f'{x:.1f}' for x in ms['no split'])} ms, "
        f"median {med['no split']:.1f}; the split saves "
        f"{med['no split'] - med['split']:.1f} ms a step; losses and grad norms of all legs "
        f"agree (rel tol {TOL_LOSS_REL}, {TOL_GRAD_NORM_REL}); launches per leg K1-K3 {n}, "
        f"K4 {6 * n}, K5 {3 * n}, K6 {3 * n}")
    return med


def state_digest(train_state):
    """Per tensor (parameters, then each one's AdamW exp_avg and
    exp_avg_sq), on the card: the sum of its 32-bit words and their sum
    weighted by a position hash, in int64; plus the update count. Any
    changed word changes the weighted sum."""
    model, opt = train_state.model, train_state.optimizer
    out = []
    with torch.no_grad():
        for _, p in model.named_parameters():
            for t in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]):
                words = t.detach().contiguous().view(-1).view(torch.int32)
                s1 = torch.zeros((), dtype=torch.int64, device=t.device)
                s2 = torch.zeros((), dtype=torch.int64, device=t.device)
                for lo in range(0, words.numel(), 1 << 24):
                    w = words[lo:lo + (1 << 24)].long()
                    pos = torch.arange(lo, lo + w.numel(), device=t.device, dtype=torch.int64)
                    s1 += w.sum()
                    s2 += (w * ((pos * 2654435761) % 2147483647 + 1)).sum()
                out.append((int(s1), int(s2)))
    out.append(opt.num_updates)
    return out


def phase_trainer(dev, card):
    """The trainer path: see phase 8 of the module docstring. Returns the
    straight leg's launch counts."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.observability.metrics import get_registry
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.tasks.train_text import main as train_text_main
    from veomni_tpu_torch.tools.trainer_profile import SEED as TRAINER_SEED
    from veomni_tpu_torch.tools.trainer_profile import STEPS as TRAINER_STEPS
    from veomni_tpu_torch.tools.trainer_profile import write_config
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.train_text_step import bench_config
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Record(Callback):
        """Per synced step: loss, grad norm, valid tokens, host time; the
        first batch as the loop shipped it."""

        def __init__(self, stop_at=None):
            self.steps, self.first_batch, self.stop_at = {}, None, stop_at

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(
                loss=m["loss"], grad_norm=m["grad_norm"], ntokens=m["ntokens"],
                t=time.perf_counter())
            if self.stop_at is not None and state.global_step >= self.stop_at:
                state.should_stop = True

    reg = get_registry()

    def span_sum(name):
        return reg.histogram_sum(f"span.{name}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        cfg_path = write_config(tmp)
        log(f"trainer: a corpus of 512 documents (lengths uniform in [256, 2048], tokens "
            f"uniform over 151936) and the config {cfg_path} (tools/trainer_profile.py)")

        # leg A: six straight steps of TextTrainer from the parsed YAML
        args = parse_args(VeOmniArguments, [cfg_path, f"--train.output_dir={tmp}/a"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        rec_a = Record()
        trainer.callbacks.append(rec_a)
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        digest_a = state_digest(trainer.train_state)
        if not torch.are_deterministic_algorithms_enabled():
            raise AssertionError("trainer: enable_full_determinism did not turn on "
                                 "torch.use_deterministic_algorithms")
        a = rec_a.steps
        first_batch = rec_a.first_batch
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, TRAINER_STEPS + 1)]
        for i in range(1, TRAINER_STEPS + 1):
            r = a[i]
            extra = (f" step_ms={ms[i - 2]:.1f} "
                     f"valid_tokens_per_s={r['ntokens'] / ms[i - 2] * 1e3:.1f}"
                     if i >= 2 else " (first step: warm-up, not timed)")
            log(f"trainer step {i} (leg A): loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
                f"ntokens={int(r['ntokens'])}{extra} [{card}]")
        med = sorted(ms)[len(ms) // 2]
        log(f"trainer (Qwen3-0.6B, 28 layers, seq 4096, micro-batch 4, ctx remat, "
            f"deterministic algorithms): warm steps 2-{TRAINER_STEPS} "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms, "
            f"{4 * 4096 / med * 1e3:.1f} tokens/s (packed rows, padding included), peak device "
            f"memory {peak / 2**30:.2f} GiB; launches {launches}, FALLBACK_CALLS={fallbacks} "
            f"[{card}]")
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], "trainer")
        n = LAYERS * TRAINER_STEPS
        check_counts(launches, fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n,
                                           "flash_bwd_dq": n}, "trainer")
        shutil.rmtree(os.path.join(tmp, "a"), ignore_errors=True)
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()

        # step-1 parity: train_text_step's build_train_step on the same
        # initial weights (same seed, same init) and the trainer's first batch
        cfg = bench_config("qwen3_0p6b")
        model = Transformer(cfg, torch.Generator(device=dev).manual_seed(TRAINER_SEED), device=dev)
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=TRAINER_STEPS)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first_batch.items()}
        _, m = build_train_step(Transformer.loss_fn)(state, batch)
        bench_loss = float(m["loss"])
        rel = abs(a[1]["loss"] - bench_loss) / abs(bench_loss)
        log(f"trainer step-1 parity: trainer loss {a[1]['loss']:.6f}, train_text_step's "
            f"build_train_step {bench_loss:.6f} (rel {rel:.2e}, tol {TOL_LOSS_REL})")
        if not rel <= TOL_LOSS_REL:
            raise AssertionError(f"trainer step-1 loss departs from build_train_step's ({rel})")
        del model, state, batch, m
        torch.cuda.empty_cache()

        # leg B1: three steps and a checkpoint (save_steps), stopped there
        args = parse_args(VeOmniArguments, [cfg_path, f"--train.output_dir={tmp}/b",
                                            f"--train.save_steps={TRAINER_SAVE_AT}"])
        reset_all_counts()
        save0, wait0 = span_sum("ckpt.save"), span_sum("ckpt.wait")
        trainer = TextTrainer(args)
        rec_b1 = Record(stop_at=TRAINER_SAVE_AT)
        trainer.callbacks.append(rec_b1)
        trainer.train()
        trainer.checkpointer.close()
        save_s, wait_s = span_sum("ckpt.save") - save0, span_sum("ckpt.wait") - wait0
        b1_launches, b1_fallbacks = read_counts()
        step_dir = os.path.join(tmp, "b", "checkpoints", f"global_step_{TRAINER_SAVE_AT}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(step_dir) for f in files)
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()

        # leg B2: a fresh main() that auto-resumes from step 3 and runs to 6
        reset_all_counts()
        restore0 = span_sum("ckpt.restore")
        t0 = time.perf_counter()
        trainer = train_text_main([cfg_path, f"--train.output_dir={tmp}/b",
                                   f"--train.save_steps={TRAINER_SAVE_AT}"])
        trainer.checkpointer.close()
        b2_s = time.perf_counter() - t0
        restore_s = span_sum("ckpt.restore") - restore0
        b2_launches, b2_fallbacks = read_counts()
        digest_b = state_digest(trainer.train_state)
        b = {}
        with open(os.path.join(tmp, "b", "metrics_rank0.jsonl")) as f:
            for line in f:
                doc = json.loads(line)
                if "loss" in doc:
                    b[doc["step"]] = doc["loss"]
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()

        log(f"trainer checkpoint (step {TRAINER_SAVE_AT}, async save, size-mode manifest): "
            f"{ckpt_bytes / 1e9:.3f} GB on disk; save {save_s + wait_s:.2f} s "
            f"({save_s:.2f} s blocking the loop: host snapshot + dispatch; {wait_s:.2f} s "
            f"waiting for the write and the manifest at train end); restore {restore_s:.2f} s "
            f"(read + copy into the live model and AdamW); leg B2 {b2_s:.1f} s in all [{card}]")
        for i in range(1, TRAINER_STEPS + 1):
            got = rec_b1.steps[i]["loss"] if i <= TRAINER_SAVE_AT else b.get(i)
            log(f"trainer step {i}: leg A loss {a[i]['loss']!r}, "
                f"{'leg B1' if i <= TRAINER_SAVE_AT else 'leg B2 (resumed)'} loss {got!r}")
            if got != a[i]["loss"]:
                raise AssertionError(f"trainer resume: step {i} loss {got!r} != the straight "
                                     f"leg's {a[i]['loss']!r}")
        if digest_b != digest_a:
            bad = sum(x != y for x, y in zip(digest_a, digest_b))
            raise AssertionError(f"trainer resume: the final state differs from the straight "
                                 f"leg's in {bad} of {len(digest_a)} digest entries "
                                 f"(num_updates {digest_b[-1]} vs {digest_a[-1]})")
        log(f"trainer resume: losses of steps {TRAINER_SAVE_AT + 1}-{TRAINER_STEPS} and the final "
            f"parameters, AdamW moments and num_updates ({digest_a[-1]}) equal the straight "
            f"leg's bit for bit ({len(digest_a) - 1} tensors)")
        half = LAYERS * TRAINER_SAVE_AT
        for tag, got_l, got_f in (("trainer leg B1", b1_launches, b1_fallbacks),
                                  ("trainer leg B2", b2_launches, b2_fallbacks)):
            check_counts(got_l, got_f, {"flash_fwd": half, "flash_bwd_dkv": half,
                                        "flash_bwd_dq": half}, tag)
        return launches
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        shutil.rmtree(tmp, ignore_errors=True)


HF_YAML = """
model:
  config_path: {hf}
  model_path: {hf}
data:
  train_path: {data}
  dataset_type: streaming
  data_type: pretokenized
  max_seq_len: {seq}
  dyn_bsz: true
train:
  micro_batch_size: {micro_bs}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  enable_full_determinism: true
  seed: 0
  save_hf_weights: true
  prefetch_depth: 2
  log_steps: 1
"""


def write_hf_run(tmp: str) -> str:
    """The HF phase's inputs under ``tmp``: the corpus (HF_DOCS pretokenized
    documents, lengths uniform in [256, 2048], tokens uniform over
    TinyLlama's 32000, from seed 0) as 4 jsonl shards, and the YAML; returns
    the YAML's path. The HF directory itself is written by phase_hf_trainer."""
    import numpy as np

    rng = np.random.default_rng(0)
    data = os.path.join(tmp, "shards")
    os.makedirs(data)
    for shard in range(4):
        with open(os.path.join(data, f"shard-{shard:03d}.jsonl"), "w") as f:
            for _ in range(HF_DOCS // 4):
                n = int(rng.integers(256, 2049))
                f.write(json.dumps({"input_ids": rng.integers(0, 32000, n).tolist()}) + "\n")
    path = os.path.join(tmp, "tinyllama_hf.yaml")
    with open(path, "w") as f:
        f.write(HF_YAML.format(hf=os.path.join(tmp, "hf"), data=data, seq=HF_SEQ,
                               micro_bs=HF_MICRO_BS, steps=HF_STEPS))
    return path


def hf_first_batch(yaml_path: str):
    """The first packed micro-batch the HF phase's trainer trains on, built
    by the same pieces the trainer builds (streaming shards, pretokenized
    transform, packing collator, token-budget dynamic batching), as numpy
    [1, B, S] arrays; phase_hf_trainer checks the trainer's against it."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.data.data_collator import TextPackingCollator
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.data.dataset import build_dataset
    from veomni_tpu_torch.data.dynamic_batching import DynamicBatchDataloader

    args = parse_args(VeOmniArguments, [yaml_path])
    d, t = args.data, args.train
    transform = build_data_transform(d.data_type, tokenizer=None, text_keys=d.text_keys,
                                     max_seq_len=d.max_seq_len, channel_list=d.channel_list,
                                     chat_template=d.chat_template)
    ds = build_dataset(d.dataset_type, path=d.train_path, transform=transform,
                       skip_budget=t.data_skip_budget)
    collator = TextPackingCollator(seq_len=d.max_seq_len, micro_batch_size=t.micro_batch_size)
    loader = DynamicBatchDataloader(ds, collator, token_budget=t.micro_batch_size * d.max_seq_len,
                                    grad_accum_steps=args.compute_grad_accum(1),
                                    buffer_size=d.dyn_bsz_buffer_size, seed=t.seed)
    return next(iter(loader))


def phase_hf_trainer(dev, card, yaml_path: str, first_batch):
    """The HF-directory trainer path: see phase 9 of the module docstring.
    Returns leg A's launch counts."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.models.hf_io import INDEX_NAME, hf_to_params, save_hf_checkpoint
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.train_text_step import HF_CONFIGS
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Record(Callback):
        """Per step: loss, grad norm, valid tokens, host time; the first
        batch as the loop shipped it."""

        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=m["loss"], grad_norm=m["grad_norm"],
                                                 ntokens=m["ntokens"], t=time.perf_counter())

    def leg(out_dir, *overrides):
        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={out_dir}",
                                            *overrides])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        rec = Record()
        trainer.callbacks.append(rec)
        export = {}
        save_hf = trainer.model.save_hf

        def timed_save_hf(*a, **k):  # HFCheckpointCallback's export, timed
            t0 = time.perf_counter()
            save_hf(*a, **k)
            export["s"] = time.perf_counter() - t0

        trainer.model.save_hf = timed_save_hf
        trainer.train()
        trainer.checkpointer.close()
        del trainer.model.save_hf  # the wrapper's cycle would keep the model alive
        launches, fallbacks = read_counts()
        by_dim = {d: dict(c) for d, c in fa.LAUNCHES_BY_HEAD_DIM.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        shutil.rmtree(os.path.join(out_dir, "checkpoints"), ignore_errors=True)
        return trainer, rec, launches, fallbacks, by_dim, peak, export.get("s")

    def params_equal(got, want, what):
        bad = [n for (n, a), (_, b) in zip(got.named_parameters(), want.named_parameters())
               if not torch.equal(a.float(), b.float())]
        if bad:
            raise AssertionError(f"hf trainer: {what} differ from the written ones in "
                                 f"{len(bad)} tensors, e.g. {bad[:3]}")

    tmp = os.path.dirname(yaml_path)
    hf_dir = os.path.join(tmp, "hf")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        # random bf16 weights from seed 0, written by the port's own export in
        # HF_SHARD_BYTES shards; config.json is the published one
        published = HF_CONFIGS[HF_PRESET]
        cfg = TransformerConfig.from_hf_config(published, param_dtype=torch.bfloat16)
        written = Transformer(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        t0 = time.perf_counter()
        save_hf_checkpoint(written, cfg, hf_dir, max_shard_bytes=HF_SHARD_BYTES)
        write_s = time.perf_counter() - t0
        with open(os.path.join(hf_dir, "config.json"), "w") as f:
            json.dump(published, f, indent=2)
        shards = sorted(f for f in os.listdir(hf_dir) if f.endswith(".safetensors"))
        hf_bytes = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in shards)
        if len(shards) < 2 or not os.path.exists(os.path.join(hf_dir, INDEX_NAME)):
            raise AssertionError(f"hf trainer: the written checkpoint has shards {shards}")
        t0 = time.perf_counter()
        loaded = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev).module
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        params_equal(loaded, written, "loaded parameters")
        n_params = sum(p.numel() for p in loaded.parameters())
        log(f"hf trainer: TinyLlama-1.1B ({cfg.num_hidden_layers} layers, hidden "
            f"{cfg.hidden_size}, heads {cfg.num_attention_heads}/{cfg.num_key_value_heads}, "
            f"head dim {cfg.head_dim}, {n_params} parameters) written as random bf16 weights "
            f"(seed 0) in {len(shards)} shards ({hf_bytes / 1e9:.3f} GB, index "
            f"{INDEX_NAME}) in {write_s:.2f} s; loaded by build_foundation_model(config_path, "
            f"weights_path) onto the card in {load_s:.2f} s as f32: the loaded parameters "
            f"are bit-equal to the written ones [{card}]")
        if cfg.head_dim != 64:
            raise AssertionError(f"hf trainer: head dim {cfg.head_dim}, expected 64")
        del loaded, written
        torch.cuda.empty_cache()

        # leg A: the YAML as it is (streaming, dyn_bsz, prefetch 2, HF export)
        trainer, rec_a, launches, fallbacks, by_dim, peak, export_s = leg(os.path.join(tmp, "a"))
        a = rec_a.steps
        shapes = {k: v.shape for k, v in rec_a.first_batch.items()}
        for k in ("input_ids", "segment_ids", "position_ids", "labels"):
            if not (rec_a.first_batch[k] == first_batch[k]).all():
                raise AssertionError(f"hf trainer: the trainer's first batch ({k}) is not the "
                                     f"one the D=64 kernel gates held")
        seq = shapes["input_ids"][-1]
        log(f"hf trainer: dyn_bsz batches are {shapes['input_ids']} (seq {seq}"
            f"{'' if seq % 128 == 0 else ', NOT a multiple of 128'}); the first is the one the "
            f"D=64 kernel gates held")
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, HF_STEPS + 1)]
        for i in range(1, HF_STEPS + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} valid_tokens_per_s="
                     f"{float(a[i]['ntokens']) / ms[i - 2] * 1e3:.1f}"
                     if i >= 2 else " (first step: warm-up, not timed)")
            log(f"hf trainer step {i} (leg A, prefetch 2): loss={float(a[i]['loss']):.6f} "
                f"grad_norm={float(a[i]['grad_norm']):.6f} ntokens={int(a[i]['ntokens'])}"
                f"{extra} [{card}]")
        check_steps([dict(loss=float(r["loss"]), grad_norm=float(r["grad_norm"]), step_ok=True)
                     for r in a.values()], "hf trainer")
        n = cfg.num_hidden_layers * HF_STEPS
        check_counts(launches, fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n,
                                           "flash_bwd_dq": n}, "hf trainer")
        if any(by_dim[d][k] != (n if d == 64 else 0) for d in by_dim for k in by_dim[d]):
            raise AssertionError(f"hf trainer: launches by head dim {by_dim}, expected "
                                 f"{n} of each at D=64")
        med = sorted(ms)[len(ms) // 2]
        log(f"hf trainer (TinyLlama-1.1B, {cfg.num_hidden_layers} layers, seq {HF_SEQ}, micro-batch {HF_MICRO_BS}, "
            f"dyn_bsz, streaming jsonl shards, prefetch 2, ctx remat, deterministic algorithms): "
            f"warm steps 2-{HF_STEPS} {', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} "
            f"ms, {HF_MICRO_BS * HF_SEQ / med * 1e3:.1f} tokens/s (packed rows, padding "
            f"included), peak device memory {peak / 2**30:.2f} GiB; HF export (f32) "
            f"{export_s:.2f} s; launches {launches} (all at D=64), FALLBACK_CALLS={fallbacks} "
            f"[{card}]")

        # the export reads back bit-equal to the final parameters
        out = os.path.join(tmp, "a", "hf_ckpt")
        final = trainer.train_state.model
        back = hf_to_params(out, final.cfg, Transformer(final.cfg, None, device=dev))
        params_equal(back, final, "exported parameters read back")
        export_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        log(f"hf trainer: the HF export ({export_bytes / 1e9:.3f} GB) reads back bit-equal to "
            f"the final parameters")
        del trainer, final, back
        destroy_parallel_state()
        torch.cuda.empty_cache()

        # step-1 parity: the bare build_train_step on the same weights and batch
        model = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev).module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=HF_STEPS)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rec_a.first_batch.items()}
        _, m = build_train_step(Transformer.loss_fn)(state, batch)
        bare = float(m["loss"])
        rel = abs(float(a[1]["loss"]) - bare) / abs(bare)
        log(f"hf trainer step-1 parity: trainer loss {float(a[1]['loss']):.6f}, "
            f"build_train_step {bare:.6f} (rel {rel:.2e}, tol {TOL_LOSS_REL})")
        if not rel <= TOL_LOSS_REL:
            raise AssertionError(f"hf trainer step-1 loss departs from build_train_step's ({rel})")
        del model, state, batch, m
        torch.cuda.empty_cache()

        # leg B: prefetch 0 (no export): the same losses bit for bit
        trainer, rec_b, b_launches, b_fallbacks, _, _, _ = leg(
            os.path.join(tmp, "b"), "--train.prefetch_depth=0", "--train.save_hf_weights=false")
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()
        check_counts(b_launches, b_fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n,
                                               "flash_bwd_dq": n}, "hf trainer leg B")
        for i in range(1, HF_STEPS + 1):
            la, lb = float(a[i]["loss"]), float(rec_b.steps[i]["loss"])
            if la != lb:
                raise AssertionError(f"hf trainer: step {i} loss with prefetch 2 {la!r} != "
                                     f"with prefetch 0 {lb!r}")
        log(f"hf trainer: losses of steps 1-{HF_STEPS} with prefetch 2 and prefetch 0 are the "
            f"same bit for bit")
        return launches
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        gc.collect()  # a trainer's reference cycles would hold its ~18 GB of state
        torch.cuda.empty_cache()


def loss_grads(dev, preset: str, layers: int, pins, keep):
    """Gradients of the parameters whose names end with one of ``keep``
    after one ``loss_fn`` backward at full width, ``layers`` deep, S=1024,
    B=4, with the ops pinned as ``pins`` says."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.train_text_step import SEED, bench_config, packed_batches

    cfg = bench_config(preset, num_hidden_layers=layers)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = {k: torch.from_numpy(v[0]).to(dev)
             for k, v in next(packed_batches(cfg.vocab_size, 1024, 4)).items()}
    apply_ops_config(pins)
    try:
        loss, _ = model.loss_fn(batch)
        loss.backward()
    finally:
        apply_ops_config(None)
    return {name: p.grad for name, p in model.named_parameters() if name.endswith(keep)}


def step_parity(dev, preset: str, layers: int, pins, tag: str):
    """One train step with the kernels against the same step with ``pins``."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    kern = run_train_steps(1024, 4, 1, preset=preset, num_layers=layers, device=dev)[0]
    torch.cuda.empty_cache()
    plain = run_train_steps(1024, 4, 1, preset=preset, num_layers=layers, device=dev,
                            ops_config=pins)[0]
    torch.cuda.empty_cache()
    d_loss = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    d_gn = abs(kern["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    log(f"parity ({tag}): loss kernels {kern['loss']:.6f} plain {plain['loss']:.6f} "
        f"(rel {d_loss:.2e}, tol {TOL_LOSS_REL}); grad_norm kernels {kern['grad_norm']:.6f} "
        f"plain {plain['grad_norm']:.6f} (rel {d_gn:.2e}, tol {TOL_GRAD_NORM_REL}); "
        f"moe_aux_loss kernels {kern['moe_aux_loss']:.6f} plain {plain['moe_aux_loss']:.6f}")
    if not (d_loss <= TOL_LOSS_REL and d_gn <= TOL_GRAD_NORM_REL):
        raise AssertionError(f"kernel step disagrees with the plain step ({tag})")


def leaf_parity(g_kern, g_plain):
    worst = 0.0
    for name, ref in g_plain.items():
        rel = ((g_kern[name] - ref).norm() / ref.norm()).item()
        log(f"  grad {name}: |kernels - plain| / |plain| = {rel:.2e} (tol {TOL_LEAF_REL})")
        worst = max(worst, rel) if math.isfinite(rel) else math.inf
    if worst > TOL_LEAF_REL:
        raise AssertionError(f"gradients disagree ({worst} > {TOL_LEAF_REL})")


def phase_parity(dev):
    """Dense: 2 layers, kernels vs plain attention."""
    step_parity(dev, "qwen3_0p6b", 2, {"attention": "xla"}, "dense, 2 layers, S=1024, B=4")
    launched, _ = read_counts()
    proj = ("q_proj", "k_proj", "v_proj", "o_proj")
    g_kern = loss_grads(dev, "qwen3_0p6b", 2, {"attention": "cuda_flash"}, proj)
    now, _ = read_counts()
    if sum(now.values()) - sum(launched.values()) != 2 * 3:  # 2 layers x (K1, K2, K3)
        raise AssertionError(f"kernel leg of the gradient parity launched {now}")
    g_plain = loss_grads(dev, "qwen3_0p6b", 2, {"attention": "xla"}, proj)
    leaf_parity(g_kern, g_plain)
    torch.cuda.empty_cache()


def phase_moe_parity(dev):
    """MoE: 1 layer (the router's input does not depend on any grouped
    GEMM, so both legs route alike), grouped-GEMM kernels vs the plain
    ragged impl."""
    step_parity(dev, MOE_PRESET, 1, {"group_gemm": "xla"}, "MoE, 1 layer, S=1024, B=4")
    launched, _ = read_counts()
    moe = ("router", "gate_proj", "up_proj", "down_proj")
    g_kern = loss_grads(dev, MOE_PRESET, 1, {"group_gemm": "cuda_gmm"}, moe)
    now, _ = read_counts()
    if any(now[k] - launched[k] != want for k, want in
           (("gmm_fwd", 6), ("gmm_dlhs", 3), ("gmm_t", 3))):
        raise AssertionError(f"kernel leg of the MoE gradient parity launched {now}")
    torch.cuda.empty_cache()
    g_plain = loss_grads(dev, MOE_PRESET, 1, {"group_gemm": "xla"}, moe)
    leaf_parity(g_kern, g_plain)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# The dense HF dialects: Gemma-3-1B, Llama-3.2-1B, Qwen2.5-1.5B from HF
# directories through TextTrainer
# --------------------------------------------------------------------------
DIALECT_YAML = """
model:
  config_path: {hf}
  model_path: {hf}
data:
  train_path: {data}
  data_type: pretokenized
  max_seq_len: {seq}
train:
  micro_batch_size: {micro_bs}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  seed: 0
  save_hf_weights: {save_hf}
  log_steps: 1
"""
DIALECT_SEQ = 4096
DIALECT_MICRO_BS = 4
GEMMA_PRESET = "gemma3_1b"
GEMMA_STEPS = 6
DIALECT_STEPS = 3
DIALECT_PRESETS = ("llama3p2_1b", "qwen2p5_1p5b")
DIALECT_NAMES = {"gemma3_1b": "Gemma-3-1B", "llama3p2_1b": "Llama-3.2-1B",
                 "qwen2p5_1p5b": "Qwen2.5-1.5B"}


def random_model(dev, cfg, seed: int = 0):
    """The port's random init from ``seed``, with router correction biases
    drawn from N(0, CORRECTION_BIAS_STD) (the init's 0 would let noaux-tc
    pick by score order alone), and zero-centered norm weights
    at 0, as HF initialises Gemma3's norms (a gain of 1). The reference's
    init puts every norm weight at 1 (``init_params``), a gain of 2 under a
    zero-centered norm at each of Gemma's four norms a layer: the random
    model is then chaotic in bf16 (at 26 layers its bf16 first-token logits
    sit up to 6.8 from the f32 re-score, the logits' own spread ~1.4), so no
    bf16-against-f32 gate could tell a fault from that."""
    from veomni_tpu_torch.models import Transformer

    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if cfg.norm_zero_centered and name.endswith("norm"):
                p.zero_()
            elif name.endswith("e_score_correction_bias"):  # noaux-tc: off the score order
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * CORRECTION_BIAS_STD)
    return model


def write_random_hf_dir(dev, hf_dir: str, preset: str, layers=None):
    """An HF directory of ``preset``'s published config.json (with
    ``num_hidden_layers`` set to ``layers`` where the depth is cut) holding
    random bf16 weights from seed 0 (``random_model``), written by the
    port's save_hf_checkpoint; returns the config."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models.hf_io import save_hf_checkpoint
    from veomni_tpu_torch.train_text_step import HF_CONFIGS

    published = dict(HF_CONFIGS[preset])
    if layers is not None:
        published["num_hidden_layers"] = layers
    cfg = TransformerConfig.from_hf_config(published, param_dtype=torch.bfloat16)
    written = random_model(dev, cfg)
    save_hf_checkpoint(written, cfg, hf_dir)
    del written
    torch.cuda.empty_cache()
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(published, f, indent=2)
    return cfg


def write_dialect_run(dev, tmp: str, preset: str, steps: int, save_hf: bool,
                      layers=None, micro_bs: int = DIALECT_MICRO_BS) -> str:
    """A run's inputs under ``tmp``: the HF directory (random bf16 weights
    from seed 0 by ``random_model``, written by the port's
    save_hf_checkpoint, then the published config.json, with
    ``num_hidden_layers`` set to ``layers`` where the depth is cut), a
    pretokenized corpus (documents of S/16-S/2 tokens, 256-2048 at S 4096,
    uniform over the model's vocabulary, seed 0) and the YAML; returns the
    YAML's path."""
    hf_dir = os.path.join(tmp, "hf")
    cfg = write_random_hf_dir(dev, hf_dir, preset, layers)
    rng = np.random.default_rng(0)
    data = os.path.join(tmp, "corpus.jsonl")
    # the loader offers 8 documents a row to the packing collator, a
    # micro-batch at a time: enough for every step's offer, in one epoch
    with open(data, "w") as f:
        for _ in range(8 * micro_bs * (steps + 2)):
            n = int(rng.integers(DIALECT_SEQ // 16, DIALECT_SEQ // 2 + 1))
            f.write(json.dumps({"input_ids": rng.integers(0, cfg.vocab_size, n).tolist()}) + "\n")
    path = os.path.join(tmp, f"{preset}.yaml")
    with open(path, "w") as f:
        f.write(DIALECT_YAML.format(hf=hf_dir, data=data, seq=DIALECT_SEQ,
                                    micro_bs=micro_bs, steps=steps,
                                    save_hf=str(save_hf).lower()))
    return path


def check_hf_export(dev, tag: str, out: str, final) -> None:
    """The trainer's HF export in ``out`` reads back bit-equal to the
    model ``final``'s parameters."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.hf_io import hf_to_params

    back = hf_to_params(out, final.cfg, Transformer(final.cfg, None, device=dev))
    bad = [n for (n, x), (_, y) in zip(back.named_parameters(), final.named_parameters())
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{tag}: the HF export differs from the final parameters "
                             f"in {len(bad)} tensors, e.g. {bad[:3]}")
    nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    log(f"{tag}: the HF export ({nbytes / 1e9:.3f} GB) reads back bit-equal to the final "
        f"parameters")


def phase_hf_dialect(dev, card, preset: str, steps: int, *, export: bool):
    """One dense HF dialect at full width and depth through ``TextTrainer``
    from an HF directory: ``steps`` steps at seq 4096, f32 master, bf16
    compute, ctx remat, AdamW. K1-K3 launch once a step for each
    full-attention layer, all at the model's head dim; each windowed layer
    is one of the reference's feature dispatches to the plain attention
    (``FALLBACK_CALLS``). The step-1 loss is held to the same step with
    the plain attention pinned; with ``export`` the HF export at the end
    reads back bit-equal to the final parameters. Returns (launches, the
    first packed batch's segment ids [B, S] on the card)."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    name = DIALECT_NAMES[preset]
    tag = f"hf dialect {name}"

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=float(m["loss"]),
                                                 grad_norm=float(m["grad_norm"]),
                                                 t=time.perf_counter())

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{preset}_")
    try:
        t0 = time.perf_counter()
        yaml_path = write_dialect_run(dev, tmp, preset, steps, export)
        write_s = time.perf_counter() - t0
        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={tmp}/out"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        cfg = trainer.train_state.model.cfg
        # the trainer phase holds checkpoints; this one saves none (a full
        # f32 state of 16-25 GB would cost the run ~30 s)
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec = Record()
        trainer.callbacks.append(rec)
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        by_dim = {d: dict(c) for d, c in fa.LAUNCHES_BY_HEAD_DIM.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        windows = [cfg.window_for_layer(i) for i in range(cfg.num_hidden_layers)]
        n_full = windows.count(0)
        n_params = sum(p.numel() for p in trainer.train_state.model.parameters())
        log(f"{tag}: {cfg.num_hidden_layers} layers ({n_full} full attention, "
            f"{len(windows) - n_full} with window {max(windows)}), hidden {cfg.hidden_size}, "
            f"heads {cfg.num_attention_heads}/{cfg.num_key_value_heads}, head dim "
            f"{cfg.head_dim}, vocab {cfg.vocab_size}, {n_params} parameters; HF directory "
            f"and corpus written in {write_s:.1f} s; TextTrainer at seq {DIALECT_SEQ}, "
            f"micro-batch {DIALECT_MICRO_BS}, f32 master, bf16 compute, ctx remat, AdamW "
            f"[{card}]")
        a = rec.steps
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], tag)
        tokens = DIALECT_MICRO_BS * DIALECT_SEQ
        flops = FlopsCounter.from_config(cfg).batch_flops(tokens, DIALECT_SEQ)
        peak_flops = get_device_peak_flops(dev)
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
        for i in range(1, steps + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} tokens_per_s={tokens / ms[i - 2] * 1e3:.1f} "
                     f"mfu={flops / (ms[i - 2] / 1e3) / peak_flops:.4f}" if i >= 2
                     else " (first step: warm-up, not timed)")
            log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f}"
                f"{extra} [{card}]")
        want = {"flash_fwd": n_full * steps, "flash_bwd_dkv": n_full * steps,
                "flash_bwd_dq": n_full * steps}
        bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
        if bad or fallbacks["flash"] != (len(windows) - n_full) * steps:
            raise AssertionError(f"{tag}: launches {launches} (expected {want}), "
                                 f"FALLBACK_CALLS {fallbacks} (expected "
                                 f"{(len(windows) - n_full) * steps}: the windowed layers)")
        if any(by_dim[d][k] != (want[k] if d == cfg.head_dim else 0)
               for d in by_dim for k in by_dim[d]):
            raise AssertionError(f"{tag}: launches by head dim {by_dim}, expected all at "
                                 f"D={cfg.head_dim}")
        med = sorted(ms)[len(ms) // 2]
        log(f"{tag}: warm steps 2-{steps} {', '.join(f'{x:.1f}' for x in ms)} ms, median "
            f"{med:.1f} ms, {tokens / med * 1e3:.1f} tokens/s (packed rows, padding included), "
            f"MFU {flops / (med / 1e3) / peak_flops:.4f} (full causal attention counted on "
            f"every layer, as the reference's FlopsCounter does); peak device memory "
            f"{peak / 2**30:.2f} GiB; launches {launches} (all at D={cfg.head_dim}: "
            f"{n_full} full-attention layers x {steps} steps), FALLBACK_CALLS {fallbacks} "
            f"({len(windows) - n_full} windowed layers x {steps} steps, the reference's "
            f"dispatch to the plain attention) [{card}]")
        if export:
            check_hf_export(dev, tag, os.path.join(tmp, "out", "hf_ckpt"),
                            trainer.train_state.model)
        first = rec.first_batch
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # step-1 parity: the same weights and batch with the plain attention
        # pinned (every layer through _attention_xla: its blockwise form at
        # S 4096)
        hf_dir = os.path.join(tmp, "hf")
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev,
                                    ops_implementation={"attention": "xla"},
                                    remat_policy="ctx")
        model = fm.module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=steps)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        reset_all_counts()
        try:
            _, m = build_train_step(Transformer.loss_fn)(state, batch)
        finally:
            from veomni_tpu_torch.ops.kernel_registry import apply_ops_config

            apply_ops_config(None)
        plain = float(m["loss"])
        plain_launches, _ = read_counts()
        rel = abs(a[1]["loss"] - plain) / abs(plain)
        log(f"{tag} step-1 parity: trainer (kernels) loss {a[1]['loss']:.6f}, plain attention "
            f"{plain:.6f} (rel {rel:.2e}, tol {TOL_LOSS_REL}; {cfg.num_hidden_layers} layers, "
            f"nothing cut; the plain leg launched {plain_launches})")
        if not rel <= TOL_LOSS_REL or any(plain_launches.values()):
            raise AssertionError(f"{tag}: step-1 loss departs from the plain attention's "
                                 f"({rel}) or the plain leg launched kernels")
        del fm, model, state, batch, m
        gc.collect()
        torch.cuda.empty_cache()
        seg = torch.from_numpy(first["segment_ids"][0]).to(dev)
        return launches, seg
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# per preset: (q heads, kv heads, head dim) of its kernel rows
DIALECT_HEADS = {"gemma3_1b": (4, 1, 256), "llama3p2_1b": (32, 8, 64),
                 "qwen2p5_1p5b": (12, 2, 128)}


def dialect_rows(dev, preset: str, seg):
    """K1-K3 held and timed at the preset's head layout on its trainer
    phase's own first packed batch; Gemma-3-1B's rows also carry its first
    row alone (micro-batch 1). Each row counts the launches of its preset's
    paths only (``path_layout``)."""
    hq, hkv, d = DIALECT_HEADS[preset]
    name = DIALECT_NAMES[preset]
    rows = phase_flash(dev, seg, hq, hkv, f"{name} layout", d=d)
    torch.cuda.empty_cache()
    if preset == GEMMA_PRESET:
        mb1 = phase_flash(dev, seg[:1].contiguous(), hq, hkv, f"{name}, micro-batch 1", d=d)
        for row, one in zip(rows, mb1):
            row["micro_batch_1"] = {k: one[k] for k in LAYOUT_KEYS}
        torch.cuda.empty_cache()
    for row in rows:
        row["path_layout"] = preset
    return rows


def phase_hf_trainer_gemma3(dev, card):
    """Gemma-3-1B at full width and all 26 layers, 6 steps, HF export; then
    K1-K3 on its first packed batch. Returns ({path: (launches, head dim,
    preset)}, kernel rows)."""
    launches, seg = phase_hf_dialect(dev, card, GEMMA_PRESET, GEMMA_STEPS, export=True)
    paths = {"hf_trainer_gemma3": (launches, DIALECT_HEADS[GEMMA_PRESET][2], GEMMA_PRESET)}
    return paths, dialect_rows(dev, GEMMA_PRESET, seg)


def phase_dialects(dev, card):
    """Llama-3.2-1B and Qwen2.5-1.5B at full width and depth, 3 steps each,
    each followed by K1-K3 on its first packed batch."""
    paths, rows = {}, []
    for preset in DIALECT_PRESETS:
        launches, seg = phase_hf_dialect(dev, card, preset, DIALECT_STEPS, export=False)
        paths[f"dialects_{preset}"] = (launches, DIALECT_HEADS[preset][2], preset)
        rows += dialect_rows(dev, preset, seg)
    return paths, rows


# --------------------------------------------------------------------------
# The deepseek MoE dialect: Moonlight-16B-A3B and DeepSeek-V2-Lite from HF
# directories through TextTrainer
# --------------------------------------------------------------------------
MOONLIGHT_PRESET = "moonlight_16b_a3b"
MOONLIGHT_LAYERS = 4  # of 27: the leading dense layer and 3 MoE layers
MOONLIGHT_STEPS = 4
V2_LITE_PRESET = "deepseek_v2_lite"
V2_LITE_LAYERS = 2  # the leading dense layer and 1 MoE layer
V2_LITE_STEPS = 3
DEEPSEEK_MICRO_BS = 2  # x seq 4096: M = 8192 x top-6 = 49152 routed rows per MoE layer
DEEPSEEK_NAMES = {MOONLIGHT_PRESET: "Moonlight-16B-A3B", V2_LITE_PRESET: "DeepSeek-V2-Lite"}
# the kernel rows of K4-K6 at the deepseek expert widths (K/N 2048/1408 and
# 1408/2048) count the launches of both deepseek paths
DEEPSEEK_LAYOUT = "deepseek 2048x1408"
# the random HF directory's router correction biases: N(0, 0.05), against a
# spread of ~0.01 between neighbouring sigmoid scores of 64 experts at the
# init's router width, so noaux-tc picks other experts than the score order
CORRECTION_BIAS_STD = 0.05
# chip_smoke's own f32 version of one MLA + MoE layer against the port's
# bf16 layer, token by token (a token's head vectors flattened):
#   rms(got - ref) <= LAYER_RTOL * rms(ref token) + LAYER_ATOL * rms(ref),
# The port runs the layer in bf16 (q/k/v, probabilities, expert outputs, the
# weighted sum each rounded to 2^-9 relative), so a token lands ~1e-2 off;
# 5% of the token's size, 2% of the tensor's for tokens near zero. A rope
# that turns the wrong channels, a missing shared expert or an expert
# choice without the correction bias moves most tokens by 20% or more.
LAYER_RTOL = 5e-2
LAYER_ATOL = 2e-2
# DeepSeek-V3's router (its published config.json): 256 experts in 8 groups,
# top-4 groups, top-8, sigmoid noaux-tc, routed scaling 2.5, hidden 7168
V3_ROUTER = dict(hidden_size=7168, num_experts=256, num_experts_per_tok=8, n_group=8,
                 topk_group=4, scoring_func="sigmoid", norm_topk_prob=True,
                 routed_scaling_factor=2.5)
V3_ROUTER_TOKENS = 4096


def deepseek_param_count(cfg) -> int:
    """The model's parameter count from its config, counted here: MLA
    attention and two norms per layer, a dense gated MLP on the leading
    ``first_k_dense_replace`` layers, router, correction bias, routed and
    shared experts on the others, embedding, final norm and head."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q = (h * cfg.q_lora_rank + cfg.q_lora_rank + cfg.q_lora_rank * nh * (dn + dr)
         if cfg.q_lora_rank else h * nh * (dn + dr))
    attn = q + h * (r + dr) + r + r * nh * (dn + dv) + nh * dv * h + 2 * h
    dense = 3 * h * cfg.intermediate_size
    e, im = cfg.num_experts, cfg.moe_intermediate_size
    moe = h * e + (e if cfg.scoring_func == "sigmoid" else 0) + 3 * e * h * im
    moe += 3 * h * im * cfg.n_shared_experts
    k = cfg.first_k_dense_replace
    body = k * (attn + dense) + (cfg.num_hidden_layers - k) * (attn + moe)
    return body + cfg.vocab_size * h * (1 if cfg.tie_word_embeddings else 2) + h


def reference_route(logits, bias, cfg):
    """chip_smoke's own routing (f32 logits [T,E] in): scores (sigmoid, or
    softmax), the expert choice (scores + correction bias for sigmoid)
    limited to each token's best ``topk_group`` groups (a group scored by
    its two best choices, or its best softmax score), the top k of the
    choice (the lower index first among equals), the weights from the
    scores (renormed, scaled)."""
    t, e = logits.shape
    scores = logits.sigmoid() if cfg.scoring_func == "sigmoid" else logits.softmax(-1)
    choice = scores + bias if cfg.scoring_func == "sigmoid" else scores.clone()
    if cfg.n_group and cfg.topk_group and cfg.n_group > 1:
        g = choice.view(t, cfg.n_group, e // cfg.n_group)
        if cfg.scoring_func == "sigmoid":
            group_score = g.sort(dim=-1, descending=True, stable=True).values[..., :2].sum(-1)
        else:
            group_score = g.max(-1).values
        best = group_score.argsort(dim=-1, descending=True, stable=True)[:, :cfg.topk_group]
        keep = torch.zeros(t, cfg.n_group, dtype=torch.bool, device=logits.device)
        keep[torch.arange(t, device=logits.device)[:, None], best] = True
        keep = keep[:, :, None].expand(t, cfg.n_group, e // cfg.n_group).reshape(t, e)
        choice = choice.masked_fill(~keep, -math.inf if cfg.scoring_func == "sigmoid" else 0.0)
    idx = choice.argsort(dim=-1, descending=True, stable=True)[:, :cfg.num_experts_per_tok]
    w = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def phase_v3_router(dev, card):
    """``route_tokens`` at DeepSeek-V3's router width on the card, against
    the same call on the CPU (the port's plain path) and chip_smoke's own
    routing: 4096 tokens, hidden 7168, 256 experts in 8 groups (top-4
    groups), top-8, sigmoid with a nonzero correction bias. The inputs sit
    on coarse grids (x in 2^-3 steps, router in 2^-5, the bias in 2^-6), so
    each f32 logit is exact in any summation order and many tie: the three
    must pick the same experts, the lower index first among equals, and
    their weights agree to rtol 1e-6."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models.transformer import route_tokens

    cfg = TransformerConfig(model_type="deepseek_v3", **V3_ROUTER)
    gen = torch.Generator().manual_seed(3)
    x = (torch.randint(-2, 3, (V3_ROUTER_TOKENS, 7168), generator=gen) / 8).bfloat16()
    router = (torch.randint(-2, 3, (7168, 256), generator=gen) / 32).bfloat16()
    bias = (torch.randint(-4, 5, (256,), generator=gen) / 64).bfloat16()
    idx_c, w_c, _ = route_tokens(x, router, cfg, bias)
    idx_g, w_g, _ = route_tokens(x.to(dev), router.to(dev), cfg, bias.to(dev))
    torch.cuda.synchronize()
    idx_r, w_r = reference_route(x.double() @ router.double(), bias.double(), cfg)
    same_card = torch.equal(idx_g.cpu(), idx_c)
    same_ref = torch.equal(idx_c, idx_r)
    w_err = max(((w_g.cpu() - w_c).abs() / w_c.abs()).max().item(),
                ((w_c.double() - w_r).abs() / w_r.abs()).max().item())
    score_order = (x.float() @ router.float()).argsort(dim=-1, descending=True, stable=True)[:, :8]
    moved = (idx_c.sort(-1).values != score_order.sort(-1).values).any(-1).float().mean().item()
    log(f"router check (DeepSeek-V3 width): {V3_ROUTER_TOKENS} tokens, hidden 7168, 256 experts "
        f"in 8 groups (top-4), top-8, sigmoid + correction bias: indices card == CPU "
        f"{same_card}, CPU == chip_smoke's routing {same_ref}; weights worst rel err "
        f"{w_err:.2e} (tol 1e-6); the bias and the groups move {moved:.1%} of the tokens' "
        f"expert sets off the plain score order [{card}]"
        + ("" if same_card and same_ref and w_err <= 1e-6 else " FAILED"))
    if not (same_card and same_ref and w_err <= 1e-6):
        raise AssertionError("router check (DeepSeek-V3 width): routing disagrees")


def token_check(tag, got, ref):
    """Hold ``got`` to ``ref`` [T, ...] token by token (LAYER_RTOL,
    LAYER_ATOL); log the worst ratio and raise if any token is over."""
    got, ref = got.float().flatten(1), ref.float().flatten(1)
    err = (got - ref).pow(2).mean(1).sqrt()
    allowed = LAYER_RTOL * ref.pow(2).mean(1).sqrt() + LAYER_ATOL * ref.pow(2).mean().sqrt()
    ratio = err / allowed
    over = int((ratio > 1).sum())
    log(f"{tag}: worst token error/allowed {ratio.max().item():.3f}, {over} of {ratio.numel()} "
        f"tokens over" + (" FAILED" if over else ""))
    if over:
        raise AssertionError(f"{tag}: the port's layer disagrees with chip_smoke's")


def phase_deepseek_layer(dev, card, model, batch):
    """The first MoE layer (layer 1) of the model as loaded, on the first
    row of ``batch`` [B, S], held to chip_smoke's own f32 version of it:
    the MLA block's q and k (q, the kv latent and its norm, the rope as a
    complex turn of each adjacent channel pair by position x
    theta^(-2i/d)) and its output (causal and same-document attention,
    o_proj) from the same input, and the MoE
    block (router, correction bias, top-k, the 64 experts one at a time,
    the shared experts) from the port's MoE input. Returns the group sizes
    of the layer's routing over the whole batch (the kernel rows' M)."""
    from veomni_tpu_torch.models.transformer import expert_counts, route_tokens

    cfg, dt = model.cfg, model.cfg.dtype
    layer = model.layers[1]
    p = {n: w.detach().to(dt).float() for n, w in layer.named_parameters()}
    nh, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    r, h = cfg.kv_lora_rank, cfg.hidden_size
    ids, pos, seg = (batch[k].to(dev) for k in ("input_ids", "position_ids", "segment_ids"))
    with torch.no_grad():
        hidden, cos, sin = model.embed_and_rotary(ids, pos)
        q, k, v = layer._qkv(hidden, cos, sin)
        attn = layer._attend(q, k, v, seg)
        h1, x = layer.mlp_input(hidden, attn)
        got_attn = (h1 - hidden)[0]
        flat = x.reshape(-1, h)
        got_moe, _ = layer.moe(flat[:ids.shape[1]])
        idx_all, _, _ = route_tokens(flat, layer.router.to(dt), cfg,
                                     layer.e_score_correction_bias.to(dt))
        sizes = expert_counts(idx_all.reshape(-1), cfg.num_experts)

        def rms(t, w):
            return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * w

        def turn(t, position):  # [S, n, dr]: adjacent pairs as complex numbers
            inv = cfg.rope_theta ** (-torch.arange(0, dr, 2, device=dev).double() / dr)
            ang = position.double()[:, None] * inv
            z = torch.view_as_complex(t.double().reshape(*t.shape[:-1], dr // 2, 2).contiguous())
            return torch.view_as_real(z * torch.polar(torch.ones_like(ang), ang)[:, None]) \
                .flatten(-2).float()

        s = ids.shape[1]
        hf = hidden[0].float()
        xa = rms(hf, p["input_layernorm"])
        qf = (xa @ p["q_proj"]).view(s, nh, dn + dr)
        kv_a = xa @ p["kv_a_proj_with_mqa"]
        kv = (rms(kv_a[:, :r], p["kv_a_layernorm"]) @ p["kv_b_proj"]).view(s, nh, dn + dv)
        qf = torch.cat([qf[..., :dn], turn(qf[..., dn:], pos[0])], -1)
        kf = torch.cat([kv[..., :dn], turn(kv_a[:, None, r:], pos[0]).expand(s, nh, dr)], -1)
        logits = torch.einsum("qhd,khd->hqk", qf, kf) * (dn + dr) ** -0.5
        visible = (torch.arange(s, device=dev)[:, None] >= torch.arange(s, device=dev)[None]) \
            & (seg[0][:, None] == seg[0][None])
        probs = logits.masked_fill(~visible, -math.inf).softmax(-1)
        ref_attn = torch.einsum("hqk,khd->qhd", probs, kv[..., dn:]).reshape(s, nh * dv) \
            @ p["o_proj"]
        del logits, probs
        xm = flat[:s].float()
        ridx, rw = reference_route(xm @ p["router"], p["e_score_correction_bias"], cfg)
        ref_moe = torch.zeros_like(xm)
        for e in range(cfg.num_experts):
            tok, slot = (ridx == e).nonzero(as_tuple=True)
            if tok.numel():
                xe = xm[tok]
                ye = (torch.nn.functional.silu(xe @ p["experts.gate_proj"][e])
                      * (xe @ p["experts.up_proj"][e])) @ p["experts.down_proj"][e]
                ref_moe.index_add_(0, tok, ye * rw[tok, slot, None])
        ref_moe += (torch.nn.functional.silu(xm @ p["shared_experts.gate_proj"])
                    * (xm @ p["shared_experts.up_proj"])) @ p["shared_experts.down_proj"]
    name = DEEPSEEK_NAMES[MOONLIGHT_PRESET]
    log(f"{name} layer check: layer 1 (MLA + MoE) on the first row ({s} tokens) against "
        f"chip_smoke's f32 layer [{card}]")
    token_check(f"{name} layer check: MLA q/k", torch.cat([q[0], k[0]], 1),
                torch.cat([qf, kf], 1))
    token_check(f"{name} layer check: MLA block", got_attn, ref_attn)
    token_check(f"{name} layer check: MoE block", got_moe, ref_moe)
    return sizes


def phase_hf_deepseek(dev, card, preset: str, layers: int, steps: int, *, export: bool):
    """One deepseek-dialect model at its published widths, ``layers`` deep,
    through ``TextTrainer`` from an HF directory (random bf16 weights from
    seed 0, correction biases drawn nonzero): ``steps`` steps at seq 4096 x
    micro-batch 2, f32 master, bf16 compute, ctx remat, AdamW. Before the
    trainer, the parameter count against the one counted from the config
    and (Moonlight) the layer check. K4 launches 6 times per MoE layer and
    step (gate, up, down, and their ctx recompute), K5 and K6 3 times; K1-K3
    never (MLA's v head dim 128 against q/k's 192 takes the reference's
    dispatch to the plain attention, one FALLBACK_CALLS per layer and step).
    The step-1 loss, grad norm and router aux loss are held to the same step
    with the plain ragged grouped GEMM pinned; with ``export`` the HF export
    reads back bit-equal to the final parameters. Returns (launches, group
    sizes of layer 1's routing on a packed batch or None)."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.train_text_step import packed_batches
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    name = DEEPSEEK_NAMES[preset]
    tag = f"hf deepseek {name}"

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                moe_aux_loss=float(m["moe_aux_loss"]), t=time.perf_counter())

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{preset}_")
    try:
        t0 = time.perf_counter()
        yaml_path = write_dialect_run(dev, tmp, preset, steps, export, layers=layers,
                                      micro_bs=DEEPSEEK_MICRO_BS)
        write_s = time.perf_counter() - t0
        hf_dir = os.path.join(tmp, "hf")
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev)
        cfg, model = fm.config, fm.module
        n_params = sum(w.numel() for w in model.parameters())
        want_params = deepseek_param_count(cfg)
        n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
        log(f"{tag}: {cfg.num_hidden_layers} of 27 layers ({cfg.first_k_dense_replace} dense, "
            f"{n_moe} MoE), hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads, MLA "
            f"kv_lora_rank {cfg.kv_lora_rank}, q/k head {cfg.qk_head_dim}, v head "
            f"{cfg.v_head_dim}, {cfg.num_experts} experts top-{cfg.num_experts_per_tok} of width "
            f"{cfg.moe_intermediate_size} + {cfg.n_shared_experts} shared, {cfg.scoring_func} "
            f"routing, vocab {cfg.vocab_size}; {n_params} parameters (counted from the config: "
            f"{want_params}); HF directory and corpus written in {write_s:.1f} s [{card}]")
        if n_params != want_params:
            raise AssertionError(f"{tag}: {n_params} parameters, the config gives {want_params}")
        sizes = None
        if preset == MOONLIGHT_PRESET:
            batch = {k: torch.from_numpy(v[0]) for k, v in
                     next(packed_batches(cfg.vocab_size, DIALECT_SEQ, DEEPSEEK_MICRO_BS)).items()}
            sizes = phase_deepseek_layer(dev, card, model, batch)
        del fm, model
        gc.collect()
        torch.cuda.empty_cache()

        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={tmp}/out"])
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec = Record()
        trainer.callbacks.append(rec)
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        a = rec.steps
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], tag)
        tokens = DEEPSEEK_MICRO_BS * DIALECT_SEQ
        flops = FlopsCounter.from_config(cfg).batch_flops(tokens, DIALECT_SEQ)
        peak_flops = get_device_peak_flops(dev)
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
        for i in range(1, steps + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} tokens_per_s={tokens / ms[i - 2] * 1e3:.1f} "
                     f"mfu={flops / (ms[i - 2] / 1e3) / peak_flops:.4f}" if i >= 2
                     else " (first step: warm-up, not timed)")
            log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f} "
                f"moe_aux_loss={a[i]['moe_aux_loss']:.6f}{extra} [{card}]")
        want = {"gmm_fwd": 6 * n_moe * steps, "gmm_dlhs": 3 * n_moe * steps,
                "gmm_t": 3 * n_moe * steps}
        med = sorted(ms)[len(ms) // 2]
        log(f"{tag}: launches {launches} (reckoned from the code: {want}: per MoE layer and "
            f"step K4 x 6 (gate, up, down and their ctx recompute), K5 x 3, K6 x 3), "
            f"FALLBACK_CALLS {fallbacks} (expected {cfg.num_hidden_layers * steps}: every MLA "
            f"layer once a step); warm steps 2-{steps} {', '.join(f'{x:.1f}' for x in ms)} ms, "
            f"median {med:.1f} ms, {tokens / med * 1e3:.1f} tokens/s, MFU "
            f"{flops / (med / 1e3) / peak_flops:.4f} (the reference's FlopsCounter: MLA and "
            f"shared-expert terms, every layer counted as MoE); peak device memory "
            f"{peak / 2**30:.2f} GiB [{card}]")
        bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
        if bad or fallbacks["flash"] != cfg.num_hidden_layers * steps:
            raise AssertionError(f"{tag}: launches {launches} (expected {want}), "
                                 f"FALLBACK_CALLS {fallbacks}")
        if export:
            check_hf_export(dev, tag, os.path.join(tmp, "out", "hf_ckpt"),
                            trainer.train_state.model)
        first = rec.first_batch
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # step-1 parity: the same weights and batch with the plain ragged
        # grouped GEMM pinned
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev,
                                    ops_implementation={"group_gemm": "xla"}, remat_policy="ctx")
        model = fm.module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=steps)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        reset_all_counts()
        try:
            _, m = build_train_step(Transformer.loss_fn)(state, batch)
        finally:
            apply_ops_config(None)
        plain = {k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux_loss")}
        plain_launches, _ = read_counts()
        rel = {k: abs(a[1][k] - plain[k]) / abs(plain[k]) for k in plain}
        tol = {"loss": TOL_LOSS_REL, "grad_norm": TOL_GRAD_NORM_REL, "moe_aux_loss": TOL_LOSS_REL}
        log(f"{tag} step-1 parity: trainer (K4-K6) against the plain ragged grouped GEMM: "
            + "; ".join(f"{k} {a[1][k]:.6f} vs {plain[k]:.6f} (rel {rel[k]:.2e}, tol {tol[k]})"
                        for k in plain)
            + f"; the plain leg launched {plain_launches}")
        if any(rel[k] > tol[k] for k in rel) or any(plain_launches.values()):
            raise AssertionError(f"{tag}: step 1 departs from the plain grouped GEMM's ({rel}) "
                                 f"or the plain leg launched kernels")
        del fm, model, state, batch, m
        gc.collect()
        torch.cuda.empty_cache()
        return launches, sizes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_hf_trainer_moonlight(dev, card):
    """Moonlight-16B-A3B at its published widths, 4 of 27 layers (the
    leading dense layer and 3 MoE layers), 4 steps from an HF directory with
    its HF export, after the router check at DeepSeek-V3's width; then K4-K6
    held and timed at its expert widths on layer 1's routing of a packed
    batch. Returns ({path: (launches, head dim, layout)}, kernel rows)."""
    phase_v3_router(dev, card)
    launches, sizes = phase_hf_deepseek(dev, card, MOONLIGHT_PRESET, MOONLIGHT_LAYERS,
                                        MOONLIGHT_STEPS, export=True)
    s = sizes.cpu()
    log(f"grouped GEMM kernels at Moonlight-16B-A3B's expert widths: layer 1's routing of a "
        f"packed seq-{DIALECT_SEQ} x {DEEPSEEK_MICRO_BS} batch: M={int(s.sum())} rows over "
        f"E={s.numel()} experts, rows/expert min {int(s.min())} median {int(s.median())} "
        f"max {int(s.max())}")
    rows = gmm_case(dev, sizes, 2048, 1408, "Moonlight gate/up: K=2048 N=1408", timed=True)
    rows += gmm_case(dev, sizes, 1408, 2048, "Moonlight down: K=1408 N=2048", timed=True)
    for row in rows:
        row["path_layout"] = DEEPSEEK_LAYOUT
    # MLA: q/k head dim 192, so no flash row counts these paths
    return {"hf_trainer_moonlight": (launches, 192, DEEPSEEK_LAYOUT)}, rows


def phase_deepseek_v2_lite(dev, card):
    """DeepSeek-V2-Lite at its published widths, 2 of 27 layers, 3 steps:
    softmax greedy routing without renorm, yarn rope with its mscale on the
    MLA softmax scale."""
    launches, _ = phase_hf_deepseek(dev, card, V2_LITE_PRESET, V2_LITE_LAYERS, V2_LITE_STEPS,
                                    export=False)
    return {"deepseek_v2_lite": (launches, 192, DEEPSEEK_LAYOUT)}, []


# --------------------------------------------------------------------------
# The SFT path: conversation data through the port's tokenizer, LoRA and the
# optimizer's parameter groups, at configs/text/lora_sft.yaml's knobs
# --------------------------------------------------------------------------
SFT_YAML = os.path.join("configs", "text", "lora_sft.yaml")
TOKENIZER_FIXTURES = os.path.join("tests", "fixtures", "tokenizers")
SFT_DOCS = ("README.md", "SURVEY.md", "docs/serving.md", "docs/performance.md",
            "docs/testing.md", "docs/observability.md", "docs/resilience.md")
SFT_ROWS = 192
SFT_SEQ = 4096  # lora_sft.yaml's max_seq_len
SFT_MICRO_BS = 2  # and micro_batch_size
SFT_DENSE_STEPS = 4
SFT_GROUPS_STEPS = 2
SFT_FREEZE = ["^embed_tokens$"]
SFT_SCALES = {r"layers\.(q|k|v|o)_proj$": 0.1}
# weight decay, so that a frozen tensor with a zero gradient would still move
# if its update were not scaled by 0
SFT_GROUPS_DECAY = 0.1
# Qwen3-30B-A3B under LoRA: the frozen f32 base is ~2.49 GB a layer and the
# rank-16 adapters with their gradient and AdamW moments ~0.28 GB; with the
# embedding and head (2.49 GB), one layer's merged experts and their
# gradients in flight and the head's logits, 16 layers are reckoned at a
# ~59 GB peak (PERF.md §4)
SFT_MOE_LAYERS = 16
SFT_MOE_STEPS = 4
SFT_MOE_CAPACITY = 2.0  # configs/text/qwen3_moe_ep.yaml's knob, read only under EP


def sft_conversations(path: str, rows: int, seed: int = 0) -> None:
    """Chat rows built from the paragraphs of the repo's docs: every other
    row opens with a system turn, then two or three user/assistant pairs,
    each turn one paragraph; no paragraph is used twice in a row, so each
    turn's text tells whose it is."""
    paras = []
    for name in SFT_DOCS:
        with open(name, encoding="utf-8") as f:
            paras += [p.strip() for p in f.read().split("\n\n") if len(p.strip()) > 80]
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(rows):
            picks = rng.choice(len(paras), size=7, replace=False)
            msgs = ([{"role": "system", "content": paras[picks[6]]}] if r % 2 else [])
            for i in range(2 * int(rng.integers(2, 4))):
                msgs.append({"role": ("user", "assistant")[i % 2], "content": paras[picks[i]]})
            f.write(json.dumps({"messages": msgs}) + "\n")


def check_label_mask(tokenizer, transform, rows, tag: str) -> int:
    """Every row through ``transform``: the decoded supervised runs hold
    each assistant turn's text and no user or system text, the decoded
    masked runs hold every user and system text, and a supervised label is
    its input id. Returns the number of supervised tokens."""
    supervised = 0
    for row in rows:
        enc = transform(row)
        ids, labels = enc["input_ids"], enc["labels"]
        if len(ids) != len(labels) or any(lab not in (-100, i) for lab, i in zip(labels, ids)):
            raise AssertionError(f"{tag}: labels are not the ids or -100")
        runs = {True: [], False: []}
        start = 0
        for j in range(1, len(ids) + 1):
            if j == len(ids) or (labels[j] == -100) != (labels[start] == -100):
                runs[labels[start] != -100].append(tokenizer.decode(ids[start:j]))
                start = j
        sup, masked = "\n".join(runs[True]), "\n".join(runs[False])
        for msg in row["messages"]:
            own = msg["role"] == "assistant"
            if msg["content"] not in (sup if own else masked) or (
                    not own and msg["content"] in sup):
                raise AssertionError(f"{tag}: a {msg['role']} turn's text is "
                                     f"{'not ' if own else ''}supervised")
        supervised += sum(lab != -100 for lab in labels)
    return supervised


def tensors_digest(tensors):
    """Per tensor, on the card: (sum of its 32-bit words, their sum weighted
    by a position hash) in int64; any changed word changes the second."""
    out = []
    with torch.no_grad():
        for t in tensors:
            words = t.detach().contiguous().view(-1).view(torch.int32)
            s1 = torch.zeros((), dtype=torch.int64, device=t.device)
            s2 = torch.zeros((), dtype=torch.int64, device=t.device)
            for lo in range(0, words.numel(), 1 << 24):
                w = words[lo:lo + (1 << 24)].long()
                pos = torch.arange(lo, lo + w.numel(), device=t.device, dtype=torch.int64)
                s1 += w.sum()
                s2 += (w * ((pos * 2654435761) % 2147483647 + 1)).sum()
            out.append((int(s1), int(s2)))
    return out


def sft_args(model_dir: str, weights: str, data: str, out: str, steps: int, *extra):
    """``configs/text/lora_sft.yaml`` with its paths pointed at ``model_dir``
    (config.json and the tokenizer files), ``weights`` and ``data``, run for
    ``steps`` steps with a log line each."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args

    return parse_args(VeOmniArguments, [
        SFT_YAML, f"--model.config_path={model_dir}", f"--model.model_path={weights}",
        f"--data.train_path={data}", f"--train.output_dir={out}",
        f"--train.train_steps={steps}", "--train.log_steps=1", *extra])


def sft_record():
    """A trainer callback recording per step the loss, grad norm and host
    time, and the first batch as the loop shipped it."""
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=float(m["loss"]),
                                                 grad_norm=float(m["grad_norm"]),
                                                 t=time.perf_counter())

    return Record()


def sft_run(dev, card, tag: str, args, steps: int, *, keep_checkpoints: bool = True):
    """``TextTrainer`` on ``args`` with an ``sft_record``: returns (trainer,
    the record, launches, fallbacks, peak bytes, the initial adapters, the
    base digest before) after logging each step; under LoRA every adapter's
    B must have moved off 0."""
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = TextTrainer(args)
    build_s = time.perf_counter() - t0
    if not keep_checkpoints:
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
    rec = sft_record()
    trainer.callbacks.append(rec)
    base = trainer.base_model if trainer.base_model is not None else trainer.train_state.model
    init = {k: v.detach().clone() for k, v in trainer.train_state.model.state_dict().items()}
    before = tensors_digest(base.parameters()) if trainer.base_model is not None else None
    reset_all_counts()
    trainer.train()
    launches, fallbacks = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if trainer.base_model is not None:
        # B starts at 0: an adapter the forward never reads keeps it there
        adapters = trainer.train_state.model
        idle = [p for p in adapters.paths if not adapters.leaf(p).lora_b.any()]
        if idle:
            raise AssertionError(f"{tag}: adapters that never trained: {idle}")
        log(f"{tag}: all {len(adapters.paths)} adapted leaves trained (B moved off 0)")
    cfg = base.cfg
    a = rec.steps
    check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                 for r in a.values()], tag)
    tokens = SFT_MICRO_BS * SFT_SEQ
    flops = FlopsCounter.from_config(cfg).batch_flops(tokens, SFT_SEQ)
    peak_flops = get_device_peak_flops(dev)
    ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
    for i in range(1, steps + 1):
        extra = (f" step_ms={ms[i - 2]:.1f} tokens_per_s={tokens / ms[i - 2] * 1e3:.1f}"
                 if i >= 2 else " (first step: warm-up, not timed)")
        log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f}"
            f"{extra} [{card}]")
    if ms:
        med = sorted(ms)[len(ms) // 2]
        n_train = sum(p.numel() for p in trainer.train_state.model.parameters())
        log(f"{tag}: built in {build_s:.1f} s; warm steps 2-{steps} "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms, "
            f"{tokens / med * 1e3:.1f} tokens/s (packed rows), MFU "
            f"{flops / (med / 1e3) / peak_flops:.4f} (the model's FlopsCounter, which counts "
            f"no adapter work); {n_train} trained parameters; peak device memory "
            f"{peak / 2**30:.2f} GiB [{card}]")
    return trainer, rec, launches, fallbacks, peak, init, before


def sft_parity(dev, tag: str, args, init, before, first, trainer_step, pins):
    """The trainer's step 1 against the same weights, adapters and batch
    with the ops pinned as ``pins`` says: the base read from the HF
    directory, or drawn from the trainer's seed (its digest must equal the
    trainer's base's); returns (rel loss, rel grad norm) after logging
    them; the pinned op's kernels must stay idle in that leg."""
    from veomni_tpu_torch.lora import (
        LoraAdapters,
        LoraConfig,
        apply_lora_to_loss_fn,
        init_lora_params,
    )
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.optim import build_optimizer
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.utils.helper import set_seed

    m, t = args.model, args.train
    fm = build_foundation_model(m.config_path, ops_implementation=pins,
                                dtype=t.compute_dtype, param_dtype=t.param_dtype,
                                remat=t.enable_gradient_checkpointing,
                                remat_policy=t.gradient_checkpointing_policy,
                                **m.config_overrides)
    if m.model_path:
        base = fm.load_hf(m.model_path, device=dev)
    else:
        base = fm.init(set_seed(t.seed, dev), device=dev)
    if tensors_digest(base.parameters()) != before:
        raise AssertionError(f"{tag}: the pinned leg's base is not the trainer's")
    adapters = init_lora_params(None, base, LoraConfig.from_dict(m.lora))
    adapters.load_state_dict(init)
    state = build_train_state(adapters, build_optimizer(adapters, lr=1e-4))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    reset_all_counts()
    try:
        _, m = build_train_step(apply_lora_to_loss_fn(Transformer.loss_fn, base),
                                scope=LoraAdapters.merged)(state, batch)
    finally:
        apply_ops_config(None)
    plain = {k: float(m[k]) for k in ("loss", "grad_norm")}
    launched, _ = read_counts()
    rel = {k: abs(trainer_step[k] - plain[k]) / abs(plain[k]) for k in plain}
    log(f"{tag} step-1 parity against {pins}: " + "; ".join(
        f"{k} {trainer_step[k]:.6f} vs {plain[k]:.6f} (rel {rel[k]:.2e})" for k in plain)
        + f"; the pinned leg launched {launched}")
    # the pinned op's kernels must stay idle (the other op keeps its own)
    family = {"attention": "flash_", "group_gemm": "gmm_"}
    if any(n for k, n in launched.items() if any(k.startswith(family[op]) for op in pins)):
        raise AssertionError(f"{tag}: the pinned leg launched kernels: {launched}")
    del fm, base, adapters, state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return rel


def check_adapter_round_trip(dev, tag: str, trainer, out_dir: str):
    """save_adapter, then load_adapter into fresh adapters: bit-equal.
    Returns (bytes, save s, load s)."""
    from veomni_tpu_torch.lora import init_lora_params, load_adapter, save_adapter
    from veomni_tpu_torch.lora.lora import ADAPTER_WEIGHTS

    live = trainer.train_state.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_adapter(live, trainer.lora_config, out_dir)
    save_s = time.perf_counter() - t0
    fresh = init_lora_params(None, trainer.base_model, trainer.lora_config)
    t0 = time.perf_counter()
    load_adapter(out_dir, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = [n for (n, x), (_, y) in zip(fresh.named_jax_parameters(), live.named_jax_parameters())
           if not (x.dtype == y.dtype and torch.equal(x, y))]
    nbytes = os.path.getsize(os.path.join(out_dir, ADAPTER_WEIGHTS))
    log(f"{tag}: adapter ({len(live.paths)} adapted leaves, {nbytes / 1e6:.1f} MB) saved in "
        f"{save_s:.2f} s and loaded in {load_s:.2f} s: "
        f"{'bit-equal' if not bad else f'{len(bad)} tensors differ, e.g. {bad[:3]}'}")
    if bad:
        raise AssertionError(f"{tag}: adapter round trip differs")
    del fresh
    return nbytes, save_s, load_s


def check_merged_export(dev, tag: str, trainer, export_dir: str):
    """The merged HF export against W + scale * A @ B worked out here in f64
    from the live base and adapters: each adapted tensor within 2^-23 of
    |ref| plus 1e-5 of its largest |scale * A @ B| (f32 rounding of the add
    and of the rank-r product), every other tensor bit-equal to the base."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.hf_io import hf_to_params

    base, adapters = trainer.base_model, trainer.train_state.model
    t0 = time.perf_counter()
    back = hf_to_params(export_dir, base.cfg, Transformer(base.cfg, None, device=dev))
    read_s = time.perf_counter() - t0
    adapted = {}
    for path in adapters.paths:
        seg, name = path.split(".", 1)
        leaf = adapters.leaf(path)
        for i, layer in enumerate(base.layers):
            adapted[f"layers.{i}.{name}"] = (leaf.lora_a[i], leaf.lora_b[i], leaf.scale)
    worst, exact = 0.0, 0
    with torch.no_grad():
        for (n, got), (_, w) in zip(back.named_parameters(), base.named_parameters()):
            if n not in adapted:
                if not torch.equal(got, w):
                    raise AssertionError(f"{tag}: {n} is not adapted, yet the export differs")
                exact += 1
                continue
            a, b, s = adapted[n]
            delta = (a.double() @ b.double()) * s.double()
            ref = w.double() + delta
            err = (got.double() - ref).abs()
            allow = 2.0 ** -23 * ref.abs() + 1e-5 * delta.abs().max()
            worst = max(worst, float((err / allow).max()))
    nbytes = sum(os.path.getsize(os.path.join(export_dir, f)) for f in os.listdir(export_dir))
    log(f"{tag}: merged HF export ({nbytes / 1e9:.3f} GB, read in {read_s:.1f} s): "
        f"{len(adapted)} adapted tensors within {worst:.3f} of the allowance against "
        f"W + scale * A @ B worked out here in f64, {exact} others bit-equal to the base")
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: merged export departs from W + scale * A @ B ({worst})")
    del back
    return nbytes


def check_merged_layer(tag: str, trainer, index: int):
    """Layer ``index``'s merged weights, as the forward and the merged HF
    export read them (``DecoderLayer.w`` inside ``LoraAdapters.merged``),
    against W + scale * A @ B worked out here in f64 from the live base and
    adapters, with ``check_merged_export``'s allowance; expert tensors
    ([E, in, out] against A [E, in, r], B [E, r, out]) a slice of experts
    at a time. Returns the worst error over its allowance."""
    base, adapters = trainer.base_model, trainer.train_state.model
    layer = base.layers[index]
    worst, names = 0.0, []
    with torch.no_grad(), adapters.merged():
        for path in adapters.paths:
            seg, name = path.split(".", 1)
            if seg != "layers":
                continue
            leaf, w = adapters.leaf(path), layer.get_parameter(name)
            got = layer.w(name)
            # a per-layer vector's adapter has an unstacked B (_merge_layer)
            a, b = leaf.lora_a[index], leaf.lora_b[index] if w.ndim > 1 else leaf.lora_b
            s = leaf.scale.double()
            step = 16 if w.ndim == 3 else w.shape[0]
            for lo in range(0, w.shape[0], step):
                sl = slice(lo, lo + step) if w.ndim == 3 else slice(None)
                delta = (a[sl].double() @ b[sl].double()) * s
                ref = w[sl].double() + delta
                allow = 2.0 ** -23 * ref.abs() + 1e-5 * delta.abs().max()
                worst = max(worst, float(((got[sl].double() - ref).abs() / allow).max()))
                del delta, ref, allow
            if not bool(b.any()):
                raise AssertionError(f"{tag}: {path}'s B is still 0 at layer {index}")
            names.append(f"{name} {tuple(w.shape)}")
            del got
    log(f"{tag}: layer {index}'s merged weights ({', '.join(names)}) within {worst:.3f} of "
        f"the allowance against W + scale * A @ B worked out here in f64")
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: layer {index}'s merged weights depart from "
                             f"W + scale * A @ B ({worst})")
    return worst


def phase_sft_lora_dense(dev, card):
    """TinyLlama-1.1B (the published config.json, random bf16 weights from
    seed 0 in an HF directory with the byte-fallback fixture tokenizer) at
    ``lora_sft.yaml``'s knobs: LoRA rank 16, alpha 32, conversation data at
    seq 4096 x micro-batch 2, lr 1e-4, the default ``nothing`` remat, 4
    steps with the llama2 template; then the parameter-group leg. Returns
    the LoRA run's launches."""
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.models.auto import build_tokenizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state

    tag = "sft lora dense TinyLlama-1.1B"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_dense_")
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        cfg = write_random_hf_dir(dev, hf_dir, HF_PRESET)
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(os.path.join(TOKENIZER_FIXTURES, "bytefallback", name), hf_dir)
        data = os.path.join(tmp, "chat.jsonl")
        sft_conversations(data, SFT_ROWS)
        log(f"{tag}: HF directory (random bf16 weights, the byte-fallback fixture tokenizer) "
            f"and {SFT_ROWS} conversations from the repo's docs written in "
            f"{time.perf_counter() - t0:.1f} s")
        # the label mask, with the llama2 template and the tokenizer's own
        # jinja template (TinyLlama-Chat's, turns ending in </s>)
        tok = build_tokenizer(hf_dir)
        with open(data) as f:
            rows = [json.loads(line) for line in f][:48]
        for template in ("llama2", "default"):
            transform = build_data_transform("conversation", tokenizer=tok, chat_template=template)
            t0 = time.perf_counter()
            n = check_label_mask(tok, transform, rows, f"{tag} {template} template")
            log(f"{tag}: the {template} template's labels mask every non-assistant token of "
                f"{len(rows)} rows ({n} supervised tokens, rendered and checked in "
                f"{time.perf_counter() - t0:.2f} s)")

        out = os.path.join(tmp, "out")
        args = sft_args(hf_dir, hf_dir, data, out, SFT_DENSE_STEPS,
                        "--data.chat_template=llama2")
        if (args.model.lora, args.data.max_seq_len, args.train.micro_batch_size) != (
                {"rank": 16, "alpha": 32}, SFT_SEQ, SFT_MICRO_BS):
            raise AssertionError(f"{tag}: {SFT_YAML} no longer sets the knobs this phase runs")
        trainer, rec, launches, fallbacks, _, init, before = sft_run(
            dev, card, tag, args, SFT_DENSE_STEPS)
        # remat "nothing" (the YAML's default): backward reruns each layer,
        # K1 included
        n = cfg.num_hidden_layers * SFT_DENSE_STEPS
        want = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
        log(f"{tag}: launches {launches} (reckoned: {want}: per layer and step K1 twice, "
            f"forward and its recompute, K2 and K3 once), FALLBACK_CALLS {fallbacks}")
        check_counts(launches, fallbacks, want, tag)
        after = tensors_digest(trainer.base_model.parameters())
        if after != before:
            raise AssertionError(f"{tag}: the frozen base changed in training")
        log(f"{tag}: all {len(before)} base tensors bit-unchanged after {SFT_DENSE_STEPS} "
            f"steps (word-sum digests)")
        ckpt = os.path.join(out, "checkpoints", f"global_step_{SFT_DENSE_STEPS}", "train_state")
        ck_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        log(f"{tag}: the checkpoint holds the adapters and their AdamW state alone: "
            f"{ck_bytes / 1e6:.1f} MB")
        check_adapter_round_trip(dev, tag, trainer, os.path.join(tmp, "adapter"))
        check_merged_export(dev, tag, trainer, os.path.join(out, "hf_ckpt"))
        first = rec.first_batch
        step1 = rec.steps[1]
        trainer.checkpointer.close()
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()
        rel = sft_parity(dev, tag, args, init, before, first, step1, {"attention": "xla"})
        # the adapters' grad norm is held like every grad norm of a kernel
        # leg against its plain one (TOL_GRAD_NORM_REL): over 22 bf16 layers
        # it read 7.38e-4 apart on an H100, where the loss read 2.08e-5
        if not (rel["loss"] <= TOL_LOSS_REL and rel["grad_norm"] <= TOL_GRAD_NORM_REL):
            raise AssertionError(f"{tag}: step 1 departs from the plain attention's ({rel})")
        phase_sft_param_groups(dev, card, hf_dir, data, tmp)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sft_param_groups(dev, card, hf_dir: str, data: str, tmp: str):
    """The dense model fully fine-tuned with ``freeze_modules`` (the
    embedding) and ``module_lr_scales`` (0.1 on q/k/v/o), weight decay 0.1,
    no clip, 2 steps, against one plain step (no groups) on the same weights
    and batch: the frozen embedding bit-unchanged, the grad norm equal to
    the plain run's with the embedding's gradient zeroed (rel 1e-5), and the
    first update of the scaled tensors 0.1 x the plain run's (norm ratio rel
    1e-5, cosine within 1e-6 of 1), of the others 1 x."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.optim import build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback

    tag = "sft param groups TinyLlama-1.1B"
    scaled = re.compile(next(iter(SFT_SCALES)))

    class FirstUpdate(Callback):
        """After step 1: each compared tensor's update."""

        def __init__(self, model):
            self.model = model
            self.start = {n: p.detach().clone() for n, p in self.compared()}
            self.update = None

        def compared(self):
            for n, p in self.model.named_parameters():
                parts = n.split(".")
                if (len(parts) == 3 and parts[2] in ("q_proj", "k_proj", "v_proj", "o_proj",
                                                     "down_proj")) or n == "lm_head":
                    yield n, p

        def on_step_end(self, trainer, state):
            if state.global_step == 1:
                self.update = {n: p.detach() - self.start[n] for n, p in self.compared()}
                self.start = None

    args = sft_args(hf_dir, hf_dir, data, os.path.join(tmp, "groups"), SFT_GROUPS_STEPS,
                    "--data.chat_template=llama2", "--train.max_grad_norm=0",
                    f"--train.weight_decay={SFT_GROUPS_DECAY}", "--train.save_hf_weights=false",
                    f"--model.freeze_modules={json.dumps(SFT_FREEZE)}",
                    f"--train.module_lr_scales={json.dumps(SFT_SCALES)}")
    args.model.lora = {}
    torch.cuda.empty_cache()
    trainer = TextTrainer(args)
    trainer.callbacks = [cb for cb in trainer.callbacks if not isinstance(cb, CheckpointCallback)]
    model = trainer.train_state.model
    embed_before = tensors_digest([model.embed_tokens])
    first = FirstUpdate(model)
    rec = sft_record()
    trainer.callbacks += [first, rec]
    groups = sorted(g["lr_scale"] for g in trainer.train_state.optimizer.param_groups)
    trainer.train()
    frozen_ok = tensors_digest([model.embed_tokens]) == embed_before
    upd_a = first.update
    trainer.checkpointer.close()
    del trainer, model, first
    destroy_parallel_state()
    gc.collect()
    torch.cuda.empty_cache()

    # the plain step: no groups, no clip, the same weights and batch
    t = args.train
    fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev, dtype=t.compute_dtype,
                                param_dtype=t.param_dtype, remat=t.enable_gradient_checkpointing,
                                remat_policy=t.gradient_checkpointing_policy)
    model = fm.module
    start = {n: p.detach().clone() for n, p in model.named_parameters() if n in upd_a}
    state = build_train_state(model, build_optimizer(model, lr=t.lr, weight_decay=t.weight_decay))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rec.first_batch.items()}
    _, m = build_train_step(Transformer.loss_fn, max_grad_norm=0)(state, batch)
    with torch.no_grad():
        # the train step's own norm over the plain run's gradients, the
        # embedding's zeroed
        zeroed = [torch.zeros_like(p.grad) if n == "embed_tokens" else p.grad
                  for n, p in model.named_parameters()]
        want_norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(zeroed))))
        got_norm = rec.steps[1]["grad_norm"]
        ratios = {}
        for n, p in model.named_parameters():
            if n not in upd_a:
                continue
            ub, ua = (p.detach() - start[n]).double(), upd_a[n].double()
            key = "scaled" if scaled.search(re.sub(r"^layers\.\d+\.", "layers.", n)) else "unscaled"
            r = ratios.setdefault(key, [0.0, 0.0, 0.0])
            r[0] += float((ua * ub).sum())
            r[1] += float((ua * ua).sum())
            r[2] += float((ub * ub).sum())
    rel_norm = abs(got_norm - want_norm) / want_norm
    summary = {k: (math.sqrt(r[1] / r[2]), r[0] / math.sqrt(r[1] * r[2])) for k, r in
               ratios.items()}
    log(f"{tag}: groups by lr scale {groups}; embedding bit-unchanged after "
        f"{SFT_GROUPS_STEPS} steps: {frozen_ok}; step-1 grad norm {got_norm:.6f} against the "
        f"plain run's without the embedding's gradient {want_norm:.6f} (rel {rel_norm:.2e}, "
        f"the plain run's whole norm {float(m['grad_norm']):.6f}); first update against the "
        f"plain run's: " + "; ".join(
            f"{k}: norm ratio {v[0]:.7f}, cosine {v[1]:.9f}" for k, v in summary.items())
        + f" [{card}]")
    want = {"scaled": 0.1, "unscaled": 1.0}
    if not (frozen_ok and rel_norm <= 1e-5 and set(summary) == set(want) and all(
            abs(summary[k][0] / want[k] - 1) <= 1e-5 and summary[k][1] >= 1 - 1e-6
            for k in want)):
        raise AssertionError(f"{tag}: parameter groups depart from the plain run")
    del fm, model, state, batch, m, start, upd_a
    gc.collect()
    torch.cuda.empty_cache()


def phase_sft_lora_moe(dev, card):
    """Qwen3-30B-A3B at its published widths, depth cut to SFT_MOE_LAYERS,
    random f32 weights from seed 0 (a model directory with the config.json
    and the byte-level fixture tokenizer, no weights), at ``lora_sft.yaml``'s
    knobs with ``moe_capacity_factor`` 2.0 at expert-parallel size 1, the
    chatml template, LoRA on the experts and attention, 4 steps. Returns its
    launches."""
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train_text_step import bench_config

    tag = "sft lora moe Qwen3-30B-A3B"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_moe_")
    try:
        cfg = bench_config(MOE_PRESET, num_hidden_layers=SFT_MOE_LAYERS)
        model_dir = os.path.join(tmp, "model")
        os.makedirs(model_dir)
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(cfg.to_hf_config(), f, indent=2)
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(os.path.join(TOKENIZER_FIXTURES, "bytelevel", name), model_dir)
        data = os.path.join(tmp, "chat.jsonl")
        sft_conversations(data, SFT_ROWS, seed=1)
        overrides = {"moe_capacity_factor": SFT_MOE_CAPACITY}
        args = sft_args(model_dir, "", data, os.path.join(tmp, "out"), SFT_MOE_STEPS,
                        "--data.chat_template=chatml", "--train.save_hf_weights=false",
                        f"--model.config_overrides={json.dumps(overrides)}")
        trainer, rec, launches, fallbacks, peak, init, before = sft_run(
            dev, card, tag, args, SFT_MOE_STEPS, keep_checkpoints=False)
        model_cfg = trainer.base_model.cfg
        widths = ("num_experts", "num_experts_per_tok", "hidden_size", "moe_intermediate_size",
                  "num_attention_heads", "num_key_value_heads", "head_dim", "vocab_size")
        if model_cfg.moe_capacity_factor != SFT_MOE_CAPACITY or any(
                getattr(model_cfg, k) != getattr(cfg, k) for k in widths):
            raise AssertionError(f"{tag}: the model is not the preset's widths at capacity "
                                 f"factor {SFT_MOE_CAPACITY}")
        adapted = sorted(trainer.train_state.model.paths)
        log(f"{tag}: {SFT_MOE_LAYERS} of 48 layers, capacity factor "
            f"{model_cfg.moe_capacity_factor} at expert-parallel size 1 (dropless), adapters "
            f"on {adapted}; peak {peak / 2**30:.2f} GiB")
        n = SFT_MOE_LAYERS * SFT_MOE_STEPS
        want = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                "gmm_fwd": 6 * n, "gmm_dlhs": 3 * n, "gmm_t": 3 * n}
        log(f"{tag}: launches {launches} (reckoned: {want}: per layer and step K1 twice, K2, "
            f"K3 once; K4 x 6 (gate, up, down on the merged experts, and their recompute), K5 "
            f"x 3, K6 x 3 (the merged experts' gradient, which flows into their adapters)), "
            f"FALLBACK_CALLS {fallbacks}")
        check_counts(launches, fallbacks, want, tag)
        after = tensors_digest(trainer.base_model.parameters())
        if after != before:
            raise AssertionError(f"{tag}: the frozen base changed in training")
        log(f"{tag}: all {len(before)} base tensors bit-unchanged after {SFT_MOE_STEPS} steps")
        check_adapter_round_trip(dev, tag, trainer, os.path.join(tmp, "adapter"))
        # the merged HF export is off in this leg: at 16 layers it would
        # write ~42 GB of f32; one MoE layer's merged experts are checked
        # through the read the export streams instead
        check_merged_layer(tag, trainer, SFT_MOE_LAYERS - 1)
        first, step1 = rec.first_batch, rec.steps[1]
        trainer.checkpointer.close()
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()
        rel = sft_parity(dev, tag, args, init, before, first, step1, {"group_gemm": "xla"})
        # the grad norm carries K6's merged-expert gradient into the adapters
        # (at step 1 every B is 0: the loss does not depend on them)
        if not (rel["loss"] <= TOL_LOSS_REL and rel["grad_norm"] <= TOL_GRAD_NORM_REL):
            raise AssertionError(f"{tag}: step 1 departs from the plain grouped GEMM's ({rel})")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Serving: the paged-KV engine at Qwen3-0.6B and Qwen3-30B-A3B
# --------------------------------------------------------------------------
SERVE_DENSE_PRESET = "qwen3_0p6b"
SERVE_DENSE = dict(slots=16, block=16, max_model_len=4096, requests=32, wave=16, wave_ticks=4,
                   prompt=(64, 1536), shared_prefix=512, max_new=128)
SERVE_MOE = dict(slots=8, block=16, max_model_len=4096, requests=16, wave=8, wave_ticks=4,
                 prompt=(64, 1024), shared_prefix=0, max_new=64)
SERVE_CHUNK = 512
SERVE_GREEDY_PROMPTS = 8  # held against greedy_generate (its contiguous loop: ~4 s a prompt)
SERVE_SPEC_K = 4
SERVE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
# The re-score gate: an engine token's logit may sit below its row's maximum
# in the f32 teacher-forced re-score by at most eps = EPS_FACTOR x the
# phase's recorded delta, a constant: delta is the largest |engine -
# re-score| over the vocabulary of the engine's first-token logits of every
# prompt of the phase (its contiguous prefill, in the compute dtype), as
# read on an NVIDIA H100 80GB HBM3 at this script's seeds. A greedy token's
# gap is at most twice its row's |engine - re-score| (it is the engine's
# argmax), so 2 x delta bounds rows like the recorded ones; EPS_FACTOR = 4
# leaves a factor 2 for rows whose error runs above the first tokens'
# (decode rows attend over a bf16 cache the prefill wrote). A sampled token
# must be in the re-score's top-k/top-p keep-set with the threshold lowered
# by eps / temperature. Each run measures delta again and fails above
# DELTA_CEILING x the recorded value: the contiguous prefill shares its layer
# functions with the paged steps, so a fault there shows in delta, while eps
# stays where the sound code put it.
# Gemma-3-1B's (0.0652) with its norm weights at 0 (``random_model``).
SERVE_DELTA = {"serve dense": 0.0481, "serve moe": 0.0917, "serve gemma3": 0.0652}
EPS_FACTOR = 4.0
DELTA_CEILING = 2.0


def serve_traffic(vocab: int, spec: dict, seed: int = 0):
    """Prompts of the phase from one numpy seed: lengths uniform in
    spec["prompt"]; every other request (from the first) carries one shared
    system prefix of spec["shared_prefix"] tokens ahead of its own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, spec["shared_prefix"]).tolist()
    lo, hi = spec["prompt"]
    prompts = []
    for i in range(spec["requests"]):
        own = rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist()
        prompts.append((system if i % 2 == 0 else []) + own)
    return prompts


def shared_blocks(prompts, block: int):
    """Per prompt, the tokens of the longest block-aligned prefix it shares
    with any other prompt: all a prefix cache may serve it."""
    out = []
    for i, p in enumerate(prompts):
        best = 0
        for j, q in enumerate(prompts):
            if i != j:
                n = 0
                while n < min(len(p), len(q)) and p[n] == q[n]:
                    n += 1
                best = max(best, n)
        out.append(best // block * block)
    return out


@contextlib.contextmanager
def f32_rescore(model):
    """The model's training forward in f32 (every compute-dtype cast of the
    weights an f32 one) with the plain attention and grouped GEMM pinned:
    a path that shares no code with the paged decode."""
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config

    cfg = model.cfg
    modules = [model, *model.layers]
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    for m in modules:
        m.cfg = f32
    apply_ops_config({"attention": "xla", "group_gemm": "xla"})
    try:
        with torch.no_grad():
            yield
    finally:
        apply_ops_config(None)
        for m in modules:
            m.cfg = cfg


def rescore_rows(model, ids, first: int):
    """f32 logits [len(ids) - first, V]: row j is the next-token
    distribution after ids[:first + j] (teacher forcing), with the config's
    final softcap. Call under f32_rescore."""
    dev = model.embed_tokens.device
    t = torch.tensor(ids, device=dev)[None]
    hidden, _ = model.forward_hidden(t, torch.arange(len(ids), device=dev)[None])
    logits = hidden[0, first - 1:len(ids) - 1].float() @ model.lm_head_kernel().float()
    cap = model.cfg.final_logit_softcap
    return cap * torch.tanh(logits / cap) if cap else logits


def first_token_spread(model, cfg, compute, prompts, tag):
    """delta: the largest |engine - re-score| over the vocabulary of the
    first-token logits of every prompt (the engine's contiguous prefill).
    Returns (delta, eps, ceiling) with eps and the ceiling from the phase's
    recorded delta."""
    from veomni_tpu_torch.models import decode as tdec

    dev = model.embed_tokens.device
    t0 = time.perf_counter()
    engine_rows = []
    for p in prompts:
        pb = tdec._bucket_pow2(len(p), floor=16)
        tokens = torch.zeros((1, pb), dtype=torch.long, device=dev)
        tokens[0, :len(p)] = torch.tensor(p, device=dev)
        engine_rows.append(tdec.prefill(compute, cfg, tokens, len(p), pb, pb)[0][0])
    spreads = []
    with f32_rescore(model):
        for p, row in zip(prompts, engine_rows):
            # a placeholder next token: causal rows before it do not see it
            spreads.append((row - rescore_rows(model, p + [0], len(p))[0]).abs().max().item())
    delta = max(spreads)
    recorded = SERVE_DELTA[tag]
    eps, ceiling = EPS_FACTOR * recorded, DELTA_CEILING * recorded
    log(f"{tag}: first-token logits, engine (bf16 contiguous prefill) vs f32 re-score over "
        f"{len(prompts)} prompts: max |diff| median {sorted(spreads)[len(spreads) // 2]:.4f}, "
        f"max {delta:.4f} (ceiling {DELTA_CEILING:g} x the recorded {recorded:.4f} = "
        f"{ceiling:.4f}); eps = {EPS_FACTOR:g} x {recorded:.4f} = {eps:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    return delta, eps, ceiling


def keep_floor(scaled, top_k: int, top_p: float):
    """Per row of temperature-scaled logits [R,V], the least logit of its
    sampling keep-set [R]: the top_k largest, then the shortest prefix of
    them (renormalised, in f64) whose mass before each member is below
    top_p."""
    top = torch.sort(scaled.double(), dim=-1, descending=True).values[:, :top_k]
    prob = torch.softmax(top, dim=-1)
    before = torch.cumsum(prob, dim=-1) - prob
    count = torch.clamp_min((before < top_p).sum(-1), 1)
    return top.gather(1, (count - 1)[:, None])[:, 0]


def rescore_gate(model, prompts, outs, sampling, eps):
    """Worst ratio over every emitted token: greedy, (row max - token's
    logit) / eps; sampled, (keep floor - token's scaled logit) /
    (eps / temperature), both floored at 0. Returns (ratio, tokens held)."""
    worst, n = 0.0, 0
    with f32_rescore(model):
        for p, out in zip(prompts, outs):
            ids = p + out.token_ids
            rows = rescore_rows(model, ids, len(p))
            tok = torch.tensor(out.token_ids, device=rows.device)
            mine = rows.gather(1, tok[:, None])[:, 0]
            if sampling.get("temperature", 0.0) > 0:
                temp = sampling["temperature"]
                below = keep_floor(rows / temp, sampling["top_k"], sampling["top_p"]) - mine / temp
                worst = max(worst, (below.clamp_min(0) / (eps / temp)).max().item())
            else:
                worst = max(worst, ((rows.max(-1).values - mine) / eps).max().item())
            n += len(out.token_ids)
    return worst, n


def host_state(tag):
    """Log what earlier phases leave in this process that a host-bound
    serving tick can feel: threads, span tracing, deterministic algorithms,
    the objects the garbage collector tracks."""
    import threading

    from veomni_tpu_torch.observability import spans

    threads = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    log(f"{tag}: host state: threads besides main {threads}; spans "
        f"{'on' if spans.spans_enabled() else 'off'}; deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}; torch threads "
        f"{torch.get_num_threads()}; {len(gc.get_objects())} objects tracked by gc")


def serve_leg(model, cfg, dev, card, prompts, spec, tag, *, prefix_cache=True,
              chunk=SERVE_CHUNK, spec_k=0, sampling=None):
    """One engine run over the phase's traffic: two waves, the second
    ``wave_ticks`` ticks after the first. Returns (outputs in submit order,
    stats) with every kernel launch counter set to 0 just before the engine
    is driven and read just after."""
    from veomni_tpu_torch.serving import EngineConfig, InferenceEngine, Request, SamplingParams

    sampling = sampling or {}
    eng = InferenceEngine(model, cfg, EngineConfig(
        num_slots=spec["slots"], block_size=spec["block"], max_model_len=spec["max_model_len"],
        prefix_cache=prefix_cache, prefill_chunk=chunk, spec_k=spec_k), device=dev)
    ptrs = (eng.k_pool.data_ptr(), eng.v_pool.data_ptr())
    reqs = [Request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=spec["max_new"], seed=i, **sampling)) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    eng.metrics()  # opens the throughput window
    # host time the leg spends in the garbage collector, and the device
    # allocations the caching allocator makes (cudaMalloc) during the leg
    gc_spent = {"s": 0.0, "n": 0, "full": 0, "t": None}

    def on_gc(phase, info):
        if phase == "start":
            gc_spent["t"] = time.perf_counter()
        elif gc_spent["t"] is not None:
            gc_spent["s"] += time.perf_counter() - gc_spent["t"]
            gc_spent["n"] += 1
            gc_spent["full"] += info["generation"] == 2

    mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0)
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        ids = [eng.submit(r) for r in reqs[:spec["wave"]]]
        ticks = 0
        for _ in range(spec["wave_ticks"]):
            eng.step()
            ticks += 1
        ids += [eng.submit(r) for r in reqs[spec["wave"]:]]
        while eng.has_work:
            eng.step()
            ticks += 1
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
    wall = time.perf_counter() - t0
    mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0) - mallocs
    launches, fallbacks = read_counts()
    m = eng.metrics()
    outs = eng.run()
    outs = [outs[i] for i in ids]
    bm = eng.blocks
    ttft = sorted(o.ttft_s for o in outs)
    tpot = sorted(o.tpot_s for o in outs if o.tpot_s is not None)
    stats = dict(
        wall_s=wall, ticks=ticks, generated=int(m["generated_tokens"]),
        decode_tokens_per_s=m["decode_tokens_per_sec"],
        ttft_p50_s=ttft[len(ttft) // 2], ttft_p99_s=ttft[min(len(ttft) - 1,
                                                             int(0.99 * len(ttft)))],
        tpot_median_ms=1e3 * tpot[len(tpot) // 2] if tpot else float("nan"),
        prefix_hit_rate=m["prefix_hit_rate"], spec_proposed=int(m["spec_proposed"]),
        spec_accepted=int(m["spec_accepted"]),
        spec_acceptance=m["spec_accepted"] / max(1.0, m["spec_proposed"]),
        prefill_chunks=int(m["prefill_chunks"]), decode_steps=eng.decode_steps,
        kv_pool_bytes=eng.kv_capacity()["pool_bytes"],
        max_concurrent_seqs=int(eng.kv_capacity()["max_concurrent_seqs"]),
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        launches=launches, fallbacks=fallbacks, preemptions=eng.scheduler.preemption_count,
        leak_free=(bm.num_used == 0
                   and bm.num_free_uncached + bm.num_cached == bm.num_blocks - 1),
        pools_fixed=(eng.k_pool.data_ptr(), eng.v_pool.data_ptr()) == ptrs,
        cached_tokens=[o.cached_tokens for o in outs],
        gc_s=gc_spent["s"], gc_collections=gc_spent["n"], gc_full=gc_spent["full"],
        device_mallocs=mallocs,
    )
    log(f"{tag}: {len(outs)} requests, {stats['generated']} tokens in {ticks} ticks, "
        f"{wall:.2f} s; TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{stats['ttft_p99_s'] * 1e3:.1f} ms; TPOT median {stats['tpot_median_ms']:.2f} ms; "
        f"decode {stats['decode_tokens_per_s']:.1f} tok/s; prefix hit rate "
        f"{stats['prefix_hit_rate']:.4f}; spec accepted {stats['spec_accepted']}/"
        f"{stats['spec_proposed']} ({stats['spec_acceptance']:.4f}); prefill chunks "
        f"{stats['prefill_chunks']}, decode steps {stats['decode_steps']}, preemptions "
        f"{stats['preemptions']}; KV pool {stats['kv_pool_bytes'] / 2**30:.3f} GiB, "
        f"max_concurrent_seqs {stats['max_concurrent_seqs']}; peak "
        f"{stats['peak_gib']:.2f} GiB; host time in gc {stats['gc_s']:.3f} s over "
        f"{stats['gc_collections']} collections ({stats['gc_full']} full); cudaMalloc calls "
        f"{mallocs}; launches {launches}, FALLBACK_CALLS {fallbacks} [{card}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return outs, stats


def check_serve_leg(tag, model, prompts, outs, stats, spread, max_new, sampling=None,
                    allowed_cached=None, want_launches=None):
    """Every check of one leg, all logged before the first failure raises.
    spread: the phase's (delta, eps, ceiling) from first_token_spread."""
    delta, eps, ceiling = spread
    t0 = time.perf_counter()
    ratio, n = rescore_gate(model, prompts, outs, sampling or {}, eps)
    checks = [("re-score gate", ratio <= 1.0,
               f"worst (gap / eps) = {ratio:.4f} over {n} tokens (eps = {eps:.4f}; "
               f"{time.perf_counter() - t0:.1f} s)"),
              ("first-token spread", delta <= ceiling,
               f"max |engine - re-score| {delta:.4f} / ceiling {ceiling:.4f} = "
               f"{delta / ceiling:.4f}")]
    checks.append(("block leak", stats["leak_free"], "free_uncached + cached == pool - null"))
    checks.append(("pool storage", stats["pools_fixed"], "k/v pools kept their storage"))
    if allowed_cached is not None:
        over = [(c, a) for c, a in zip(stats["cached_tokens"], allowed_cached) if c > a]
        checks.append(("prefix cache", not over,
                       f"cached tokens within each prompt's shared block-aligned prefix "
                       f"(over: {over[:3]})"))
    checks.append(("fallback", not any(stats["fallbacks"].values()),
                   f"FALLBACK_CALLS {stats['fallbacks']}"))
    want = want_launches or {}
    bad = {k: v for k, v in stats["launches"].items() if v != want.get(k, 0)}
    checks.append(("launches", not bad, f"launches {stats['launches']}, expected {want}"))
    checks.append(("lengths", all(len(o.token_ids) == max_new and o.finish_reason == "length"
                                  for o in outs), "every request finished at max_new_tokens"))
    for name, ok, what in checks:
        log(f"  {tag}: {name}: {'ok' if ok else 'FAILED'}: {what}")
    failed = [f"{name} ({what})" for name, ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return ratio


def match_share(a, b):
    return sum(x == y for x, y in zip(a, b)) / len(a)


def common_prefix(a, b):
    """Mean length of the common prefix of paired token lists: bf16 GEMMs of
    other shapes may flip a near-tie, after which a stream diverges."""
    total = 0
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        total += n
    return total / len(a)


def phase_serve_dense(dev, card):
    """The serving main path at Qwen3-0.6B, full width and depth: legs (a)
    prefix cache + chunked prefill, (b) cache off + monolithic prefill,
    (c) = (a) + ngram speculation, (d) (a) and (c) sampled."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import SEED, bench_config

    host_state("serve dense")
    spec = SERVE_DENSE
    cfg = bench_config(SERVE_DENSE_PRESET, param_dtype="bfloat16")
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = serve_traffic(cfg.vocab_size, spec)
    allowed = shared_blocks(prompts, spec["block"])
    lens = [len(p) for p in prompts]
    log(f"serve dense: Qwen3-0.6B ({cfg.num_hidden_layers} layers, bf16 weights from seed "
        f"{SEED}), {spec['slots']} slots, block {spec['block']}, max_model_len "
        f"{spec['max_model_len']}; {len(prompts)} requests of {min(lens)}-{max(lens)} prompt "
        f"tokens ({len(prompts) // 2} behind one {spec['shared_prefix']}-token prefix), "
        f"{spec['max_new']} new tokens each, waves of {spec['wave']} [{card}]")
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts, "serve dense")
    legs = {}
    for leg, kw in (("a", {}), ("b", dict(prefix_cache=False, chunk=0)),
                    ("c", dict(spec_k=SERVE_SPEC_K)), ("d-a", dict(sampling=SERVE_SAMPLING)),
                    ("d-c", dict(spec_k=SERVE_SPEC_K, sampling=SERVE_SAMPLING))):
        tag = f"serve dense leg ({leg})"
        outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag, **kw)
        stats["gate"] = check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                                        sampling=kw.get("sampling"),
                                        allowed_cached=allowed if kw.get("prefix_cache", True)
                                        else [0] * len(prompts))
        legs[leg] = (outs, stats)
    t0 = time.perf_counter()
    greedy = [tdec.greedy_generate(model, cfg, p, max_new_tokens=spec["max_new"])[len(p):]
              for p in prompts[:SERVE_GREEDY_PROMPTS]]
    log(f"serve dense: greedy_generate of the first {len(greedy)} prompts in "
        f"{time.perf_counter() - t0:.1f} s")
    a = [o.token_ids for o in legs["a"][0]]
    pairs = {"(a)/(b)": (a, [o.token_ids for o in legs["b"][0]]),
             "(a)/(c)": (a, [o.token_ids for o in legs["c"][0]]),
             "(a)/greedy_generate": (a[:len(greedy)], greedy),
             "sampled (a)/(c)": ([o.token_ids for o in legs["d-a"][0]],
                                 [o.token_ids for o in legs["d-c"][0]])}
    log("serve dense: agreement between legs (share of requests with identical tokens; mean "
        "length of the common prefix of each pair, of " + str(spec["max_new"]) + "): "
        + "; ".join(f"{k} {match_share(x, y):.3f}, {common_prefix(x, y):.1f}"
                    for k, (x, y) in pairs.items()))
    summary = {leg: {k: v for k, v in st.items() if k not in ("cached_tokens", "launches",
                                                                "fallbacks")}
               for leg, (_, st) in legs.items()}
    log("serve dense summary: " + json.dumps(summary))
    launches = {k: sum(st["launches"][k] for _, st in legs.values())
                for k in legs["a"][1]["launches"]}
    del model, legs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SERVE_GEMMA = dict(slots=16, block=16, max_model_len=4096, requests=32, wave=16, wave_ticks=4,
                   prompt=(64, 1536), shared_prefix=512, max_new=128)


def phase_serve_gemma3(dev, card):
    """Gemma-3-1B, all 26 layers in bf16, through the engine: leg (a) of
    the dense phase (prefix cache, 512-token chunks) over prompts of
    64-2048 tokens, every other one behind a shared 512-token prefix, so
    the 512-token window of its 22 sliding layers bites."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import HF_CONFIGS, SEED

    host_state("serve gemma3")
    spec = SERVE_GEMMA
    cfg = TransformerConfig.from_hf_config(HF_CONFIGS[GEMMA_PRESET], param_dtype=torch.bfloat16)
    model = random_model(dev, cfg, SEED)
    prompts = serve_traffic(cfg.vocab_size, spec)
    allowed = shared_blocks(prompts, spec["block"])
    lens = [len(p) for p in prompts]
    windows = [cfg.window_for_layer(i) for i in range(cfg.num_hidden_layers)]
    log(f"serve gemma3: Gemma-3-1B ({cfg.num_hidden_layers} layers, {windows.count(0)} full "
        f"attention, {len(windows) - windows.count(0)} with window {max(windows)}, bf16 weights "
        f"from seed {SEED}, norm weights 0), {spec['slots']} slots, block {spec['block']}, max_model_len "
        f"{spec['max_model_len']}; {len(prompts)} requests of {min(lens)}-{max(lens)} prompt "
        f"tokens ({len(prompts) // 2} behind one {spec['shared_prefix']}-token prefix), "
        f"{spec['max_new']} new tokens each, waves of {spec['wave']} [{card}]")
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts,
                                "serve gemma3")
    tag = "serve gemma3 leg (a)"
    outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag)
    check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                    allowed_cached=allowed)
    summary = {k: v for k, v in stats.items() if k not in ("cached_tokens", "launches",
                                                           "fallbacks")}
    log("serve gemma3 summary: " + json.dumps(summary))
    launches = stats["launches"]
    del model, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def capture_group_sizes(model, cfg, dev, prompts, spec):
    """Layer 0's group sizes of one prefill chunk (M = top-k x chunk rows)
    and of one decode step (M = top-k x slots) of the serving engine: the K4 shapes
    of the serving path. A short run of its own, with a recording impl
    pinned for the grouped GEMM (it calls the kernel)."""
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
    from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, apply_ops_config
    from veomni_tpu_torch.serving import EngineConfig, InferenceEngine, Request, SamplingParams

    seen = {}

    def record(tokens, weights, group_sizes):
        seen.setdefault(tokens.shape[0], group_sizes.clone())
        return gg.cuda_group_gemm(tokens, weights, group_sizes)

    KERNEL_REGISTRY.register("group_gemm", "__serve_capture", device_types=("cuda",))(record)
    eng = InferenceEngine(model, cfg, EngineConfig(
        num_slots=spec["slots"], block_size=spec["block"], max_model_len=spec["max_model_len"],
        prefill_chunk=SERVE_CHUNK), device=dev)
    apply_ops_config({"group_gemm": "__serve_capture"})
    try:
        ids = [eng.submit(Request(prompt_ids=(p * 2)[:SERVE_CHUNK],
                                  sampling=SamplingParams(max_new_tokens=2)))
               for p in prompts[:spec["slots"]]]
        eng.step()
    finally:
        apply_ops_config(None)
        KERNEL_REGISTRY._ops["group_gemm"].pop("__serve_capture")
        KERNEL_REGISTRY._resolve.cache_clear()
    for rid in ids:
        eng.cancel(rid)
    del eng
    torch.cuda.empty_cache()
    top_k = cfg.num_experts_per_tok
    return seen[top_k * SERVE_CHUNK], seen[top_k * spec["slots"]]


def gmm_fwd_rows(dev, sizes, tag):
    """K4 alone at a serving shape, (K, N) = (2048, 768) and (768, 2048):
    held against its plain version, then its time, the plain version's,
    torch._grouped_mm's and the bound (bytes: lhs, the weights of the
    experts this routing uses, out)."""
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    sizes = sizes.to(dev)
    e = sizes.numel()
    starts = gg.group_starts(sizes)
    m = int(starts[-1])
    used = int((sizes > 0).sum())
    rows = []
    for k, n, what in ((2048, 768, "gate/up"), (768, 2048, "down")):
        gen = torch.Generator(device=dev).manual_seed(3)
        lhs = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        rhs = torch.randn(e, k, n, device=dev, generator=gen).bfloat16()
        ref = gg.gmm_plain(lhs, rhs, starts)
        err = check_close(f"K4 out ({tag} {what}: K={k} N={n})", gg.gmm_cuda(lhs, rhs, starts),
                          ref, atol=GMM_ATOL_MAX * ref.float().abs().max().item(), rtol=GMM_RTOL)
        lib_ms, lib_name = library_gmm("fwd", lhs, rhs, None, starts)
        bound = bound_ms(dev, 2.0 * m * k * n, (m * k + used * k * n + m * n) * 2 + (e + 1) * 4)
        row = dict(name="gmm_fwd", route="cuda", source="veomni_tpu_torch/csrc/grouped_gemm.cu",
                   replaces="veomni_tpu/ops/pallas/grouped_gemm.py:37", k=k, n=n,
                   layout=f"{tag} {what}: M={m} E={e}, {used} experts non-empty",
                   max_abs_err=err, ms=timed_ms(lambda: gg.gmm_cuda(lhs, rhs, starts), reps=50),
                   plain_ms=timed_ms(lambda: gg.gmm_plain(lhs, rhs, starts), reps=3, warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
        log(f"  K4 ({tag} {what}, K={k} N={n}, M={m}, {used}/{e} experts): {row['ms']:.4f} ms "
            f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, plain {row['plain_ms']:.3f} ms, "
            f"library {lib_ms:.4f} ms [{lib_name}])")
        rows.append(row)
        del lhs, rhs, ref
        torch.cuda.empty_cache()
    return rows


def phase_serve_moe(dev, card):
    """The serving main path at Qwen3-30B-A3B, full width and all 48 layers
    (bf16 weights, no master copy): leg (a) with K4 on every MoE layer of
    every prefill chunk and decode step; then K4 alone at the serving
    shapes. Returns (launches, K4 table rows)."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import SEED, bench_config

    held = torch.cuda.memory_allocated(dev)
    log(f"serve moe: device memory allocated before the phase {held / 2**20:.1f} MiB")
    if held > 256 * 2**20:
        raise AssertionError(f"serve moe: {held / 2**30:.2f} GiB still allocated by earlier phases")
    host_state("serve moe")
    spec = SERVE_MOE
    cfg = bench_config(MOE_PRESET, param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve moe: Qwen3-30B-A3B, {cfg.num_hidden_layers} layers, {n_params / 1e9:.2f} B "
        f"parameters in bf16 ({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB) made on the "
        f"card from seed {SEED} in {time.perf_counter() - t0:.1f} s; {spec['slots']} slots, "
        f"block {spec['block']}, max_model_len {spec['max_model_len']}; {spec['requests']} "
        f"requests of {spec['prompt'][0]}-{spec['prompt'][1]} prompt tokens, "
        f"{spec['max_new']} new tokens each [{card}]")
    prompts = serve_traffic(cfg.vocab_size, spec)
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts, "serve moe")
    tag = "serve moe leg (a)"
    outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag)
    passes = stats["prefill_chunks"] + stats["decode_steps"]
    want = {"gmm_fwd": 3 * cfg.num_hidden_layers * passes}
    log(f"  {tag}: K4 launches {stats['launches']['gmm_fwd']} = 3 x {cfg.num_hidden_layers} x "
        f"({stats['prefill_chunks']} prefill chunks + {stats['decode_steps']} decode steps) "
        f"expected {want['gmm_fwd']}")
    check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                    allowed_cached=shared_blocks(prompts, spec["block"]), want_launches=want)
    launches = stats["launches"]
    prefill_sizes, decode_sizes = capture_group_sizes(model, cfg, dev, prompts, spec)
    del model, outs
    gc.collect()
    torch.cuda.empty_cache()
    rows = (gmm_fwd_rows(dev, decode_sizes, "serve decode step")
            + gmm_fwd_rows(dev, prefill_sizes, f"serve prefill chunk of {SERVE_CHUNK}"))
    return launches, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="",
                    help="run only these phases after the build, in order: serve_dense, "
                         "serve_moe, hf_trainer_gemma3, serve_gemma3, dialects, "
                         "hf_trainer_moonlight, deepseek_v2_lite, sft_lora_dense, "
                         "sft_lora_moe, and "
                         "before them main (the dense loop) or trainer; such a partial run "
                         "prints no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
    from veomni_tpu_torch.ops.cuda import probe
    from veomni_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    phase_build([probe.SOURCE, fa.SOURCE, gg.SOURCE])
    if args.phases:
        phases = {"main": phase_main, "trainer": phase_trainer,
                  "serve_dense": phase_serve_dense, "serve_moe": phase_serve_moe,
                  "hf_trainer_gemma3": phase_hf_trainer_gemma3,
                  "serve_gemma3": phase_serve_gemma3, "dialects": phase_dialects,
                  "hf_trainer_moonlight": phase_hf_trainer_moonlight,
                  "deepseek_v2_lite": phase_deepseek_v2_lite,
                  "sft_lora_dense": phase_sft_lora_dense, "sft_lora_moe": phase_sft_lora_moe}
        for name in args.phases.split(","):
            phases[name](dev, card)
            torch.cuda.empty_cache()
        log(f"phases {args.phases} passed (a partial run: no result line)")
        return 0
    hf_tmp = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    try:
        return run_phases(dev, card, hf_tmp)
    finally:
        shutil.rmtree(hf_tmp, ignore_errors=True)


def run_phases(dev, card, hf_tmp) -> int:
    from veomni_tpu_torch.train_text_step import packed_batches

    t0 = time.perf_counter()
    table = [phase_probe(dev)]
    # the dense main path's first packed micro-batch: the kernels' real segment layout
    seg = torch.from_numpy(next(packed_batches(151936, 4096, 4))["segment_ids"][0]).to(dev)
    flash = phase_flash(dev, seg, 16, 8, "Qwen3-0.6B layout")
    torch.cuda.empty_cache()
    # the same batch at the MoE model's head layout, as the MoE main path runs it
    moe_rows = phase_flash(dev, seg, 32, 4, "Qwen3-30B-A3B layout")
    torch.cuda.empty_cache()
    # its first row alone: micro-batch 1, where K2 splits the q-head group
    mb1_rows = phase_flash(dev, seg[:1].contiguous(), 32, 4, "Qwen3-30B-A3B, micro-batch 1")
    for row, moe, mb1 in zip(flash, moe_rows, mb1_rows):
        row["moe_layout"] = {k: moe[k] for k in LAYOUT_KEYS}
        row["moe_micro_batch_1"] = {k: mb1[k] for k in LAYOUT_KEYS}
    table += flash
    torch.cuda.empty_cache()
    phase_flash_edges(dev)
    # head dim 64 on the HF trainer phase's own first packed batch
    # (TinyLlama-1.1B: 32 q / 4 kv heads), and its first row alone (K2 splits
    # each group of 8 q heads over 8 work items)
    hf_yaml = write_hf_run(hf_tmp)
    hf_batch = hf_first_batch(hf_yaml)
    hf_seg = torch.from_numpy(hf_batch["segment_ids"][0]).to(dev)
    d64 = phase_flash(dev, hf_seg, 32, 4, "TinyLlama-1.1B layout", d=64)
    torch.cuda.empty_cache()
    d64_mb1 = phase_flash(dev, hf_seg[:1].contiguous(), 32, 4, "TinyLlama-1.1B, micro-batch 1",
                          d=64)
    for row, mb1 in zip(d64, d64_mb1):
        row["micro_batch_1"] = {k: mb1[k] for k in LAYOUT_KEYS}
    table += d64
    torch.cuda.empty_cache()
    # head dim 256 at Gemma-7B's heads (16 q, 16 kv) on the dense batch's first row
    table += phase_flash(dev, seg[:1].contiguous(), 16, 16, "Gemma-7B heads, S=4096", d=256)
    torch.cuda.empty_cache()
    table += phase_gmm(dev)
    torch.cuda.empty_cache()
    # each main path with the head dim its attention runs at, and the
    # preset whose layout rows count it (None: the rows above)
    by_path = {"dense": (phase_main(dev, card), 128, None)}
    torch.cuda.empty_cache()
    by_path["trainer"] = (phase_trainer(dev, card), 128, None)
    torch.cuda.empty_cache()
    by_path["hf_trainer"] = (phase_hf_trainer(dev, card, hf_yaml, hf_batch), 64, None)
    torch.cuda.empty_cache()
    by_path["moe"] = (phase_moe_main(dev, card), 128, None)
    torch.cuda.empty_cache()
    phase_moe_micro_batch_1(dev, card)
    phase_parity(dev)
    phase_moe_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the dialect phases")
    # the dense HF dialects and the deepseek MoE dialect, each path followed
    # by its kernel rows
    for phase in (phase_hf_trainer_gemma3, phase_dialects, phase_hf_trainer_moonlight,
                  phase_deepseek_v2_lite):
        paths, rows = phase(dev, card)
        by_path.update(paths)
        table += rows
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the serving phases")
    by_path["serve_dense"] = (phase_serve_dense(dev, card), 128, None)
    by_path["serve_gemma3"] = (phase_serve_gemma3(dev, card), DIALECT_HEADS[GEMMA_PRESET][2],
                               GEMMA_PRESET)
    moe_launches, serve_rows = phase_serve_moe(dev, card)
    by_path["serve_moe"] = (moe_launches, 128, None)
    table += serve_rows
    gc.collect()
    torch.cuda.empty_cache()
    # the SFT path, after the serving phases (their host-bound ticks slow
    # down behind every trainer phase that runs before them): TinyLlama-1.1B
    # with LoRA (K1-K3 at D=64, the TinyLlama layout rows) and the
    # parameter-group leg, Qwen3-30B-A3B with LoRA on its experts (K1-K3 at
    # D=128 at the MoE layout, K4-K6 at 2048/768)
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the SFT phases")
    by_path["sft_lora_dense"] = (phase_sft_lora_dense(dev, card), 64, None)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["sft_lora_moe"] = (phase_sft_lora_moe(dev, card), 128, None)
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the end")

    for row in table:
        # a flash row counts the paths at its head dim and layout; a
        # grouped-GEMM row at widths no main path runs counts none
        counts = {path: (launches.get(row["name"], 0)
                         if row.get("head_dim", d) == d and row.get("on_main_path", True)
                         and row.get("path_layout") == layout else 0)
                  for path, (launches, d, layout) in by_path.items()}
        row["launches"] = sum(counts.values())
        row["launches_by_path"] = counts
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    # flash K1-K3: head_dim and layout (what the row holds), single_segment_ms
    # (the like-for-like yardstick against SDPA), and for D=128 moe_layout
    # (the same numbers at Hq=32, Hkv=4 on the same batch) and
    # moe_micro_batch_1 (at Hq=32, Hkv=4 on its first row alone), for D=64
    # micro_batch_1; grouped GEMM K4-K6: k, n and layout
    extra = ("head_dim", "k", "n", "layout", "single_segment_ms", "moe_layout",
             "moe_micro_batch_1", "micro_batch_1")
    print(json.dumps({"kernels": [{k: row[k] for k in keys + extra if k in row}
                                  for row in table]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

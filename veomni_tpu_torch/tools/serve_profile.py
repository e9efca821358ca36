"""The serving engine on the card: where a decode tick's time goes.

Builds the serving engine over Qwen3-0.6B (``bench_config("qwen3_0p6b")``,
28 layers, random bf16 weights from seed 0; 16 slots, block 16,
max_model_len 4096, prefix cache on, 512-token prefill chunks), fills every
slot with a seeded prompt of ``--prompt-len`` tokens, runs the engine until
every request decodes, times ``--ticks`` plain decode ticks with the host
clock (each ends in the host read of its tokens), then traces as many more
with ``torch.profiler`` and prints their device time by kernel category:
the paged gather, the attention products, the bf16 projection GEMMs, the
f32 LM head, K4 (the grouped GEMM, MoE only), sampling and the rest.
``--preset qwen3_30b_a3b`` serves the MoE model instead (8 slots, bf16
weights, all 48 layers). Run from the repository root on a machine with one
NVIDIA Hopper card::

    python3 -m veomni_tpu_torch.tools.serve_profile [--trace build/serve_trace.json.gz]

The last line is one JSON object with the tick times and the breakdown.
"""

from __future__ import annotations

import argparse
import gzip
import json
import subprocess
import time

import numpy as np
import torch

# device kernel categories of a decode tick, by kernel-name substring, first
# match wins (the names CUDA 12 / torch 2.11 give on an H100)
CATEGORIES = (
    ("K4 grouped GEMM", ("gmm_tma_kernel",)),
    ("paged gather (indexing)", ("index_elementwise", "vectorized_gather", "indexSelect",
                                 "index_kernel", "gather")),
    ("f32 GEMMs (attention products, LM head)", ("sgemm", "f32", "tf32", "s1688", "s16816")),
    ("bf16 GEMMs (projections)", ("bf16", "gemm", "nvjet", "xmma", "cutlass")),
    ("sampling (sort, argmax, threefry)", ("sort", "Sort", "argmax", "ArgMax")),
    ("softmax / reductions", ("softmax", "reduce_kernel")),
    ("copies / casts", ("copy", "Cat")),
)


def breakdown(trace_path: str):
    """Device ms by category (and the kernel span) from a chrome trace."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    out = {}
    for e in kernels:
        name = next((c for c, keys in CATEGORIES if any(k in e["name"] for k in keys)),
                    "other elementwise")
        out[name] = out.get(name, 0.0) + e["dur"] / 1e3
    out["total"] = sum(e["dur"] for e in kernels) / 1e3
    out["span"] = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    return out


def main(argv=None) -> None:
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.serving import EngineConfig, InferenceEngine, Request, SamplingParams
    from veomni_tpu_torch.train_text_step import SEED, bench_config
    from veomni_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen3_0p6b", choices=("qwen3_0p6b", "qwen3_30b_a3b"))
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--trace", default="build/serve_trace.json.gz")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = bench_config(args.preset, param_dtype="bfloat16")
    slots = 16 if args.preset == "qwen3_0p6b" else 8
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    eng = InferenceEngine(model, cfg, EngineConfig(
        num_slots=slots, block_size=16, max_model_len=4096, prefill_chunk=512), device=dev)
    rng = np.random.default_rng(SEED)
    budget = 2 * args.ticks + 8
    for _ in range(slots):
        eng.submit(Request(prompt_ids=rng.integers(1, cfg.vocab_size, args.prompt_len).tolist(),
                           sampling=SamplingParams(max_new_tokens=budget)))
    while any(s.prefilling for _, s in eng.scheduler.running()) or eng.scheduler.waiting:
        eng.step()
    for _ in range(3):  # warm the decode shapes
        eng.step()
    ms = []
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        eng.step()
        ms.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            eng.step()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.ticks
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)
    prof.export_chrome_trace(args.trace)
    device = {k: v / args.ticks for k, v in breakdown(args.trace).items()}
    ms.sort()
    print(json.dumps({
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0],
        "preset": args.preset, "slots": slots,
        "context_tokens": args.prompt_len, "tick_ms_median": ms[len(ms) // 2],
        "tick_ms_min": ms[0], "tick_ms_max": ms[-1], "traced_tick_ms": traced_ms,
        "device_ms_per_tick": device,
    }), flush=True)


if __name__ == "__main__":
    main()

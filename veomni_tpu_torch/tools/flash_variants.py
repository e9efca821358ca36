"""Design variants of the flash-attention forward kernel K1, timed side by side.

Each variant in ``VARIANTS`` is a list of exact edits to a copy of
``veomni_tpu_torch/csrc/flash_attention.cu`` (the default is the source as
it is). Every variant is built into a library of its own under the system
temp directory (one ``nvcc`` per variant, all at once), checked against the
plain version (O and LSE) and timed in turns with CUDA events, best of three
runs of 20 launches, on the dense main path's first packed batch at the
Qwen3-0.6B head layout (B=4, S=4096, Hq=16, Hkv=8) and at the Qwen3-30B-A3B
one (its first row, Hq=32, Hkv=4), and on a single-segment batch of the
dense shape. Run from the repository root on a machine with one NVIDIA
Hopper card::

    python3 -m veomni_tpu_torch.tools.flash_variants

It prints one line per (batch, variant) and then one JSON line with every
time.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from veomni_tpu_torch.tools.gmm_variants import build_edited

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = "flash_attention.cu"

# name -> (what, edits); every variant computes the same function
VARIANTS = {
    "default": ("the source as it is", []),
    "mask-every-tile": ("the per-element mask on every k tile, not only on diagonal or "
                        "mixed-segment ones",
                        [("const bool masked = (causal && k0 + KV_TILE - 1 > q0) || qr.x != qr.y "
                          "|| kr.x != qr.x || kr.y != qr.x;", "const bool masked = true;")]),
    "q64": ("64-row q tiles: one consumer warpgroup per block, so each K/V tile is loaded "
            "once per 64 q rows",
            [("constexpr int FWD_CW = 2;", "constexpr int FWD_CW = 1;")]),
    "kv-3-stages": ("a 3-stage K/V ring (~225 KB of shared memory) instead of 2",
                    [("constexpr int KV_STAGES = 2;", "constexpr int KV_STAGES = 3;")]),
    "regs-24-240": ("24 registers for the producer warpgroup, 240 for the consumers "
                    "(40 and 232)",
                    [("setmaxnreg_dec<40>();", "setmaxnreg_dec<24>();"),
                     ("setmaxnreg_inc<CW == 2 ? 232 : 240>();", "setmaxnreg_inc<240>();")]),
}


def build_variant(name: str, edits, workdir: str) -> ctypes.CDLL:
    """Build csrc with ``edits`` applied to the flash-attention source."""
    cdll = build_edited(SOURCE, name, edits, workdir)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.vt_flash_fwd.argtypes = [ptr] * 7 + [i32] * 4 + [f32, i32, ptr]
    cdll.vt_flash_fwd.restype = ctypes.c_int
    return cdll


def main(argv=None) -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import packed_batches

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.card_line()
    seg = torch.from_numpy(next(packed_batches(151936, 4096, 4))["segment_ids"][0]).to(dev)
    batches = {"Qwen3-0.6B layout": (seg, 16, 8),
               "Qwen3-30B-A3B layout": (seg[:1].contiguous(), 32, 4),
               "single segment, Qwen3-0.6B layout": (torch.zeros_like(seg), 16, 8)}
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = {name: pool.submit(build_variant, name, edits, tmp)
                     for name, (_, edits) in VARIANTS.items()}
            libs = {name: f.result() for name, f in built.items()}
        for tag, (sg, hq, hkv) in batches.items():
            b, s = sg.shape
            gen = torch.Generator(device=dev).manual_seed(1)
            q = torch.randn(b, s, hq, 128, device=dev, generator=gen).bfloat16()
            k = torch.randn(b, s, hkv, 128, device=dev, generator=gen).bfloat16()
            v = torch.randn(b, s, hkv, 128, device=dev, generator=gen).bfloat16()
            rng = fa.seg_ranges(sg)
            scale = 128 ** -0.5
            o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, sg, scale, True)
            o = torch.empty_like(q)
            lse = torch.empty(b, hq, s, device=dev, dtype=torch.float32)
            calls = {name: (lambda lib=lib: lib.vt_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), sg.data_ptr(), rng.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, s, hq, hkv, scale, 1, stream))
                for name, lib in libs.items()}
            ms = {name: [] for name in libs}
            for name in libs:
                if calls[name]() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                cs.check_close(f"K1 O ({name}, {tag})", o, o_ref)
                cs.check_close(f"K1 LSE ({name}, {tag})", lse, lse_ref, atol=cs.TOL_LSE, rtol=0.0)
            for _ in range(3):  # in turns, so drift hits every variant alike
                for name in libs:
                    ms[name].append(cs.timed_ms(calls[name], reps=20))
            for name in libs:
                best = min(ms[name])
                results[f"{tag} {name}"] = best
                print(f"{tag:34s} {name:16s} {best:.4f} ms  [{VARIANTS[name][0]}]", flush=True)
            del q, k, v, o_ref, lse_ref, o, lse, calls
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

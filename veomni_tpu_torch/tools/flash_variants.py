"""Design variants of the flash-attention kernels K1-K3, timed side by side.

Each variant in ``VARIANTS`` is a list of exact edits to a copy of
``veomni_tpu_torch/csrc/flash_attention.cu`` (the default is the source as
it is) and names the kernel it is about. Every variant is built into a
library of its own under the system temp directory (one ``nvcc`` per
variant, all at once); every library's K1, K2 and K3 are checked against the
plain version (O and LSE; dQ, dK, dV) and timed in turns with CUDA events,
best of three runs of 20 launches, on the dense main path's first packed
batch at the Qwen3-0.6B head layout (B=4, S=4096, Hq=16, Hkv=8), at the
Qwen3-30B-A3B one (Hq=32, Hkv=4) on the same batch, as the MoE step runs it,
and on its first row alone (micro-batch 1, where K2 splits each q-head
group over 4 work items), and on a single-segment batch of the dense
shape. K2 takes the group split of the wrapper's ``dkv_group_split``. Run
from the repository root on a machine with one NVIDIA Hopper card::

    python3 -m veomni_tpu_torch.tools.flash_variants [--only default,q64]

It prints one line per (batch, kernel, variant), and then one JSON line
with every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from veomni_tpu_torch.tools.gmm_variants import build_edited

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = "flash_attention.cu"
KERNELS = ("K1", "K2", "K3")

# K2's P^T loop body as it is (every tile masked), and branched on the walk's flag
DKV_MASKED_P = """\
        const int2 sq = *reinterpret_cast<const int2*>(seg_t + c);
        s[4 * j + 0] = visible(q0 + c, kj0, sq.x, sk0, causal) ? exp2f(fmaf(s[4 * j + 0], sl2, -l0)) : 0.f;
        s[4 * j + 1] = visible(q0 + c + 1, kj0, sq.y, sk0, causal) ? exp2f(fmaf(s[4 * j + 1], sl2, -l1)) : 0.f;
        s[4 * j + 2] = visible(q0 + c, kj1, sq.x, sk1, causal) ? exp2f(fmaf(s[4 * j + 2], sl2, -l0)) : 0.f;
        s[4 * j + 3] = visible(q0 + c + 1, kj1, sq.y, sk1, causal) ? exp2f(fmaf(s[4 * j + 3], sl2, -l1)) : 0.f;
"""
DKV_BRANCHED_P = """\
        if (masked) {
          const int2 sq = *reinterpret_cast<const int2*>(seg_t + c);
          s[4 * j + 0] = visible(q0 + c, kj0, sq.x, sk0, causal) ? exp2f(fmaf(s[4 * j + 0], sl2, -l0)) : 0.f;
          s[4 * j + 1] = visible(q0 + c + 1, kj0, sq.y, sk0, causal) ? exp2f(fmaf(s[4 * j + 1], sl2, -l1)) : 0.f;
          s[4 * j + 2] = visible(q0 + c, kj1, sq.x, sk1, causal) ? exp2f(fmaf(s[4 * j + 2], sl2, -l0)) : 0.f;
          s[4 * j + 3] = visible(q0 + c + 1, kj1, sq.y, sk1, causal) ? exp2f(fmaf(s[4 * j + 3], sl2, -l1)) : 0.f;
        } else {
          s[4 * j + 0] = exp2f(fmaf(s[4 * j + 0], sl2, -l0));
          s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, -l1));
          s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, -l0));
          s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, -l1));
        }
"""

# name -> (what, edits); every variant computes the same function
VARIANTS = {
    "default": ("the source as it is", []),
    "mask-every-tile": ("the per-element mask on every k tile, not only on diagonal or "
                        "mixed-segment ones (in the walk K1 and K3 share)",
                        [("const bool masked = (causal && k0 + KT - 1 > q0) || qr.x != qr.y "
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
    "dkv-no-split": ("the whole q-head group in every work item, whatever the wrapper's split",
                     [("  // split: the wrapper's dkv_group_split; ws holds 2 * split f32 planes "
                       "when split > 1\n",
                       "  split = 1;  // the variant: the whole group in every item\n")]),
    "dkv-mask-flagged": ("the per-element mask only on the q tiles that reach the causal "
                         "diagonal or hold more than one segment, as K1 does: walk_q_tiles "
                         "flags them, the consumers branch on the flag",
                         [("      tile(h, q0);",
                           "      tile(h, q0, (causal && q0 < k0 + DKV_KT - 1) || kr.x != kr.y "
                           "|| qr.x != kr.x || qr.y != kr.x);"),
                          ("causal, [&](int h, int q0) {", "causal, [&](int h, int q0, bool) {"),
                          ("causal, [&](int, int q0) {", "causal, [&](int, int q0, bool masked) {"),
                          (DKV_MASKED_P, DKV_BRANCHED_P)]),
    "dkv-3-stages": ("a 3-stage Q/dO ring (~168 KB of shared memory) instead of 2",
                     [("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 3;")]),
    "dkv-regs-24-240": ("24 registers for the producer warpgroup, 240 for the consumers "
                        "(40 and 232)",
                        [("constexpr int DKV_PRODUCER_REGS = 40, DKV_CONSUMER_REGS = 232;",
                          "constexpr int DKV_PRODUCER_REGS = 24, DKV_CONSUMER_REGS = 240;")]),
    "dq-mask-every-tile": ("the per-element mask on every k tile of K3 (K1 as it is)",
                           [("causal, [&](int k0, bool masked) {\n      const uint32_t st = ring + "
                             "stage * DQ_STAGE;",
                             "causal, [&](int k0, bool) {\n      const bool masked = true;\n"
                             "      const uint32_t st = ring + stage * DQ_STAGE;")]),
    "dq-kt-128": ("K3 on 128-key K/V tiles instead of 64 (~193 KB of shared memory; S and "
                  "dP as wgmma m64n128)",
                  [("constexpr int DQ_KT = 64;", "constexpr int DQ_KT = 128;"),
                   ("wgmma_m64n64k16<0>(s, wgmma_desc(qa", "wgmma_m64n128k16<0>(s, wgmma_desc(qa"),
                   ("wgmma_m64n64k16<0>(dp, wgmma_desc(da",
                    "wgmma_m64n128k16<0>(dp, wgmma_desc(da")]),
}
# the kernel each variant is about (the default: all)
ABOUT = {"mask-every-tile": "K1", "q64": "K1", "kv-3-stages": "K1", "regs-24-240": "K1",
         "dkv-no-split": "K2", "dkv-mask-flagged": "K2", "dkv-3-stages": "K2",
         "dkv-regs-24-240": "K2", "dq-mask-every-tile": "K3", "dq-kt-128": "K3"}


def build_variant(name: str, edits, workdir: str) -> ctypes.CDLL:
    """Build csrc with ``edits`` applied to the flash-attention source."""
    cdll = build_edited(SOURCE, name, edits, workdir)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.vt_flash_fwd.argtypes = [ptr] * 7 + [i32] * 5 + [f32, i32, ptr]
    cdll.vt_flash_bwd_dkv.argtypes = [ptr] * 11 + [i32] * 6 + [f32, i32, ptr]
    cdll.vt_flash_bwd_dq.argtypes = [ptr] * 9 + [i32] * 5 + [f32, i32, ptr]
    for fn in (cdll.vt_flash_fwd, cdll.vt_flash_bwd_dkv, cdll.vt_flash_bwd_dq):
        fn.restype = ctypes.c_int
    return cdll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import packed_batches

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = {n: v for n, v in VARIANTS.items() if not args.only or n in args.only.split(",")}
    dev = torch.device("cuda")
    card = cs.card_line()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    seg = torch.from_numpy(next(packed_batches(151936, 4096, 4))["segment_ids"][0]).to(dev)
    batches = {"Qwen3-0.6B layout": (seg, 16, 8),
               "Qwen3-30B-A3B layout": (seg, 32, 4),
               "Qwen3-30B-A3B, micro-batch 1": (seg[:1].contiguous(), 32, 4),
               "single segment, Qwen3-0.6B layout": (torch.zeros_like(seg), 16, 8)}
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            built = {name: pool.submit(build_variant, name, edits, tmp)
                     for name, (_, edits) in variants.items()}
            libs = {name: f.result() for name, f in built.items()}
        for tag, (sg, hq, hkv) in batches.items():
            b, s = sg.shape
            gen = torch.Generator(device=dev).manual_seed(1)
            q = torch.randn(b, s, hq, 128, device=dev, generator=gen).bfloat16()
            k = torch.randn(b, s, hkv, 128, device=dev, generator=gen).bfloat16()
            v = torch.randn(b, s, hkv, 128, device=dev, generator=gen).bfloat16()
            do = torch.randn(b, s, hq, 128, device=dev, generator=gen).bfloat16()
            rng = fa.seg_ranges(sg)
            scale = 128 ** -0.5
            o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, sg, scale, True)
            delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
            refs = fa.flash_bwd_plain(q, k, v, sg, do, lse_ref, delta, scale, True)
            split = fa.dkv_group_split(b, s, hq, hkv, n_sm)
            shape = fa.dkv_workspace_shape(b, s, hkv, split)
            ws = None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
            o, dq, dk, dv = (torch.empty_like(x) for x in (q, q, k, v))
            lse = torch.empty(b, hq, s, device=dev, dtype=torch.float32)
            p = [x.data_ptr() for x in (q, k, v, sg, rng)]
            tail = (b, s, hq, hkv, 128, scale, 1, stream)
            calls = {name: {
                "K1": lambda lib=lib: lib.vt_flash_fwd(*p, o.data_ptr(), lse.data_ptr(), *tail),
                "K2": lambda lib=lib: lib.vt_flash_bwd_dkv(
                    *p, do.data_ptr(), lse_ref.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), 0 if ws is None else ws.data_ptr(), split, *tail),
                "K3": lambda lib=lib: lib.vt_flash_bwd_dq(
                    *p, do.data_ptr(), lse_ref.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail),
            } for name, lib in libs.items()}
            for name in libs:
                for kern, call in calls[name].items():
                    if call() != 0:
                        raise RuntimeError(f"{name} {kern}: launch failed")
                torch.cuda.synchronize()
                cs.check_close(f"K1 O ({name}, {tag})", o, o_ref)
                cs.check_close(f"K1 LSE ({name}, {tag})", lse, lse_ref, atol=cs.TOL_LSE, rtol=0.0)
                for label, got, ref in zip(("K3 dQ", "K2 dK", "K2 dV"), (dq, dk, dv), refs):
                    cs.check_close(f"{label} ({name}, {tag})", got, ref)
            ms = {(name, kern): [] for name in libs for kern in KERNELS}
            for _ in range(3):  # in turns, so drift hits every variant alike
                for kern in KERNELS:
                    for name in libs:
                        ms[name, kern].append(cs.timed_ms(calls[name][kern], reps=20))
            for kern in KERNELS:
                for name in libs:
                    best = min(ms[name, kern])
                    results[f"{tag} {kern} {name}"] = best
                    what = variants[name][0]
                    mark = "" if ABOUT.get(name, kern) == kern else " (not this variant's kernel)"
                    print(f"{tag:34s} {kern} {name:20s} {best:.4f} ms  [{what}]{mark}",
                          flush=True)
            del q, k, v, do, o_ref, lse_ref, delta, refs, ws, o, dq, dk, dv, lse, calls
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

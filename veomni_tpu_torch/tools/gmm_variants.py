"""Design variants of the grouped-GEMM kernels K4-K6, timed side by side.

Each variant in ``VARIANTS`` is a list of exact edits to a copy of
``veomni_tpu_torch/csrc/grouped_gemm.cu`` (the default is the source as it
is). Every variant is built into a library of its own under the system temp
directory (one ``nvcc`` per variant, all at once), checked against the plain versions at the MoE main path's shapes
(M = 131072 routed rows, E = 128, the layer-0 routing of its first batch,
gate/up K = 2048 N = 768 and down K = 768 N = 2048; the diagnostic variants
are not expected to agree), and timed in turns with CUDA events, best of
three runs of 20 launches. With ``--single-expert`` all rows go to one
expert instead. Run from the repository root on a machine with one NVIDIA
Hopper card::

    python3 -m veomni_tpu_torch.tools.gmm_variants [--single-expert]

It prints one line per (shape, kernel, variant) and then one JSON line with
every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = "grouped_gemm.cu"

# name -> (what, edits); the diagnostic variants compute something else
VARIANTS = {
    "default": ("the source as it is", []),
    "static-schedule": ("block b takes tiles b, b + grid, ... instead of drawing them in order",
                        [("int t = (int)atomicAdd(ticket, 1u);", "int t = (int)blockIdx.x;"),
                         ("const int next = (int)atomicAdd(ticket, 1u);",
                          "const int next = t + (int)gridDim.x;")]),
    "tile-128": ("128 x 128 output tiles at every width (5 ring stages)",
                 [("return W % 256 == 0", "return false")]),
    "no-weight-hint": ("K5's weight TMA loads without the L2 evict-last hint",
                       [("tma_load_2d_hint(b, map_b, full, c * BK, e * K + w0, keep);",
                         "tma_load_2d(b, map_b, full, c * BK, e * K + w0);")]),
    "mainloop-only": ("diagnostic: K4/K5 without epilogue (nothing staged, nothing stored)",
                      [("stage_rows<TN, false>(stg_p, m0, row, col, lo, hi, acc);", ""),
                       ("stage_rows<TN, true>(stg_p, m0, row, col, gs[E], M, acc);", ""),
                       ("tma_store_2d(map_out, stg + j * BM * 128, w0 + 64 * j, m0);", ";")]),
    # K6 (the kind "t")
    "t-no-epilogue": ("diagnostic: K6 without epilogue (nothing staged, nothing stored)",
                      [("stage_rows<TN, false>(stg_p, 0, row, col, 0, BM, acc);", ""),
                       ("tma_store_3d(map_out, stg + j * BM * 128, n0 + 64 * j, k0, e);",
                        ";")]),
    "t-serial-epilogue": ("K6 with its epilogue not overlapped: each tile's stores are waited "
                          "for before the next tile's mainloop",
                          [("zero_regs(acc);  // the next tile's sum",
                            "if (storer) bulk_wait<0>();\n          named_barrier<1, 256>();\n"
                            "          zero_regs(acc);")]),
}
DIAGNOSTIC = ("mainloop-only", "t-no-epilogue")


def build_edited(source: str, name: str, edits, workdir: str) -> ctypes.CDLL:
    """Copy csrc to ``workdir/name``, apply ``edits`` (each anchor must occur
    exactly once) to ``source`` there, build it with the package's nvcc flags
    and load it."""
    from veomni_tpu_torch.ops.cuda import build

    vdir = os.path.join(workdir, name)
    shutil.copytree(build.CSRC_DIR, vdir)
    path = os.path.join(vdir, source)
    with open(path) as f:
        text = f.read()
    for anchor, replacement in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found exactly once: {anchor!r}")
        text = text.replace(anchor, replacement)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(vdir, "lib.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(lib)


def build_variant(name: str, edits, workdir: str) -> ctypes.CDLL:
    """Build csrc with ``edits`` applied to the grouped-GEMM source."""
    cdll = build_edited(SOURCE, name, edits, workdir)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (cdll.vt_gmm_fwd, cdll.vt_gmm_dlhs, cdll.vt_gmm_t):
        fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
    return cdll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--single-expert", action="store_true",
                    help="all rows to one expert (no expert boundaries, weights stay in L2)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.card_line()
    sizes = cs.moe_group_sizes(dev, 4096, 4)
    if args.single_expert:
        sizes = sizes.sum().reshape(1)
    torch.cuda.empty_cache()
    starts = gg.group_starts(sizes)
    m, e = int(starts[-1]), sizes.numel()
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    with tempfile.TemporaryDirectory(prefix="gmm_variants_") as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = {name: pool.submit(build_variant, name, edits, tmp)
                     for name, (_, edits) in VARIANTS.items()}
            libs = {name: f.result() for name, f in built.items()}
        for k, n in ((2048, 768), (768, 2048)):
            gen = torch.Generator(device=dev).manual_seed(2)
            lhs = torch.randn(m, k, device=dev, generator=gen).bfloat16()
            rhs = torch.randn(e, k, n, device=dev, generator=gen).bfloat16()
            g = torch.randn(m, n, device=dev, generator=gen).bfloat16()
            refs = {"fwd": gg.gmm_plain(lhs, rhs, starts).float(),
                    "dlhs": gg.gmm_dlhs_plain(g, rhs, starts).float(),
                    "t": gg.gmm_t_plain(lhs, g, starts, e).float()}
            outs = {"fwd": torch.empty(m, n, device=dev, dtype=torch.bfloat16),
                    "dlhs": torch.empty(m, k, device=dev, dtype=torch.bfloat16),
                    "t": torch.empty(e, k, n, device=dev, dtype=torch.bfloat16)}
            calls = {name: {
                "fwd": lambda lib=lib: lib.vt_gmm_fwd(lhs.data_ptr(), rhs.data_ptr(),
                                                     starts.data_ptr(), outs["fwd"].data_ptr(),
                                                     m, k, n, e, stream),
                "dlhs": lambda lib=lib: lib.vt_gmm_dlhs(g.data_ptr(), rhs.data_ptr(),
                                                       starts.data_ptr(), outs["dlhs"].data_ptr(),
                                                       m, k, n, e, stream),
                "t": lambda lib=lib: lib.vt_gmm_t(lhs.data_ptr(), g.data_ptr(),
                                                 starts.data_ptr(), outs["t"].data_ptr(),
                                                 m, k, n, e, stream)}
                for name, lib in libs.items()}
            flops = 2.0 * m * k * n
            for kind in ("fwd", "dlhs", "t"):
                ms = {name: [] for name in libs}
                for name in libs:
                    if calls[name][kind]() != 0:
                        raise RuntimeError(f"{name} {kind}: launch failed")
                    torch.cuda.synchronize()
                    err = (outs[kind].float() - refs[kind]).abs()
                    allowed = 1e-4 * refs[kind].abs().max() + 2.0 ** -7 * refs[kind].abs()
                    if name not in DIAGNOSTIC and not bool((err <= allowed).all()):
                        raise AssertionError(f"{name} {kind}: disagrees with its plain version")
                for _ in range(3):  # in turns, so drift hits every variant alike
                    for name in libs:
                        ms[name].append(cs.timed_ms(calls[name][kind], reps=20))
                for name in libs:
                    best = min(ms[name])
                    results[f"K={k} N={n} {kind} {name}"] = best
                    print(f"K={k} N={n} {kind:4s} {name:17s} {best:.4f} ms "
                          f"({flops / best / 1e9:.0f} TFLOP/s)  [{VARIANTS[name][0]}]", flush=True)
            del lhs, rhs, g, refs, outs, calls
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "single_expert": args.single_expert, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

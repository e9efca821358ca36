"""Two checkouts of the repository on one card: flash K1-K3 at head dim 128
and the dense bare step loop, timed in turns.

Each tree runs in a process of its own from its own root (so it builds and
loads its own kernels): the given tree first, this checkout twice, the
given tree again. In each: K1, K2 and K3 on the dense main path's first
packed batch (B=4, S=4096, D=128) at the Qwen3-0.6B head layout (Hq 16, Hkv
8) and the Qwen3-30B-A3B one (32, 4), best of three runs of 20 launches
with CUDA events; then four warm steps of ``train_text_step``'s dense
Qwen3-0.6B loop (seq 4096 x micro-batch 4). Run from the repository root on
a machine with one NVIDIA Hopper card, with the other tree unpacked
somewhere (e.g. ``git archive <commit> | tar -x -C build/parent``)::

    python3 -m veomni_tpu_torch.tools.tree_compare --other build/parent

It prints one JSON line per run and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SNIPPET = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from veomni_tpu_torch.ops.cuda import flash_attention as fa
from veomni_tpu_torch.train_text_step import packed_batches, run_train_steps
dev = torch.device("cuda")
seg = torch.from_numpy(next(packed_batches(151936, 4096, 4))["segment_ids"][0]).to(dev)
out = {}
for hq, hkv in ((16, 8), (32, 4)):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(4, 4096, hq, 128, device=dev, generator=g).bfloat16()
    k = torch.randn(4, 4096, hkv, 128, device=dev, generator=g).bfloat16()
    v = torch.randn(4, 4096, hkv, 128, device=dev, generator=g).bfloat16()
    do = torch.randn(4, 4096, hq, 128, device=dev, generator=g).bfloat16()
    rng, sc = fa.seg_ranges(seg), 128 ** -0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, seg, sc, True, rng)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {"K1": lambda: fa.flash_fwd_cuda(q, k, v, seg, sc, True, rng),
             "K2": lambda: fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse, delta, sc, True, rng),
             "K3": lambda: fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse, delta, sc, True, rng)}
    for name, call in calls.items():
        out[f"{name} {hq}/{hkv} ms"] = min(cs.timed_ms(call, reps=20) for _ in range(3))
    del q, k, v, do, o, lse, delta, calls
torch.cuda.empty_cache()
out["dense step ms"] = [r["step_ms"] for r in run_train_steps(4096, 4, 5, device=dev)[1:]]
print("RESULT " + json.dumps(out))
'''


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", SNIPPET], cwd=tree, capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": os.path.abspath(tree)})
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[0][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other tree")
    args = ap.parse_args(argv)
    for name, tree in (("other", args.other), ("this", REPO), ("this", REPO),
                       ("other", args.other)):
        print(json.dumps({"tree": name, **run(tree)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

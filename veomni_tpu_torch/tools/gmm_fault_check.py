"""Planted faults in the grouped-GEMM kernels K4-K6: do ``chip_smoke.py``'s checks bite?

For each fault in ``FAULTS``, copy ``chip_smoke.py`` and ``veomni_tpu_torch/``
into a fresh directory outside the checkout (under the system temp
directory), apply one edit to the copy's ``csrc/grouped_gemm.cu`` and run the
copy's ``chip_smoke.py``. A fault is caught when that run exits non-zero,
prints no result line and stops at the check named for the fault. Run from
the repository root on a machine with one NVIDIA Hopper card::

    python3 -m veomni_tpu_torch.tools.gmm_fault_check [--log-dir DIR]

It prints, for each fault, the edit, the exit code and the failing check's
log line (with its worst error/allowed ratio), then one JSON summary line,
and exits 0 only if every fault was caught. With ``--log-dir`` each run's
full output goes to ``DIR/<fault>.log``. Kernel libraries already built in
the checkout's ``build/kernels/`` are copied along; they are keyed by a hash
of their sources, so the edited source is always built anew.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import NamedTuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join("veomni_tpu_torch", "csrc", "grouped_gemm.cu")
# the first small case of chip_smoke.py's grouped-GEMM phase: group sizes
# [100, 156, 0, 256], so m tile 3 (rows 384-511) belongs to expert 3 alone
CASE = "(small ragged+empty, K=128 N=256)"
RUN_TIMEOUT_S = 900  # one faulted chip_smoke.py run stops at its grouped-GEMM phase


class Fault(NamedTuple):
    name: str
    what: str
    anchor: str  # occurs exactly once in SOURCE
    replacement: str
    check: str  # the chip_smoke.py check that must fail


# K4 and K5 share one kernel template and one work schedule (the producer and
# the consumers walk it alike, so a fault there cannot leave the pipeline out
# of step); DLHS is true in K5. Running no contraction chunk for an expert
# leaves its accumulators at 0, which its epilogue writes to its rows.
_EXPERT_CALL = "    expert(m0, w0, e, lo, hi, nchunks);\n"


def _skip_first_expert(kernel: str) -> str:
    """The expert call with the fault, in the kernel that ``kernel`` selects."""
    return (f"    expert(m0, w0, e, lo, hi, ({kernel} && m0 == 3 * BM && w0 == 0 &&\n"
            "                               e == first_expert(gs, E, m0)) ? 0 : nchunks);\n")


FAULTS = (
    Fault("K4", "K4 skips the first expert of (m tile 3, n tile 0): its rows come out 0",
          _EXPERT_CALL, _skip_first_expert("!DLHS"), f"K4 out (autograd path) {CASE}"),
    Fault("K5", "K5 skips the first expert of (m tile 3, k tile 0): its rows come out 0",
          _EXPERT_CALL, _skip_first_expert("DLHS"), f"K5 dlhs (autograd path) {CASE}"),
    Fault("K6", "K6 loads 32-row chunk 1 of expert 0's lhs rows as zeros",
          "load_cr(As, lhs, K, lo + c * BC, k0, hi);",
          "load_cr(As, lhs, K, lo + c * BC, k0, (e == 0 && c == 1) ? lo : hi);",
          f"K6 drhs (autograd path) {CASE}"),
)


def plant(root: str, fault: Fault) -> None:
    """Apply ``fault`` to the grouped-GEMM source under ``root``."""
    path = os.path.join(root, SOURCE)
    with open(path) as f:
        text = f.read()
    if text.count(fault.anchor) != 1:
        raise RuntimeError(f"{fault.name}: anchor not found exactly once in {SOURCE}")
    with open(path, "w") as f:
        f.write(text.replace(fault.anchor, fault.replacement))


def make_copy(dst: str) -> None:
    """What ``chip_smoke.py`` needs, plus the kernels already built here."""
    shutil.copytree(os.path.join(REPO, "veomni_tpu_torch"), os.path.join(dst, "veomni_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)
    built = glob.glob(os.path.join(REPO, "build", "kernels", "*.so"))
    if built:
        os.makedirs(os.path.join(dst, "build", "kernels"))
        for lib in built:
            shutil.copy(lib, os.path.join(dst, "build", "kernels"))


def run_fault(fault: Fault, log_dir: str | None) -> dict:
    with tempfile.TemporaryDirectory(prefix="gmm_fault_") as tmp:
        make_copy(tmp)
        plant(tmp, fault)
        env = {**os.environ, "PYTHONPATH": tmp}
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    if log_dir:
        with open(os.path.join(log_dir, f"{fault.name}.log"), "w") as f:
            f.write(out)
    line = next((ln.strip() for ln in proc.stdout.splitlines()
                 if ln.strip().startswith(fault.check + ": max_abs_err")), None)
    caught = (proc.returncode != 0 and '"ok": true' not in proc.stdout
              and f"{fault.check}: kernel disagrees" in proc.stderr)
    return {"name": fault.name, "fault": fault.what, "rc": proc.returncode, "caught": caught,
            "check": fault.check, "line": line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", default=None, help="write each run's full output here")
    args = ap.parse_args(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    results = []
    for fault in FAULTS:
        print(f"{fault.name}: {fault.what}\n  edit: {fault.anchor.strip()!r}\n"
              f"     -> {fault.replacement.strip()!r}", flush=True)
        r = run_fault(fault, args.log_dir)
        print(f"  exit {r['rc']}, caught={r['caught']}: {r['line']}", flush=True)
        results.append(r)
    ok = all(r["caught"] for r in results)
    print(json.dumps({"faults": results, "all_caught": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Start a world of ranks on one host.

The reference tests its mesh on virtual CPU devices of one process
(``train.num_virtual_devices``); torch has no such devices, so the port
starts one process a rank. Two entries:

* :func:`spawn_entry_point` — the trainer entry points' counterpart of
  ``num_virtual_devices: N`` with ``platform: cpu``: the command re-runs
  itself as N processes with the launcher environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which
  ``trainer/base.py::maybe_initialize_distributed`` joins over gloo;
* :func:`run_ranks` — runs ``module:function(rank, world, payload)`` in
  ``world`` fresh processes inside one process group (joined for the
  target, or by it from the launcher environment) and returns their JSON
  results (the parity tests and ``chip_smoke.py``'s two-rank legs).

A rank process imports nothing but what its target needs. Every process it
starts is waited for, and killed at the time limit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_all(procs: Sequence[subprocess.Popen], timeout: Optional[float]):
    """(exit codes of every process, the index of the first that failed on
    its own or None); all are killed once one fails or the time (if any) is
    up (a rank waiting on a dead peer would hang)."""
    deadline = time.time() + timeout if timeout is not None else float("inf")
    codes: List[Optional[int]] = [None] * len(procs)
    first = None
    try:
        while any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
                    if codes[i] not in (None, 0) and first is None:
                        first = i
            if first is not None or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            codes[i] = p.wait()
    return [int(c) for c in codes], first


def launcher_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """A launcher's environment for rank ``rank`` of a one-host world."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def spawn_entry_point(world: int, argv: Sequence[str], module: str) -> int:
    """Run ``python -m module *argv`` as ``world`` CPU ranks; the exit code
    is the first failing rank's, else 0."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, **launcher_env(rank, world, port), "CUDA_VISIBLE_DEVICES": ""}
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))
    codes, first = _wait_all(procs, None)
    return codes[first] if first is not None else next((c for c in codes if c), 0)


def run_ranks(world: int, target: str, payload: Any = None, *, device: str = "cpu",
              timeout: float = 600.0, env: Optional[Dict[str, str]] = None,
              join: bool = True) -> List[Any]:
    """``target`` ("module:function") called as ``fn(rank, world, payload)``
    in each of ``world`` processes of one process group; returns the ranks'
    JSON-able results in rank order. With ``join`` each process joins a
    gloo group before the call; without, the target joins from the
    launcher environment itself (``trainer/base.py::
    maybe_initialize_distributed``). ``device`` 'cpu' hides the cards from
    the ranks; 'cuda' leaves them visible (ranks share a card when there
    are fewer cards than ranks). Raises with the failing rank's last output
    when a rank fails."""
    with tempfile.TemporaryDirectory(prefix="veomni-ranks-") as work:
        return _run_ranks(work, world, target, payload, device, timeout, env, join)


def _run_ranks(work, world, target, payload, device, timeout, env, join) -> List[Any]:
    with open(os.path.join(work, "payload.json"), "w") as f:
        json.dump(payload, f)
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        # unbuffered, with Python's fault handler: a rank that dies, even on
        # a signal, leaves its last words in its log
        child_env = {**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONFAULTHANDLER": "1",
                     **(env or {}), **launcher_env(rank, world, port)}
        if device == "cpu":
            child_env["CUDA_VISIBLE_DEVICES"] = ""
        log_path = os.path.join(work, f"rank{rank}.log")
        log = open(log_path, "w")
        logs.append((log, log_path))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "veomni_tpu_torch.parallel.launch", target, work, device,
             "join" if join else "target-joins"],
            env=child_env, stdout=log, stderr=subprocess.STDOUT))
    try:
        codes, first = _wait_all(procs, timeout)
    finally:
        for log, _ in logs:
            log.close()
    if any(codes):
        rank = first if first is not None else next(i for i, c in enumerate(codes) if c)
        with open(logs[rank][1]) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"rank {rank} of {target} exited {codes[rank]} "
                           f"(exit codes {codes}):\n{tail}")
    out = []
    for rank in range(world):
        with open(os.path.join(work, f"result{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _child(target: str, work: str, device: str, join: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device == "cpu":
        torch.set_num_threads(1)
    with open(os.path.join(work, "payload.json")) as f:
        payload = json.load(f)
    if join == "join":
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(rank, world, payload)
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(work, f"result{rank}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    _child(*sys.argv[1:5])

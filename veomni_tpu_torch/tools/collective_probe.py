"""Which collectives two processes sharing one card can run.

NCCL keeps one rank per device, so two ranks on one card talk over gloo.
This probe spawns two processes on ``cuda:0`` (or the CPU with ``--cpu``)
and tries, on tensors of that device, each collective the parallel layer
issues: ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast``, ``isend``/``irecv``, then FSDP2's
``fully_shard`` forward and backward over the gloo group. A last leg asks
NCCL for two ranks on the one device. It prints one JSON line per leg and a
summary line ``{"probe": {...}}``.

    python -m veomni_tpu_torch.tools.collective_probe [--cpu]
"""

from __future__ import annotations

import argparse
import json
import socket
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


LEGS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
        "broadcast", "isend_irecv", "fsdp2_fully_shard")


def _legs(dev):
    """{leg name: fn() -> bool} on tensors of ``dev``, in this process's group."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == 3.0).all())

    def all_gather_into_tensor():
        x = torch.full((2,), float(rank), device=dev)
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist() == [0.0, 0.0, 1.0, 1.0]

    def reduce_scatter_tensor():
        x = torch.arange(4, dtype=torch.float32, device=dev) * (rank + 1)
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist() == ([0.0, 3.0] if rank == 0 else [6.0, 9.0])

    def all_to_all_single():
        x = torch.tensor([10.0 * rank, 10.0 * rank + 1], device=dev)
        out = torch.empty(2, device=dev)
        dist.all_to_all_single(out, x)
        return out.tolist() == [float(rank), float(10 + rank)]

    def broadcast():
        x = torch.full((3,), float(rank), device=dev)
        dist.broadcast(x, src=1)
        return bool((x == 1.0).all())

    def isend_irecv():
        x = torch.full((3,), float(rank), device=dev)
        out = torch.empty(3, device=dev)
        peer = (rank + 1) % world
        reqs = [dist.isend(x, peer), dist.irecv(out, (rank - 1) % world)]
        for r in reqs:
            r.wait()
        return bool((out == float((rank - 1) % world)).all())

    def fsdp2():
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.fsdp import fully_shard

        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)).to(dev)
        mesh = DeviceMesh.from_group(dist.group.WORLD, dev.type)
        for m in model:
            fully_shard(m, mesh=mesh)
        fully_shard(model, mesh=mesh)
        loss = model(torch.ones(2, 8, device=dev)).sum()
        loss.backward()
        return all(p.grad is not None for p in model.parameters())

    return dict(zip(LEGS, (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
                           all_to_all_single, broadcast, isend_irecv, fsdp2)))


def _worker(rank: int, port: int, cpu: bool, leg: str, queue) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu" if cpu else "cuda:0")
    out = {}
    if leg != "nccl_two_ranks_one_device":
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2)
        fn = _legs(dev)[leg]
        t0 = time.perf_counter()
        try:
            ok = bool(fn())
            out = {"ok": ok, "ms": round((time.perf_counter() - t0) * 1e3, 3)}
        except Exception as e:  # the probe records what a backend refuses
            out = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}
        dist.destroy_process_group()
    else:
        try:
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                    rank=rank, world_size=2, device_id=dev)
            x = torch.ones(1, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            out = {"ok": float(x.item()) == 2.0}
            dist.destroy_process_group()
        except Exception as e:
            out = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}
    queue.put((rank, out))


def _run_leg(ctx, leg: str, cpu: bool, timeout: float):
    """One leg in a fresh pair of processes (a backend that cannot take a
    tensor may abort the process): ({rank: result}, exit codes)."""
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, cpu, leg, queue)) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    while len(results) < 2 and time.time() < deadline:
        try:
            rank, out = queue.get(timeout=max(0.5, deadline - time.time()))
        except Exception:  # queue.Empty: a rank died or hangs
            break
        results[rank] = out
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join(timeout=5)
    return results, [p.exitcode for p in procs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="probe CPU tensors instead of cuda:0")
    ap.add_argument("--timeout", type=float, default=40.0, help="seconds a leg may take")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    from torch.distributed.fsdp import FSDPModule

    ctx = mp.get_context("spawn")
    legs = list(LEGS)
    if not args.cpu:
        legs.append("nccl_two_ranks_one_device")
    summary = {}
    for leg in legs:
        results, codes = _run_leg(ctx, leg, args.cpu, args.timeout)
        for rank in sorted(results):
            print(json.dumps({"rank": rank, "leg": leg, **results[rank]}), flush=True)
        summary[leg] = len(results) == 2 and all(r.get("ok") for r in results.values())
        if len(results) < 2:
            print(json.dumps({"leg": leg, "ranks_reported": len(results), "exitcodes": codes}),
                  flush=True)
    hooks = {name: hasattr(FSDPModule, name) for name in (
        "set_custom_all_gather", "set_custom_reduce_scatter", "set_gradient_divide_factor",
        "set_reduce_scatter_divide_factor", "set_force_sum_reduction_for_comms")}
    print(json.dumps({"probe": summary, "fsdp_hooks": hooks,
                      "device": "cpu" if args.cpu else "cuda:0"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

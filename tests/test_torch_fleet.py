"""The port's fleet monitor (``veomni_tpu_torch/observability/fleet.py``)
against the JAX one, on the CPU.

* ``compute_skew`` on seeded tables (2-8 ranks, one straggler or none)
  equals the reference's exactly, the suspect out of its own median.
* ``FleetMonitor`` with an injected exchange, beside the reference's on
  the same fake fleet: the same ``fleet.*`` gauges and the same
  ``fleet.straggler`` flight event (rank, ratio, median and max); off below
  two ranks (heartbeat only); three consecutive exchange failures disable
  the exchange, one transient failure does not; ``/debug/fleet``'s last
  window names the slow rank.
* The trainer writes its heartbeat each sync window (the reference's
  ``observability_fleet`` default of 1), and its step advances.
* The default transport: two processes in a gloo process group (a file
  rendezvous) all-gather their rows and name the same straggler.
"""

import json
import os

import numpy as np
import pytest

from veomni_tpu.observability.fleet import FleetMonitor as JFleet
from veomni_tpu.observability.fleet import compute_skew as j_compute_skew
from veomni_tpu.observability.metrics import MetricsRegistry as JRegistry
from veomni_tpu_torch.observability.fleet import (
    FleetMonitor,
    compute_skew,
    read_heartbeats,
)
from veomni_tpu_torch.observability.flight_recorder import get_flight_recorder
from veomni_tpu_torch.observability.metrics import MetricsRegistry

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _table(rng, world, straggle):
    means = rng.uniform(0.01, 0.02, world)
    if straggle is not None:
        means[straggle] *= 5
    return np.stack([np.arange(world, dtype=float), means, means * 1.1,
                     np.full(world, 7.0)], axis=1)


@pytest.mark.parametrize("world,straggle", [(2, 1), (3, None), (4, 2), (8, 5)])
def test_compute_skew_equals_the_reference(world, straggle):
    table = _table(np.random.default_rng(world), world, straggle)
    assert compute_skew(table) == j_compute_skew(table)


FLEET = np.stack([np.array([0.0, 0.001, 0.001, 9.0]), np.array([1.0, 0.030, 0.030, 9.0]),
                  np.array([2.0, 0.001, 0.002, 9.0]), np.array([3.0, 0.0012, 0.0015, 9.0])])


def test_injected_exchange_gauges_and_straggler_event(tmp_path):
    reg, j_reg = MetricsRegistry(), JRegistry()
    kw = dict(world_size=4, rank=0, straggler_factor=2.0, exchange_fn=lambda local: FLEET)
    mon = FleetMonitor(registry=reg, heartbeat_dir=str(tmp_path / "port"), **kw)
    j_mon = JFleet(registry=j_reg, heartbeat_dir=str(tmp_path / "ref"), **kw)
    assert mon.observe_window(9, 0.001) == j_mon.observe_window(9, 0.001)
    for name in ("fleet.step_time_skew_s", "fleet.step_time_median_s", "fleet.step_time_max_s",
                 "fleet.slowest_rank"):
        assert reg.gauge(name).value == j_reg.gauge(name).value, name
    assert reg.counter("fleet.stragglers").value == 1 == mon.straggler_count
    events = [e for e in get_flight_recorder().snapshot(limit=0)["events"]
              if e["kind"] == "fleet.straggler" and e["payload"].get("step") == 9]
    assert len(events) == 1 and events[0]["cid"] == "1"
    assert events[0]["payload"]["ratio"] == round(0.030 / 0.001, 3)  # the others' median
    doc = mon.debug_doc()
    assert doc["last_window"]["slowest_rank"] == 1 and doc["last_window"]["straggling"]
    assert doc["heartbeats"][0]["global_step"] == 9


def test_off_below_two_ranks_heartbeats_only(tmp_path):
    mon = FleetMonitor(registry=MetricsRegistry(), world_size=1, rank=0,
                       heartbeat_dir=str(tmp_path))
    assert not mon.exchange_enabled and mon.observe_window(5, 0.01) is None
    assert read_heartbeats(str(tmp_path))[0]["global_step"] == 5


def test_three_failures_disable_one_does_not(tmp_path):
    calls = [0]

    def broken(local):
        calls[0] += 1
        raise RuntimeError("collective transport down")

    mon = FleetMonitor(registry=MetricsRegistry(), world_size=4, rank=0,
                       heartbeat_dir=str(tmp_path), exchange_fn=broken)
    budget = FleetMonitor.MAX_CONSECUTIVE_EXCHANGE_FAILURES
    assert budget == JFleet.MAX_CONSECUTIVE_EXCHANGE_FAILURES == 3
    for i in range(budget):
        assert mon.observe_window(i + 1, 0.01) is None
        assert mon.exchange_enabled == (i + 1 < budget)
    assert mon.observe_window(budget + 1, 0.01) is None and calls[0] == budget
    assert read_heartbeats(str(tmp_path))[0]["global_step"] == budget + 1

    fail = [True]

    def flaky(local):
        if fail[0]:
            fail[0] = False
            raise RuntimeError("one dropped round")
        return FLEET

    mon2 = FleetMonitor(registry=MetricsRegistry(), world_size=4, rank=0,
                        heartbeat_dir=str(tmp_path / "b"), exchange_fn=flaky)
    assert mon2.observe_window(1, 0.01) is None and mon2.exchange_enabled
    assert mon2.observe_window(2, 0.01) is not None and mon2._exchange_failures == 0


def test_trainer_heartbeats_each_sync_window(tmp_path):
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    from test_e2e_training import _write_dummy_data
    from test_torch_trainer import port_args

    steps = []

    class Read(Callback):
        def on_step_end(self, trainer, state):
            path = os.path.join(trainer.args.train.output_dir, "heartbeat-0.json")
            if not os.path.exists(path):
                steps.append(None)
                return
            with open(path) as f:
                steps.append(json.load(f)["global_step"])

    _write_dummy_data(tmp_path / "data.jsonl")
    trainer = TextTrainer(port_args(tmp_path, train_steps=4, log_steps=2))
    assert trainer.args.train.observability_fleet == 1  # the reference's default
    trainer.callbacks.append(Read())
    trainer.train()
    trainer.checkpointer.close()
    destroy_parallel_state()
    assert steps == [None, 2, 2, 4]  # written on each sync (log) step


_EXCHANGE = r"""
import json, sys
import torch.distributed as dist
from veomni_tpu_torch.observability.fleet import FleetMonitor
from veomni_tpu_torch.observability.metrics import MetricsRegistry
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
mon = FleetMonitor(registry=MetricsRegistry(), heartbeat_dir=out)
assert (mon.world_size, mon.rank, mon.exchange_enabled) == (world, rank, True)
skew = mon.observe_window(4, 0.5 if rank == 1 else 0.01)
with open(f"{out}/skew-{rank}.json", "w") as f:
    json.dump({"skew": skew, "doc": mon.debug_doc()["last_window"]}, f)
dist.destroy_process_group()
"""


def test_default_exchange_over_a_gloo_process_group(tmp_path):
    """The default transport: two processes in a gloo group all-gather their
    rows; both see the same table, rank 1 (50x slower) named the straggler."""
    import subprocess
    import sys

    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, "-c", _EXCHANGE, str(r), "2", init,
                               str(tmp_path)], env=env) for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    docs = [json.load(open(tmp_path / f"skew-{r}.json")) for r in range(2)]
    assert docs[0]["skew"] == docs[1]["skew"]
    assert docs[0]["skew"]["slowest_rank"] == 1 and docs[0]["doc"]["straggling"]
    assert [row["rank"] for row in docs[1]["doc"]["table"]] == [0, 1]
    assert {d["rank"] for d in read_heartbeats(str(tmp_path))} == {0, 1}

"""The port's foundation modules against the reference's, on the same inputs.

Copies (``utils/registry``, ``observability/metrics``, ``flight_recorder``,
``goodput``, ``resilience/faults``, ``retry``, ``supervisor`` and the gate
and cursor merge/split of ``elastic``) are held to the reference module
called on identical inputs, plus replays of the reference's own assertions
(``tests/test_resilience.py:233,268,557``, ``tests/test_elastic.py:44,100``,
``tests/test_observability.py``). Ports are held to what they promise:
``observability/spans`` mirrors into ``torch.profiler.record_function``,
``utils/helper`` seeds a ``torch.Generator`` and meters without a device
peak on the CPU, ``utils/determinism`` turns deterministic algorithms on,
``resilience/elastic.capture_topology`` reads torch, ``parallel/
parallel_state`` lays one process out as a world of one rank (its
multi-process mesh: ``tests/test_torch_parallel_*.py``), and
``models/auto`` builds the text families and raises for the rest.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@pytest.fixture(autouse=True)
def _clean():
    yield
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.resilience.faults import disarm_faults

    disarm_faults()
    os.environ.pop("VEOMNI_FAULT_PLAN", None)
    destroy_parallel_state()


# ------------------------------------------------------------- resilience


def test_fault_plan_grammar_env_and_file(tmp_path):
    from veomni_tpu_torch.resilience import faults

    os.environ["VEOMNI_FAULT_PLAN"] = json.dumps(
        [{"point": "ckpt.save", "mode": "exception", "hit": 2, "times": 2, "message": "boom"}])
    assert faults.arm_from_env()
    assert faults.fault_point("ckpt.save") is None
    for _ in range(2):
        with pytest.raises(faults.InjectedFault, match="boom"):
            faults.fault_point("ckpt.save")
    assert faults.fault_point("ckpt.save") is None
    assert [a.hit for a in faults.fired_faults()] == [2, 3]
    assert issubclass(faults.InjectedFault, OSError)

    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps([{"point": "step.loss", "mode": "nan"}]))
    os.environ["VEOMNI_FAULT_PLAN"] = "@" + str(plan_file)
    assert faults.arm_from_env()
    act = faults.fault_point("step.loss")
    assert act is not None and act.mode == "nan" and act.hit == 1
    assert faults.fault_point("step.loss") is None

    with pytest.raises(ValueError, match="unknown fault mode"):
        faults.configure_faults([{"point": "x", "mode": "explode"}])
    with pytest.raises(ValueError, match="missing 'point'"):
        faults.configure_faults([{"mode": "nan"}])
    faults.disarm_faults()
    assert faults.fault_point("ckpt.save") is None
    assert faults.fired_faults() == []


def test_retry_deterministic_backoff_and_exhaustion():
    from veomni_tpu.resilience.retry import RetryPolicy as JPolicy
    from veomni_tpu_torch.resilience.retry import RetryPolicy, retry_call

    delays, calls = [], []

    def flaky(fail_times):
        calls.append(1)
        if len(calls) <= fail_times:
            raise OSError(f"transient {len(calls)}")
        return "ok"

    policy = RetryPolicy(retries=3, base_delay_s=0.5, max_delay_s=1.5)
    assert retry_call(flaky, 2, policy=policy, sleep=delays.append) == "ok"
    assert delays == [0.5, 1.0]
    ref = JPolicy(retries=3, base_delay_s=0.5, max_delay_s=1.5)
    assert [policy.delay(i) for i in range(6)] == [ref.delay(i) for i in range(6)]
    assert policy.delay(5) == 1.5

    calls.clear()
    with pytest.raises(OSError, match="transient 4"):
        retry_call(flaky, 99, policy=policy, sleep=lambda _: None)
    assert len(calls) == 4

    def bug():
        calls.append(1)
        raise ValueError("schema mismatch")

    calls.clear()
    with pytest.raises(ValueError):
        retry_call(bug, policy=policy, sleep=lambda _: None)
    assert len(calls) == 1


def _classify_cases():
    topo4 = {"world_size": 4, "device_count": 4, "mesh": {"fsdp": 4, "tp": 1}}
    return [
        ((topo4, 4), dict(rank_files=[0, 1, 2, 3])),
        ((topo4, 2), dict(rank_files=[0, 1, 2, 3])),
        ((topo4, 8), dict(rank_files=[0, 1, 2, 3])),
        ((topo4, 2), dict(rank_files=[0, 2, 3])),
        (({"world_size": 4, "mesh": {"fsdp": 2, "tp": 2}}, 4),
         dict(target_mesh={"fsdp": 1, "tp": 4}, rank_files=[0, 1, 2, 3])),
        (({"world_size": 1, "device_count": 4, "mesh": {"fsdp": 4}}, 1),
         dict(target_mesh={"fsdp": 2}, target_device_count=2, rank_files=[0])),
        ((None, 1), dict(rank_files=[0])),
        ((None, 2), dict(rank_files=[0, 1])),
        ((None, 1), dict(rank_files=[0, 1])),
        ((None, 4), {}),
        (({"world_size": 1}, 1), dict(rank_files=[7])),
        (({"world_size": 2, "rank_state_files": 2}, 1), dict(rank_files=None)),
        (({"world_size": 2, "rank_state_files": 2}, 1), dict(rank_files=[0, 1])),
    ]


def test_classify_restore_matches_reference():
    from veomni_tpu.resilience.elastic import classify_restore as j_classify
    from veomni_tpu_torch.resilience.elastic import classify_restore

    verdicts = []
    for args, kwargs in _classify_cases():
        got = classify_restore(*args, **kwargs)
        assert got == j_classify(*args, **kwargs)
        verdicts.append(got[0])
    assert verdicts == ["ok", "elastic", "elastic", "incompatible", "incompatible", "elastic",
                        "ok", "ok", "incompatible", "unknown", "incompatible",
                        "incompatible", "elastic"]


def _native_state(cursor, pending, epoch=0, seed=1, dropped=0):
    return {"dataloader": {
        "epoch": epoch, "cursor": cursor, "seed": seed, "dp_rank": 0, "dp_size": 2,
        "collator": {"pending": pending, "dropped_oversized": dropped}}}


def test_merge_split_native_loader_states_match_reference():
    from veomni_tpu.resilience import elastic as j_elastic
    from veomni_tpu_torch.resilience import elastic

    states = {0: _native_state(10, ["a", "b"], dropped=1), 1: _native_state(12, ["c"])}
    merged = elastic.merge_rank_states(states)
    assert merged == j_elastic.merge_rank_states(states)
    assert merged["dataloader"]["global_cursor"] == 22
    for world in (1, 2, 3, 4):
        for rank in range(world):
            assert (elastic.split_rank_state(merged, world, rank)
                    == j_elastic.split_rank_state(merged, world, rank))
    quarters = [elastic.split_rank_state(merged, 4, r)["dataloader"] for r in range(4)]
    assert [q["cursor"] for q in quarters] == [6, 6, 5, 5]
    with pytest.raises(elastic.ElasticRestoreError, match="torn sidecar set"):
        elastic.merge_rank_states({0: _native_state(1, []), 2: _native_state(1, [])})


def test_capture_topology_reads_torch():
    from veomni_tpu_torch.parallel import init_parallel_state
    from veomni_tpu_torch.resilience.elastic import TOPOLOGY_VERSION, capture_topology

    topo = capture_topology()
    assert topo["version"] == TOPOLOGY_VERSION and topo["world_size"] == 1
    assert topo["torch"] == torch.__version__ and topo["mesh"] == {}
    init_parallel_state()
    mesh = capture_topology()["mesh"]
    assert set(mesh) == {"pp", "dp_replicate", "ep", "fsdp", "ulysses", "cp", "tp"}
    assert set(mesh.values()) == {1}


def _observe_all(sup, entries):
    out = []
    for step, loss, ok in entries:
        out.append(sup.observe(step, {"loss": loss, "step_ok": ok}))
    out.append(sup.drain())
    return out


def test_supervisor_verdicts_match_reference():
    from veomni_tpu.resilience.supervisor import SupervisorPolicy as JPolicy
    from veomni_tpu.resilience.supervisor import TrainSupervisor as JSup
    from veomni_tpu_torch.resilience.supervisor import SupervisorPolicy, TrainSupervisor

    entries = [(i + 1, float("nan") if i in (2, 5, 6, 7, 9) else 1.0 + i, i not in (5,))
               for i in range(12)]
    kw = dict(anomaly_budget=4, rollback_after=2, max_rollbacks=1, inflight_depth=2)
    got_sup, ref_sup = TrainSupervisor(SupervisorPolicy(**kw)), JSup(JPolicy(**kw))
    got, ref = _observe_all(got_sup, entries), _observe_all(ref_sup, entries)
    assert got == ref and "rollback" in got
    assert got_sup.stats() == ref_sup.stats()
    # device scalars are read through np.asarray, as the trainer hands them over
    sup = TrainSupervisor(SupervisorPolicy(inflight_depth=0))

    class Lazy:
        def __array__(self, dtype=None, copy=None):
            return np.asarray(float("inf"))

    assert sup.observe(1, {"loss": Lazy(), "step_ok": None}) == "skip"


def test_graceful_shutdown_flags_sigterm():
    from veomni_tpu_torch.resilience import GracefulShutdown

    hits = []
    with GracefulShutdown(on_request=lambda: hits.append(1)) as gs:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if gs.requested:
                break
            time.sleep(0.01)
    assert gs.requested and gs.signum == signal.SIGTERM and hits == [1]


# ---------------------------------------------------------- observability


def test_registry_copy_matches_reference():
    from veomni_tpu.utils.registry import Registry as JRegistry
    from veomni_tpu_torch.utils.registry import Registry

    for cls in (Registry, JRegistry):
        r = cls("things")
        r.register("a", 1)

        @r.register("b")
        def b():
            return 2

        assert r.get("a") == 1 and r.get("b")() == 2 and list(r) == ["a", "b"]
        with pytest.raises(KeyError, match="duplicate"):
            r.register("a", 3)
        with pytest.raises(KeyError, match="unknown key 'z'"):
            r.get("z")


def test_metrics_registry_matches_reference(tmp_path):
    from veomni_tpu.observability.metrics import MetricsRegistry as JRegistry
    from veomni_tpu_torch.observability.metrics import MetricsRegistry

    rng = np.random.default_rng(0)
    values = rng.exponential(0.05, 300).tolist()
    docs = []
    for cls, name in ((MetricsRegistry, "port"), (JRegistry, "ref")):
        reg = cls()
        reg.counter("ckpt.saves").inc(3)
        reg.gauge("mem.x").set(7.5)
        h = reg.histogram("span.step")
        for v in values:
            h.observe(v)
        path = tmp_path / f"{name}.jsonl"
        reg.attach_jsonl(str(path))
        seen = []
        reg.add_export_hook(lambda step, payload, _s=seen: _s.append((step, payload["loss"])))
        reg.export(4, {"loss": 1.25})
        assert seen == [(4, 1.25)]
        assert reg.last_export(step=4)["loss"] == 1.25
        line = json.loads(path.read_text().splitlines()[0])
        line.pop("time", None)
        line.pop("ts", None)
        docs.append((line, reg.export_scalars(), h.percentile(0.5), h.percentile(0.95),
                     reg.histogram_sum("span.step")))
    assert docs[0] == docs[1]


def test_spans_feed_histograms_trace_and_profiler(tmp_path):
    from veomni_tpu_torch.observability import spans
    from veomni_tpu_torch.observability.goodput import GoodputTracker
    from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry

    spans.disable_spans()  # a trainer run earlier in this process leaves them on
    assert spans.span("x") is spans.span("y")  # disabled: the shared no-op
    spans.enable_spans()
    try:
        reg = get_registry()
        before = reg.histogram("span.data.wait").count
        tracker = GoodputTracker(reg)
        tracker.begin_window()
        with spans.span("data.wait"):
            time.sleep(0.01)
        with spans.span("step.dispatch"):
            time.sleep(0.01)
        fracs = tracker.end_window()
        assert reg.histogram("span.data.wait").count == before + 1
        assert abs(sum(v for k, v in fracs.items() if k.endswith("_frac")) - 1.0) < 1e-6
        assert fracs["data_wait_frac"] > 0 and 0 < fracs["goodput_pct"] <= 100
        n = spans.dump_chrome_trace(str(tmp_path / "t.json.gz"))
        assert n >= 2
        from torch.profiler import ProfilerActivity, profile

        spans.set_profiler_active(True)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with spans.span("host.callbacks"):
                    torch.ones(4).sum()
        finally:
            spans.set_profiler_active(False)
        assert "host.callbacks" in {e.key for e in prof.key_averages()}
    finally:
        spans.disable_spans()
    del MetricsRegistry


def test_flight_recorder_dump(tmp_path):
    from veomni_tpu_torch.observability.flight_recorder import (
        configure_flight_recorder,
        dump_postmortem,
        record,
    )

    configure_flight_recorder(max_events=16, dump_dir=str(tmp_path), fresh=True)
    for i in range(20):
        record("step.end", cid=str(i), synced=True)
    path = dump_postmortem("test", extra={"global_step": 19})
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "test" and doc["global_step"] == 19 and doc["dropped"] == 4
    kinds = [e["kind"] for e in doc["events"]]
    assert len(kinds) == 16 and set(kinds) == {"step.end"}
    assert "test_flight_recorder_dump" in doc["thread_stacks"]


# ------------------------------------------------------------------ utils


def test_set_seed_and_meter():
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.helper import EnvironMeter, host_floats, live_memory_stats, set_seed

    a = torch.randn(5, generator=set_seed(3))
    np_a = np.random.rand()
    b = torch.randn(5, generator=set_seed(3))
    assert torch.equal(a, b) and np_a == (set_seed(3), np.random.rand())[1]
    counter = FlopsCounter(64, 128, 2, 4, 2, 16, 256)
    cpu_meter = EnvironMeter(flops_counter=counter, device=torch.device("cpu"))
    cpu_meter.add(1000, seq_len=128)
    m = cpu_meter.step()
    assert m["consumed_tokens"] == 1000 and "mfu" not in m and m["tokens_per_sec"] > 0
    cpu_meter.add(24, seq_len=128)
    assert cpu_meter.state_dict() == {"consumed_tokens": 1024}
    assert host_floats({"a": 1.0, "b": torch.ones(()), "c": 2}) == {"a": 1.0, "c": 2}
    assert live_memory_stats()["host_rss_bytes"] > 0


def test_watchdog_unit_dump_names_threads():
    from veomni_tpu_torch.utils.helper import Watchdog

    dumps = []
    stop = threading.Event()
    blocker = threading.Thread(target=stop.wait, name="stuck-worker", daemon=True)
    blocker.start()
    with Watchdog(0.1, on_stall=dumps.append, description="unit") as dog:
        for _ in range(100):
            if dumps:
                break
            time.sleep(0.02)
    stop.set()
    assert dog.stall_count >= 1 and "stuck-worker" in dumps[0]


def test_enable_full_determinism():
    from veomni_tpu_torch.utils.determinism import enable_full_determinism, set_batch_invariant_mode

    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        g = enable_full_determinism(7)
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (env or ":4096:8")
        assert torch.equal(torch.randn(3, generator=g),
                           torch.randn(3, generator=torch.Generator().manual_seed(7)))
        with set_batch_invariant_mode():
            pass
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def test_parallel_state_world_size_one():
    from veomni_tpu_torch.parallel import (
        get_parallel_state,
        init_parallel_state,
        use_parallel_state,
    )

    ps = init_parallel_state(dp_shard_size=-1)
    assert (ps.world_size, ps.dp_size, ps.sp_size) == (1, 1, 1)
    assert get_parallel_state() is ps
    other = init_parallel_state(name="vision")
    with use_parallel_state("vision"):
        assert get_parallel_state() is other
    assert get_parallel_state() is ps
    # one process is a world of one rank: a larger mesh raises the reference's
    # size errors (the mesh runs over processes: tests/test_torch_parallel_*.py)
    for kw in ({"ulysses_size": 2}, {"ep_size": 2}, {"dp_shard_size": 4}, {"tp_size": 2}):
        with pytest.raises(ValueError, match="not divisible|device count|must divide"):
            init_parallel_state(**kw)
    with pytest.raises(ValueError):
        init_parallel_state(dp_shard_size=0)


def test_models_auto_text_branch(tmp_path):
    from veomni_tpu_torch.models.auto import build_config, build_foundation_model
    from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, apply_ops_config

    cfg = build_config("qwen3", vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                       head_dim=16, qk_norm=True)
    try:
        fm = build_foundation_model(None, config=cfg, ops_implementation={"attention": "xla"})
        assert KERNEL_REGISTRY.pinned("attention") == "xla"
        module = fm.init(torch.Generator().manual_seed(0), device="cpu")
        assert fm.module is module and len(module.layers) == 1
    finally:
        apply_ops_config(None)
    # the qwen-vl families are ported (tests/test_torch_qwen2_vl.py,
    # tests/test_torch_qwen3_vl.py); the slot VLM waits
    assert build_config("qwen3_vl_moe").text.expert_layout == "fused_chunked"
    with pytest.raises(NotImplementedError, match="slice F"):
        build_config("slot_vlm")
    # an HF directory: config.json and weights round-trip through the family
    with pytest.raises(FileNotFoundError):
        build_foundation_model(str(tmp_path / "missing"))
    fm.save_hf(str(tmp_path / "hf"))
    back = build_foundation_model(str(tmp_path / "hf"), weights_path=str(tmp_path / "hf"),
                                  device="cpu", dtype=cfg.dtype)
    assert back.config.head_dim == 16 and back.config.qk_norm
    for (name, a), (_, b) in zip(back.module.named_parameters(), module.named_parameters()):
        assert torch.equal(a, b), name

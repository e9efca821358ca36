"""The port's self-healing fleet: wedge detection, resurrection, fencing.

The drills of ``tests/test_self_healing.py`` replayed on the port's router,
on the CPU, in f32: a replica hung inside ``engine.step()`` by the fault
layer's ``hang`` mode is declared WEDGED within the stall budget (never by
waiting the hang out), every surviving output equals ``greedy_generate``
token for token, survivors leak no block, the victim respawns through
probation back to rotation; total fleet loss flips ``health()`` and
recovers; a lineage past ``max_respawns`` retires; an admission fault
bounces the request and not the replica; revoked metric views drop a
zombie's writes; pump workers write ``heartbeat-<rid>.json``. The
reference's zero-new-trace assertion after a respawn has no counterpart
(the port's respawned engine shares no compiled programs).
"""

import time

import numpy as np
import pytest

from veomni_tpu_torch.models import decode as decode_mod  # noqa: F401
from veomni_tpu_torch.models.decode import greedy_generate
from veomni_tpu_torch.resilience.faults import configure_faults, disarm_faults
from veomni_tpu_torch.serving import EngineConfig, Request, SamplingParams
from veomni_tpu_torch.serving.replica import (
    STATE_LIVE,
    STATE_PROBATION,
    STATE_WEDGED,
)
from veomni_tpu_torch.serving.router import RouterConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_fleet_fixtures import InferenceEngine, Router, perturb, qwen3_models


@pytest.fixture(scope="module")
def qwen3():
    _, _, model, cfg = qwen3_models()
    return model, cfg


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    disarm_faults()


def _prompts(n, seed=0, length=8):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, length)]
            for _ in range(n)]


def _reqs(prompts, n_new=8):
    return [Request(prompt_ids=list(p),
                    sampling=SamplingParams(max_new_tokens=n_new))
            for p in prompts]


def _pool_identity(eng):
    bm = eng.blocks
    assert bm.num_used == 0
    assert bm.num_free_uncached + bm.num_cached == bm.num_blocks - 1


def _engine_cfg(**kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_model_len", 128)
    return EngineConfig(**kw)


def _drain(router, timeout_s=30.0):
    deadline = time.perf_counter() + timeout_s
    while router.has_work and time.perf_counter() < deadline:
        router.step()
    assert not router.has_work, "router failed to drain"


def _restore_fleet(router, probe_prompt, timeout_s=30.0):
    """Drive respawns to landing and probation replicas to parole with
    identical-prefix probe bursts (they saturate one affinity target so
    the spill reaches the probationer). Returns probe request ids."""
    probes = []
    deadline = time.perf_counter() + timeout_s
    n_cfg = router.config.replicas
    while time.perf_counter() < deadline:
        probation = [h for h in router.replicas.values()
                     if h.state == STATE_PROBATION]
        if (len(router.live_replicas()) >= n_cfg
                and not router._pending_respawns and not probation
                and not router.has_work):
            return probes
        if router.has_work or router._pending_respawns:
            router.step()
            continue
        burst = router.config.spill_queue_depth + 1 + sum(
            router.config.probation_requests for _ in probation)
        for req in _reqs([probe_prompt] * burst, n_new=4):
            probes.append(router.submit(req))
    raise AssertionError("fleet did not restore in time")


# ------------------------------------------------------------ the hang drill
def test_wedge_detection_respawn_and_parity_mid_storm(qwen3):
    """One replica hangs mid-storm inside ``engine.step()``. The router
    must declare it WEDGED within the stall budget (NOT wait out the
    hang), keep the healthy replicas' ticks fast, keep every output
    token-exact, respawn the victim with zero new traces, and walk it
    through probation back to rotation."""
    params, cfg = qwen3
    stall_s, stall_ticks, hang_s = 0.5, 2, 4.0
    r = Router(params, cfg, _engine_cfg(), RouterConfig(
        replicas=3, replica_stall_s=60.0, replica_stall_ticks=stall_ticks,
        max_respawns=2, respawn_backoff_s=0.05, respawn_backoff_max_s=0.2,
        probation_requests=2))
    prompts = _prompts(18, seed=3)
    refs = {tuple(p): greedy_generate(params, cfg, p,
                                      max_new_tokens=8)[len(p):]
            for p in prompts}
    # warm EVERY shape the storm will touch (incl. the cache-hit chunked
    # prefill) under the forgiving deadline, then tighten it
    r.run(_reqs(prompts))
    r.run(_reqs(prompts))
    r.config.replica_stall_s = stall_s

    # ---- fault-free replay: per-tick latency baseline + quiet check
    ids = [r.submit(q) for q in _reqs(prompts)]
    ff_durs = []
    while r.has_work:
        t0 = time.perf_counter()
        r.step()
        ff_durs.append(time.perf_counter() - t0)
    assert r._wedged_total == 0 and r._respawn_total == 0
    for rid, p in zip(ids, prompts):
        out = r.pop_output(rid)
        assert out.token_ids == refs[tuple(p)], rid
    p99_ff = float(np.percentile(ff_durs, 99))

    # ---- the hang: one decode tick, somewhere in the fleet, sleeps 4s
    configure_faults([{"point": "serve.decode_tick", "mode": "hang",
                       "hit": 5, "times": 1, "seconds": hang_s}])
    ids = [r.submit(q) for q in _reqs(prompts)]
    t_start = time.perf_counter()
    t_wedge = None
    post_wedge_durs = []
    while r.has_work:
        t0 = time.perf_counter()
        r.step()
        dt = time.perf_counter() - t0
        if t_wedge is None and r._wedged_total >= 1:
            t_wedge = time.perf_counter()
        elif t_wedge is not None:
            post_wedge_durs.append(dt)
    disarm_faults()
    assert r._wedged_total == 1, "the hang must read as exactly one wedge"
    assert t_wedge is not None
    # detection bound: stall_s per strike tick + scheduling slack — and
    # strictly before the 4s hang would have returned on its own
    assert t_wedge - t_start < stall_s * stall_ticks + 1.5
    assert t_wedge - t_start < hang_s
    # healthy replicas' ticks were never held hostage after abandonment
    if len(post_wedge_durs) >= 5:
        assert float(np.percentile(post_wedge_durs, 99)) <= max(
            2.0 * p99_ff, 0.15)
    # token integrity for every storm output: completed requests (incl.
    # the stranded-then-redispatched, which restart from scratch) match
    # greedy exactly; requests that had already streamed tokens on the
    # wedged replica are terminal ``cancelled`` keeping the delivered
    # greedy PREFIX — exactly-once, never duplicated, never corrupted
    n_done = n_cancelled = 0
    for rid, p in zip(ids, prompts):
        out = r.pop_output(rid)
        ref = refs[tuple(p)]
        assert out is not None and out.finished, rid
        if out.finish_reason in ("eos", "length"):
            n_done += 1
            assert out.token_ids == ref, rid
        else:
            assert out.finish_reason == "cancelled", rid
            n_cancelled += 1
            assert out.token_ids == ref[:len(out.token_ids)], rid
    # only requests actually RUNNING on the wedged engine can cancel —
    # bounded by its slot count; everything else must complete
    assert n_cancelled <= r.engine_config.num_slots
    assert n_done + n_cancelled == len(prompts)
    # ---- resurrection: lands in probation, paroles on clean spill work
    probes = _restore_fleet(r, prompts[0])
    assert r._respawn_total == 1 and r._probation_total == 1
    assert len(r.live_replicas()) == 3
    for rid in probes:
        out = r.pop_output(rid)
        if out is not None:
            assert out.finish_reason in ("eos", "length", "rejected")
    # zero leaked blocks on every quiescent engine (survivors + respawn)
    for h in r.replicas.values():
        if h.engine_quiescent:
            _pool_identity(h.engine)


# ------------------------------------------------- total loss and recovery
def test_total_fleet_loss_recovers_and_health_flips(qwen3):
    """Killing EVERY replica drops ``health()`` to unhealthy; respawns
    land, queued work completes, and health recovers — the 503 is a
    state the fleet exits, not a tombstone."""
    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(num_slots=2), RouterConfig(
        replicas=2, min_live=2, max_respawns=2, respawn_backoff_s=0.05,
        respawn_backoff_max_s=0.2, probation_requests=0))
    prompts = _prompts(4, seed=9)
    r.run(_reqs(prompts))
    r.run(_reqs(prompts))
    assert r.health()["healthy"]
    for rid in [h.rid for h in r.live_replicas()]:
        r.kill_replica(rid, reason="drill: total loss")
    h = r.health()
    assert not h["healthy"] and h["replicas_live"] == 0
    assert h["pending_respawns"] == 2
    # queued work survives the outage: submitted while NOTHING is live
    ids = [r.submit(q) for q in _reqs(prompts, n_new=4)]
    _drain(r)
    for rid, p in zip(ids, prompts):
        out = r.pop_output(rid)
        assert out.finish_reason in ("eos", "length")
        want = greedy_generate(params, cfg, p, max_new_tokens=4)[len(p):]
        assert out.token_ids == want
    h = r.health()
    assert h["healthy"] and h["replicas_live"] == 2
    assert r._respawn_total == 2


def test_respawn_budget_exhausts_into_permanent_retirement(qwen3):
    """A lineage that keeps dying burns its ``max_respawns`` budget and
    is retired for good: capacity stays reduced, health says so, and the
    survivor keeps serving."""
    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(num_slots=2), RouterConfig(
        replicas=2, min_live=2, max_respawns=1, respawn_backoff_s=0.05,
        respawn_backoff_max_s=0.1, probation_requests=0))
    prompts = _prompts(3, seed=11)
    r.run(_reqs(prompts))
    victim = r.live_replicas()[0].rid
    r.kill_replica(victim, reason="drill: kill 1")
    deadline = time.perf_counter() + 10.0
    while (len(r.live_replicas()) < 2
           and time.perf_counter() < deadline):
        r.step()
    assert len(r.live_replicas()) == 2, "first respawn must land"
    r.kill_replica(victim, reason="drill: kill 2")
    # budget (1) already spent: no pending respawn, lineage retired
    assert not r._pending_respawns
    assert victim in r._retired_lineages
    h = r.health()
    assert not h["healthy"]  # live 1 < min_live 2, permanently
    assert victim in h["retired_lineages"]
    # the survivor still serves correctly
    ids = [r.submit(q) for q in _reqs(prompts, n_new=4)]
    _drain(r)
    for rid, p in zip(ids, prompts):
        out = r.pop_output(rid)
        want = greedy_generate(params, cfg, p, max_new_tokens=4)[len(p):]
        assert out.token_ids == want


# --------------------------------------------------------- dispatch bounce
def test_admit_fault_bounces_request_not_replica(qwen3):
    """An exception at ``serve.admit`` (engine.submit) is the REQUEST's
    problem: it gets a terminal rejected output, the replica stays in
    rotation, and the next request sails through."""
    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(num_slots=2),
               RouterConfig(replicas=2, max_respawns=0))
    prompts = _prompts(2, seed=13)
    r.run(_reqs(prompts))
    configure_faults([{"point": "serve.admit", "mode": "exception",
                       "hit": 1, "times": 1}])
    rid_bounced = r.submit(_reqs(prompts[:1], n_new=4)[0])
    _drain(r)
    out = r.pop_output(rid_bounced)
    assert out is not None and out.finish_reason == "rejected"
    assert len(r.live_replicas()) == 2  # nobody died for this
    disarm_faults()
    rid_ok = r.submit(_reqs(prompts[1:], n_new=4)[0])
    _drain(r)
    out = r.pop_output(rid_ok)
    want = greedy_generate(params, cfg, prompts[1],
                           max_new_tokens=4)[len(prompts[1]):]
    assert out.finish_reason in ("eos", "length") and out.token_ids == want


# -------------------------------------------------------- zombie write fence
def test_metrics_fence_drops_zombie_writes():
    """``LabelledRegistry.revoke()`` turns a labelled view's instruments
    into write-dropping proxies — the abandoned pump thread's late writes
    vanish — while a successor view over the SAME label writes normally
    and the unlabelled identity view is untouched."""
    from veomni_tpu_torch.observability.metrics import (
        LabelledRegistry,
        MetricsRegistry,
    )

    base = MetricsRegistry()
    view = LabelledRegistry(base, "r0")
    c = view.counter("serve.requests")
    g = view.gauge("serve.queue_depth")
    c.inc()
    g.set(7.0)
    assert c.value == 1.0
    view.revoke()
    c.inc(5)          # zombie write: dropped
    g.set(99.0)       # zombie write: dropped
    assert c.value == 1.0 and g.value == 7.0
    # reads still delegate; the successor (fresh view, same label, same
    # base registry -> same underlying instrument) writes normally
    succ = LabelledRegistry(base, "r0")
    succ.counter("serve.requests").inc()
    assert succ.counter("serve.requests").value == 2.0
    assert c.value == 2.0  # the zombie can still READ the shared truth
    c.inc()  # still fenced even after the successor took over
    assert succ.counter("serve.requests").value == 2.0
    # identity view: bare instruments, revoke is a no-op shape-wise
    ident = LabelledRegistry(base, "")
    ic = ident.counter("standalone.count")
    ident.revoke()
    ic.inc()
    assert ic.value == 1.0


def test_engine_revoke_metrics_fences_labelled_only(qwen3):
    """``InferenceEngine.revoke_metrics()``: labelled engines stop
    writing, unlabelled engines are untouched (single-engine serving has
    no respawn and must keep its metrics)."""
    from dataclasses import replace

    from veomni_tpu_torch.observability.metrics import get_registry

    params, cfg = qwen3
    ec = _engine_cfg(num_slots=2, metrics_label="fencetest")
    eng = InferenceEngine(params, cfg, ec)
    p = _prompts(1, seed=17)[0]
    eng.run(_reqs([p], n_new=4))
    reg = get_registry()
    # the labelled view scopes serve.requests -> serve.fencetest.requests
    after_first = reg.counter("serve.fencetest.requests").value
    assert after_first >= 1.0
    eng.revoke_metrics()
    out = eng.run(_reqs([p], n_new=4))  # steps happily, writes dropped
    assert all(o.finish_reason in ("eos", "length") for o in out.values())
    assert reg.counter("serve.fencetest.requests").value == after_first
    # unlabelled: revoke_metrics is a no-op, metrics keep flowing
    eng2 = InferenceEngine(params, cfg, replace(ec, metrics_label=""))
    eng2.revoke_metrics()
    base_reqs = reg.counter("serve.requests").value
    eng2.run(_reqs([p], n_new=4))
    assert reg.counter("serve.requests").value == base_reqs + 1.0


# ------------------------------------------------------------- pump beats
def test_pump_workers_write_replica_heartbeats(qwen3, tmp_path):
    """With ``heartbeat_dir`` set, every pump worker beats as
    ``heartbeat-<rid>.json`` (phase serve_pump) — the wedged-replica
    diagnosis artifact scripts/fleet.py merges."""
    from veomni_tpu_torch.observability.fleet import read_heartbeats

    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(num_slots=2), RouterConfig(
        replicas=2, max_respawns=0, heartbeat_dir=str(tmp_path)))
    prompts = _prompts(6, seed=19)
    r.run(_reqs(prompts, n_new=4))
    beats = read_heartbeats(str(tmp_path))
    rids = {h.rid for h in r.replicas.values()}
    assert {b["rank"] for b in beats} == rids
    for b in beats:
        assert b["phase"] == "serve_pump"
        assert b["replica"] in rids
        assert b["state"] in (STATE_LIVE, STATE_PROBATION, STATE_WEDGED)

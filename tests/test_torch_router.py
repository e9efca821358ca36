"""The port's scale-out router (``veomni_tpu_torch/serving/router.py``)
against the reference's contract and the JAX router, on the CPU, in f32.

The assertions of ``tests/test_router.py`` replayed on the port's router
(affinity keys block-aligned and deterministic, rendezvous stable under
membership change, spill and park, a one-replica router equal to the bare
engine, shared-prefix parity with ``greedy_generate`` over 2 and 4
replicas, router-level QoS, a mid-storm kill that sheds and never
corrupts, the loud stall, live add and remove, versioning, the metrics and
debug surface, deadlines and cancel), plus, against the JAX package: the
affinity keys and rendezvous targets equal the reference router's, and a
1- and a 2-replica router give every request the JAX router's tokens. The
reference's zero-new-trace test of ``add_replica`` has no counterpart (the
port's engines share no compiled programs).
"""

import threading
import time

import numpy as np
import pytest

from veomni_tpu import serving as jserving
from veomni_tpu.serving.router import Router as JaxRouter, RouterConfig as JaxRouterConfig
from veomni_tpu_torch.models.decode import greedy_generate
from veomni_tpu_torch.serving import EngineConfig, Request, SamplingParams, host_state
from veomni_tpu_torch.serving.replica import STATE_DETACHED, STATE_DRAINING
from veomni_tpu_torch.serving.router import RouterConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_fleet_fixtures import InferenceEngine, Router, perturb, qwen3_models


@pytest.fixture(scope="module")
def qwen3():
    _, _, model, cfg = qwen3_models()
    return model, cfg


def _prompts(lengths, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


def _shared_prefix_prompts(n, prefix_len=16, tail=8, seed=0, groups=2):
    """``n`` prompts drawn from ``groups`` distinct shared prefixes with
    random tails — the workload affinity routing exists for."""
    rng = np.random.default_rng(seed)
    prefixes = [[int(t) for t in rng.integers(1, 128, prefix_len)]
                for _ in range(groups)]
    return [prefixes[i % groups]
            + [int(t) for t in rng.integers(1, 128, tail)]
            for i in range(n)]


def _pool_identity(eng):
    """The no-leak identity: every non-cached block on the free list, every
    cached block refcount-0, nothing still attributed to a sequence."""
    bm = eng.blocks
    assert bm.num_used == 0
    assert bm.num_free_uncached + bm.num_cached == bm.num_blocks - 1
    if eng.prefix_cache is not None:
        assert all(bm.refcount(b) == 0 for b in eng.prefix_cache._by_block)


def _greedy_refs(params, cfg, prompts, n_new):
    return {tuple(p): greedy_generate(params, cfg, p,
                                      max_new_tokens=n_new)[len(p):]
            for p in prompts}


# ---------------------------------------------------------- affinity + spill
def test_affinity_key_deterministic_and_block_aligned(qwen3):
    """The affinity key hashes the LEADING full blocks only: same prefix
    -> same key regardless of tail; different prefix -> (a.s.) different
    key; sub-block prompts key on the whole prompt."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=2, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=2, affinity_blocks=2))
    prefix = list(range(1, 17))  # two full 8-token blocks
    k1 = r._affinity_key(prefix + [99, 98, 97])
    k2 = r._affinity_key(prefix + [55])
    k3 = r._affinity_key(prefix)
    assert k1 == k2 == k3
    assert r._affinity_key([7] + prefix) != k1
    # short prompts: whole-prompt key, still deterministic
    assert r._affinity_key([1, 2, 3]) == r._affinity_key([1, 2, 3])
    assert r._affinity_key([1, 2, 3]) != r._affinity_key([1, 2, 4])
    # rendezvous target is a pure function of (key, live set)
    live = r.live_replicas()
    assert r._affinity_target(k1, live).rid == r._affinity_target(
        k1, list(reversed(live))).rid


def test_rendezvous_stability_under_membership_change(qwen3):
    """Removing one replica only moves the keys it owned; keys owned by
    survivors keep their target (the property that keeps caches warm
    through elastic resizes)."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=2, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=3))
    live = r.live_replicas()
    keys = list(range(200))
    before = {k: r._affinity_target(k, live).rid for k in keys}
    gone = live[0].rid
    survivors = [h for h in live if h.rid != gone]
    for k in keys:
        after = r._affinity_target(k, survivors).rid
        if before[k] != gone:
            assert after == before[k]


def test_spill_threshold_and_park(qwen3):
    """Affinity yields to the least-loaded replica past the queue-depth
    threshold; with EVERY live replica past it the router parks (QoS
    back-pressure) instead of blind fan-out."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=1, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=2, spill_queue_depth=2))
    h0, h1 = r.live_replicas()
    assert not r._past_threshold(h0)
    # same-prefix requests all map to one replica; its queue crossing the
    # threshold forces spills to the sibling
    prompts = _shared_prefix_prompts(8, prefix_len=16, tail=4, seed=1,
                                     groups=1)
    for p in prompts:
        r.submit(Request(prompt_ids=p,
                         sampling=SamplingParams(max_new_tokens=2)))
    r._dispatch()
    d0, d1 = h0.queue_depth() + len(h0.assigned), \
        h1.queue_depth() + len(h1.assigned)
    assert d0 > 0 and d1 > 0, (d0, d1)  # spill engaged both replicas
    assert r._spill_total > 0
    # both replicas now past threshold -> the rest parks at the router
    assert len(r._queue) > 0
    assert r.run()  # drains clean


# ------------------------------------------------------------------- parity
def test_single_replica_router_matches_bare_engine(qwen3):
    """The representative serving slice through a 1-replica router:
    token-exact with the bare engine, same ids, same finish reasons."""
    params, cfg = qwen3
    prompts = _prompts((5, 12, 9, 17), seed=2)
    ec = EngineConfig(num_slots=2, block_size=8, max_model_len=64)
    reqs = lambda: [Request(prompt_ids=list(p),  # noqa: E731
                            sampling=SamplingParams(max_new_tokens=6))
                    for p in prompts]
    eng = InferenceEngine(params, cfg, ec)
    r = Router(params, cfg, ec, RouterConfig(replicas=1))
    eng_outs = eng.run(reqs())
    rout_outs = r.run(reqs())
    assert sorted(eng_outs) == sorted(rout_outs)
    for rid, o in eng_outs.items():
        assert rout_outs[rid].token_ids == o.token_ids
        assert rout_outs[rid].finish_reason == o.finish_reason
    _pool_identity(r.live_replicas()[0].engine)


def test_single_replica_router_shed_semantics(qwen3):
    """QoS moved up to the router: the bounded queue and validation raise/
    shed exactly like the bare engine's submit (same error messages, same
    terminal statuses), so fronting one engine changes nothing."""
    params, cfg = qwen3
    ec = EngineConfig(num_slots=1, block_size=8, max_model_len=32,
                      queue_bound=2)
    r = Router(params, cfg, ec, RouterConfig(replicas=1))
    with pytest.raises(ValueError, match="empty prompt"):
        r.submit(Request(prompt_ids=[]))
    with pytest.raises(ValueError, match="max_new_tokens"):
        r.submit(Request(prompt_ids=[1],
                         sampling=SamplingParams(max_new_tokens=0)))
    with pytest.raises(ValueError, match="max_model_len"):
        r.submit(Request(prompt_ids=[1] * 30,
                         sampling=SamplingParams(max_new_tokens=8)))
    with pytest.raises(ValueError, match="unknown priority class"):
        r.submit(Request(prompt_ids=[1, 2],
                         sampling=SamplingParams(max_new_tokens=1),
                         priority="vip"))
    ids = [r.submit(Request(prompt_ids=[1, 2, 3],
                            sampling=SamplingParams(max_new_tokens=2)))
           for _ in range(5)]
    with pytest.raises(ValueError, match="duplicate"):
        r.submit(Request(prompt_ids=[1], request_id=ids[0]))
    outs = r.run()
    statuses = [outs[i].finish_reason for i in ids]
    assert statuses.count("rejected") == 3  # queue_bound=2 + 5 submits
    assert all(s in ("rejected", "length") for s in statuses)
    assert r.metrics()["rejected"] == 3.0


@pytest.mark.parametrize("stall_s", [60.0, 0.0])
def test_router_shared_prefix_parity_across_fleet_sizes(qwen3, stall_s):
    """Shared-prefix traffic over 2..4 replicas: every request is
    token-exact with isolated greedy generation, wherever affinity or
    spill landed it, and every pool drains leak-free; with wedge detection
    on and off (``replica_stall_s=0``: workers joined without a deadline)."""
    params, cfg = qwen3
    prompts = _shared_prefix_prompts(10, prefix_len=16, tail=6, seed=3,
                                     groups=3)
    refs = _greedy_refs(params, cfg, prompts, 6)
    for n in (2, 4):
        r = Router(params, cfg, EngineConfig(
            num_slots=2, block_size=8, max_model_len=64,
        ), RouterConfig(replicas=n, spill_queue_depth=2, replica_stall_s=stall_s))
        outs = r.run([Request(prompt_ids=list(p),
                              sampling=SamplingParams(max_new_tokens=6))
                      for p in prompts])
        assert len(outs) == len(prompts)
        for o in outs.values():
            assert o.token_ids == refs[tuple(o.prompt_ids)], o.request_id
        for h in r.live_replicas():
            _pool_identity(h.engine)
        # affinity concentrated each prefix group: the fleet-aggregate hit
        # rate stays warm instead of diluting N ways
        assert r.metrics()["prefix_hit_rate"] > 0


# -------------------------------------------------------------- router QoS
def test_router_qos_no_starvation_under_parked_backlog(qwen3):
    """With every replica past the spill threshold the router parks and
    ITS stride picker decides dispatch order: an interactive arrival
    overtakes a parked batch backlog, and batch still gets its weighted
    share — no starvation at the front door."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=1, block_size=8, max_model_len=64,
        classes="interactive:4,batch:1",
    ), RouterConfig(replicas=2, spill_queue_depth=1))
    for i, p in enumerate(_prompts((8,) * 8, seed=4)):
        r.submit(Request(prompt_ids=p, priority="batch",
                         sampling=SamplingParams(max_new_tokens=2)))
    r._dispatch()  # fill both replicas past the threshold; rest parks
    assert len(r._queue) > 0
    inter = r.submit(Request(prompt_ids=_prompts((8,), seed=5)[0],
                             priority="interactive",
                             sampling=SamplingParams(max_new_tokens=2)))
    order = []
    orig = r._dispatch_to

    def spy(item, h):
        order.append(item.request.request_id)
        orig(item, h)

    r._dispatch_to = spy
    outs = r.run()
    assert outs[inter].finish_reason == "length"
    # the late interactive request dispatched ahead of the parked batch
    # backlog (stride weight 4:1), but batch was NOT starved out
    assert order.index(inter) < len(order) - 1
    assert all(o.finish_reason == "length" for o in outs.values())


# ----------------------------------------------------------------- failure
def test_replica_kill_mid_storm_sheds_never_corrupts(qwen3):
    """Mid-storm kill: survivors stay token-exact and leak-free; every
    request that was on the dead replica reaches a terminal status —
    re-dispatched (nothing streamed yet) or ``cancelled`` (tokens already
    delivered) — and nothing hangs."""
    params, cfg = qwen3
    prompts = _shared_prefix_prompts(12, prefix_len=16, tail=6, seed=6,
                                     groups=4)
    refs = _greedy_refs(params, cfg, prompts, 8)
    r = Router(params, cfg, EngineConfig(
        num_slots=2, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=3, spill_queue_depth=2))
    ids = [r.submit(Request(prompt_ids=list(p),
                            sampling=SamplingParams(max_new_tokens=8)))
           for p in prompts]
    for _ in range(4):  # let the storm develop: prefills + some decode
        r.step()
    victim = max(r.live_replicas(),
                 key=lambda h: len(h.assigned))  # kill the busiest
    stranded = set(victim.assigned)
    r.kill_replica(victim.rid, reason="drill")
    outs = r.run()
    assert sorted(outs) == sorted(ids)  # nothing lost, nothing duplicated
    for rid in ids:
        o = outs[rid]
        assert o.finished and o.finish_reason, rid  # terminal, never hung
        if o.finish_reason == "length":
            assert o.token_ids == refs[tuple(o.prompt_ids)], rid
        else:  # only the dead replica's in-flight work may cancel
            assert o.finish_reason == "cancelled" and rid in stranded
    for h in r.live_replicas():
        _pool_identity(h.engine)  # zero leaked blocks on survivors
    assert len(r.live_replicas()) == 2
    doc = r.debug_doc()
    assert [x["rid"] for x in doc["retired"]] == [victim.rid]
    assert doc["retired"][0]["fail_reason"]


def test_router_stalls_loudly_with_no_live_replicas(qwen3):
    """With resurrection disabled (max_respawns=0), losing every replica
    still fails loudly — but only AFTER every queued request got a
    terminal REJECTED output, so a run()/pop_output caller is never left
    blocking on a request that can no longer be served."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=1, block_size=8, max_model_len=32,
    ), RouterConfig(replicas=2, max_respawns=0))
    rid = r.submit(Request(prompt_ids=[1, 2, 3],
                           sampling=SamplingParams(max_new_tokens=2)))
    for h in list(r.live_replicas()):
        r.kill_replica(h.rid)
    with pytest.raises(RuntimeError, match="no live replicas"):
        r.step()
    out = r.pop_output(rid)
    assert out is not None and out.finished
    assert out.finish_reason == "rejected"
    assert not r.has_work  # nothing left parked or in flight


# -------------------------------------------------------------- elasticity
def test_live_add_remove_no_lost_or_duplicated_ids(qwen3):
    """Grow 2->3 mid-traffic, then drain one replica out: every id
    submitted before, during and after the resize reaches exactly one
    terminal output; the drained replica leaves only once empty."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=2, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=2, spill_queue_depth=1))
    mk = lambda p: Request(prompt_ids=list(p),  # noqa: E731
                           sampling=SamplingParams(max_new_tokens=4))
    prompts = _shared_prefix_prompts(9, prefix_len=8, tail=6, seed=7,
                                     groups=3)
    ids = [r.submit(mk(p)) for p in prompts[:3]]
    r.step()
    added = r.add_replica()
    ids += [r.submit(mk(p)) for p in prompts[3:6]]
    r.step()
    victim = r.live_replicas()[0]
    r.remove_replica(victim.rid)
    assert victim.state == STATE_DRAINING
    with pytest.raises(ValueError, match="not live"):
        r.remove_replica(victim.rid)
    ids += [r.submit(mk(p)) for p in prompts[6:]]
    outs = r.run()
    assert sorted(outs) == sorted(ids)
    assert all(o.finish_reason == "length" for o in outs.values())
    assert victim.state == STATE_DETACHED
    assert not victim.assigned and not victim.engine.has_work
    _pool_identity(victim.engine)
    assert added.rid in r.replicas
    # can't drain the fleet to zero
    last_live = r.live_replicas()
    while len(last_live) > 1:
        r.remove_replica(last_live[0].rid)
        r.step()
        last_live = r.live_replicas()
    with pytest.raises(ValueError, match="last live replica"):
        r.remove_replica(last_live[0].rid)


def test_publish_weights_versioning(qwen3):
    """New replicas serve the latest published version immediately;
    existing replicas keep theirs until the rolling publish (driven by
    ``step()``) reaches them — never mid-stream, always via the drain
    fence (docs/serving.md "Versioned weight publication")."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=1, block_size=8, max_model_len=32,
    ), RouterConfig(replicas=2))
    old = {h.rid for h in r.live_replicas()}
    assert all(h.weights_version == "v0" for h in r.live_replicas())
    p2 = host_state(params)
    assert r.publish_weights(p2, "v1") == "v1"
    h = r.add_replica()
    assert h.weights_version == "v1"
    # snapshot BEFORE any step(): the roll is lazy, nothing swapped yet
    assert all(x.weights_version == "v0"
               for x in r.live_replicas() if x.rid in old)
    assert r.debug_doc()["weights_version"] == "v1"
    assert r.publish_in_progress
    # an idle fleet converges through step() alone (has_work holds the
    # pump open while any serving replica is off the latest version)
    deadline = time.perf_counter() + 30.0
    while r.has_work and time.perf_counter() < deadline:
        r.step()
    assert not r.publish_in_progress
    assert all(x.weights_version == "v1" for x in r.live_replicas())
    doc = r.debug_doc()
    assert doc["publishes"] == 1 and not doc["publish_in_progress"]
    health = r.health()
    assert health["weights_version"] == "v1"
    assert set(health["replica_weights"].values()) == {"v1"}


# ----------------------------------------------------------- observability
def test_router_metrics_and_debug_surface(qwen3):
    """serve.router.* gauges/counters and /debug/router reflect dispatch
    reality; the debug snapshot is safe to read from another thread while
    the pump runs."""
    from veomni_tpu_torch.observability.metrics import get_registry

    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=2, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=2))
    reqs = [Request(prompt_ids=p, sampling=SamplingParams(max_new_tokens=3))
            for p in _prompts((6, 9, 12), seed=10)]
    stop = threading.Event()
    seen = []

    def scrape():
        while not stop.is_set():
            seen.append(r.debug_doc())

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    try:
        outs = r.run(reqs)
    finally:
        stop.set()
        t.join(timeout=5)
    assert len(outs) == 3
    reg = get_registry()
    assert reg.counter("serve.router.requests").value >= 3
    assert reg.counter("serve.router.dispatched").value >= 3
    assert reg.gauge("serve.router.replicas_live").value == 2
    # per-replica engine metrics carry the instance label, so two engines
    # do not clobber one shared gauge family
    labelled = [n for n, _ in reg.items_snapshot()
                if n.startswith("serve.r0.") or n.startswith("serve.r1.")]
    assert labelled
    doc = r.debug_doc()
    assert {x["rid"] for x in doc["replicas"]} == {"r0", "r1"}
    assert sum(x["dispatched"] for x in doc["replicas"]) >= 3
    assert seen  # concurrent scraper observed snapshots without crashing


def test_router_deadline_and_cancel_paths(qwen3):
    """Deadlines expire both at the router (parked) and on replicas with
    the clock backdated to router intake; cancel reaches a request
    wherever it currently lives."""
    params, cfg = qwen3
    r = Router(params, cfg, EngineConfig(
        num_slots=1, block_size=8, max_model_len=64,
    ), RouterConfig(replicas=2, spill_queue_depth=1))
    # park a deadline-carrying request behind a saturating backlog
    for p in _prompts((8,) * 6, seed=11):
        r.submit(Request(prompt_ids=p,
                         sampling=SamplingParams(max_new_tokens=2)))
    r._dispatch()
    victim = r.submit(Request(prompt_ids=[1, 2, 3], deadline_s=30.0,
                              sampling=SamplingParams(max_new_tokens=2)))
    item = r._items[victim]
    assert item.phase == "queued"  # parked at the router
    item.submit_time -= 60.0  # deadline elapsed while parked
    cancel_me = r.submit(Request(
        prompt_ids=[4, 5, 6], sampling=SamplingParams(max_new_tokens=2)))
    assert r.cancel(cancel_me)
    assert not r.cancel(cancel_me)  # already terminal
    assert not r.cancel("req-nope")
    outs = r.run()
    assert outs[victim].finish_reason == "deadline"
    assert outs[victim].deadline_missed
    assert outs[cancel_me].finish_reason == "cancelled"
    assert r.metrics()["deadline_misses"] >= 1.0


# ------------------------------------------------------ against the JAX router
def test_affinity_keys_and_rendezvous_targets_equal_the_reference(qwen3):
    jparams, jcfg, model, cfg = qwen3_models()
    ec = dict(num_slots=2, block_size=8, max_model_len=64)
    mine = Router(model, cfg, EngineConfig(**ec), RouterConfig(replicas=3, affinity_blocks=2))
    ref = JaxRouter(jparams, jcfg, jserving.EngineConfig(**ec),
                    JaxRouterConfig(replicas=3, affinity_blocks=2))
    prompts = (_shared_prefix_prompts(12, prefix_len=16, tail=5, seed=21, groups=4)
               + _prompts((3, 7, 8, 9, 15, 16, 17, 40), seed=22))
    live_mine, live_ref = mine.live_replicas(), ref.live_replicas()
    assert [h.rid for h in live_mine] == [h.rid for h in live_ref]
    for p in prompts:
        key = mine._affinity_key(p)
        assert key == ref._affinity_key(p), p
        for k in range(1, 4):  # every live subset, in rotation order
            assert (mine._affinity_target(key, live_mine[:k]).rid
                    == ref._affinity_target(key, live_ref[:k]).rid)


@pytest.mark.parametrize("replicas", [1, 2])
def test_router_tokens_equal_the_jax_routers(qwen3, replicas):
    """The same shared-prefix traffic (waves, spill past a queue depth of
    2, a sampled request) through the JAX router and the port's: every
    request id gets the same tokens, finish reason and replica dispatch
    counts."""
    jparams, jcfg, model, cfg = qwen3_models()
    prompts = _shared_prefix_prompts(8, prefix_len=16, tail=6, seed=23, groups=3)
    ec = dict(num_slots=2, block_size=8, max_model_len=64, prefill_chunk=8)
    runs = []
    for router, req, sp in (
            (JaxRouter(jparams, jcfg, jserving.EngineConfig(**ec),
                       JaxRouterConfig(replicas=replicas, spill_queue_depth=2)),
             jserving.Request, jserving.SamplingParams),
            (Router(model, cfg, EngineConfig(**ec),
                    RouterConfig(replicas=replicas, spill_queue_depth=2)),
             Request, SamplingParams)):
        ids = [router.submit(req(prompt_ids=list(p), sampling=sp(
            max_new_tokens=6, **({"temperature": 0.8, "top_k": 20, "seed": 3} if i == 3 else {}))))
            for i, p in enumerate(prompts[:5])]
        router.step()
        ids += [router.submit(req(prompt_ids=list(p), sampling=sp(max_new_tokens=6)))
                for p in prompts[5:]]
        outs = router.run()
        doc = router.debug_doc()
        runs.append(({i: (outs[i].token_ids, outs[i].finish_reason) for i in ids},
                     sorted((x["rid"], x["dispatched"]) for x in doc["replicas"]),
                     doc["spills"]))
    assert runs[1] == runs[0]

"""The port's live weight publication: the weight store, the engine swap,
the rolling publish and the checkpoint gate.

The drills of ``tests/test_weight_publish.py`` replayed on the port, on the
CPU, in f32 (payloads are the model's state on the host, perturbed by
``torch_fleet_fixtures.perturb``): monotonic seqs and immutable tags; the
swap refuses a busy engine and an incongruent payload, flushes the prefix
cache under a bumped epoch with the no-leak identity kept, adds no trace
and gives a fresh engine's tokens; the roll fences one replica at a time
above ``min_live`` and starves nobody; a kill mid-publish respawns at the
latest version; respawned and added replicas agree. The checkpoint gate
runs on generations the port's ``Checkpointer`` writes (a manifest, a
truncated payload, an uncommitted directory) and publishes the trained
weights through the default loader. The two chaos-composition tests of
the reference's file are in ``tests/test_torch_chaos.py``.
"""

import os
import time

import numpy as np
import pytest
import torch

from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models import decode as decode_mod
from veomni_tpu_torch.resilience.faults import configure_faults, disarm_faults
from veomni_tpu_torch.resilience.integrity import CheckpointCorruptError
from veomni_tpu_torch.models.decode import greedy_generate
from veomni_tpu_torch.serving import (
    EngineConfig,
    Request,
    SamplingParams,
    WeightStore,
    load_checkpoint_params,
    load_published_params,
)
from veomni_tpu_torch.serving.replica import STATE_PROBATION
from veomni_tpu_torch.serving.router import RouterConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_fleet_fixtures import QWEN3, InferenceEngine, Router, perturb, qwen3_models


@pytest.fixture(scope="module")
def qwen3():
    _, _, model, cfg = qwen3_models()
    return model, cfg


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    disarm_faults()


def cfg_fields(cfg):
    return {k: getattr(cfg, k) for k in QWEN3}


def _prompts(n, seed=0, length=8, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + [int(t) for t in rng.integers(1, 128, length)]
            for _ in range(n)]


def _reqs(prompts, n_new=6):
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


def _drain(router, timeout_s=60.0):
    deadline = time.perf_counter() + timeout_s
    while router.has_work and time.perf_counter() < deadline:
        router.step()
    assert not router.has_work, "router failed to drain"


def _restore_fleet(router, probe_prompt, timeout_s=60.0):
    """Drive respawns to landing and probation replicas to parole (same
    idiom as test_self_healing.py). Returns probe request ids."""
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


# --------------------------------------------------------------- WeightStore
def test_weight_store_monotonic_seq_and_immutable_tags(qwen3):
    params, _ = qwen3
    store = WeightStore(params, "v0")
    assert store.latest.version == "v0" and store.latest.seq == 0
    rec = store.put("step-100", params)
    assert rec.seq == 1 and store.latest.version == "step-100"
    assert store.seq("v0") == 0 and store.seq("step-100") == 1
    assert store.seq("never-published") == -1
    assert store.versions() == ["v0", "step-100"]
    assert "v0" in store and "nope" not in store and len(store) == 2
    with pytest.raises(ValueError, match="immutable"):
        store.put("v0", params)  # retagging is a caught operator error
    with pytest.raises(ValueError, match="non-empty"):
        store.put("", params)
    assert store.get("v0").params is params


# ----------------------------------------------------------- the engine swap
def test_swap_refuses_busy_engine_and_incongruent_payloads(qwen3):
    params, cfg = qwen3
    eng = InferenceEngine(params, cfg, _engine_cfg())
    eng.submit(_reqs(_prompts(1), n_new=4)[0])
    with pytest.raises(RuntimeError, match="busy engine"):
        eng.swap_weights(perturb(params))
    eng.run()  # drain; swaps are legal again
    # a wider model's payload: the congruence check refuses it BEFORE any
    # state changes (the port's engine casts a payload to its compute
    # dtype, so a dtype change alone is congruent; a shape change is not)
    wider = TransformerConfig(dtype=torch.float32, **{**cfg_fields(cfg), "intermediate_size": 256})
    epoch_before = eng.cache_epoch
    with pytest.raises(ValueError, match="incongruent"):
        eng.swap_weights(Transformer(wider, torch.Generator().manual_seed(0), device="cpu"))
    assert eng.cache_epoch == epoch_before  # refusal changed nothing


def test_swap_flushes_prefix_cache_no_leak_identity(qwen3):
    """The cache-epoch invalidation: a swap flushes EVERY cached block
    back to the free pool (the no-leak identity holds across the flush),
    bumps the epoch, and the cache repopulates cleanly afterwards."""
    params, cfg = qwen3
    eng = InferenceEngine(params, cfg, _engine_cfg())
    shared = tuple(_prompts(1, seed=3, length=16)[0])
    eng.run(_reqs(_prompts(4, seed=4, prefix=shared), n_new=4))
    bm = eng.blocks
    cached_before = bm.num_cached
    assert cached_before > 0  # the swap has real cached KV to invalidate
    _pool_identity(eng)
    assert eng.cache_epoch == 0 and eng.prefix_cache.epoch == 0
    info = eng.swap_weights(perturb(params))
    assert info["flushed_blocks"] == cached_before
    assert info["cache_epoch"] == 1
    assert eng.cache_epoch == 1 and eng.prefix_cache.epoch == 1
    assert bm.num_cached == 0  # stale KV is unreachable, not leaked
    _pool_identity(eng)
    # the flushed cache repopulates under the new weights
    eng.run(_reqs(_prompts(4, seed=5, prefix=shared), n_new=4))
    assert bm.num_cached > 0
    _pool_identity(eng)


def test_swap_token_parity_vs_fresh_engine_zero_traces(qwen3):
    """THE acceptance gate: after swapping perturbed weights into an
    engine with a hot prefix cache, its outputs must be token-identical
    to a FRESH engine built on the new weights (zero stale KV anywhere),
    must DIFFER from the old weights' streams (the swap is live), and
    the swap + post-swap serving must add zero jit traces."""
    params, cfg = qwen3
    new_params = perturb(params)
    ecfg = _engine_cfg(num_slots=2)
    shared = tuple(_prompts(1, seed=9, length=16)[0])
    prompts = _prompts(4, seed=10, prefix=shared)
    eng = InferenceEngine(params, cfg, ecfg)
    old_outs = eng.run(_reqs(prompts))  # warm: cache hot, buckets traced
    _pool_identity(eng)
    base = dict(decode_mod.TRACE_COUNTS)
    eng.swap_weights(new_params)
    outs = eng.run(_reqs(prompts))  # same shapes -> same buckets
    assert decode_mod.TRACE_COUNTS == base, "weight swap must not retrace"
    fresh = InferenceEngine(new_params, cfg, ecfg)
    fresh_outs = fresh.run(_reqs(prompts))
    by_tokens = lambda outs: sorted(o.token_ids for o in outs.values())
    assert by_tokens(outs) == by_tokens(fresh_outs), \
        "published engine diverged from fresh engine on the same weights"
    assert by_tokens(outs) != by_tokens(old_outs), \
        "outputs unchanged after swap: the perturbed publish was a no-op"


# ------------------------------------------------------------ the rolling roll
def test_rolling_publish_respects_min_live_and_starves_nobody(qwen3):
    """A publish under load rolls ONE replica at a time, never drops the
    live fleet below min_live, and every request — submitted before,
    during and after the roll — reaches a clean terminal output."""
    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(num_slots=2), RouterConfig(
        replicas=3, min_live=2))
    ids = [r.submit(q) for q in _reqs(_prompts(6, seed=20), n_new=5)]
    for _ in range(2):
        r.step()
    assert r.publish_weights(perturb(params), "v1") == "v1"
    min_live_seen = len(r.live_replicas())
    max_publishing = 0
    ids += [r.submit(q) for q in _reqs(_prompts(4, seed=21), n_new=5)]
    deadline = time.perf_counter() + 60.0
    while r.has_work and time.perf_counter() < deadline:
        r.step()
        min_live_seen = min(min_live_seen, len(r.live_replicas()))
        max_publishing = max(max_publishing, sum(
            1 for h in r.replicas.values() if h.state == "publishing"))
    assert not r.has_work
    assert min_live_seen >= 2, "publish took the fleet below min_live"
    assert max_publishing <= 1, "roll must fence one replica at a time"
    assert not r.publish_in_progress
    assert all(h.weights_version == "v1" for h in r.live_replicas())
    outs = {i: r.pop_output(i) for i in ids}
    assert all(o is not None and o.finish_reason == "length"
               for o in outs.values()), "a request starved during the roll"


def test_kill_mid_publish_respawn_attaches_at_latest_version(qwen3):
    """The crash drill: ``serve.publish`` kills the first victim inside
    its swap window. Failure triage must run (no lost ids), the respawn
    must attach at the LATEST version (the satellite-1 bugfix pin — an
    ancestor-version respawn would freeze the fleet mixed forever), and
    the fleet still converges to one version with zero leaked blocks."""
    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(), RouterConfig(
        replicas=3, min_live=1, probation_requests=1,
        respawn_backoff_s=0.05))
    probe = _prompts(1, seed=30)[0]
    ids = [r.submit(q) for q in _reqs(_prompts(3, seed=31), n_new=4)]
    _drain(r)
    configure_faults([{"point": "serve.publish", "mode": "exception",
                       "hit": 1, "times": 1}])
    r.publish_weights(perturb(params), "v1")
    probes = _restore_fleet(r, probe)
    disarm_faults()
    _drain(r)
    assert not r.publish_in_progress
    replicas = list(r.replicas.values())
    assert len(r.live_replicas()) == 3
    assert all(h.weights_version == "v1" for h in replicas)
    died = [h for h in replicas if h.generation > 0]
    assert len(died) == 1, "exactly one replica dies in this drill"
    for i in ids + probes:  # nobody lost, nobody duplicated
        assert r.pop_output(i) is not None
        assert r.pop_output(i) is None
    for h in replicas:
        _pool_identity(h.engine)


def test_publish_then_respawn_parity_with_add_replica(qwen3):
    """Respawns and freshly-added replicas agree: both attach at the
    latest published version, not at the fleet's founding version."""
    params, cfg = qwen3
    r = Router(params, cfg, _engine_cfg(), RouterConfig(
        replicas=2, min_live=1, probation_requests=0,
        respawn_backoff_s=0.05))
    r.publish_weights(perturb(params), "v1")
    _drain(r)  # converge the publish first
    victim = next(iter(r.live_replicas()))
    r.kill_replica(victim.rid)
    probe = _prompts(1, seed=40)[0]
    _restore_fleet(r, probe)
    _drain(r)
    assert r.replicas[victim.rid].generation == 1
    assert r.replicas[victim.rid].weights_version == "v1"
    added = r.add_replica()
    assert added.weights_version == "v1"
    assert all(h.weights_version == "v1" for h in r.replicas.values())


# ------------------------------------------------------- the checkpoint gate
def _generation(tmp_path, model, step):
    """A committed generation the port's ``Checkpointer`` writes (model.pt,
    optimizer.pt, sidecars, manifest) of ``model``, before any optimizer
    step (no moments)."""
    from veomni_tpu_torch.checkpoint.checkpointer import Checkpointer
    from veomni_tpu_torch.optim.optimizer import build_optimizer
    from veomni_tpu_torch.train.train_step import build_train_state

    ckpt = Checkpointer(str(tmp_path / "ckpt"), async_save=False)
    ckpt.save(step, build_train_state(model, build_optimizer(model, lr=1e-4)))
    ckpt.wait()
    ckpt.close()
    return str(tmp_path / "ckpt" / f"global_step_{step}")


def test_publish_from_checkpoint_integrity_gate(qwen3, tmp_path):
    """Corrupt and uncommitted generations are refused BEFORE the loader
    runs: the fleet's buffers and version history stay untouched. A clean
    generation publishes through the default loader (its model.pt) and the
    fleet then serves the checkpoint's weights."""
    params, cfg = qwen3
    trained = Transformer(cfg, None, device="cpu")
    trained.load_state_dict(perturb(params), strict=False)
    loads = []

    def loader(step_dir):
        loads.append(step_dir)
        return load_checkpoint_params(step_dir)

    r = Router(params, cfg, _engine_cfg(), RouterConfig(
        replicas=2))
    # clean generation: manifest written, loader runs, fleet converges
    good = _generation(tmp_path, trained, 7)
    assert r.publish_from_checkpoint(good, loader) == "global_step_7"
    _drain(r)
    assert all(h.weights_version == "global_step_7"
               for h in r.live_replicas())
    assert loads == [good]
    prompt = _prompts(1, seed=60)[0]
    (out,) = r.run(_reqs([prompt])).values()
    assert out.token_ids == greedy_generate(trained, cfg, prompt, max_new_tokens=6)[8:]
    # the default loader reads the same weights
    assert r.publish_from_checkpoint(good, version="again") == "again"
    _drain(r)
    # truncated payload: CORRUPT — refused, loader never called
    bad = _generation(tmp_path, trained, 8)
    os.truncate(os.path.join(bad, "train_state", "model.pt"), 1)
    with pytest.raises(CheckpointCorruptError, match="verification failed"):
        r.publish_from_checkpoint(bad, loader)
    # uncommitted dir (no train_state payload): refused, loader never ran
    empty = tmp_path / "global_step_9"
    empty.mkdir()
    with pytest.raises(CheckpointCorruptError, match="not a committed"):
        r.publish_from_checkpoint(str(empty), loader)
    assert loads == [good], "a refused generation must never be loaded"
    assert r.weights_version == "again"  # history untouched
    # verify_mode="off" still refuses uncommitted dirs
    with pytest.raises(CheckpointCorruptError):
        load_published_params(str(empty), loader, verify_mode="off")

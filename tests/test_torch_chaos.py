"""The port's chaos plans and soak (``veomni_tpu_torch/resilience/chaos.py``)
against the JAX ones, on the CPU.

* The plan: for seeds 0-3, with and without publish events and at two
  argument sets, the port's ``to_doc()`` equals the reference's field for
  field (one ``random.Random(seed)`` stream drawn in the same order).
* The counterparts of ``tests/test_chaos.py`` (determinism, seeds that
  differ, specs that parse under the port's fault grammar and target known
  points with hangs only at pump points, a non-positive duration refused,
  modular kill picks, ``fault_plan`` a copy, a fault-free soak over a two
  replica fleet of the qwen3 toy reporting clean) and of
  ``tests/test_weight_publish.py:367-414`` (publish draws leave the
  faults and kills a seed pins; a publish-only soak converges every
  replica on the published version, and a plan that schedules publishes
  without a ``publish_fn`` is refused).
"""

import json

import numpy as np
import pytest

from veomni_tpu.resilience.chaos import build_chaos_plan as j_build_chaos_plan
from veomni_tpu_torch.resilience.chaos import (
    CHAOS_POINTS,
    ChaosPlan,
    KillEvent,
    build_chaos_plan,
    run_chaos_soak,
)
from veomni_tpu_torch.resilience.faults import KNOWN_POINTS, _parse_specs, disarm_faults
from veomni_tpu_torch.serving import EngineConfig, Request, RouterConfig, SamplingParams

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_fleet_fixtures import Router, perturb, qwen3_models

KWARGS = [dict(), dict(duration_s=7.5, kills=2, hangs=2, delays=3, exceptions=2,
                       hang_seconds=1.5, delay_ms=10.0, expected_ticks=200)]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    disarm_faults()


@pytest.mark.parametrize("publishes", [0, 2])
@pytest.mark.parametrize("kw", range(len(KWARGS)))
@pytest.mark.parametrize("seed", range(4))
def test_plan_equals_the_reference(seed, kw, publishes):
    got = build_chaos_plan(seed, publishes=publishes, **KWARGS[kw]).to_doc()
    assert got == j_build_chaos_plan(seed, publishes=publishes, **KWARGS[kw]).to_doc()
    json.dumps(got)


def test_plan_different_seeds_differ():
    kw = dict(duration_s=7.5, kills=1, hangs=1, delays=2, exceptions=1)
    docs = [build_chaos_plan(s, **kw).to_doc() for s in (1, 2, 3)]
    assert docs[0] != docs[1] or docs[1] != docs[2]


def test_plan_specs_parse_and_target_known_points():
    plan = build_chaos_plan(99, duration_s=10.0, kills=3, hangs=3, delays=3, exceptions=3,
                            hang_seconds=2.0)
    specs = _parse_specs(plan.fault_plan())
    assert len(specs) == 9
    for spec in specs:
        assert spec.point in CHAOS_POINTS and spec.point in KNOWN_POINTS
        if spec.mode == "hang":
            assert spec.point in ("serve.prefill", "serve.decode_tick")
            assert spec.seconds == 2.0
    kills = plan.kill_events()
    assert kills == sorted(kills, key=lambda k: k.at_s)
    assert all(0.15 * 10.0 <= k.at_s <= 0.70 * 10.0 and k.pick >= 0 for k in kills)


def test_plan_rejects_nonpositive_duration_and_picks_modularly():
    with pytest.raises(ValueError):
        build_chaos_plan(1, duration_s=0.0)
    ev = KillEvent(at_s=1.0, pick=7)
    assert all(0 <= ev.pick % n < n for n in (1, 2, 3, 5))


def test_plan_fault_plan_is_a_copy():
    plan = ChaosPlan(seed=1, duration_s=1.0,
                     faults=[{"point": "serve.admit", "mode": "delay", "hit": 1, "ms": 5.0}])
    got = plan.fault_plan()
    got[0]["mode"] = "exception"
    assert plan.faults[0]["mode"] == "delay"


def test_publish_draws_leave_the_seed_pinned():
    base = build_chaos_plan(11, duration_s=10.0).to_doc()
    withpub = build_chaos_plan(11, duration_s=10.0, publishes=2).to_doc()
    assert withpub["faults"] == base["faults"] and withpub["kills"] == base["kills"]
    assert base["publishes"] == [] and len(withpub["publishes"]) == 2
    assert build_chaos_plan(11, duration_s=10.0, publishes=2).to_doc() == withpub
    assert all(0.15 * 10.0 <= p["at_s"] <= 0.70 * 10.0 for p in withpub["publishes"])


def _reqs(prompts, n_new):
    return [Request(prompt_ids=list(p), sampling=SamplingParams(max_new_tokens=n_new))
            for p in prompts]


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, 8)] for _ in range(n)]


def test_fault_free_soak_reports_clean():
    _, _, model, cfg = qwen3_models()

    def factory():
        return Router(model, cfg, EngineConfig(num_blocks=64, block_size=8, num_slots=2,
                                               max_model_len=64), RouterConfig(replicas=2))

    report = run_chaos_soak(router_factory=factory, requests=_reqs(_prompts(6, 5), 4),
                            arrivals=[0.0, 0.01, 0.02, 0.05, 0.08, 0.1], plan=None,
                            restore_timeout_s=10.0)
    assert report["seed"] is None
    assert report["submitted"] == 6 and report["completed"] == 6
    assert not report["lost_ids"] and not report["duplicated"] and not report["leaked_blocks"]
    assert report["restored"] and not report["stalled"]
    assert report["wedged"] == 0 and report["respawns"] == 0
    assert report["goodput_tok"] > 0 and report["invariants_ok"]


def test_publish_only_soak_converges_and_requires_publish_fn():
    _, _, model, cfg = qwen3_models()
    plan = build_chaos_plan(5, duration_s=2.0, kills=0, hangs=0, delays=0, exceptions=0,
                            publishes=1)
    reqs = _reqs(_prompts(8, 50), 4)
    arrivals = [0.2 * i for i in range(len(reqs))]

    def factory():
        r = Router(model, cfg, EngineConfig(num_blocks=64, block_size=8, num_slots=2,
                                            max_model_len=128), RouterConfig(replicas=3))
        r.run(_reqs(_prompts(2, 51), 2))  # warm
        return r

    with pytest.raises(ValueError, match="publish_fn"):
        run_chaos_soak(router_factory=factory, requests=reqs, arrivals=arrivals, plan=plan)
    report = run_chaos_soak(
        router_factory=factory, requests=reqs, arrivals=arrivals, plan=plan,
        publish_fn=lambda router, idx: router.publish_weights(perturb(model),
                                                              f"storm-v{idx + 1}"))
    assert report["publishes"] == 1 and report["published_versions"] == ["storm-v1"]
    assert report["version_converged"] and report["serving_versions"] == ["storm-v1"]
    assert report["publish_wall_s"] >= 0
    assert report["invariants_ok"], report

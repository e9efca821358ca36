"""Seeded deterministic chaos schedules + the self-healing soak.

Port of ``veomni_tpu/resilience/chaos.py`` (``:54-393``): the same plan,
drawn from the same ``random.Random(seed)`` stream in the same order, so a
seed's ``to_doc()`` equals the reference's field for field
(``tests/test_torch_chaos.py``). A chaos *plan* is a pure function of its
seed: :func:`build_chaos_plan` draws kill times and fault specs from one
``random.Random(seed)`` stream, so a failing soak can be replayed
bit-for-bit from the one integer in its report. The faults are composed
from the ``resilience/faults.py`` grammar — ``hang``/``delay``/
``exception`` across the serving points ``serve.admit``/
``serve.prefill``/``serve.decode_tick`` — plus router-level replica kills
and mid-storm weight publishes, which the fault layer cannot express
because they are *control-plane* actions (``Router.kill_replica``,
``Router.publish_weights``), not code-path faults. Publish events are
drawn AFTER every fault and kill draw, so adding ``publishes=N`` to a
plan never moves the faults/kills an existing seed pins.

:func:`run_chaos_soak` runs the storm behind the chaos tests and
``chip_smoke.py``'s router phase: it replays an open-loop arrival schedule
through a fresh router while the plan's faults fire, lets the
self-healing machinery (wedge detection -> respawn -> probation,
``serving/router.py``) do its job, then drives a bounded *restore* phase
(probe bursts create the spill traffic probation replicas need) and
checks the fleet invariants:

* **no lost or duplicated request ids** — every submitted id reaches
  exactly one terminal output;
* **zero leaked blocks per survivor** — each quiescent engine satisfies
  the pool identity ``used == 0 and free_uncached + cached == pool``;
* **fleet restored** — the live count returns to the configured replica
  count (unless the plan deliberately exhausted a respawn budget);
* **goodput floor** — callers compare ``goodput_tok_s`` against a
  fault-free replay of the same storm (same requests, same arrivals,
  ``plan=None``).

Layering: this module is resilience-layer and imports serving types only
inside the soak, so arming/parsing plans stays importable from
anywhere without dragging in the engine.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: serving code-path fault points a chaos plan may target
CHAOS_POINTS = ("serve.admit", "serve.prefill", "serve.decode_tick")

#: points that run INSIDE the router's pump (``engine.step``) — a ``hang``
#: there is what the wedge detector exists for; a hang at ``serve.admit``
#: would hang the dispatching router thread itself, which is a different
#: (host-side, non-XLA) failure mode the plan generator never schedules
_PUMP_POINTS = ("serve.prefill", "serve.decode_tick")


@dataclass(frozen=True)
class KillEvent:
    """One scheduled replica kill: at ``at_s`` (storm-relative) the soak
    kills ``live[pick % len(live)]`` — the pick is seeded but resolves
    against the live set at fire time, so the schedule stays valid
    whatever the fleet looks like by then."""

    at_s: float
    pick: int


@dataclass(frozen=True)
class PublishEvent:
    """One scheduled mid-storm weight publish: at ``at_s`` the soak calls
    its ``publish_fn`` (which runs ``Router.publish_weights``) and then
    watches the rolling swap converge — the chaos coverage for the
    PUBLISHING state machine (docs/serving.md "Versioned weight
    publication")."""

    at_s: float


@dataclass
class ChaosPlan:
    """A seeded, fully deterministic chaos schedule."""

    seed: int
    duration_s: float
    faults: List[Dict[str, Any]] = field(default_factory=list)
    kills: List[KillEvent] = field(default_factory=list)
    publishes: List[PublishEvent] = field(default_factory=list)

    def fault_plan(self) -> List[Dict[str, Any]]:
        """The ``faults.py`` spec list — feed to ``configure_faults`` (or
        serialize into ``VEOMNI_FAULT_PLAN``)."""
        return [dict(f) for f in self.faults]

    def kill_events(self) -> List[KillEvent]:
        return sorted(self.kills, key=lambda k: k.at_s)

    def publish_events(self) -> List[PublishEvent]:
        return sorted(self.publishes, key=lambda p: p.at_s)

    def to_doc(self) -> Dict[str, Any]:
        """JSON-ready canonical form (reports, determinism pin)."""
        return {
            "seed": self.seed,
            "duration_s": self.duration_s,
            "faults": [dict(f) for f in self.faults],
            "kills": [{"at_s": k.at_s, "pick": k.pick}
                      for k in self.kill_events()],
            "publishes": [{"at_s": p.at_s}
                          for p in self.publish_events()],
        }


def build_chaos_plan(seed: int, *, duration_s: float = 10.0,
                     kills: int = 1, hangs: int = 1, delays: int = 2,
                     exceptions: int = 1, hang_seconds: float = 2.0,
                     delay_ms: float = 20.0,
                     expected_ticks: int = 400,
                     publishes: int = 0) -> ChaosPlan:
    """Draw a deterministic chaos schedule from ``seed``.

    ``expected_ticks`` scales the fault hit positions: fault-layer hit
    counters count ``fault_point`` calls fleet-wide from arming, so hits
    are drawn from ``[2, expected_ticks)`` to land mid-storm rather than
    stacking on the first tick. Kills are drawn from the middle 15–70% of
    ``duration_s`` so the fleet is busy when they land and has storm left
    to recover in; ``publishes`` schedules mid-storm weight publications
    in the same window, drawn AFTER every other event so the faults and
    kills an existing seed pins stay bit-identical when publish coverage
    is added. Same seed -> identical plan, field for field.
    """
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0")
    rng = random.Random(int(seed))
    hit_hi = max(3, int(expected_ticks))
    faults: List[Dict[str, Any]] = []
    for _ in range(max(0, hangs)):
        faults.append({
            "point": rng.choice(_PUMP_POINTS), "mode": "hang",
            "hit": rng.randrange(2, hit_hi), "times": 1,
            "seconds": float(hang_seconds),
        })
    for _ in range(max(0, delays)):
        faults.append({
            "point": rng.choice(CHAOS_POINTS), "mode": "delay",
            "hit": rng.randrange(2, hit_hi),
            "times": rng.randrange(1, 4), "ms": float(delay_ms),
        })
    for _ in range(max(0, exceptions)):
        faults.append({
            "point": rng.choice(CHAOS_POINTS), "mode": "exception",
            "hit": rng.randrange(2, hit_hi), "times": 1,
        })
    # canonical order (point, hit, mode) so to_doc() comparisons are
    # insensitive to the draw order above
    faults.sort(key=lambda f: (f["point"], f["hit"], f["mode"]))
    kill_events = [
        KillEvent(at_s=round(rng.uniform(0.15, 0.70) * duration_s, 3),
                  pick=rng.randrange(0, 8))
        for _ in range(max(0, kills))
    ]
    # publishes draw LAST: a seed's faults/kills stay bit-identical
    # whether or not the caller asks for publish coverage
    publish_events = [
        PublishEvent(at_s=round(rng.uniform(0.15, 0.70) * duration_s, 3))
        for _ in range(max(0, publishes))
    ]
    return ChaosPlan(seed=int(seed), duration_s=float(duration_s),
                     faults=faults, kills=kill_events,
                     publishes=publish_events)


def run_chaos_soak(*, router_factory: Callable[[], Any],
                   requests: List[Any], arrivals: List[float],
                   plan: Optional[ChaosPlan] = None,
                   probe_request_fn: Optional[Callable[[int], List[Any]]]
                   = None,
                   publish_fn: Optional[Callable[[Any, int], str]] = None,
                   restore: bool = True,
                   restore_timeout_s: float = 30.0) -> Dict[str, Any]:
    """Drive one open-loop storm through a fresh router while ``plan``'s
    faults and kills fire, then restore the fleet and report invariants.

    ``router_factory`` builds (and warms) the router — a fresh one per
    soak so the fault-free replay and the chaos run start identical.
    ``requests``/``arrivals`` define the storm (request ``i`` is
    submitted once the storm clock passes ``arrivals[i]``); pass
    ``plan=None`` for the fault-free replay. ``probe_request_fn(k)``
    supplies ``k`` shared-prefix probe requests for the restore phase
    (default: clones of ``requests[0]``'s prompt) — bursts sized to push
    every live replica past the spill threshold, so probation replicas
    receive the spill traffic they need to pass.

    ``publish_fn(router, idx)`` fires at each of the plan's publish
    events: it must call ``router.publish_weights`` (with whatever
    payload the caller stages) and return the version tag. The soak then
    times the rolling swap to convergence (``publish_wall_s``) and adds
    a **version convergence** invariant: after restore, every serving
    replica reports ONE weights version and no publish is still in
    progress. A plan that schedules publishes without a ``publish_fn``
    is an error — silently skipping scheduled chaos would report
    coverage that never ran.
    """
    from veomni_tpu_torch.resilience.faults import configure_faults, disarm_faults
    from veomni_tpu_torch.serving.api import Request, SamplingParams

    if plan is not None and plan.publishes and publish_fn is None:
        raise ValueError(
            "chaos plan schedules publish events but no publish_fn was "
            "given: the publish coverage would silently not run"
        )
    router = router_factory()
    n_cfg = router.config.replicas
    kills = plan.kill_events() if plan is not None else []
    publishes = plan.publish_events() if plan is not None else []
    if plan is not None:
        configure_faults(plan.fault_plan())
    ids: List[str] = []
    published: List[str] = []
    publish_walls: List[float] = []
    pub_t0: Optional[float] = None
    stalled = False
    t0 = time.perf_counter()
    try:
        i = 0
        while i < len(requests) or router.has_work:
            t = time.perf_counter() - t0
            while kills and t >= kills[0].at_s:
                ev = kills.pop(0)
                live = router.live_replicas()
                if live:
                    victim = live[ev.pick % len(live)]
                    logger.warning("chaos: killing replica %s (t=%.2fs)",
                                   victim.rid, t)
                    router.kill_replica(
                        victim.rid, reason=f"chaos kill @{ev.at_s:.2f}s")
            while publishes and t >= publishes[0].at_s:
                ev = publishes.pop(0)
                logger.warning("chaos: publishing weights mid-storm "
                               "(t=%.2fs)", t)
                published.append(str(publish_fn(router, len(published))))
                pub_t0 = time.perf_counter()
            while i < len(requests) and arrivals[i] <= t:
                ids.append(router.submit(requests[i]))
                i += 1
            if router.has_work:
                try:
                    router.step()
                except RuntimeError:
                    # total fleet loss past every respawn budget: the
                    # router rejected everything queued before raising —
                    # stop submitting, the report shows what survived
                    stalled = True
                    break
            elif i < len(requests):
                time.sleep(min(max(arrivals[i] - t, 0.0), 0.01))
            if pub_t0 is not None and not router.publish_in_progress:
                publish_walls.append(time.perf_counter() - pub_t0)
                pub_t0 = None
        duration_s = time.perf_counter() - t0
    finally:
        if plan is not None:
            disarm_faults()
    # ------------------------------------------------------------- restore
    # fault-free from here on: land pending respawns and graduate
    # probation replicas so the fleet returns to its configured size
    probes: List[str] = []
    if publishes and not stalled:
        # the storm drained before a scheduled publish time arrived: fire
        # the remaining events now rather than silently skipping chaos
        # coverage the plan promised
        for _ in list(publishes):
            publishes.pop(0)
            published.append(str(publish_fn(router, len(published))))
            pub_t0 = time.perf_counter()
    if restore and not stalled:
        if probe_request_fn is None and requests:
            base = list(requests[0].prompt_ids)

            def probe_request_fn(k: int) -> List[Any]:  # noqa: F811
                return [Request(prompt_ids=list(base),
                                sampling=SamplingParams(max_new_tokens=4))
                        for _ in range(k)]

        deadline = time.perf_counter() + restore_timeout_s
        while time.perf_counter() < deadline:
            fleet_ok = (
                len(router.live_replicas()) >= n_cfg
                and not router._pending_respawns
                and not any(h.state == "probation"
                            for h in router.replicas.values())
            )
            if fleet_ok and not router.has_work:
                break
            if router.has_work or router._pending_respawns:
                try:
                    router.step()
                except RuntimeError:
                    stalled = True
                    break
                if (pub_t0 is not None
                        and not router.publish_in_progress):
                    publish_walls.append(time.perf_counter() - pub_t0)
                    pub_t0 = None
                continue
            if probe_request_fn is None:
                break
            if router._retired_lineages and not any(
                    h.state == "probation"
                    for h in router.replicas.values()):
                # a lineage exhausted its respawn budget: full restoration
                # is impossible by design, don't burn the timeout probing
                break
            # identical-prefix burst: every probe rendezvouses to ONE live
            # target, saturating it past spill_queue_depth so the
            # least-loaded (idle probation) replica receives the spill
            burst = (router.config.spill_queue_depth + 1
                     + sum(router.config.probation_requests
                           for h in router.replicas.values()
                           if h.state == "probation"))
            for req in probe_request_fn(burst):
                probes.append(router.submit(req))
    # ----------------------------------------------------------- invariants
    if pub_t0 is not None and not router.publish_in_progress:
        publish_walls.append(time.perf_counter() - pub_t0)
        pub_t0 = None
    outs = {rid: router._outputs[rid]
            for rid in ids if rid in router._outputs}
    lost = sorted(set(ids) - set(outs))
    leaked: Dict[str, int] = {}
    for h in router.replicas.values():
        if not h.engine_quiescent or h.engine.has_work:
            continue
        bm = h.engine.blocks
        leak = (bm.num_blocks - 1) - (bm.num_free_uncached + bm.num_cached)
        if bm.num_used != 0 or leak != 0:
            leaked[h.rid] = max(leak, bm.num_used)
    goodput_tok = sum(
        len(o.token_ids) for o in outs.values()
        if o.finish_reason in ("eos", "length")
        and not getattr(o, "deadline_missed", False)
    )
    live_count = len(router.live_replicas())
    # version convergence: after a mid-storm publish every serving
    # replica must report ONE weights version (the latest) with no
    # publish still rolling — the mixed-version window must CLOSE
    serving_versions = sorted({
        h.weights_version for h in router.replicas.values()
        if h.state in ("live", "probation", "publishing")
    })
    version_converged = (
        not published
        or (len(serving_versions) <= 1
            and not router.publish_in_progress
            and not stalled)
    )
    report = {
        "seed": plan.seed if plan is not None else None,
        "submitted": len(ids),
        "completed": len(outs),
        "duplicated": len(ids) != len(set(ids)),
        "lost_ids": lost,
        "leaked_blocks": leaked,
        "live_count": live_count,
        "restored": (live_count >= n_cfg
                     and not router._pending_respawns),
        "stalled": stalled,
        "wedged": router._wedged_total,
        "respawns": router._respawn_total,
        "probation_passed": router._probation_total,
        "retired_lineages": sorted(router._retired_lineages),
        "probe_submitted": len(probes),
        "goodput_tok": goodput_tok,
        "duration_s": duration_s,
        "goodput_tok_s": goodput_tok / max(duration_s, 1e-9),
        "publishes": len(published),
        "published_versions": published,
        "serving_versions": serving_versions,
        "version_converged": version_converged,
        "publish_wall_s": round(sum(publish_walls), 6),
    }
    report["invariants_ok"] = bool(
        not report["duplicated"] and not lost and not leaked
        and report["restored"] and not stalled and version_converged
    )
    report["outputs"] = outs
    report["router"] = router
    return report

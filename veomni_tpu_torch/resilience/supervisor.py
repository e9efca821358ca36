"""Train-loop supervision: anomaly escalation + preemption-safe shutdown.

The loop in ``trainer/base.py`` dispatches steps asynchronously and only
syncs with the device on the log cadence; a loss blow-up must be caught
WITHOUT adding host syncs. The train step therefore computes a device-side
``step_ok`` flag (finite loss AND finite grad norm — see
``train/train_step.py``) and, when ``resilience_skip_nonfinite`` is on,
already refuses to apply a non-finite update on device. The supervisor rides
the loop's existing in-flight drain (the dispatch-depth bound): each step's
``(loss, step_ok)`` futures are queued, and only entries popped beyond the
depth — or on a sync step, where the host blocks anyway — are fetched.

Escalation policy per observed anomaly:

1. **skip**     — the device already skipped the update; count and log.
2. **rollback** — after ``rollback_after`` CONSECUTIVE anomalies, restore the
   latest committed checkpoint (params + optimizer + rank-local dataloader
   cursor) and replay the iterator from there.
3. **abort**    — when total anomalies exceed ``anomaly_budget`` or rollbacks
   exceed ``max_rollbacks``, raise :class:`AnomalyBudgetExceeded`: the blow-up
   is systemic (deterministic replay will reproduce a data-driven NaN), and
   burning cluster time is worse than dying loudly.

:class:`GracefulShutdown` handles SIGTERM preemption: the handler only sets a
flag (and unblocks a prefetch-blocked consumer); the loop notices at the next
step boundary, takes one final synchronous checkpoint via the normal
``on_train_end`` path, and returns so the process exits 0 — the cluster
restart then resumes bit-exactly.
"""

from __future__ import annotations

import signal
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from veomni_tpu_torch.observability.flight_recorder import record as flight_record
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.resilience.faults import fault_point
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class AnomalyBudgetExceeded(RuntimeError):
    """Training aborted: anomalous steps exceeded the configured budget."""


class RollbackImpossible(RuntimeError):
    """Rollback was requested but no committed checkpoint exists."""


_SEVERITY = {"ok": 0, "skip": 1, "rollback": 2, "abort": 3}


def worse_verdict(a: str, b: str) -> str:
    return a if _SEVERITY[a] >= _SEVERITY[b] else b


@dataclass(frozen=True)
class SupervisorPolicy:
    skip_nonfinite: bool = True
    anomaly_budget: int = 8
    rollback_after: int = 3
    max_rollbacks: int = 2
    # matches the loop's historical dispatch-depth bound: at most this many
    # un-inspected steps in flight before the oldest loss is fetched
    inflight_depth: int = 4
    watchdog_s: float = 0.0

    @classmethod
    def from_train_args(cls, t) -> "SupervisorPolicy":
        return cls(
            skip_nonfinite=t.resilience_skip_nonfinite,
            anomaly_budget=t.resilience_anomaly_budget,
            rollback_after=t.resilience_rollback_after,
            max_rollbacks=t.resilience_max_rollbacks,
            watchdog_s=t.resilience_watchdog_s,
        )


class TrainSupervisor:
    """Observes per-step metrics futures and returns an escalation verdict:
    ``"ok" | "skip" | "rollback" | "abort"`` (the trainer acts on the last
    two). Fetches a host value only where the loop already would."""

    def __init__(self, policy: SupervisorPolicy):
        self.policy = policy
        # (global_step, loss_future, ok_future, injected)
        self._inflight: Deque[Tuple[int, Any, Any, bool]] = deque()
        self.anomalies = 0
        self.consecutive = 0
        # first global_step of the CURRENT consecutive anomaly run: the
        # rollback target must be a checkpoint committed BEFORE it, or the
        # "restore and replay" contract degenerates to a no-op rewind
        self.consec_start: Optional[int] = None
        self.rollbacks = 0
        self.stalls = 0
        self.anomaly_steps: List[int] = []
        self.last_verdict = "ok"
        # True when the MOST RECENT observe() call's step carried a host-
        # injected step.loss poison: the trainer stamps the published
        # step_ok flag false for that step (so window accumulators and the
        # train.step_ok gauge agree with the supervisor)
        self.last_injected = False
        # Whether the most recently CHECKED anomalous entry was host-
        # injected. Distinct from last_injected: the dispatch-depth queue
        # drains an entry steps AFTER it was observed, so when a non-ok
        # verdict surfaces, the current observe() call's injected flag
        # describes the wrong step. Set unconditionally on every anomalous
        # _check (never reset), so by the time the trainer reads it a
        # non-ok verdict guarantees it was stamped by an anomaly of the
        # same observe/drain window. The numerics provenance doc keys its
        # `injected` marker off this one (a drill must never read as
        # organic rot in a post-mortem).
        self.last_anomaly_injected = False

    # ---------------------------------------------------------- observation
    def observe(self, step: int, metrics: Dict[str, Any]) -> str:
        """Queue this step's signals; inspect whatever the dispatch-depth
        bound pops. ``step.loss`` fault injection poisons the OBSERVED flag
        here (host-side, deterministic) — the device-side skip path has its
        own unit coverage with a genuinely non-finite loss."""
        act = fault_point("step.loss")
        injected = act is not None and act.mode == "nan"
        self.last_injected = injected
        self._inflight.append(
            (step, metrics.get("loss"), metrics.get("step_ok"), injected)
        )
        verdict = "ok"
        while len(self._inflight) > self.policy.inflight_depth:
            verdict = worse_verdict(verdict, self._check(self._inflight.popleft()))
            if _SEVERITY[verdict] >= _SEVERITY["rollback"]:
                break  # the rest of the queue belongs to a doomed trajectory
        return verdict

    def drain(self) -> str:
        """Inspect every queued entry (sync steps — the host is blocked on
        the device anyway — and end of train)."""
        verdict = "ok"
        while self._inflight:
            verdict = worse_verdict(verdict, self._check(self._inflight.popleft()))
            if _SEVERITY[verdict] >= _SEVERITY["rollback"]:
                break
        return verdict

    def _check(self, entry: Tuple[int, Any, Any, bool]) -> str:
        step, loss, ok, injected = entry
        anomalous = injected
        if not anomalous and ok is not None:
            anomalous = not bool(np.asarray(ok))
        if not anomalous and loss is not None:
            anomalous = not np.isfinite(float(np.asarray(loss)))
        if not anomalous:
            self.consecutive = 0
            self.consec_start = None
            return "ok"
        self.anomalies += 1
        self.last_anomaly_injected = injected
        get_registry().counter("resilience.anomalies").inc()
        flight_record("supervisor.anomaly", cid=str(step),
                      injected=injected, consecutive=self.consecutive + 1,
                      total=self.anomalies)
        self.consecutive += 1
        if self.consecutive == 1:
            self.consec_start = step
        self.anomaly_steps.append(step)
        logger.warning_rank0(
            "anomalous step %d (non-finite loss/grad%s): %d consecutive, "
            "%d/%d total",
            step, " [injected]" if injected else "",
            self.consecutive, self.anomalies, self.policy.anomaly_budget,
        )
        if self.anomalies > self.policy.anomaly_budget:
            return self._verdict("abort")
        if self.consecutive >= self.policy.rollback_after:
            if self.rollbacks >= self.policy.max_rollbacks:
                return self._verdict("abort")
            return self._verdict("rollback")
        return self._verdict("skip")

    def _verdict(self, v: str) -> str:
        # "abort" is sticky for /healthz; skip/rollback clear when the
        # trajectory recovers (note_rollback) — a probe must flip unhealthy
        # the moment the budget is blown, even if the raise is still queued
        self.last_verdict = worse_verdict(self.last_verdict, v)
        if v == "skip":
            get_registry().counter("resilience.skips").inc()
        flight_record("supervisor.verdict", cid=v,
                      anomalies=self.anomalies, consecutive=self.consecutive)
        return v

    # ------------------------------------------------------------ lifecycle
    def note_rollback(self, to_step: int) -> None:
        self.rollbacks += 1
        get_registry().counter("resilience.rollbacks").inc()
        flight_record("supervisor.rollback", cid=str(to_step),
                      rollback=self.rollbacks)
        self.consecutive = 0
        self.consec_start = None
        self._inflight.clear()  # futures from the abandoned trajectory
        if self.last_verdict != "abort":
            self.last_verdict = "ok"  # trajectory restored; probe recovers
        logger.warning_rank0(
            "rolled back to checkpoint step %d (rollback %d/%d)",
            to_step, self.rollbacks, self.policy.max_rollbacks,
        )

    def note_stall(self, stack_dump: str) -> None:
        self.stalls += 1
        get_registry().counter("resilience.stalls").inc()
        flight_record("supervisor.stall", cid=str(self.stalls))

    def stats(self) -> Dict[str, Any]:
        return {
            "anomalies": self.anomalies,
            "anomaly_steps": list(self.anomaly_steps),
            "rollbacks": self.rollbacks,
            "watchdog_stalls": self.stalls,
        }

    def health(self) -> Dict[str, Any]:
        """/healthz document (observability exporter): healthy until the
        anomaly budget blows (``abort`` is sticky); a mid-escalation
        skip/rollback reports degraded-but-healthy with full context.
        Integrity counts ride along so a probe sees storage rot (quarantined
        checkpoint generations, skipped poison records) without log
        scraping."""
        reg = get_registry()
        return {
            "healthy": self.last_verdict != "abort",
            "last_verdict": self.last_verdict,
            "consecutive_anomalies": self.consecutive,
            "ckpt_quarantined": int(reg.counter("integrity.ckpt_quarantined").value),
            "ckpt_fallbacks": int(reg.counter("integrity.ckpt_fallbacks").value),
            "data_skipped": int(reg.counter("integrity.data_skipped").value),
            # a probe should see that this run crossed a topology boundary
            # (resharded arrays + merged cursors) without log scraping
            "elastic_restores": int(reg.counter("ckpt.elastic_restores").value),
            **self.stats(),
        }


class GracefulShutdown:
    """Context manager installing SIGTERM (by default) handlers that request
    a graceful stop instead of dying mid-step.

    The handler body is signal-safe-minimal: set a flag, log, and invoke
    ``on_request`` (the trainer passes an idempotent prefetcher close, so a
    consumer blocked on the prefetch queue wakes up instead of absorbing the
    preemption deadline). Handler installation is a no-op off the main
    thread (Python restriction) — nested/threaded test trainers still work,
    they just don't get signal coverage.
    """

    def __init__(self, signals=None,
                 on_request: Optional[Callable[[], None]] = None):
        self.signals = tuple(signals) if signals else (signal.SIGTERM,)
        self.on_request = on_request
        self.requested = False
        self.signum: Optional[int] = None
        self._prev: Dict[int, Any] = {}

    def _handler(self, signum, frame):
        self.requested = True
        self.signum = signum
        logger.warning_rank0(
            "received signal %d: requesting graceful stop (final checkpoint "
            "at the next step boundary)", signum,
        )
        if self.on_request is not None:
            try:
                self.on_request()
            except Exception:
                pass

    def __enter__(self) -> "GracefulShutdown":
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                break
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}

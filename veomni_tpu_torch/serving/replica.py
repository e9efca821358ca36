"""Replica handle: the router's per-engine bookkeeping unit.

Port of ``veomni_tpu/serving/replica.py`` (``:67-186``), unchanged but for
its imports. One :class:`ReplicaHandle` wraps one in-process
:class:`~veomni_tpu_torch.serving.engine.InferenceEngine` behind the
scale-out router (``serving/router.py``). The handle owns everything the router
needs to know about a replica that the engine itself does not track:

* **lifecycle state** — ``live`` (in the dispatch rotation), ``probation``
  (a respawned replica serving only spill traffic until it proves itself),
  ``draining`` (finishing in-flight work before a clean detach; receives
  no new requests), ``publishing`` (receives no new requests while it
  drains in-flight work on the OLD weights version, then the router
  hot-swaps its buffers in place and returns it to its prior rotation
  state at the new version), ``wedged`` (its pump thread blew the
  ``replica_stall_s`` deadline and was abandoned behind the generation
  fence) or ``dead`` (pump raised / killed; its stranded requests were
  re-dispatched or surfaced terminal by the router).
* **generation fence** — a monotonically increasing integer bumped every
  time the router abandons the replica's in-flight pump (wedge) or
  respawns its lineage. A zombie pump thread that eventually returns
  carries a stale generation, so its results, metrics-label writes and
  debug rows are all dropped instead of corrupting the successor.
* **assignment set** — the request ids currently dispatched to this
  engine and not yet captured back by the router. On replica death this
  set IS the list of stranded requests to triage; on drain it is the
  work left before detach.
* **weights version** — the version tag the replica's parameters were
  published under (``Router.publish_weights``). Replicas added after a
  publish serve the new version while old replicas finish on theirs.
* **dispatch counters** — requests dispatched here, requests that had to
  be re-dispatched AWAY after this replica died, and the probation
  completions a respawned replica has served so far.

The handle is plain host bookkeeping touched only by the router's pump
thread; anything another thread reads goes through the router's locked
debug snapshot (``/debug/router``), never through a live handle. The one
exception is the pump worker the router itself starts for this handle:
while a pump ticket is outstanding (``pump is not None``) the ENGINE
belongs to that worker, so every router-side read here falls back to the
``last_*`` snapshots taken at the previous completed tick.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set

from veomni_tpu_torch.serving.engine import InferenceEngine

#: lifecycle states a replica moves through (strictly forward:
#: live -> draining -> detached, live/draining -> dead/wedged, and —
#: self-healing — dead/wedged ->
#: respawned successor handle in probation -> live)
STATE_LIVE = "live"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"
STATE_DETACHED = "detached"  # drained clean and out of the replica set
STATE_WEDGED = "wedged"  # pump blew replica_stall_s; thread abandoned
STATE_PROBATION = "probation"  # respawned; spill-only until proven
STATE_PUBLISHING = "publishing"  # draining toward a weight hot-swap


@dataclass
class ReplicaHandle:
    """One engine replica as the router sees it."""

    rid: str  # instance label, e.g. "r0" — also the engine's metrics_label
    engine: InferenceEngine
    state: str = STATE_LIVE
    weights_version: str = "v0"
    # request ids dispatched to this engine, not yet captured back
    assigned: Set[str] = field(default_factory=set)
    dispatched: int = 0  # requests ever routed here
    redispatched: int = 0  # requests re-routed away after this replica died
    # the router's last observed failure for a dead replica (repr'd
    # exception) — lands in the debug doc so a postmortem names the cause
    fail_reason: str = ""
    # generation fence: bumped on wedge-abandon and on respawn. A pump
    # ticket snapshots the generation at start; the router only applies
    # results whose generation still matches.
    generation: int = 0
    # lineage root rid (respawned handles keep their ancestor's rid, so
    # lineage == rid today; kept explicit for the respawn budget ledger)
    lineage: str = ""
    # clean completions served while on probation (router-counted)
    probation_done: int = 0
    # rolling weight publication (state == "publishing"): the version tag
    # this replica is draining toward, and the rotation state to restore
    # after the swap (live replicas return to live, probation replicas
    # resume probation — a publish must not launder a replica past its
    # probation sentence)
    publish_to: str = ""
    publish_from_state: str = ""
    # consecutive router ticks this handle's pump exceeded replica_stall_s
    stall_ticks: int = 0
    # outstanding pump ticket (router._PumpTicket) — None when the engine
    # is quiescent and safe for the router thread to touch directly
    pump: Optional[Any] = field(default=None, repr=False)
    # last engine readings taken while quiescent; served while a pump
    # ticket is outstanding so gauges/spill decisions never race the
    # worker thread into the engine
    last_queue_depth: int = 0
    last_num_running: int = 0
    last_free_seqs: int = 0
    # pump-worker-private: ticks pumped (heartbeat global_step) and the
    # last heartbeat write time (throttle); only ever touched by the one
    # outstanding worker, never by the router thread
    pumped_ticks: int = 0
    last_beat: float = 0.0

    @property
    def in_rotation(self) -> bool:
        """Eligible for NEW affinity dispatches (probation, draining,
        wedged and dead replicas are not)."""
        return self.state == STATE_LIVE

    @property
    def pumpable(self) -> bool:
        """Still stepped by the router (wedged/dead replicas never are).
        A PUBLISHING replica stays pumpable: it must finish its in-flight
        work on the old weights before the swap can happen."""
        return self.state in (STATE_LIVE, STATE_DRAINING, STATE_PROBATION,
                              STATE_PUBLISHING)

    @property
    def engine_quiescent(self) -> bool:
        """True when the router thread may touch ``engine`` directly: the
        replica is pumpable or cleanly detached AND no pump worker is in
        flight. Wedged/dead engines may still be mutated by an abandoned
        zombie thread, so they are never quiescent."""
        return (self.pump is None
                and self.state not in (STATE_DEAD, STATE_WEDGED))

    def queue_depth(self) -> int:
        """Waiting requests at the replica's engine (the spill signal).
        Falls back to the last quiescent snapshot while a pump ticket is
        outstanding."""
        if not self.engine_quiescent:
            return self.last_queue_depth
        self.last_queue_depth = self.engine.scheduler.queue_depth
        return self.last_queue_depth

    def free_concurrent_seqs(self) -> int:
        """Max-length sequences the engine's free blocks could still
        admit — the capacity leg of the spill decision (mirrors the
        engine's ``serve.kv_free_concurrent_seqs`` gauge). Snapshot-backed
        like :meth:`queue_depth`."""
        if not self.engine_quiescent:
            return self.last_free_seqs
        eng = self.engine
        per_seq = max(1, eng.blocks.blocks_for(eng.config.max_model_len))
        self.last_free_seqs = eng.blocks.num_free // per_seq
        return self.last_free_seqs

    def status_doc(self) -> Dict[str, Any]:
        """JSON-ready row for ``/debug/router`` and the CLI census."""
        if self.state in (STATE_DEAD, STATE_WEDGED):
            qd = nr = -1
        elif self.pump is not None:
            qd, nr = self.last_queue_depth, self.last_num_running
        else:
            qd = self.queue_depth()
            nr = self.last_num_running = self.engine.scheduler.num_running
        doc: Dict[str, Any] = {
            "rid": self.rid,
            "state": self.state,
            "generation": self.generation,
            "weights_version": self.weights_version,
            "queue_depth": qd,
            "num_running": nr,
            "assigned": len(self.assigned),
            "dispatched": self.dispatched,
            "redispatched": self.redispatched,
        }
        if self.state == STATE_PROBATION:
            doc["probation_done"] = self.probation_done
        if self.state == STATE_PUBLISHING:
            doc["publish_to"] = self.publish_to
        if self.stall_ticks:
            doc["stall_ticks"] = self.stall_ticks
        if self.fail_reason:
            doc["fail_reason"] = self.fail_reason
        return doc

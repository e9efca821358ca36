"""Scale-out serving: prefix-affinity router over data-parallel replicas.

Port of ``veomni_tpu/serving/router.py`` (``RouterConfig``, ``Router``,
``:153-1419``) over the port's engine, with the reference's behaviour
throughout. The router is the front door over N in-process
:class:`~veomni_tpu_torch.serving.engine.InferenceEngine` replicas: it owns
the QoS admission queue (classes, tenant DRR, queue bound, deadlines) and
dispatches through the ``api.py`` Request/RequestOutput surface. Replica
engines run single-class FIFO (``classes="default"``, bounds off), so a
request on a replica is token-exact with the bare engine.

1. **Prefix-affinity routing.** The target is chosen by rendezvous-hashing
   (crc32) the prompt's leading block-aligned chunk key, the chunks the
   radix prefix cache keys its tree on, so shared-prefix traffic lands
   where its KV already lives; adding or removing a replica moves only the
   keys that hash to it. Affinity yields under load: when the target's
   queue depth reaches ``spill_queue_depth`` (or its free
   concurrent-sequence estimate drops below ``spill_min_free_seqs``) the
   request spills to the least-loaded replica; when every replica is past
   the threshold it parks at the router, where the QoS pick decides.
2. **Health- and shed-aware dispatch.** A replica whose ``step()`` raises
   is marked DEAD the same tick; its stranded requests are triaged exactly
   once: nothing streamed yet -> re-dispatched (front of the router queue,
   arrival order); tokens already streamed -> terminal ``cancelled``;
   already terminal -> captured as-is.
3. **Live add/remove behind versioned weights.** ``add_replica()`` spins up
   an engine on the LATEST published payload; ``remove_replica()`` drains,
   then detaches. ``publish_weights`` rolls a new payload into the running
   fleet one replica at a time: PUBLISHING (out of rotation) -> drain on the
   old version -> in-place swap + prefix-cache flush under a bumped cache
   epoch -> back in rotation, never dropping the LIVE count below
   ``min_live`` while a pending respawn could restore headroom.
   ``publish_from_checkpoint`` refuses a corrupt generation behind the
   integrity gate before any replica changes version.
4. **Self-healing fleet.** Every busy replica is pumped on a worker thread
   behind ``replica_stall_s``: a ``step()`` over the deadline for
   ``replica_stall_ticks`` consecutive router ticks marks it WEDGED; the
   stuck worker is abandoned behind a generation fence (its result is never
   read, its labelled metric writes are revoked) and the death triage runs.
   Dead and wedged replicas respawn after a deterministic
   ``resilience.retry.RetryPolicy`` backoff and serve a PROBATION of spill
   traffic before rejoining the rotation; ``max_respawns`` a lineage
   exhausts into permanent retirement. ``health()`` reports it.

What differs from the reference: the weight store holds the model's state
on the host (``serving/weights.py::host_state``) and each engine casts its
own device copy, so a spawn or a swap copies the payload to the card; the
reference's ``SharedPrograms`` has no counterpart, since the port's engines
build no programs to share. On one card the replicas' pump workers share
the device and tick on its default stream: their host work (scheduling,
sampling, Python) overlaps, their kernels queue on the one stream.
``decode.TRACE_COUNTS`` and the hand kernels' launch counters are updated
under locks, so concurrent ticks count exactly. ``health()`` and
``debug_doc()`` are served over HTTP by the exporter
(``observability/exporter.py``: ``/healthz``, ``/debug/router``;
``tasks/serve.py --replicas`` under ``VEOMNI_METRICS_PORT``).

Threading contract: the router holds no locks for its own state. ONE pump
thread (the caller's) drives ``submit``/``step``/``generate``/``run``, and
each replica engine is touched by at most one thread at a time: the router
thread (quiescent) or the single outstanding pump worker
(``_PumpTicket``; ``Thread.join`` publishes its result back). While a
ticket is outstanding the router reads only the handle's ``last_*``
snapshots. The only other cross-thread surface is the debug snapshot
behind ``_debug_lock`` plus the thread-safe metrics registry and flight
recorder.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, Iterator, List, Optional, Union

from veomni_tpu_torch.observability.fleet import write_heartbeat
from veomni_tpu_torch.observability.flight_recorder import record as _flight_record
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.resilience.faults import fault_point
from veomni_tpu_torch.resilience.retry import RetryPolicy
from veomni_tpu_torch.serving.api import (
    Request,
    RequestOutput,
    SamplingParams,
    StreamEvent,
)
from veomni_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from veomni_tpu_torch.serving.replica import (
    STATE_DEAD,
    STATE_DETACHED,
    STATE_DRAINING,
    STATE_LIVE,
    STATE_PROBATION,
    STATE_PUBLISHING,
    STATE_WEDGED,
    ReplicaHandle,
)
from veomni_tpu_torch.serving.scheduler import QoSPicker, parse_classes
from veomni_tpu_torch.serving.weights import (
    WeightRecord,
    WeightStore,
    host_state,
    load_checkpoint_params,
    load_published_params,
)
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: numeric encoding for the per-replica ``serve.router.<rid>.state`` gauge
#:: forward transitions only ever raise the value
#: until a respawn resets it
STATE_CODES = {
    STATE_LIVE: 0,
    STATE_PROBATION: 1,
    STATE_DRAINING: 2,
    STATE_WEDGED: 3,
    STATE_DEAD: 4,
    STATE_DETACHED: 5,
    STATE_PUBLISHING: 6,  # transient: returns to live/probation post-swap
}


@dataclass
class RouterConfig:
    """Router-level knobs (the engine keeps its own via EngineConfig)."""

    # initial replica count (grow/shrink live via add/remove_replica)
    replicas: int = 2
    # leading FULL blocks of the prompt hashed into the affinity key —
    # mirrors the radix cache's block-aligned chunk keys, so requests
    # sharing a system prompt share a key. Prompts shorter than one block
    # key on the whole prompt.
    affinity_blocks: int = 2
    # affinity yields when the target replica's engine queue depth reaches
    # this; when EVERY live replica is past it, requests park at the
    # router (back-pressure). 0 disables spill AND parking (pure affinity).
    spill_queue_depth: int = 4
    # affinity also yields when the target's free concurrent-sequence
    # estimate (the serve.kv_free_concurrent_seqs signal) drops below
    # this. 0 disables the capacity leg.
    spill_min_free_seqs: int = 0
    # QoS at the front door. None inherits the corresponding EngineConfig
    # field, so an engine-tuned deployment routes identically.
    classes: Optional[str] = None
    queue_bound: Optional[int] = None
    tenant_max_inflight: Optional[int] = None
    # --- self-healing fleet ---
    # per-replica pump deadline: a step() still running after this many
    # seconds counts one stall strike per router tick, and
    # replica_stall_ticks consecutive strikes mark the replica WEDGED
    # (detection latency <= replica_stall_s + one tick). 0 disables wedge
    # detection: the pump joins its workers without a deadline.
    replica_stall_s: float = 60.0
    replica_stall_ticks: int = 2
    # respawn budget per replica lineage (0 disables resurrection);
    # attempts are spaced by the deterministic retry.RetryPolicy backoff
    # (base * 2**attempt, capped — no jitter, so recovery timelines are
    # reproducible in tests and chaos replays)
    max_respawns: int = 2
    respawn_backoff_s: float = 0.5
    respawn_backoff_max_s: float = 30.0
    # clean completions (eos/length) a respawned replica must serve —
    # spill traffic only, never an affinity target — before it rejoins
    # the rendezvous rotation. 0 respawns straight to live.
    probation_requests: int = 2
    # health() reports healthy=False (the exporter serves HTTP 503) while
    # fewer than this many replicas are LIVE; recovering, not sticky
    min_live: int = 1
    # pump workers drop throttled heartbeat-<rid>.json files here so a
    # wedged replica is diagnosable from OUTSIDE the process; "" disables
    heartbeat_dir: str = ""

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("need at least one replica")
        if self.affinity_blocks < 1:
            raise ValueError("affinity_blocks must be >= 1")
        if self.spill_queue_depth < 0:
            raise ValueError("spill_queue_depth must be >= 0 (0 disables)")
        if self.spill_min_free_seqs < 0:
            raise ValueError("spill_min_free_seqs must be >= 0 (0 disables)")
        if self.replica_stall_s < 0:
            raise ValueError("replica_stall_s must be >= 0 (0 disables)")
        if self.replica_stall_ticks < 1:
            raise ValueError("replica_stall_ticks must be >= 1")
        if self.max_respawns < 0:
            raise ValueError("max_respawns must be >= 0 (0 disables)")
        if self.respawn_backoff_s < 0 or self.respawn_backoff_max_s < 0:
            raise ValueError("respawn backoff delays must be >= 0")
        if self.probation_requests < 0:
            raise ValueError("probation_requests must be >= 0 (0 skips)")
        if self.min_live < 0:
            raise ValueError("min_live must be >= 0")


@dataclass
class _RouterItem:
    """Router-side bookkeeping for one accepted request."""

    request: Request
    class_idx: int  # QoSPicker duck-type field
    order: int  # arrival sequence number (re-dispatch keeps this order)
    submit_time: float = field(default_factory=time.perf_counter)
    phase: str = "queued"  # queued -> dispatched -> done
    replica: str = ""  # rid while dispatched

    @property
    def tenant(self) -> str:  # QoSPicker duck-type field
        return getattr(self.request, "tenant", "")


class _PumpTicket:
    """One in-flight ``engine.step()`` on a worker thread.

    Created and joined by the router's pump thread; the worker writes
    ``result`` then exits, and ``Thread.join`` is the happens-before edge
    that publishes the result back. While a ticket is outstanding the
    replica's engine belongs to the worker — every router-side read goes
    through the handle's ``last_*`` snapshots instead.

    ``generation`` snapshots the handle's fence at start. If the router
    abandons this ticket (the replica wedged, was killed mid-stall, or
    respawned), the dropped ticket reference means the zombie's result is
    never read, the bumped handle generation invalidates any late match,
    and the engine's revoked metrics view drops its late labelled writes
    — the zombie may still be inside a device step, and none of that matters.
    """

    def __init__(self, handle: ReplicaHandle, heartbeat_dir: str = ""):
        self.handle = handle
        self.generation = handle.generation
        self.heartbeat_dir = heartbeat_dir
        self.started = time.perf_counter()
        self.thread: Optional[threading.Thread] = None
        self.result: Any = ("ok", [])

    def run(self) -> None:
        h = self.handle
        if self.heartbeat_dir:
            # throttled liveness beat BEFORE the step: a wedged step
            # leaves the file aging, which is exactly what makes the
            # wedge diagnosable from outside the process
            now = time.monotonic()
            if now - h.last_beat >= 1.0:
                h.last_beat = now
                write_heartbeat(
                    self.heartbeat_dir, rank=h.rid,
                    global_step=h.pumped_ticks, phase="serve_pump",
                    extra={"replica": h.rid, "state": h.state,
                           "generation": self.generation},
                )
        try:
            self.result = ("ok", h.engine.step())
        except Exception as e:  # noqa: BLE001 — triaged post-join
            self.result = ("dead", e)
        h.pumped_ticks += 1


class Router:
    """Front door over N in-process engine replicas. ``params`` is a
    ``Transformer`` or its ``{name: tensor}`` state; replicas run on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, params, cfg, engine_config: Optional[EngineConfig] = None,
                 config: Optional[RouterConfig] = None, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.engine_config = engine_config or EngineConfig()
        self.config = config or RouterConfig()
        ec, rc = self.engine_config, self.config
        # QoS moves UP to the router: the front door runs the class/tenant
        # pick and the admission bounds; replicas run single-class FIFO
        # with bounds off so their per-request semantics stay token-exact.
        classes_spec = rc.classes if rc.classes is not None else ec.classes
        self.qos = QoSPicker(parse_classes(classes_spec))
        self.queue_bound = (
            rc.queue_bound if rc.queue_bound is not None else ec.queue_bound
        )
        self.tenant_max_inflight = (
            rc.tenant_max_inflight if rc.tenant_max_inflight is not None
            else ec.tenant_max_inflight
        )
        # versioned weights: every spawn (boot, add_replica, respawn)
        # reads the store's LATEST record, so a replica resurrected after
        # a publish attaches at the new version, never the boot payload
        self._weights = WeightStore(host_state(params), "v0")
        self._cfg = cfg
        self.replicas: Dict[str, ReplicaHandle] = {}
        self.retired: List[ReplicaHandle] = []
        self._next_rid = 0
        for _ in range(rc.replicas):
            self._spawn_replica()
        # request bookkeeping: arrival-ordered router queue + id -> item
        self._items: Dict[str, _RouterItem] = {}
        self._queue: List[_RouterItem] = []
        self._outputs: Dict[str, RequestOutput] = {}
        self._req_counter = 0
        self._order_counter = 0
        # router-local outcome totals (metrics() mirrors the engine's keys)
        self._rejected_total = 0
        self._shed_tokens_total = 0
        self._deadline_cancelled_total = 0
        self._spill_total = 0
        self._redispatch_total = 0
        self._wedged_total = 0
        self._respawn_total = 0
        self._probation_total = 0
        self._publish_total = 0
        # self-healing scheduler state: pending respawns (due-dated by the
        # deterministic backoff), the per-lineage budget ledger, and the
        # lineages that exhausted it (permanently retired)
        self._respawn_policy = RetryPolicy(
            retries=max(0, rc.max_respawns),
            base_delay_s=rc.respawn_backoff_s,
            max_delay_s=max(rc.respawn_backoff_s, rc.respawn_backoff_max_s),
        )
        self._pending_respawns: List[Dict[str, Any]] = []
        self._lineage_respawns: Dict[str, int] = {}
        self._retired_lineages: set = set()
        # router-level observability:
        self._reg = get_registry()
        self._m_requests = self._reg.counter("serve.router.requests")
        self._m_dispatched = self._reg.counter("serve.router.dispatched")
        self._m_redispatched = self._reg.counter("serve.router.redispatched")
        self._m_spills = self._reg.counter("serve.router.spills")
        self._m_rejected = self._reg.counter("serve.router.rejected")
        self._m_deadline = self._reg.counter("serve.router.deadline_cancelled")
        self._m_wedged = self._reg.counter("serve.router.wedged")
        self._m_respawns = self._reg.counter("serve.router.respawns")
        self._m_probation = self._reg.counter("serve.router.probation")
        self._m_publishes = self._reg.counter("serve.router.publishes")
        self._m_publish_gauge = self._reg.gauge(
            "serve.router.publish_in_progress")
        self._m_live = self._reg.gauge("serve.router.replicas_live")
        self._m_queue = self._reg.gauge("serve.router.queue_depth")
        self._m_hit_rate = self._reg.gauge("serve.router.prefix_hit_rate")
        # cross-thread debug snapshot: the exporter's HTTP thread reads
        # /debug/router while the pump writes — the ONLY router state that
        # crosses threads, refreshed at the end of every step()
        self._debug_lock = threading.Lock()
        self._debug_doc: Dict[str, Any] = {}  # guarded-by: _debug_lock
        self._publish_gauges()

    # ------------------------------------------------------------- replicas
    def _spawn_replica(self, rid: Optional[str] = None,
                       state: str = STATE_LIVE, generation: int = 0,
                       lineage: str = "") -> ReplicaHandle:
        if rid is None:
            rid = f"r{self._next_rid}"
            self._next_rid += 1
        # resurrection fault drill (``serve.spawn``): an exception here
        # during a respawn burns one budget attempt
        fault_point("serve.spawn")
        # replicas run single-class FIFO with the bounds off — QoS lives at
        # the router — and carry their rid as the metrics instance label.
        # A respawned replica REUSES its ancestor's rid: the metric series
        # continues, and the generation fence (plus the ancestor's revoked
        # registry view) keeps the zombie's late writes out of it.
        rcfg = replace(
            self.engine_config, classes="default", queue_bound=0,
            tenant_max_inflight=0, metrics_label=rid,
        )
        eng = InferenceEngine(self._params, self._cfg, rcfg, device=self.device)
        h = ReplicaHandle(rid=rid, engine=eng, state=state,
                          generation=generation, lineage=lineage or rid,
                          weights_version=self._weights_version)
        self.replicas[rid] = h
        return h

    def _schedule_respawn(self, *, rid: str, lineage: str, generation: int,
                          fail_reason: str = "") -> None:
        """Book a resurrection attempt for a dead/wedged lineage, spaced
        by the deterministic backoff; a lineage past ``max_respawns`` is
        permanently retired instead — loudly, because from here only an
        operator ``add_replica()`` restores the lost capacity."""
        rc = self.config
        if rc.max_respawns <= 0:
            return
        used = self._lineage_respawns.get(lineage, 0)
        if used >= rc.max_respawns:
            if lineage not in self._retired_lineages:
                self._retired_lineages.add(lineage)
                logger.error(
                    "router: replica %s exhausted its respawn budget "
                    "(%d/%d) and is PERMANENTLY retired — fleet capacity "
                    "stays reduced until an operator adds a replica "
                    "(last failure: %s)",
                    lineage, used, rc.max_respawns, fail_reason or "n/a")
                _flight_record("router.replica_retired", cid=lineage,
                               respawns=used,
                               last_error=fail_reason[:160])
            return
        delay = self._respawn_policy.delay(used)
        self._lineage_respawns[lineage] = used + 1
        self._pending_respawns.append({
            "rid": rid, "lineage": lineage, "generation": generation,
            "attempt": used + 1, "delay_s": delay,
            "due": time.perf_counter() + delay,
        })
        logger.warning(
            "router: replica %s will respawn in %.3gs (attempt %d/%d)",
            rid, delay, used + 1, rc.max_respawns)

    def _maybe_respawn(self) -> None:
        """Land every due respawn: a fresh engine on the latest published
        payload, same rid, bumped generation, entering PROBATION
        (spill traffic only) unless probation is disabled. A spawn that
        raises (the ``serve.spawn`` fault drill, an allocator error)
        burns the attempt and reschedules."""
        if not self._pending_respawns:
            return
        now = time.perf_counter()
        for p in [p for p in self._pending_respawns if p["due"] <= now]:
            self._pending_respawns.remove(p)
            state = (STATE_PROBATION if self.config.probation_requests > 0
                     else STATE_LIVE)
            try:
                h = self._spawn_replica(rid=p["rid"], state=state,
                                        generation=p["generation"],
                                        lineage=p["lineage"])
            except Exception as e:  # noqa: BLE001 — a failed respawn must
                # not take down the healthy fleet driving this pump
                logger.warning("router: respawn of replica %s failed (%s)",
                               p["rid"], e)
                self._schedule_respawn(rid=p["rid"], lineage=p["lineage"],
                                       generation=p["generation"],
                                       fail_reason=repr(e))
                continue
            self._respawn_total += 1
            self._m_respawns.inc()
            _flight_record("router.replica_respawned", cid=h.rid,
                           generation=h.generation, attempt=p["attempt"],
                           state=h.state)
            logger.warning(
                "router: replica %s respawned (generation %d, %s, "
                "attempt %d/%d)", h.rid, h.generation, h.state,
                p["attempt"], self.config.max_respawns)
            self._publish_gauges()

    def add_replica(self) -> ReplicaHandle:
        """Grow the fleet by one live replica serving the LATEST published
        weights version."""
        h = self._spawn_replica()
        _flight_record("router.replica_added", cid=h.rid,
                       weights_version=h.weights_version)
        self._publish_gauges()
        return h

    def remove_replica(self, rid: str) -> ReplicaHandle:
        """Begin a clean drain: the replica leaves the dispatch rotation
        immediately, finishes everything already dispatched to it, and
        detaches once drained (no lost or duplicated requests). Refuses to
        drain the LAST live replica — a router with work and nowhere to
        send it would stall."""
        h = self.replicas[rid]
        if h.state != STATE_LIVE:
            raise ValueError(f"replica {rid!r} is {h.state}, not live")
        if sum(1 for o in self.replicas.values()
               if o.state == STATE_LIVE) <= 1:
            raise ValueError("cannot remove the last live replica")
        h.state = STATE_DRAINING
        _flight_record("router.replica_draining", cid=rid,
                       assigned=len(h.assigned))
        self._publish_gauges()
        return h

    def kill_replica(self, rid: str, reason: str = "killed") -> None:
        """Simulate a replica crash (tests, the bench's mid-storm kill
        drill): the replica is drained out of rotation exactly as if its
        pump had raised — stranded requests re-dispatched or surfaced
        terminal, never hung."""
        self._on_replica_failure(self.replicas[rid], RuntimeError(reason))

    # ------------------------------------------------------ weight publish
    def publish_weights(self, params, version: str) -> str:
        """Publish a new weights payload (a ``Transformer`` or its state;
        kept on the host) under a version tag and roll it into the RUNNING
        fleet. The payload lands in the :class:`WeightStore`
        immediately — replicas spawned from now on (``add_replica``,
        respawns) serve it — and ``step()`` then rolls the existing
        fleet one replica at a time: PUBLISHING (out of rotation) ->
        drain in-flight work on the old version -> in-place buffer swap
        + prefix-cache flush under a bumped cache epoch -> back to
        rotation at the new version. The LIVE count never drops below
        ``min_live`` while waiting could restore headroom. An idle fleet
        converges on the caller's next ``step()``/``run()`` drive
        (``has_work`` stays True until every serving replica is on the
        latest version). Duplicate version tags are refused — tags are
        immutable once published."""
        rec = self._weights.put(str(version), host_state(params))
        self._publish_total += 1
        self._m_publishes.inc()
        _flight_record("router.weights_published", cid=rec.version,
                       seq=rec.seq)
        logger.info(
            "router: weights %s published (seq %d); rolling %d serving "
            "replica(s)", rec.version, rec.seq,
            sum(1 for h in self.replicas.values()
                if h.state in (STATE_LIVE, STATE_PROBATION)))
        self._publish_gauges()
        return rec.version

    def publish_from_checkpoint(self, step_dir: str, loader=load_checkpoint_params,
                                *, version: Optional[str] = None,
                                verify_mode: str = "size") -> str:
        """``publish_weights`` from a checkpoint generation (the port's
        ``global_step_N/train_state/model.pt`` by default), behind the
        integrity gate: an uncommitted directory or a manifest that fails
        verification raises ``CheckpointCorruptError`` BEFORE ``loader``
        reads a byte, so no replica changes version. ``version`` defaults
        to the generation's directory name (e.g. ``global_step_400``)."""
        params = load_published_params(step_dir, loader,
                                       verify_mode=verify_mode)
        if version is None:
            version = os.path.basename(os.path.normpath(step_dir))
        return self.publish_weights(params, version)

    @property
    def _params(self):
        """Latest published params — what every new spawn attaches to."""
        return self._weights.latest.params

    @property
    def _weights_version(self) -> str:
        return self._weights.latest.version

    @property
    def weights_version(self) -> str:
        return self._weights_version

    @property
    def publish_in_progress(self) -> bool:
        """True while any SERVING replica (live/probation/publishing) is
        not yet on the latest published version — the mixed-version
        window. Draining replicas finish on their version and detach;
        they never hold a publish open."""
        latest = self._weights.latest.version
        return any(
            h.state == STATE_PUBLISHING or h.weights_version != latest
            for h in self.replicas.values()
            if h.state in (STATE_LIVE, STATE_PROBATION, STATE_PUBLISHING)
        )

    def _advance_publish(self) -> None:
        """One rolling-publish step, run at the top of every ``step()``:
        complete any PUBLISHING replica that has drained (swap + flush +
        return to rotation), then move at most ONE stale serving replica
        into PUBLISHING — one at a time keeps the out-of-rotation window
        minimal and the live floor honest."""
        latest = self._weights.latest
        publishing = [h for h in self.replicas.values()
                      if h.state == STATE_PUBLISHING]
        for h in publishing:
            if (h.pump is None and not h.engine.has_work
                    and not h.assigned):
                self._swap_replica(h, latest)
        if any(h.state == STATE_PUBLISHING
               for h in self.replicas.values()):
            return  # one replica out of rotation at a time
        stale = [h for h in self.replicas.values()
                 if h.state in (STATE_LIVE, STATE_PROBATION)
                 and h.weights_version != latest.version]
        if not stale:
            return
        # probation replicas first (they are outside the live rotation —
        # no floor impact), then the least-loaded live replica (shortest
        # drain); rid tiebreak keeps the roll deterministic
        stale.sort(key=lambda h: (h.state != STATE_PROBATION,
                                  len(h.assigned) + h.queue_depth(),
                                  h.rid))
        h = stale[0]
        if h.state == STATE_LIVE:
            n_live = sum(1 for o in self.replicas.values()
                         if o.state == STATE_LIVE)
            if (n_live - 1 < self.config.min_live
                    and self._pending_respawns):
                # taking this replica would breach min_live and a pending
                # respawn could still restore headroom: wait for it. With
                # nothing pending, waiting cannot help — the roll
                # proceeds (briefly under the floor) because holding the
                # fleet on stale weights forever is the worse failure.
                return
        h.publish_from_state = h.state
        h.publish_to = latest.version
        h.state = STATE_PUBLISHING
        _flight_record("router.publish_replica", cid=h.rid,
                       prev=h.weights_version, to=latest.version,
                       assigned=len(h.assigned))
        logger.info(
            "router: replica %s PUBLISHING %s -> %s (%d in-flight to "
            "drain)", h.rid, h.weights_version, latest.version,
            len(h.assigned))
        # already drained (idle replica): swap within the same tick — the
        # out-of-rotation window closes before dispatch even runs
        if h.pump is None and not h.engine.has_work and not h.assigned:
            self._swap_replica(h, latest)

    def _swap_replica(self, h: ReplicaHandle, rec: WeightRecord) -> None:
        """In-place hot-swap of a drained PUBLISHING replica's engine:
        the ``serve.publish`` fault point fires first (the deterministic
        kill-mid-publish drill), then the engine swaps buffers and
        flushes its prefix cache under a bumped cache epoch. A swap that
        raises is a replica failure — the normal triage runs and the
        respawn attaches at the LATEST version, so the fleet still
        converges to exactly one version."""
        t0 = time.perf_counter()
        try:
            fault_point("serve.publish", context=h.rid)
            info = h.engine.swap_weights(rec.params)
        except Exception as e:  # noqa: BLE001 — a publish casualty is a
            # replica casualty: triaged, respawned at the new version
            logger.warning(
                "router: replica %s died mid-publish (%s); its respawn "
                "attaches at %s", h.rid, e, rec.version)
            self._on_replica_failure(h, e)
            return
        prev = h.weights_version
        h.weights_version = rec.version
        h.state = h.publish_from_state or STATE_LIVE
        h.publish_from_state = ""
        h.publish_to = ""
        self._reg.gauge(f"serve.router.{h.rid}.weights_version").set(
            self._weights.seq(rec.version))
        _flight_record("router.publish_swapped", cid=h.rid,
                       prev=prev, to=rec.version,
                       flushed_blocks=info["flushed_blocks"],
                       cache_epoch=info["cache_epoch"],
                       wall_s=round(time.perf_counter() - t0, 6))
        logger.info(
            "router: replica %s swapped %s -> %s (%d cached blocks "
            "flushed, cache epoch %d); back in rotation", h.rid, prev,
            rec.version, info["flushed_blocks"], info["cache_epoch"])
        if not self.publish_in_progress:
            _flight_record("router.publish_done", cid=rec.version,
                           replicas=len(self.replicas))
            logger.info("router: fleet converged on weights %s",
                        rec.version)

    def live_replicas(self) -> List[ReplicaHandle]:
        return [h for h in self.replicas.values() if h.state == STATE_LIVE]

    # ---------------------------------------------------------------- intake
    def submit(self, request: Union[Request, Iterable[int]],
               sampling: Optional[SamplingParams] = None) -> str:
        """Enqueue a request at the front door. Validation mirrors
        ``InferenceEngine.submit`` exactly (malformed raises, overloaded
        load-sheds to a terminal ``rejected`` output) so a single-replica
        router is behavior-identical to the bare engine."""
        ec = self.engine_config
        if not isinstance(request, Request):
            request = Request(prompt_ids=[int(t) for t in request],
                              sampling=sampling or SamplingParams())
        if not request.request_id:
            while f"req-{self._req_counter}" in self._items:
                self._req_counter += 1
            request.request_id = f"req-{self._req_counter}"
            self._req_counter += 1
        if request.request_id in self._items:
            raise ValueError(f"duplicate request id {request.request_id!r}")
        if not request.prompt_ids:
            raise ValueError("empty prompt")
        sp = request.sampling
        if sp.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(request.prompt_ids) + sp.max_new_tokens
        if total > ec.max_model_len:
            raise ValueError(
                f"prompt+max_new_tokens={total} exceeds max_model_len="
                f"{ec.max_model_len}"
            )
        blocks_needed = -(-total // ec.block_size)
        if blocks_needed > ec.num_blocks - 1:
            raise ValueError(
                f"request needs {blocks_needed} blocks; each replica pool "
                f"has {ec.num_blocks - 1}"
            )
        if request.deadline_s is not None and request.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0 (None disables)")
        # unknown priority class raises BEFORE anything registers —
        # malformed is an error, overloaded is an outcome
        class_idx = self.qos.resolve_class(
            getattr(request, "priority", "interactive")
        )
        item = _RouterItem(request=request, class_idx=class_idx,
                           order=self._order_counter)
        self._order_counter += 1
        self._m_requests.inc()
        # front-door admission control: the waiting population is the
        # router queue PLUS every pumped engine's waiting queue, so with
        # one replica the bound sheds exactly when the bare engine would
        if (self.queue_bound
                and self._total_waiting() >= self.queue_bound) or (
                self.tenant_max_inflight
                and self._tenant_inflight(item.tenant)
                >= self.tenant_max_inflight):
            out = RequestOutput(
                request_id=request.request_id,
                prompt_ids=list(request.prompt_ids),
            )
            out.finished = True
            out.finish_reason = "rejected"
            item.phase = "done"
            self._items[request.request_id] = item
            self._outputs[request.request_id] = out
            self._rejected_total += 1
            self._shed_tokens_total += total
            self._m_rejected.inc()
            _flight_record("router.rejected", cid=request.request_id)
            return request.request_id
        self._items[request.request_id] = item
        self._queue.append(item)
        return request.request_id

    def _total_waiting(self) -> int:
        return len(self._queue) + sum(
            h.queue_depth() for h in self.replicas.values() if h.pumpable
        )

    def _tenant_inflight(self, tenant: str) -> int:
        return sum(1 for it in self._items.values()
                   if it.phase != "done" and it.tenant == tenant)

    # -------------------------------------------------------------- affinity
    def _affinity_key(self, prompt_ids) -> int:
        """crc32 over the prompt's leading block-aligned chunk keys — the
        exact ``tuple(tokens[i*bs:(i+1)*bs])`` chunks the radix cache keys
        its tree on, so two prompts that would share cache blocks share an
        affinity key. Prompts shorter than one block key on the whole
        prompt (they can't share full blocks anyway)."""
        bs = self.engine_config.block_size
        n = min(self.config.affinity_blocks, len(prompt_ids) // bs)
        if n <= 0:
            chunks: Any = tuple(int(t) for t in prompt_ids)
        else:
            chunks = tuple(
                tuple(int(t) for t in prompt_ids[i * bs:(i + 1) * bs])
                for i in range(n)
            )
        return zlib.crc32(repr(chunks).encode())

    def _affinity_target(self, key: int,
                         live: List[ReplicaHandle]) -> ReplicaHandle:
        """Rendezvous (highest-random-weight) hash: stable under replica
        add/remove — only keys owned by a departing replica move."""
        return max(live, key=lambda h: (
            zlib.crc32(f"{key}:{h.rid}".encode()), h.rid,
        ))

    def _past_threshold(self, h: ReplicaHandle) -> bool:
        rc = self.config
        if rc.spill_queue_depth and h.queue_depth() >= rc.spill_queue_depth:
            return True
        if (rc.spill_min_free_seqs
                and h.free_concurrent_seqs() < rc.spill_min_free_seqs):
            return True
        return False

    # ---------------------------------------------------------------- pump
    @property
    def has_work(self) -> bool:
        # an unconverged publish IS work: generate()/run() keep stepping
        # until every serving replica swapped to the latest version, so a
        # publish into an idle fleet still completes on the next drive
        return bool(self._queue) or self.publish_in_progress or any(
            (h.pump is not None or h.engine.has_work or h.assigned)
            for h in self.replicas.values() if h.pumpable
        )

    def step(self) -> List[StreamEvent]:
        """One router tick: land due respawns, expire queued deadlines,
        dispatch under the QoS pick + affinity/spill policy, pump every
        busy replica one engine tick behind the ``replica_stall_s``
        deadline (a raising replica dies, a hanging one WEDGES and is
        abandoned — either way survivors shed, never hang), capture
        finished outputs, detach drained replicas, and refresh gauges +
        the /debug/router snapshot."""
        self._maybe_respawn()
        self._advance_publish()
        self._expire_deadlines()
        self._dispatch()
        events: List[StreamEvent] = []
        stall_s = self.config.replica_stall_s
        pump = [h for h in self.replicas.values() if h.pumpable]
        events.extend(self._pump_fenced(pump, stall_s))
        for h in pump:
            # skip replicas that died/wedged this tick, and replicas whose
            # pump worker is still running (their engine is untouchable
            # until the ticket resolves)
            if self.replicas.get(h.rid) is h and h.engine_quiescent:
                self._capture_finished(h)
        self._detach_drained()
        self._publish_gauges()
        if (not events and self._pending_respawns
                and not any(h.pump is not None or h.engine.has_work
                            for h in self.replicas.values() if h.pumpable)):
            # idle fleet waiting out a respawn backoff: a generate()/run()
            # caller spins on has_work, so nap toward the next due time
            # instead of burning a core
            wait = (min(p["due"] for p in self._pending_respawns)
                    - time.perf_counter())
            if wait > 0:
                time.sleep(min(wait, 0.005))
        return events

    def _pump_fenced(self, pump: List[ReplicaHandle],
                     stall_s: float) -> List[StreamEvent]:
        """Pump every busy replica on a worker thread behind a
        per-replica join deadline. Each engine is still touched by
        exactly one thread at a time — its single outstanding worker,
        with ``join`` as the read-back barrier — so the engine's
        single-pump-thread contract holds per replica while their host
        work overlaps. Replicas on separate devices overlap their device
        steps too; on one card their kernels queue on the one stream, and
        two replicas measured 0.62x one engine's decode tok/s on an H100
        (PERF.md, the router's open question). A worker that blows the
        deadline leaves its ticket outstanding (the replica is skipped by
        dispatch/capture/gauges until it resolves) and collects one stall
        strike per router tick; ``replica_stall_ticks`` strikes wedge the
        replica and abandon the worker behind the generation fence.
        ``stall_s == 0`` joins without a deadline: no strike, no wedge."""
        events: List[StreamEvent] = []
        tickets: List[ReplicaHandle] = []
        for h in pump:
            if h.pump is not None:
                tickets.append(h)  # outstanding from a previous tick
                continue
            if not h.engine.has_work:
                continue
            t = _PumpTicket(h, self.config.heartbeat_dir)
            h.pump = t
            t.thread = threading.Thread(
                target=t.run, name=f"router-pump-{h.rid}", daemon=True)
            t.thread.start()
            tickets.append(h)
        for h in tickets:
            t = h.pump
            if stall_s > 0:
                t.thread.join(max(0.0, stall_s - (time.perf_counter() - t.started)))
            else:
                t.thread.join()
            if t.thread.is_alive():
                # over its deadline: one strike per router tick, so a
                # wedge is declared within replica_stall_s + one tick
                h.stall_ticks += 1
                if h.stall_ticks >= self.config.replica_stall_ticks:
                    self._on_replica_wedged(h)
                continue
            h.pump = None
            h.stall_ticks = 0
            if t.generation != h.generation:
                continue  # fenced: the handle moved on while this ran
            kind, val = t.result
            if kind == "ok":
                events.extend(val)
            else:
                self._on_replica_failure(h, val)
        return events

    def generate(self, requests: Optional[Iterable] = None
                 ) -> Iterator[StreamEvent]:
        """Streaming interface mirroring the engine's: submit, then yield
        token events (from every replica) until all in-flight work
        drains. More requests may be ``submit()``-ed between yields."""
        for r in requests or ():
            self.submit(r)
        while self.has_work:
            yield from self.step()

    def run(self, requests: Optional[Iterable] = None
            ) -> Dict[str, RequestOutput]:
        """Drain ``generate()`` and hand over every terminal output,
        releasing router bookkeeping for them (same ownership contract as
        ``InferenceEngine.run``)."""
        for _ in self.generate(requests):
            pass
        done = dict(self._outputs)
        for rid in done:
            self._outputs.pop(rid, None)
            self._items.pop(rid, None)
        return done

    def pop_output(self, request_id: str) -> Optional[RequestOutput]:
        """Release and return one finished request's output; refuses while
        it is still in flight anywhere in the fleet."""
        item = self._items.get(request_id)
        if item is not None and item.phase != "done":
            raise ValueError(f"request {request_id!r} is still in flight")
        self._items.pop(request_id, None)
        return self._outputs.pop(request_id, None)

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Cancel wherever the request currently is: parked at the router
        (terminal output synthesized here) or dispatched (delegated to the
        owning engine, output captured immediately). False for unknown or
        already-finished ids."""
        item = self._items.get(request_id)
        if item is None or item.phase == "done":
            return False
        if item.phase == "queued":
            self._queue.remove(item)
            out = RequestOutput(
                request_id=request_id,
                prompt_ids=list(item.request.prompt_ids),
            )
            out.finished = True
            out.finish_reason = reason
            self._finish_item(item, out)
            return True
        h = self.replicas.get(item.replica)
        # a replica mid-stall (outstanding pump ticket) is untouchable —
        # the cancel would race its worker inside the engine; callers see
        # False and may retry after the ticket resolves or the wedge triage
        # surfaces the request terminally
        if h is None or not h.engine_quiescent:
            return False
        if not h.engine.cancel(request_id, reason):
            return False
        self._capture_finished(h)
        return True

    # ------------------------------------------------------------- internals
    def _expire_deadlines(self) -> None:
        """Expire ROUTER-queued requests past their deadline (terminal
        ``deadline`` status) — the engine expires what was dispatched to
        it, with the clock backdated to router intake so the two waits
        add up to one deadline."""
        now = time.perf_counter()
        for item in [it for it in self._queue
                     if it.request.deadline_s is not None
                     and (now - it.submit_time) > it.request.deadline_s]:
            self._queue.remove(item)
            out = RequestOutput(
                request_id=item.request.request_id,
                prompt_ids=list(item.request.prompt_ids),
            )
            out.finished = True
            out.finish_reason = "deadline"
            out.deadline_missed = True
            self._deadline_cancelled_total += 1
            self._shed_tokens_total += (
                len(item.request.prompt_ids)
                + item.request.sampling.max_new_tokens
            )
            self._m_deadline.inc()
            _flight_record("router.deadline", cid=item.request.request_id)
            self._finish_item(item, out)

    def _dispatch(self) -> None:
        # a replica with an outstanding pump ticket is untouchable until
        # the ticket resolves — its engine belongs to the worker thread
        live = [h for h in self.live_replicas() if h.pump is None]
        probation = [h for h in self.replicas.values()
                     if h.state == STATE_PROBATION and h.pump is None]
        if not live and not probation:
            if (self._queue and not self._pending_respawns
                    and not any(
                        h.pump is not None or h.engine.has_work or h.assigned
                        for h in self.replicas.values() if h.pumpable)):
                # nothing can ever serve the queue again — surface every
                # queued request as a terminal REJECTED output first (a
                # generate()/run() caller must never block forever on a
                # request that can no longer be served), THEN fail loudly,
                # mirroring the engine's scheduler-stall invariant
                self._reject_stranded_queue()
                raise RuntimeError(
                    "router stalled: requests queued but no live replicas"
                )
            # draining replicas may still finish their work, and a pending
            # respawn may restore capacity — the pump waits, never stalls
            return
        # probation replicas receive ONLY spill traffic: the rendezvous
        # target set is the live rotation, and probation capacity shows up
        # as a spill destination / parking headroom. A fleet reduced to
        # probation-only dispatches to it directly — serving on an
        # unproven replica beats stalling the queue.
        targets = live or probation
        pool = live + probation
        while self._queue:
            # park at the router when every live+probation replica is past
            # the spill threshold AND the fleet is actually busy —
            # back-pressure makes the router-level QoS pick decide who
            # goes next. An idle fleet always accepts (a threshold below
            # the idle capacity must never stall an empty router).
            busy = (any(h.engine.has_work for h in pool)
                    or any(h.pump is not None
                           for h in self.replicas.values()))
            if busy and all(self._past_threshold(h) for h in pool):
                break
            item = self.qos.pick(self._queue)
            key = self._affinity_key(item.request.prompt_ids)
            target = self._affinity_target(key, targets)
            if self._past_threshold(target):
                spilled = min(pool, key=lambda h: (h.queue_depth(), h.rid))
                if spilled.rid != target.rid:
                    self._spill_total += 1
                    self._m_spills.inc()
                    _flight_record("router.spill",
                                   cid=item.request.request_id,
                                   affinity=target.rid, to=spilled.rid)
                target = spilled
            self.qos.commit(item)
            self._queue.remove(item)
            self._dispatch_to(item, target)

    def _reject_stranded_queue(self) -> None:
        """Terminal REJECTED outputs for everything still queued when the
        router stalls with no live replicas and no way back — callers
        blocked in ``run()``/``pop_output`` get an answer, not a hang."""
        for item in list(self._queue):
            req = item.request
            out = RequestOutput(request_id=req.request_id,
                                prompt_ids=list(req.prompt_ids))
            out.finished = True
            out.finish_reason = "rejected"
            self._rejected_total += 1
            self._shed_tokens_total += (
                len(req.prompt_ids) + req.sampling.max_new_tokens)
            self._m_rejected.inc()
            _flight_record("router.rejected", cid=req.request_id,
                           reason="no live replicas")
            self._finish_item(item, out)
        self._queue.clear()
        self._publish_gauges()

    def _dispatch_to(self, item: _RouterItem, h: ReplicaHandle) -> None:
        req = item.request
        try:
            h.engine.submit(req)
        except Exception as e:  # noqa: BLE001 — an admission that raises
            # (the serve.admit fault drill, an allocator edge) bounces the
            # REQUEST, not the fleet: terminal rejected, the replica stays
            # in rotation. Malformed requests cannot reach here —
            # Router.submit already ran the same validation the engine
            # does, so whatever raised is environmental.
            out = RequestOutput(request_id=req.request_id,
                                prompt_ids=list(req.prompt_ids))
            out.finished = True
            out.finish_reason = "rejected"
            self._rejected_total += 1
            self._shed_tokens_total += (
                len(req.prompt_ids) + req.sampling.max_new_tokens)
            self._m_rejected.inc()
            _flight_record("router.dispatch_rejected", cid=req.request_id,
                           replica=h.rid, error=repr(e)[:160])
            self._finish_item(item, out)
            return
        # router-side wait counts toward the deadline exactly like engine
        # queue wait: one clock, started at user intake
        h.engine.backdate_submit_time(req.request_id, item.submit_time)
        item.phase = "dispatched"
        item.replica = h.rid
        h.assigned.add(req.request_id)
        h.dispatched += 1
        self._m_dispatched.inc()
        _flight_record("router.dispatch", cid=req.request_id, replica=h.rid)

    def _capture_finished(self, h: ReplicaHandle) -> None:
        """Pull every terminal output off a replica. Runs after each pump
        tick AND on demand (cancel), and covers event-less terminals too
        (deadline/cancel inside the engine emit no StreamEvent). Clean
        completions captured from a PROBATION replica count toward its
        parole: ``probation_requests`` of them rejoin it to the live
        rendezvous rotation."""
        for rid_ in list(h.assigned):
            out = h.engine.get_output(rid_)
            if out is not None and out.finished:
                h.engine.pop_output(rid_)
                h.assigned.discard(rid_)
                self._finish_item(self._items[rid_], out)
                if (h.state == STATE_PROBATION
                        and out.finish_reason in ("eos", "length")):
                    h.probation_done += 1
                    if h.probation_done >= self.config.probation_requests:
                        h.state = STATE_LIVE
                        self._probation_total += 1
                        self._m_probation.inc()
                        _flight_record("router.probation_passed", cid=h.rid,
                                       generation=h.generation,
                                       served=h.probation_done)
                        logger.info(
                            "router: replica %s passed probation after %d "
                            "clean completions; rejoining rotation",
                            h.rid, h.probation_done)

    def _finish_item(self, item: _RouterItem, out: RequestOutput) -> None:
        item.phase = "done"
        item.replica = ""
        self._outputs[out.request_id] = out

    def _on_replica_wedged(self, h: ReplicaHandle) -> None:
        """A pump worker blew ``replica_stall_s`` for
        ``replica_stall_ticks`` consecutive ticks: abandon it behind the
        generation fence and run the normal death triage. The zombie
        thread may still be inside a device step — its ticket is dropped before the
        fence bumps, so its result is never read and its labelled metric
        writes are revoked."""
        t = h.pump
        stalled = time.perf_counter() - t.started if t is not None else 0.0
        self._wedged_total += 1
        self._m_wedged.inc()
        _flight_record("router.replica_wedged", cid=h.rid,
                       generation=h.generation,
                       stalled_s=round(stalled, 3),
                       stall_ticks=h.stall_ticks)
        logger.warning(
            "router: replica %s WEDGED — step() still running after %.3gs "
            "(deadline replica_stall_s=%.3gs, %d strike(s)); abandoning "
            "its pump thread behind the generation fence",
            h.rid, stalled, self.config.replica_stall_s, h.stall_ticks)
        self._on_replica_failure(
            h,
            RuntimeError(
                f"wedged: step() exceeded replica_stall_s="
                f"{self.config.replica_stall_s}s for {h.stall_ticks} "
                f"consecutive tick(s)"
            ),
            state=STATE_WEDGED,
        )

    def _on_replica_failure(self, h: ReplicaHandle, exc: Exception,
                            state: str = STATE_DEAD) -> None:
        """Drain a dead/wedged replica out of rotation, exactly-once per
        stranded request: finished on the dead engine -> captured as-is;
        nothing streamed yet -> re-dispatched at the FRONT of the router
        queue in original arrival order; tokens already streamed ->
        terminal ``cancelled`` keeping what was delivered. Never hung.
        If the lineage still has respawn budget a resurrection is booked
        on the deterministic backoff."""
        if h.state in (STATE_DEAD, STATE_WEDGED):
            return
        if h.pump is not None:
            # abandon the in-flight worker behind the generation fence:
            # the ticket reference is dropped (its result is never read),
            # the generation bump invalidates any late match, and the
            # engine's labelled metrics view is revoked so the zombie's
            # eventual writes are dropped. The triage reads below touch
            # only GIL-atomic dict/list state the worker appends to, so a
            # concurrently-running zombie cannot corrupt them.
            h.pump = None
            h.generation += 1
            h.engine.revoke_metrics()
        h.state = state
        h.fail_reason = repr(exc)
        self.replicas.pop(h.rid, None)
        self.retired.append(h)
        logger.warning("router: replica %s died (%s); %d stranded requests",
                       h.rid, exc, len(h.assigned))
        _flight_record("router.replica_dead", cid=h.rid, error=repr(exc),
                       stranded=len(h.assigned))
        # last state the rid's gauge will show until a respawn resets it
        self._reg.gauge(f"serve.router.{h.rid}.state").set(
            STATE_CODES.get(state, -1))
        requeue: List[_RouterItem] = []
        for rid_ in list(h.assigned):
            item = self._items[rid_]
            out = h.engine.get_output(rid_)
            if out is not None and out.finished:
                self._finish_item(item, out)
            elif out is None or not out.token_ids:
                item.phase = "queued"
                item.replica = ""
                requeue.append(item)
                h.redispatched += 1
                self._redispatch_total += 1
                self._m_redispatched.inc()
                _flight_record("router.redispatch", cid=rid_,
                               from_replica=h.rid)
            else:
                out.finished = True
                out.finish_reason = "cancelled"
                self._shed_tokens_total += (
                    item.request.sampling.max_new_tokens - len(out.token_ids)
                )
                self._finish_item(item, out)
        h.assigned.clear()
        # front of the queue, original arrival order — like a preemption
        # requeue, a victim of infrastructure never loses its place
        self._queue[:0] = sorted(requeue, key=lambda it: it.order)
        # self-healing: book the resurrection (or retire the lineage)
        self._schedule_respawn(rid=h.rid, lineage=h.lineage or h.rid,
                               generation=h.generation + 1,
                               fail_reason=h.fail_reason)
        self._publish_gauges()

    def _detach_drained(self) -> None:
        for h in [h for h in self.replicas.values()
                  if h.state == STATE_DRAINING and h.pump is None
                  and not h.engine.has_work and not h.assigned]:
            h.state = STATE_DETACHED
            self.replicas.pop(h.rid, None)
            self.retired.append(h)
            _flight_record("router.replica_detached", cid=h.rid)

    # ---------------------------------------------------------------- stats
    def _publish_gauges(self) -> None:
        live = [h for h in self.replicas.values() if h.state == STATE_LIVE]
        self._m_live.set(len(live))
        self._m_queue.set(len(getattr(self, "_queue", ())))
        self._m_publish_gauge.set(1 if self.publish_in_progress else 0)
        cached = prompts = 0
        for h in self.replicas.values():
            if not h.pumpable:
                continue
            self._reg.gauge(
                f"serve.router.{h.rid}.queue_depth"
            ).set(h.queue_depth())
            self._reg.gauge(
                f"serve.router.{h.rid}.state"
            ).set(STATE_CODES.get(h.state, -1))
            # mixed-version window: each replica reports the monotonic
            # seq of the version it serves (tags are opaque strings)
            self._reg.gauge(
                f"serve.router.{h.rid}.weights_version"
            ).set(self._weights.seq(h.weights_version))
            if not h.engine_quiescent:
                continue  # engine belongs to its outstanding pump worker
            # lifetime totals; pump-thread-private engine fields are safe
            # to read here — the router thread owns a quiescent engine
            cached += h.engine._cached_tokens_total
            prompts += h.engine._prompt_tokens_total
        self._m_hit_rate.set(cached / max(1, prompts))
        self._refresh_debug()

    def _refresh_debug(self) -> None:
        now = time.perf_counter()
        doc = {
            "replicas": [h.status_doc() for h in self.replicas.values()],
            "retired": [h.status_doc() for h in self.retired],
            "queue_depth": len(self._queue),
            "weights_version": self._weights_version,
            "rejected": self._rejected_total,
            "deadline_cancelled": self._deadline_cancelled_total,
            "spills": self._spill_total,
            "redispatched": self._redispatch_total,
            # self-healing columns
            "replicas_live": sum(1 for h in self.replicas.values()
                                 if h.state == STATE_LIVE),
            "min_live": self.config.min_live,
            "wedged": self._wedged_total,
            "respawns": self._respawn_total,
            "probation_passed": self._probation_total,
            # versioned weight publication
            "publishes": self._publish_total,
            "publish_in_progress": self.publish_in_progress,
            "pending_respawns": [
                {"rid": p["rid"], "attempt": p["attempt"],
                 "delay_s": p["delay_s"],
                 "due_in_s": round(max(0.0, p["due"] - now), 3)}
                for p in self._pending_respawns
            ],
            "retired_lineages": sorted(self._retired_lineages),
        }
        with self._debug_lock:
            self._debug_doc = doc

    def debug_doc(self) -> Dict[str, Any]:
        """Thread-safe snapshot for ``/debug/router`` (exporter HTTP
        thread); refreshed by the pump at the end of every step. The
        ``_debug_doc`` swap is the ONLY cross-thread write, and the
        single-writer is the router's pump thread — an abandoned zombie
        pump worker never touches it (workers only run ``engine.step``),
        so a wedge cannot corrupt the snapshot a scrape is reading."""
        with self._debug_lock:
            return dict(self._debug_doc)

    def health(self) -> Dict[str, Any]:
        """Fleet health for ``/healthz`` — thread-safe (built from the
        locked debug snapshot, so the exporter's HTTP thread calls it
        directly). ``healthy`` is False while fewer than
        ``RouterConfig.min_live`` replicas are LIVE — the exporter maps
        that to HTTP 503 — and it is RECOVERING, not sticky: the moment
        respawn + probation restore the fleet, the next scrape is 200."""
        doc = self.debug_doc()
        rows = doc.get("replicas", [])
        n_live = doc.get(
            "replicas_live",
            sum(1 for r in rows if r.get("state") == STATE_LIVE),
        )
        return {
            "healthy": n_live >= self.config.min_live,
            "replicas_live": n_live,
            "min_live": self.config.min_live,
            "replica_states": {r.get("rid"): r.get("state") for r in rows},
            "queue_depth": doc.get("queue_depth", 0),
            "wedged": doc.get("wedged", 0),
            "respawns": doc.get("respawns", 0),
            "pending_respawns": len(doc.get("pending_respawns", ())),
            "retired_lineages": doc.get("retired_lineages", []),
            # versioned weight publication: the latest tag, whether the
            # mixed-version window is still open, and each replica's
            # served version (probes watch convergence here)
            "weights_version": doc.get("weights_version", ""),
            "publish_in_progress": doc.get("publish_in_progress", False),
            "replica_weights": {r.get("rid"): r.get("weights_version")
                                for r in rows},
        }

    def metrics(self, reset_window: bool = True) -> Dict[str, Any]:
        """Fleet-aggregated metrics, same keys as the engine's plus
        router-level outcomes and a ``per_replica`` breakdown. Rates sum
        across replicas; the hit rate is token-weighted."""
        per: Dict[str, Dict[str, float]] = {}
        for h in self.replicas.values():
            # a replica mid-stall is skipped for one poll rather than
            # racing its worker inside the engine's window bookkeeping
            if h.pumpable and h.engine_quiescent:
                per[h.rid] = h.engine.metrics(reset_window=reset_window)
        agg: Dict[str, Any] = {
            "queue_depth": float(len(self._queue)) + sum(
                m["queue_depth"] for m in per.values()
            ),
            "num_running": sum(m["num_running"] for m in per.values()),
            "generated_tokens": sum(
                m["generated_tokens"] for m in per.values()
            ),
            "decode_tokens_per_sec": sum(
                m["decode_tokens_per_sec"] for m in per.values()
            ),
            "goodput_tokens": sum(m["goodput_tokens"] for m in per.values()),
            "goodput_tokens_per_sec": sum(
                m["goodput_tokens_per_sec"] for m in per.values()
            ),
            "prefix_hit_rate": (
                sum(m["cached_tokens"] for m in per.values())
                / max(1, sum(m["prompt_tokens"] for m in per.values()))
            ),
            "cached_tokens": sum(m["cached_tokens"] for m in per.values()),
            "prompt_tokens": sum(m["prompt_tokens"] for m in per.values()),
            "preemptions": sum(m["preemptions"] for m in per.values()),
            # engine-side rejects are structurally 0 (bounds live here)
            "rejected": float(self._rejected_total),
            "shed_tokens": float(self._shed_tokens_total) + sum(
                m["shed_tokens"] for m in per.values()
            ),
            "deadline_misses": float(self._deadline_cancelled_total) + sum(
                m["deadline_misses"] for m in per.values()
            ),
            "spills": float(self._spill_total),
            "redispatched": float(self._redispatch_total),
            "replicas_live": float(len(self.live_replicas())),
            "wedged": float(self._wedged_total),
            "respawns": float(self._respawn_total),
            "probation_passed": float(self._probation_total),
            "publishes": float(self._publish_total),
            "per_replica": per,
        }
        return agg

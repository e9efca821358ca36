"""Always-on flight recorder: the last N structured events before a death.

PR 4's metrics/spans make a *live* run attributable; this module covers the
*dead* one. Every hot subsystem appends tiny structured events — trainer
step lifecycle, scheduler admit/preempt, checkpoint commit/quarantine,
supervisor verdicts, retry attempts, fault-injection hits — into one
process-wide bounded ring, and when the run dies (watchdog fire, supervisor
abort, uncaught exception escaping ``train()``, SIGTERM) the ring is dumped
to ``postmortem-<rank>.json`` together with a metrics snapshot, the span
ring tail and every thread's stack: a self-contained artifact answering
"what did the scheduler/checkpointer/data path do in the seconds before?".

Design constraints, in order:

1. **Always on, alloc-light.** :func:`record` with the recorder enabled is
   one tuple + one bounded ``deque.append`` under a lock — no I/O, no clock
   beyond ``perf_counter_ns`` (the same timebase the span tracer uses, so a
   post-mortem's events and spans line up). Disabled (ring size 0) it is a
   single attribute check.
2. **Bounded.** The ring evicts oldest-first; evictions are counted
   (``dropped`` in the dump) so a truncated history is never mistaken for a
   quiet one.
3. **Dump must never make things worse.** :meth:`dump` is exception-proof
   and serializes concurrent triggers (a watchdog thread and a crashing main
   thread may both fire); payload values that aren't JSON-serializable are
   stringified rather than aborting the artifact.

``scripts/postmortem.py`` merges rank-local dumps into one fleet timeline
(each dump carries a wall-clock / perf-counter anchor pair, so monotonic
event timestamps from different processes map onto one wall axis).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

DEFAULT_MAX_EVENTS = 4096

# span ring entries mirrored into a dump (the full 100k span ring would
# dwarf the artifact; the tail is what the last seconds look like)
_SPAN_TAIL = 2000


class FlightRecorder:
    """Thread-safe bounded ring of ``(ts_ns, kind, cid, payload)`` events."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._events: deque = deque(maxlen=max(0, max_events) or None)  # guarded-by: _lock
        # _enabled is deliberately NOT lock-guarded: record()'s fast path
        # reads it as a latch (one attribute check when disabled) and a
        # torn read merely records/skips one borderline event
        self._enabled = max_events > 0
        self._dropped = 0  # guarded-by: _lock
        self.dump_dir = ""
        self.last_dump_path = ""

    # -------------------------------------------------------------- configure
    def configure(self, max_events: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  fresh: bool = False) -> None:
        """Resize the ring (0 disables recording AND clears it — a run that
        asked for no event history must not dump a previous same-process
        run's events as its own; existing events are kept up to the new
        bound otherwise) and/or set the default dump directory.

        ``fresh=True`` clears the ring first: a new run's startup (the
        trainer prologue) must not inherit a previous same-process run's
        events — a crash-at-startup dump would attribute them to the new
        run."""
        with self._lock:
            if fresh:
                self._events.clear()
                self._dropped = 0
            if max_events is not None:
                if max_events > 0:
                    if self._events.maxlen != max_events:
                        before = len(self._events)
                        self._events = deque(self._events, maxlen=max_events)
                        # shrinking evicts the oldest entries: count them,
                        # same invariant as a full-ring append
                        self._dropped += before - len(self._events)
                    self._enabled = True
                else:
                    self._enabled = False
                    self._events.clear()
                    self._dropped = 0
            if dump_dir is not None:
                self.dump_dir = dump_dir

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # ----------------------------------------------------------------- record
    def record(self, kind: str, cid: str = "", **payload: Any) -> None:
        """Append one event. The record is the only allocation: a 4-tuple
        (plus the payload dict when keyword fields are given)."""
        if not self._enabled:
            return
        ev = (time.perf_counter_ns(), kind, cid, payload or None)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    # ------------------------------------------------------------------ egress
    def events(self, limit: int = 0) -> List[tuple]:
        """Most recent ``limit`` raw event tuples (0 = all), oldest first."""
        with self._lock:
            evs = list(self._events)
        return evs[-limit:] if limit > 0 else evs

    def snapshot(self, limit: int = 200) -> Dict[str, Any]:
        """JSON-ready view for ``/debug/flight``."""
        with self._lock:
            evs = list(self._events)
            dropped = self._dropped  # one locked pass: count matches events
        if limit > 0:
            evs = evs[-limit:]
        return {
            "rank": _process_index(),
            "enabled": self._enabled,
            "dropped": dropped,
            "anchor": _anchor(),
            "events": [_event_doc(ev) for ev in evs],
        }

    # a dump wedged on a dead filesystem (the watchdog abandons its side-
    # thread dumper after its deadline, still inside _dump) must not hold
    # _dump_lock against every LATER dump — the SIGTERM path dumps on the
    # main thread before the final checkpoint, and blocking there forever
    # trades a missing artifact for a hard-killed, non-resumable process
    DUMP_LOCK_TIMEOUT_S = 20.0
    # how many superseded postmortem-<rank>.json artifacts to keep as
    # .1/.2/... next to the canonical (= latest) one
    KEEP_PREVIOUS = 2

    def dump(self, reason: str, path: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the post-mortem artifact; returns its path (None on
        failure — dumping is best-effort by contract, a broken disk must not
        mask the original failure)."""
        if not self._dump_lock.acquire(timeout=self.DUMP_LOCK_TIMEOUT_S):
            logger.error(
                "flight-recorder dump (%s) skipped: another dump has held "
                "the lock for %.3gs (hung filesystem?)",
                reason, self.DUMP_LOCK_TIMEOUT_S,
            )
            return None
        try:
            return self._dump(reason, path, extra)
        except Exception as e:  # never make a dying run die harder
            logger.error("flight-recorder dump failed: %s", e)
            return None
        finally:
            self._dump_lock.release()

    def _dump(self, reason: str, path: Optional[str],
              extra: Optional[Dict[str, Any]]) -> str:
        rank = _process_index()
        if path is None:
            path = os.path.join(self.dump_dir or ".", f"postmortem-{rank}.json")
        from veomni_tpu_torch.observability.metrics import get_registry
        from veomni_tpu_torch.observability.spans import live_span_events
        from veomni_tpu_torch.utils.helper import dump_thread_stacks

        with self._lock:
            evs = list(self._events)
            dropped = self._dropped  # one locked pass: count matches events
        doc: Dict[str, Any] = {
            "schema": 1,
            "reason": reason,
            "rank": rank,
            "anchor": _anchor(),
            "dropped": dropped,
            "events": [_event_doc(ev) for ev in evs],
            "metrics": get_registry().export_scalars(),
            "spans": [
                {"name": n, "ts_ns": t0, "dur_ns": d, "tid": tid}
                for n, t0, d, tid in live_span_events(_SPAN_TAIL)
            ],
            "thread_stacks": dump_thread_stacks(),
        }
        if extra:
            for k, v in extra.items():
                if k in doc:  # 'events'/'rank'/'anchor'/... are the artifact
                    logger.warning(
                        "post-mortem extra key %r collides with the dump "
                        "schema; dropped", k,
                    )
                    continue
                doc[k] = v
        # the dump dir may be declared-but-not-created (bench's lazy per-pid
        # default): a missing parent must not cost the artifact
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            # default=str: a payload that smuggled in a non-JSON value must
            # not abort the whole artifact
            json.dump(doc, f, default=str)
        # rotate instead of overwrite: a transient stall's dump at step 1000
        # must survive the SIGTERM dump hours later (the ring has long since
        # rotated past the first incident). Canonical name = latest;
        # .1/.2 = the two before it. Rotation happens only AFTER the new
        # artifact is safely on disk — a full-disk write failure above must
        # not have already demoted a valid canonical artifact.
        if os.path.exists(path):
            for k in range(self.KEEP_PREVIOUS, 1, -1):
                older = f"{path}.{k - 1}"
                if os.path.exists(older):
                    os.replace(older, f"{path}.{k}")
            if self.KEEP_PREVIOUS > 0:
                os.replace(path, f"{path}.1")
        os.replace(tmp, path)
        self.last_dump_path = path
        # a graceful SIGTERM preemption (exit 0, bit-exact resume) is not a
        # failure: ERROR there rings operator alerts on every scheduled stop
        log = logger.warning if reason == "sigterm" else logger.error
        log(
            "flight recorder: wrote post-mortem (%s, %d events, %d dropped) "
            "-> %s", reason, len(doc["events"]), dropped, path,
        )
        return path


def _anchor() -> Dict[str, float]:
    """Paired wall-clock / perf-counter reading: lets a merger map this
    process's monotonic event timestamps onto a shared wall axis."""
    return {"wall_time_s": time.time(), "perf_ns": time.perf_counter_ns()}


def _event_doc(ev: tuple) -> Dict[str, Any]:
    ts_ns, kind, cid, payload = ev
    doc: Dict[str, Any] = {"ts_ns": ts_ns, "kind": kind}
    if cid:
        doc["cid"] = cid
    if payload:
        doc["payload"] = payload
    return doc


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder every subsystem emits into."""
    return _RECORDER


def record(kind: str, cid: str = "", **payload: Any) -> None:
    """Module-level shorthand for ``get_flight_recorder().record(...)``."""
    _RECORDER.record(kind, cid, **payload)


def configure_flight_recorder(max_events: Optional[int] = None,
                              dump_dir: Optional[str] = None,
                              fresh: bool = False) -> None:
    _RECORDER.configure(max_events=max_events, dump_dir=dump_dir, fresh=fresh)


def dump_postmortem(reason: str, path: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump the global recorder (watchdog fire, supervisor abort, uncaught
    exception, SIGTERM all route here). Never raises."""
    return _RECORDER.dump(reason, path=path, extra=extra)

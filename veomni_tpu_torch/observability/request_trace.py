"""Per-request lifecycle tracing for the serving engine.

Copy of ``veomni_tpu/observability/request_trace.py`` on the port's
``flight_recorder``, ``metrics``, ``spans`` and ``logging``.

Aggregate TTFT cannot answer *"why was request X slow — queue wait,
preemption, or slow decode?"*. This module threads a timeline through
``serving/api.py`` → ``scheduler.py`` → ``engine.py``: every request records
its stage transitions (queued → admitted → prefill-done → first-token →
preempted×N → finished) with host timestamps, and the tracer derives the two
per-request latency distributions the SLO-scheduling roadmap item regresses
against:

* ``serve.queue_wait_s`` — each waiting segment (initial admission wait AND
  every post-preemption re-admission wait) observed into one histogram;
* ``serve.tpot_s``       — time-per-output-token over the decode phase
  (first token → finish, minus any re-admission waits inside that window so
  a preemption's requeue time is not double-counted as slow decode,
  ÷ tokens-1), observed once per finished request;
* ``serve.preemptions_per_request`` — preemption count per finished request.

Each transition also lands in the flight recorder (``serve.*`` events,
correlation id = request id), so a serving post-mortem carries request
histories, and :meth:`RequestTracer.dump_chrome_trace` exports a chrome
trace with **one track per decode slot** (plus a ``waiting`` track): a
request's hops across preemptions are visible in the same viewer as the
host spans from ``observability/spans.py`` (same µs timebase, pid = rank).

The tracer is pure host bookkeeping and thread-safe: the engine's pump loop
writes while the exporter's HTTP thread snapshots for ``/debug/requests``.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from veomni_tpu_torch.observability.flight_recorder import record as _flight_record
from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from veomni_tpu_torch.utils.logging import _process_index

@dataclass
class RequestTimeline:
    """Host-side lifecycle history of one request."""

    request_id: str
    # (t_s, stage, detail) — t_s is perf_counter seconds (tracer-relative
    # offsets come from the owning tracer's epoch)
    marks: List[Tuple[float, str, Dict[str, Any]]] = field(default_factory=list)
    # closed (slot, t0, t1) residencies + the currently-open one
    slot_segments: List[Tuple[int, float, float]] = field(default_factory=list)
    _open_slot: Optional[Tuple[int, float]] = None
    _wait_since: Optional[float] = None
    queue_wait_s: float = 0.0
    wait_segments: List[Tuple[float, float]] = field(default_factory=list)
    preemptions: int = 0
    first_token_t: Optional[float] = None
    finished_t: Optional[float] = None
    finish_reason: str = ""
    tokens: int = 0
    tpot_s: Optional[float] = None
    cached_tokens: int = 0  # prompt positions served from the prefix cache
    # decode-phase accounting by PER-TICK emitted counts: with speculative
    # decoding a verify step lands several tokens in one tick, so "ticks
    # since first token" and "tokens since first token" are different
    # numbers — tpot_s must divide by the latter. decode_tokens accumulates
    # every decode tick's real emitted count (the first token, emitted by
    # prefill, is excluded: tpot is a decode-phase figure).
    decode_tokens: int = 0
    spec_accepted_tokens: int = 0  # of those, accepted speculative drafts

    def mark(self, stage: str, t: Optional[float] = None,
             **detail: Any) -> float:
        t = time.perf_counter() if t is None else t
        self.marks.append((t, stage, detail))
        return t

    def copy_for_read(self) -> "RequestTimeline":
        """Shallow copy with the mutable lists copied — taken under the
        tracer lock so callers can format ``to_doc`` AFTER releasing it
        (formatting ~260 dicts under the lock would stall the decode pump
        on every ``/debug/requests`` scrape)."""
        import copy

        tl = copy.copy(self)
        tl.marks = list(self.marks)
        tl.slot_segments = list(self.slot_segments)
        tl.wait_segments = list(self.wait_segments)
        return tl

    @property
    def stages(self) -> List[str]:
        return [s for _, s, _ in self.marks]

    def to_doc(self, epoch: float = 0.0,
               now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-ready view (``/debug/requests``, post-mortems).

        ``now`` (perf_counter seconds) folds a live request's *open* state
        into the doc: a still-waiting request reports its wait so far, a
        decoding one the slot it occupies — otherwise "why is request X
        slow right now?" reads as ``queue_wait_s: 0.0`` the whole time it
        queues."""
        queue_wait = self.queue_wait_s
        if now is not None and self._wait_since is not None:
            queue_wait += max(now - self._wait_since, 0.0)
        doc: Dict[str, Any] = {
            "request_id": self.request_id,
            "timeline": [
                {"t_s": round(t - epoch, 6), "stage": s, **d}
                for t, s, d in self.marks
            ],
            "queue_wait_s": queue_wait,
            "preemptions": self.preemptions,
            "tokens": self.tokens,
            "cached_tokens": self.cached_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
        }
        if self._wait_since is not None and now is not None:
            doc["waiting"] = True
        if self._open_slot is not None:
            doc["in_slot"] = self._open_slot[0]
        if self.finished_t is not None and self.marks:
            doc["e2e_s"] = round(self.finished_t - self.marks[0][0], 6)
        if self.tpot_s is not None:
            doc["tpot_s"] = self.tpot_s
        if self.finish_reason:
            doc["finish_reason"] = self.finish_reason
        return doc


class RequestTracer:
    """Collects :class:`RequestTimeline` objects and feeds the per-request
    histograms + flight recorder. One instance per engine."""

    def __init__(self, num_slots: int,
                 registry: Optional[MetricsRegistry] = None,
                 max_finished: int = 256):
        self.num_slots = num_slots
        self.registry = registry or get_registry()
        self._h_wait = self.registry.histogram("serve.queue_wait_s")
        self._h_tpot = self.registry.histogram("serve.tpot_s")
        self._h_preempt = self.registry.histogram(
            "serve.preemptions_per_request"
        )
        self._lock = threading.Lock()
        self._inflight: Dict[str, RequestTimeline] = {}  # guarded-by: _lock
        # finished timelines kept for chrome export / debugging, bounded so a
        # long-running pump never accumulates one timeline per request served
        self._finished: deque = deque(maxlen=max_finished)  # guarded-by: _lock
        self.epoch = time.perf_counter()

    # ------------------------------------------------------------ transitions
    def on_queued(self, request_id: str) -> None:
        tl = RequestTimeline(request_id=request_id)
        t = tl.mark("queued")
        tl._wait_since = t
        with self._lock:
            self._inflight[request_id] = tl
        _flight_record("serve.queued", cid=request_id)

    def on_rejected(self, request_id: str) -> None:
        """A request load-shed at submit (bounded queue / tenant cap): it
        was never queued, so its timeline is a single terminal ``rejected``
        mark straight into the finished ring — ``/debug/requests`` shows
        WHO was turned away during an overload window, with timestamps."""
        tl = RequestTimeline(request_id=request_id)
        t = tl.mark("rejected")
        tl.finished_t = t
        tl.finish_reason = "rejected"
        with self._lock:
            self._finished.append(tl)
        _flight_record("serve.rejected", cid=request_id)

    def on_admitted(self, request_id: str, slot: int) -> None:
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is None:
                return
            t = tl.mark("admitted", slot=slot)
            if tl._wait_since is not None:
                wait = t - tl._wait_since
                tl.queue_wait_s += wait
                tl.wait_segments.append((tl._wait_since, t))
                tl._wait_since = None
                self._h_wait.observe(wait)
            tl._open_slot = (slot, t)
        _flight_record("serve.admitted", cid=request_id, slot=slot)

    def on_prefill_done(self, request_id: str,
                        cached_tokens: int = 0) -> None:
        """``cached_tokens`` = prompt positions served from the prefix cache
        on this admission (lands on the timeline mark AND the rollup doc, so
        ``/debug/requests`` answers "did request X hit the cache?")."""
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is not None:
                tl.mark("prefill_done", cached_tokens=cached_tokens)
                tl.cached_tokens = cached_tokens

    def on_first_token(self, request_id: str) -> None:
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is not None:
                tl.first_token_t = tl.mark("first_token")
        _flight_record("serve.first_token", cid=request_id)

    def on_decode_tokens(self, request_id: str, n: int,
                         spec_accepted: int = 0) -> None:
        """Record one decode tick's REAL emitted-token count (the engine
        calls this once per sequence per decode tick, before the tokens are
        emitted). ``serve.tpot_s`` previously divided the decode wall by
        ``tokens - 1`` — correct only while every decode tick emits exactly
        one token; a speculative verify step lands up to k+1, so the
        tracer now accumulates the per-tick counts and divides by those.
        Multi-token ticks additionally land a ``verify_emit`` timeline mark
        (tokens + accepted-draft count) so ``/debug/requests`` shows WHERE
        a request's speculative wins happened; one-token ticks only bump
        the counters (a mark per generated token would bloat every
        timeline)."""
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is None:
                return
            tl.decode_tokens += n
            tl.spec_accepted_tokens += spec_accepted
            if n > 1:
                tl.mark("verify_emit", tokens=n, spec_accepted=spec_accepted)

    def on_preempted(self, request_id: str) -> None:
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is None:
                return
            t = tl.mark("preempted")
            tl.preemptions += 1
            if tl._open_slot is not None:
                slot, t0 = tl._open_slot
                tl.slot_segments.append((slot, t0, t))
                tl._open_slot = None
            tl._wait_since = t  # requeued: the next admit closes this wait
        _flight_record("serve.preempted", cid=request_id)

    def on_finished(self, request_id: str, reason: str,
                    tokens: int) -> Optional[RequestTimeline]:
        """Close the timeline; returns it so the engine's finish path needs
        no second lookup (``get()`` would scan the finished deque)."""
        with self._lock:
            tl = self._inflight.pop(request_id, None)
            if tl is None:
                return None
            t = tl.mark("finished", reason=reason, tokens=tokens)
            tl.finished_t = t
            tl.finish_reason = reason
            tl.tokens = tokens
            if tl._open_slot is not None:
                slot, t0 = tl._open_slot
                tl.slot_segments.append((slot, t0, t))
                tl._open_slot = None
            if tl._wait_since is not None:
                # finished while requeued (cancel/abort): close the wait so
                # queue_wait_s covers it and the segment is exported
                wait = t - tl._wait_since
                tl.queue_wait_s += wait
                tl.wait_segments.append((tl._wait_since, t))
                tl._wait_since = None
                self._h_wait.observe(wait)
            if tl.first_token_t is not None and tokens > 1:
                # decode wall time MINUS re-admission waits inside it: a
                # preempted request's 10s requeue wait is queue_wait_s, and
                # counting it here too would read as slow decode — the exact
                # confusion this decomposition exists to remove
                decode_wall = t - tl.first_token_t
                for w0, w1 in tl.wait_segments:
                    decode_wall -= max(
                        0.0, min(w1, t) - max(w0, tl.first_token_t)
                    )
                # divide by the RECORDED decode-phase token count (per-tick
                # emitted counts, multi-token verify ticks included) — the
                # old ``tokens - 1`` denominator assumed one token per
                # decode tick and is kept only as the fallback for engines
                # that never report tick counts
                denom = tl.decode_tokens if tl.decode_tokens > 0 else (
                    tokens - 1
                )
                tl.tpot_s = max(decode_wall, 0.0) / denom
                self._h_tpot.observe(tl.tpot_s)
            self._h_preempt.observe(float(tl.preemptions))
            self._finished.append(tl)
        _flight_record("serve.finished", cid=request_id, reason=reason,
                       tokens=tokens, preemptions=tl.preemptions)
        return tl

    # ---------------------------------------------------------------- queries
    def get(self, request_id: str) -> Optional[RequestTimeline]:
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is not None:
                return tl
            for done in self._finished:
                if done.request_id == request_id:
                    return done
        return None

    def finished(self) -> List[RequestTimeline]:
        with self._lock:
            return list(self._finished)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view for ``/debug/requests``: in-flight timelines plus
        the bounded recently-finished tail."""
        now = time.perf_counter()
        with self._lock:
            live = [tl.copy_for_read() for tl in self._inflight.values()]
            done_tls = list(self._finished)  # immutable once finished
        inflight = [tl.to_doc(self.epoch, now=now) for tl in live]
        done = [tl.to_doc(self.epoch) for tl in done_tls]
        return {
            "rank": _process_index(),
            "num_slots": self.num_slots,
            "inflight": inflight,
            "finished": done,
        }

    # ----------------------------------------------------------------- export
    def dump_chrome_trace(self, path: str) -> int:
        """Chrome-trace JSON (gzip by extension): one track per decode slot,
        one ``waiting`` track, pid = rank — loadable alongside
        ``spans.dump_chrome_trace`` output in the same viewer. Returns the
        number of "X" events written."""
        rank = _process_index()
        # share the span tracer's ts=0 anchor when it has one: a request's
        # slot-residency segment must land ON the serve.prefill/serve.decode
        # host spans covering it, not seconds away (the tracer's own epoch
        # is pinned at engine construction, the spans' at first enable)
        from veomni_tpu_torch.observability.spans import chrome_epoch_ns

        span_epoch = chrome_epoch_ns()
        epoch = span_epoch / 1e9 if span_epoch is not None else self.epoch
        now = time.perf_counter()
        # segment lists + open state must be copied in ONE locked pass: a
        # preemption between a lock-free list() and reading _open_slot would
        # export the same residency twice (once closed, once extended to
        # "now"). Live requests close their open slot/wait segments at "now"
        # for the export, else an in-flight request's current residency (and
        # a 30s-and-counting wait) is simply absent from the trace.
        snaps: List[Tuple[RequestTimeline, List[Tuple[int, float, float]],
                          List[Tuple[float, float]]]] = []
        with self._lock:
            for tl in list(self._finished) + list(self._inflight.values()):
                slot_segs = list(tl.slot_segments)
                wait_segs = list(tl.wait_segments)
                if tl._open_slot is not None:
                    slot, t0 = tl._open_slot
                    slot_segs.append((slot, t0, now))
                if tl._wait_since is not None:
                    wait_segs.append((tl._wait_since, now))
                snaps.append((tl, slot_segs, wait_segs))
        wait_tid = self.num_slots
        trace: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
            "args": {"name": f"veomni serve requests (rank {rank})"},
        }]
        for s in range(self.num_slots):
            trace.append({"name": "thread_name", "ph": "M", "pid": rank,
                          "tid": s, "args": {"name": f"slot-{s}"}})
        trace.append({"name": "thread_name", "ph": "M", "pid": rank,
                      "tid": wait_tid, "args": {"name": "waiting"}})
        n = 0
        for tl, slot_segs, wait_segs in snaps:
            for slot, t0, t1 in slot_segs:
                trace.append({
                    "name": tl.request_id, "cat": "serve", "ph": "X",
                    "pid": rank, "tid": slot,
                    "ts": (t0 - epoch) * 1e6,
                    "dur": max(t1 - t0, 0.0) * 1e6,
                    "args": {"preemptions": tl.preemptions,
                             "tokens": tl.tokens},
                })
                n += 1
            for t0, t1 in wait_segs:
                trace.append({
                    "name": tl.request_id, "cat": "serve.wait", "ph": "X",
                    "pid": rank, "tid": wait_tid,
                    "ts": (t0 - epoch) * 1e6,
                    "dur": max(t1 - t0, 0.0) * 1e6,
                })
                n += 1
            if tl.first_token_t is not None:
                trace.append({
                    "name": f"{tl.request_id}:first_token", "ph": "i",
                    "pid": rank, "tid": wait_tid, "s": "t",
                    "ts": (tl.first_token_t - epoch) * 1e6,
                })
        payload = {"traceEvents": trace, "displayTimeUnit": "ms"}
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump(payload, f)
        return n

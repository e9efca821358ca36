"""Host-side span tracing: ``with span("data.wait"): ...``.

Design constraints, in order:

1. **Disabled ≈ free.** ``span()`` with tracing off returns one shared
   no-op context manager — no allocation, no clock read, no dict lookup.
   The trainer can leave call sites in the hot loop unconditionally.
2. **Always feeds histograms when enabled.** Every span exit observes its
   duration into the registry histogram ``span.<name>`` — that is what the
   goodput decomposition deltas, so spans are useful with zero extra
   machinery running.
3. **Mirrors into the device profiler only when one is active.** When
   ``torch.profiler`` has a trace running (``set_profiler_active(True)``, set
   by ``ProfileCallback``), each span also opens a
   ``torch.profiler.record_function`` range so host phases line up with
   device kernels in the heavyweight trace — but the heavyweight path is
   never *required*.
4. **Self-serve chrome traces.** Completed spans land in a bounded ring
   buffer; :func:`dump_chrome_trace` writes chrome-trace JSON (gzip by
   extension) that ``scripts/merge_chrome_trace.py`` merges across hosts —
   a stall timeline without ever starting the profiler.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from collections import deque
from typing import Optional

from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

_enabled = False
_profiler_active = False
_epoch_ns: Optional[int] = None
# (name, t0_ns, dur_ns, tid) ring
_events: deque = deque(maxlen=100_000)  # guarded-by: _ring_lock
# ring evictions: a chrome trace missing its head is truncated,
_dropped = 0  # guarded-by: _ring_lock
# not short — say so once (rank 0) + count forever
_warned_dropped = False  # guarded-by: _ring_lock
# serializes the full-ring check + append + drop accounting: spans exit on
# several threads (prefetch worker, commit thread), and an unlocked
# check-then-act would undercount evictions right at the full boundary
_ring_lock = threading.Lock()
_tid_lock = threading.Lock()
# thread ident -> small stable int
_tids: dict = {}  # guarded-by: _tid_lock


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _tid() -> int:
    ident = threading.get_ident()
    t = _tids.get(ident)
    if t is None:
        with _tid_lock:
            t = _tids.setdefault(ident, len(_tids))
    return t


class _Span:
    __slots__ = ("name", "_t0", "_annot")

    def __init__(self, name: str):
        self.name = name
        self._annot = None

    def __enter__(self):
        if _profiler_active:
            import torch.profiler

            self._annot = torch.profiler.record_function(self.name)
            self._annot.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self._t0
        if self._annot is not None:
            self._annot.__exit__(*exc)
            self._annot = None
        get_registry().histogram(f"span.{self.name}").observe(dur_ns * 1e-9)
        ev = (self.name, self._t0, dur_ns, _tid())
        global _dropped, _warned_dropped
        evicted = warn = False
        cap = 0
        with _ring_lock:
            cap = _events.maxlen
            if len(_events) == cap:
                # once full (steady state on a long run) EVERY exit evicts:
                # only the bookkeeping ints live under the lock — registry
                # lookup and logging happen after release so concurrent
                # span exits don't serialize behind I/O
                _dropped += 1
                evicted = True
                if not _warned_dropped:
                    _warned_dropped = True
                    warn = True
            _events.append(ev)
        if evicted:
            _note_dropped(1, warn, cap)
        return False


def _note_dropped(n: int, warn: bool, cap: int) -> None:
    """``n`` events were just evicted (full-ring append, or a shrink via
    ``enable_spans``); the caller already bumped ``_dropped``, claimed the
    one-time warning, and read the ring capacity ``cap`` under
    ``_ring_lock``. This mirrors the loss into the ``span.dropped`` counter
    and warns ONCE (rank 0) — without this a truncated chrome trace reads
    as a short run, not a long one missing its head. Deliberately called
    OUTSIDE the ring lock (registry + logging I/O must not serialize
    concurrent span exits), which is why the capacity is passed in instead
    of read from the guarded ring here."""
    get_registry().counter("span.dropped").inc(n)
    if warn:
        logger.warning_rank0(
            "span ring buffer full (%d events): oldest spans are being "
            "dropped — a chrome-trace dump will be missing its HEAD, not its "
            "tail. Raise enable_spans(max_events=...) or dump earlier; "
            "`span.dropped` counts the loss from here on.",
            cap,
        )


def span(name: str):
    """Time a host phase. Returns the shared no-op when tracing is off."""
    return _Span(name) if _enabled else _NULL


def dropped_events() -> int:
    """Span-ring evictions so far (mirrors the ``span.dropped`` counter)."""
    with _ring_lock:
        return _dropped


def chrome_epoch_ns() -> Optional[int]:
    """The ts=0 anchor of span chrome traces (None until first enable).
    Other chrome exporters (request_trace) offset against this so their
    tracks line up with the span tracks in one viewer."""
    return _epoch_ns


def live_span_events(limit: int = 0):
    """Most recent ``limit`` raw span tuples ``(name, t0_ns, dur_ns, tid)``
    (0 = all). The flight recorder embeds this tail in post-mortems so host
    phases and recorder events share one timebase."""
    with _ring_lock:  # a concurrent span exit mutates the deque mid-list()
        evs = list(_events)
    return evs[-limit:] if limit > 0 else evs


def spans_enabled() -> bool:
    return _enabled


def enable_spans(max_events: int = 100_000) -> None:
    """Turn tracing on; resizes the event ring if ``max_events`` changed.
    The chrome-trace epoch is pinned on first enable so ts offsets stay
    comparable across enable/disable cycles in one process."""
    global _enabled, _epoch_ns, _events, _dropped, _warned_dropped
    if _epoch_ns is None:
        _epoch_ns = time.perf_counter_ns()
    warn = False
    evicted = 0
    with _ring_lock:
        if _events.maxlen != max_events:
            before = len(_events)
            _events = deque(_events, maxlen=max_events)
            # shrinking evicts the oldest entries: count them, same
            # invariant as a full-ring append
            evicted = before - len(_events)
            if evicted:
                _dropped += evicted
                if not _warned_dropped:
                    _warned_dropped = True
                    warn = True
    if evicted:
        _note_dropped(evicted, warn, max_events)
    _enabled = True


def disable_spans() -> None:
    global _enabled
    _enabled = False


def set_profiler_active(active: bool) -> None:
    """ProfileCallback toggles this around start/stop_trace so spans mirror
    into ``torch.profiler.record_function`` exactly while a trace runs."""
    global _profiler_active
    _profiler_active = bool(active)


def clear_events() -> None:
    global _dropped, _warned_dropped
    with _ring_lock:
        _events.clear()
        _dropped = 0
        _warned_dropped = False


def dump_chrome_trace(path: str) -> int:
    """Write the span ring buffer as chrome-trace JSON ("X" complete
    events, µs timebase; pid = process rank so multi-host merges group
    naturally). Returns the number of span events written."""
    epoch = _epoch_ns if _epoch_ns is not None else time.perf_counter_ns()
    rank = _process_index()
    with _ring_lock:  # a concurrent span exit mutates the deque mid-list()
        events = list(_events)
        dropped = _dropped  # same locked pass: count matches the snapshot
    trace = [{
        "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
        # dropped rides along so a viewer of a truncated trace can see HOW
        # truncated (satellite of the one-time warning above)
        "args": {"name": f"veomni host spans (rank {rank})",
                 "dropped_events": dropped},
    }]
    with _tid_lock:  # a thread registering its first span mutates the dict
        tids = sorted(_tids.items(), key=lambda kv: kv[1])
    for ident, t in tids:
        trace.append({
            "name": "thread_name", "ph": "M", "pid": rank, "tid": t,
            "args": {"name": f"thread-{ident}"},
        })
    for name, t0_ns, dur_ns, tid in events:
        trace.append({
            "name": name, "cat": "host", "ph": "X", "pid": rank, "tid": tid,
            "ts": (t0_ns - epoch) / 1e3, "dur": dur_ns / 1e3,
        })
    payload = {"traceEvents": trace, "displayTimeUnit": "ms"}
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(payload, f)
    else:
        with open(path, "w") as f:
            json.dump(payload, f)
    return len(events)

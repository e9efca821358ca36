"""Process-wide, thread-safe metrics registry.

Three instrument kinds, all safe to touch from any thread (prefetch worker,
checkpoint commit thread, exporter HTTP thread, train loop):

* :class:`Counter`   — monotonically increasing float.
* :class:`Gauge`     — last-write-wins float.
* :class:`Histogram` — bounded reservoir (exact count/sum/min/max; p50/p95
  from a deterministic reservoir sample so memory stays O(max_samples) no
  matter how many steps a run observes).

The registry is *rank-aware* without ever forcing a backend init: rank is
resolved through the same lazy path the logger uses (a metrics call must
never be the thing that claims a TPU chip — see ``utils/logging.py``).

Two egress paths, both pull-free for the hot loop:

* ``attach_jsonl(path)`` — a rank-local JSONL sink; every ``export()`` call
  (the trainer's sync cadence) appends one line.
* ``add_export_hook(fn)`` — pluggable consumers (``WandbCallback``,
  ``LoggingCallback``) receive the merged ``(step, payload)`` instead of
  reaching into ``state.metrics`` directly.

The Prometheus text rendering lives in ``observability/exporter.py``.
"""

from __future__ import annotations

import json
import random
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

#: latency-style bucket bounds (seconds) for native-histogram rendering
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: families the exporter renders as NATIVE Prometheus histograms
#: (`<name>_hist_bucket{le=...}`). The registry auto-attaches these bounds
#: at creation so the bucket counts are EXACT counters maintained at
#: observe() time — a reservoir-scaled estimate would not be monotone
#: non-decreasing across scrapes, and PromQL `rate()` reads any decrease
#: as a counter reset (spurious p99 spikes on exactly the SLO queries the
#: native render exists to serve).
SLO_BUCKET_BOUNDS: Dict[str, tuple] = {
    "serve.ttft_s": LATENCY_BUCKETS,
    "serve.tpot_s": LATENCY_BUCKETS,
    # queue wait is the third serving-SLO family: under the PR 15 QoS
    # layer it is the signal shedding/deadline decisions act on, so p99
    # queries over it must work in PromQL like the other two
    "serve.queue_wait_s": LATENCY_BUCKETS,
}


class Counter:
    """Monotonic counter. ``inc`` of a negative amount is rejected."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0.0  # guarded-by: _lock
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"value": self._value}


class Gauge:
    """Last-write-wins value (queue depth, utilization, live memory)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0.0  # guarded-by: _lock
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"value": self._value}


class Histogram:
    """Bounded-reservoir duration/size distribution.

    count/sum/min/max are exact over every observation; percentiles come
    from an Algorithm-R reservoir (deterministically seeded per name, so a
    fixed observation sequence yields fixed percentiles — tests and bit-
    exact replay drills stay reproducible)."""

    __slots__ = ("name", "_lock", "_samples", "_max_samples", "_count",
                 "_sum", "_min", "_max", "_rng", "_bounds", "_bins")

    def __init__(self, name: str, lock: threading.RLock,
                 max_samples: int = 512,
                 bucket_bounds: Optional[tuple] = None):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.name = name
        self._lock = lock
        self._samples: List[float] = []  # guarded-by: _lock
        self._max_samples = max_samples
        self._count = 0  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._min = float("inf")  # guarded-by: _lock
        self._max = float("-inf")  # guarded-by: _lock
        # crc32, not hash(): str hash is salted per process, which would
        # break the cross-restart reproducibility promised above
        self._rng = random.Random(0xC0FFEE ^ zlib.crc32(name.encode()))
        # optional EXACT bucket accounting (SLO_BUCKET_BOUNDS families):
        # one bisect + int bump per observe; bins[i] counts values in
        # (bounds[i-1], bounds[i]], bins[-1] the overflow past every bound
        self._bounds = (
            tuple(sorted(float(b) for b in bucket_bounds))
            if bucket_bounds else None
        )
        self._bins: List[int] = (  # guarded-by: _lock
            [0] * (len(self._bounds) + 1) if self._bounds else []
        )

    def observe(self, value: float) -> None:
        import bisect

        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if self._bounds is not None:
                self._bins[bisect.bisect_left(self._bounds, value)] += 1
            if len(self._samples) < self._max_samples:
                self._samples.append(value)
            else:
                j = self._rng.randrange(self._count)
                if j < self._max_samples:
                    self._samples[j] = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir, q in [0, 100]."""
        with self._lock:
            if not self._samples:
                return 0.0
            ordered = sorted(self._samples)
            idx = min(len(ordered) - 1, max(0, round(q / 100.0 * (len(ordered) - 1))))
            return ordered[idx]

    def cumulative_buckets(self, bounds) -> List[tuple]:
        """Prometheus-native cumulative bucket counts ``[(le, count), ...,
        ("+Inf", total)]`` over ascending ``bounds``.

        When ``bounds`` are the histogram's attached bucket bounds (every
        ``SLO_BUCKET_BOUNDS`` family), counts come from EXACT per-bin
        counters maintained at observe() time: monotone non-decreasing
        across scrapes at any observation count, as PromQL's ``rate()``
        over ``_bucket`` series requires. For ad-hoc bounds the reservoir
        fraction at or under each bound is scaled to the exact total — an
        estimate (same approximation as the p50/p95 summary), monotone
        within one call but NOT across scrapes once the reservoir churns;
        don't feed it to rate()."""
        import bisect

        want = tuple(sorted(float(b) for b in bounds))
        with self._lock:
            if self._bounds is not None and want == self._bounds:
                running, out = 0, []
                for le, n in zip(self._bounds, self._bins):
                    running += n
                    out.append((le, running))
                out.append(("+Inf", int(self._count)))
                return out
            ordered = sorted(self._samples)
            total = self._count
        out = []
        n_res = len(ordered)
        for le in want:
            if n_res:
                frac = bisect.bisect_right(ordered, float(le)) / n_res
            else:
                frac = 0.0
            out.append((float(le), int(round(frac * total))))
        # cumulative counts must be monotone even under scaling round-off
        for i in range(1, len(out)):
            if out[i][1] < out[i - 1][1]:
                out[i] = (out[i][0], out[i - 1][1])
        out.append(("+Inf", int(total)))
        return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if not self._count:
                return {"count": 0.0, "sum": 0.0}
            return {
                "count": float(self._count),
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "mean": self._sum / self._count,
                "p50": self.percentile(50),
                "p95": self.percentile(95),
            }


class MetricsRegistry:
    """Name -> instrument map with JSONL + hook egress.

    Instrument creation is get-or-create (two subsystems asking for the same
    counter share it); asking for an existing name as a different kind is a
    programming error and raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Any] = {}  # guarded-by: _lock
        self._hooks: List[Callable[[int, Dict[str, float]], None]] = []  # guarded-by: _lock
        self._jsonl_path: Optional[str] = None  # guarded-by: _lock
        self._last_export: Optional[tuple] = None  # guarded-by: _lock

    # ------------------------------------------------------------ instruments
    def _get_or_create(self, name: str, kind, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, self._lock, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, max_samples: int = 512) -> Histogram:
        # SLO families get exact native-bucket counters attached at birth
        # (see SLO_BUCKET_BOUNDS); everyone else stays reservoir-only
        return self._get_or_create(
            name, Histogram, max_samples=max_samples,
            bucket_bounds=SLO_BUCKET_BOUNDS.get(name),
        )

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def histogram_sum(self, name: str) -> float:
        """Cumulative sum of a histogram, 0.0 if it doesn't exist yet (the
        goodput tracker deltas span histograms that may not have fired)."""
        with self._lock:
            m = self._metrics.get(name)
        return m.sum if isinstance(m, Histogram) else 0.0

    def items_snapshot(self) -> List[tuple]:
        """Stable-ordered (name, instrument) pairs for renderers."""
        with self._lock:
            return sorted(self._metrics.items())

    # ---------------------------------------------------------------- egress
    def export_scalars(self) -> Dict[str, float]:
        """Flatten every instrument to plain floats (histograms expand to
        ``name.p50`` / ``.p95`` / ``.max`` / ``.mean`` / ``.count``)."""
        out: Dict[str, float] = {}
        for name, m in self.items_snapshot():
            if isinstance(m, Histogram):
                snap = m.snapshot()
                for k in ("p50", "p95", "max", "mean", "count"):
                    if k in snap:
                        out[f"{name}.{k}"] = snap[k]
            else:
                out[name] = m.value
        return out

    def set_gauges(self, prefix: str, values: Dict[str, Any]) -> None:
        """Publish a dict of host floats as ``{prefix}.{key}`` gauges
        (non-numeric values are skipped — device futures must never be
        fetched here)."""
        for k, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(f"{prefix}.{k}").set(v)

    def add_export_hook(self, fn: Callable[[int, Dict[str, float]], None]) -> None:
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def remove_export_hook(self, fn) -> None:
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    def attach_jsonl(self, path: str) -> None:
        """Rank-local JSONL sink: every ``export()`` appends one line to
        ``path``. Re-attaching switches files (a resumed run appends to the
        new run's sink)."""
        with self._lock:
            self._jsonl_path = path

    def export(self, step: int, payload: Optional[Dict[str, Any]] = None
               ) -> Dict[str, float]:
        """Merge registry scalars with ``payload`` (step metrics already on
        host), write the JSONL line, fire export hooks, return the merged
        dict. Hook/sink failures are logged, never raised — observability
        must not kill a training step."""
        merged = self.export_scalars()
        if payload:
            merged.update({
                k: v for k, v in payload.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            })
        with self._lock:
            self._last_export = (step, merged)
            path, hooks = self._jsonl_path, list(self._hooks)
        if path:
            try:
                with open(path, "a") as f:
                    f.write(json.dumps({
                        "ts": time.time(), "step": step,
                        "rank": _process_index(), **merged,
                    }) + "\n")
            except OSError as e:
                logger.warning("metrics JSONL write failed: %s", e)
        for fn in hooks:
            try:
                fn(step, merged)
            except Exception as e:
                logger.warning("metrics export hook %r failed: %s", fn, e)
        return merged

    def last_export(self, step: Optional[int] = None
                    ) -> Optional[Dict[str, float]]:
        """The most recent ``export()`` payload; with ``step`` given, only
        if it matches (consumers use this to detect a fresh publish)."""
        with self._lock:
            last = self._last_export
        if last is None:
            return None
        if step is not None and last[0] != step:
            return None
        return last[1]

    def rank(self) -> int:
        """Lazy rank (never the thing that initializes the backend)."""
        return _process_index()

    def reset(self) -> None:
        """Drop every instrument + sink (tests)."""
        with self._lock:
            self._metrics.clear()
            self._hooks.clear()
            self._jsonl_path = None
            self._last_export = None


class _FencedInstrument:
    """Write-dropping proxy over one instrument, owned by a labelled view.

    Writes (``inc``/``set``/``observe``) forward to the real instrument
    until the owning :class:`LabelledRegistry` is ``revoke()``-d, then
    become no-ops — the fence an abandoned zombie pump thread hits when it
    finally returns from a wedged step and tries to bump its replica's
    labelled counters. Everything else (``value``, ``snapshot``, native
    bucket introspection, ...) delegates to the real instrument, so read
    paths and the exporter see the one true series.
    """

    __slots__ = ("_inst", "_owner")

    def __init__(self, inst, owner: "LabelledRegistry"):
        self._inst = inst
        self._owner = owner

    def inc(self, amount: float = 1.0) -> None:
        if not self._owner._revoked:
            self._inst.inc(amount)

    def set(self, value: float) -> None:
        if not self._owner._revoked:
            self._inst.set(value)

    def observe(self, value: float) -> None:
        if not self._owner._revoked:
            self._inst.observe(value)

    def __getattr__(self, attr):
        return getattr(self._inst, attr)


class LabelledRegistry:
    """Per-instance relabeling view over a shared :class:`MetricsRegistry`.

    N in-process serving engines used to clobber each other's process-wide
    ``serve.*`` instruments — every replica's pump wrote the SAME
    ``serve.queue_depth`` gauge, so ``/metrics`` showed whichever replica
    scribbled last. Each engine now emits through a view carrying an
    instance label; the label is inserted after the family prefix at
    creation time (``serve.queue_depth`` -> ``serve.r0.queue_depth``) so
    per-replica series coexist in the one registry the exporter renders.

    Two deliberate properties:

    * **call sites keep literal names** — graftlint's metric scanner and
      the doc-drift gate key off the literal strings at ``.counter(...)``/
      ``.gauge(...)``/``.histogram(...)`` call sites, and those strings are
      the BASE family names; the view relabels underneath, so the scanner
      sanity pins and the docs table keep meaning what they say.
    * **the empty label is the identity** — a single unlabelled engine
      produces byte-identical metric names to every release before this
      one, so existing scrape configs and dashboards keep working.

    Dot-free names (``recompiles``) stay shared across instances: they are
    process-wide by design, not per-replica families.

    **Revocation (the zombie-write fence).** The scale-out router abandons
    a pump thread that blows its ``replica_stall_s`` deadline — but that
    thread may still be inside XLA and will eventually return and keep
    writing this view's labelled instruments. ``revoke()`` flips the view
    into a write-dropping state: every instrument a LABELLED view hands
    out is a :class:`_FencedInstrument` proxy whose ``inc``/``set``/
    ``observe`` no-op once the owning view is revoked, so a late zombie
    write can never double-count the respawned replica's window (the
    successor engine gets a FRESH view for the same label). Reads
    delegate to the real instrument, and the unlabelled identity view
    hands out bare instruments — the single-engine path is untouched.
    """

    def __init__(self, base: MetricsRegistry, label: str = ""):
        # never stack views — relabeling a labelled view re-targets its base
        while isinstance(base, LabelledRegistry):
            base = base.base
        self.base = base
        self.label = str(label)
        self._revoked = False
        self._proxies: Dict[str, "_FencedInstrument"] = {}

    def revoke(self) -> None:
        """Drop every FUTURE write through this view (reads keep working).
        Idempotent; used by the router's generation fence when a wedged
        replica's pump thread is abandoned."""
        self._revoked = True

    @property
    def revoked(self) -> bool:
        return self._revoked

    def _fence(self, inst):
        """Wrap ``inst`` in this view's write fence (cached per concrete
        name so callers that cache the instrument and callers that re-look
        it up behave identically)."""
        if not self.label:
            return inst  # identity view: no fleet above it, no fence
        proxy = self._proxies.get(inst.name)
        if proxy is None or proxy._inst is not inst:
            proxy = _FencedInstrument(inst, self)
            self._proxies[inst.name] = proxy
        return proxy

    def scoped(self, name: str) -> str:
        """The concrete instrument name this view creates for ``name``."""
        if not self.label or "." not in name:
            return name
        head, rest = name.split(".", 1)
        return f"{head}.{self.label}.{rest}"

    # Same instrument surface as MetricsRegistry — callers (engine, tracer,
    # recompile detector) cannot tell the difference.
    def counter(self, name: str) -> Counter:
        return self._fence(self.base.counter(self.scoped(name)))

    def gauge(self, name: str) -> Gauge:
        return self._fence(self.base.gauge(self.scoped(name)))

    def histogram(self, name: str, max_samples: int = 512) -> Histogram:
        # SLO bucket bounds are keyed by BASE family name: a labelled
        # serve.r0.ttft_s must carry the same exact native buckets as
        # serve.ttft_s or per-replica PromQL p99s silently degrade to
        # reservoir estimates
        return self._fence(self.base._get_or_create(
            self.scoped(name), Histogram, max_samples=max_samples,
            bucket_bounds=SLO_BUCKET_BOUNDS.get(name),
        ))

    def get(self, name: str):
        return self.base.get(self.scoped(name))

    def histogram_sum(self, name: str) -> float:
        return self.base.histogram_sum(self.scoped(name))

    def set_gauges(self, prefix: str, values: Dict[str, Any]) -> None:
        for k, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(f"{prefix}.{k}").set(v)

    def items_snapshot(self) -> List[tuple]:
        return self.base.items_snapshot()

    def rank(self) -> int:
        return self.base.rank()


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem emits into."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = MetricsRegistry()
    return _GLOBAL


def set_registry(registry: Optional[MetricsRegistry]) -> Optional[MetricsRegistry]:
    """Swap the global registry (tests); returns the previous one."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, registry
    return prev

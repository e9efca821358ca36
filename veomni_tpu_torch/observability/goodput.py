"""Goodput accounting: where did the wall time go?

``GoodputTracker`` decomposes a window of wall time into named categories
by delta-ing the cumulative sums of the span histograms the trainer feeds
(``trainer/base.py`` wraps its loop phases in spans):

* ``data_wait``  — blocked on the input pipeline (``data.wait``)
* ``host``       — callback hooks: meters, logging, eval (``host.callbacks``,
                   minus the checkpoint time nested inside them)
* ``dispatch``   — handing work to the device: jitted step dispatch + H2D
                   batch shipping (``step.dispatch``, ``data.ship``)
* ``checkpoint`` — save/restore/wait (``ckpt.save``, ``ckpt.wait``,
                   ``ckpt.restore``)
* ``other``      — the residual; on the async loop this is dominated by the
                   sync-step device fetch, i.e. time the device was the
                   bottleneck — which is exactly where a training run
                   *wants* to spend its time.

``goodput_pct`` is therefore ``100 * (dispatch + other)`` fractions: the
share of wall time not attributable to a known host-side stall. The TPUv4
pjit paper's goodput accounting and T3's step-time tracking (PAPERS.md)
motivate making this a first-class per-window metric rather than a
profiler-session artifact.

Also here: live device-memory gauges and the recompile detector that
extends the decode/serving ``TRACE_COUNTS`` discipline to the train step.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# category -> span names whose histogram sums it aggregates
CATEGORY_SPANS: Dict[str, Tuple[str, ...]] = {
    "data_wait": ("data.wait",),
    "host": ("host.callbacks",),
    "dispatch": ("step.dispatch", "data.ship"),
    "checkpoint": ("ckpt.save", "ckpt.wait", "ckpt.restore"),
}
# checkpoint saves run inside the on_step_end callback hook, so their time
# is nested inside the host category's span and must be subtracted once
_NESTED_IN_HOST = "checkpoint"


class GoodputTracker:
    """Window-delta decomposition over the span histograms.

    ``begin_window()`` snapshots the cumulative span sums; ``end_window()``
    returns the fractions for the elapsed window (and starts the next one).
    Fractions always sum to ~1.0: the residual is ``other``, and if measured
    categories exceed the wall (overlapping spans on several threads) the
    set is renormalized."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 categories: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.registry = registry or get_registry()
        self.categories = dict(categories or CATEGORY_SPANS)
        self._t0: Optional[float] = None
        self._base: Dict[str, float] = {}

    def _sums(self) -> Dict[str, float]:
        return {
            cat: sum(self.registry.histogram_sum(f"span.{n}") for n in names)
            for cat, names in self.categories.items()
        }

    def begin_window(self) -> None:
        self._t0 = time.perf_counter()
        self._base = self._sums()

    def end_window(self) -> Dict[str, float]:
        """Close the window -> metric dict; re-arms for the next window."""
        if self._t0 is None:
            self.begin_window()
            return {}
        now = time.perf_counter()
        wall = max(now - self._t0, 1e-9)
        cur = self._sums()
        deltas = {c: max(0.0, cur[c] - self._base.get(c, 0.0)) for c in cur}
        if _NESTED_IN_HOST in deltas and "host" in deltas:
            deltas["host"] = max(0.0, deltas["host"] - deltas[_NESTED_IN_HOST])
        fracs = {c: d / wall for c, d in deltas.items()}
        known = sum(fracs.values())
        if known > 1.0:
            fracs = {c: f / known for c, f in fracs.items()}
            known = 1.0
        fracs["other"] = 1.0 - known
        out = {f"{c}_frac": f for c, f in fracs.items()}
        out["goodput_pct"] = 100.0 * (fracs["dispatch"] + fracs["other"])
        out["window_wall_s"] = wall
        self._t0, self._base = now, cur
        return out


def update_memory_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    """Publish the ``mem.*`` gauges (``observability/devmem.py::
    publish_memory_gauges``): per-card allocated bytes and their peak where
    a card is in use, host RSS, and the high watermark, so the family is
    live on CPU runs too."""
    from veomni_tpu_torch.observability.devmem import publish_memory_gauges

    publish_memory_gauges(registry or get_registry())


class RecompileDetector:
    """Watches trace-count dicts (``train/train_step.py::TRACE_COUNTS``,
    ``models/decode.py::TRACE_COUNTS``) and raises a loud rank-0 warning —
    with the offending shapes — when XLA re-traces after the warmup
    compiles were absorbed by :meth:`arm`.

    A recompile storm (every step re-tracing, e.g. dynamic batching without
    shape bucketing) silently multiplies step time; the detector turns it
    into one unmissable log line + a ``recompiles`` counter instead of a
    mystery utilization cliff."""

    def __init__(self, count_sources: Sequence[Tuple],
                 shape_source: Optional[Mapping[str, Any]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 storm_threshold: int = 3):
        """``count_sources``: ``(label, mapping)`` or ``(label, mapping,
        keys)`` tuples; ``keys`` restricts which entries of a live
        TRACE_COUNTS dict are watched (the trainer watches only
        ``train_step`` — a first eval jit or a new decode bucket is a fresh
        program, not a recompile)."""
        self.count_sources = [
            (s[0], s[1], tuple(s[2]) if len(s) > 2 and s[2] else None)
            for s in count_sources
        ]
        self.shape_source = shape_source
        self.registry = registry or get_registry()
        self.storm_threshold = storm_threshold
        self._base: Dict[str, int] = {}
        self._armed = False
        self.total_recompiles = 0

    def _totals(self) -> Dict[str, int]:
        return {
            label: sum(
                v for k, v in counts.items() if keys is None or k in keys
            )
            for label, counts, keys in self.count_sources
        }

    def arm(self) -> None:
        """Snapshot current counts as the expected-compile baseline (call
        after the first step, once warmup traces have happened)."""
        self._base = self._totals()
        self._armed = True

    def check(self) -> int:
        """New traces since the last arm/check; warns (rank 0) if any."""
        if not self._armed:
            self.arm()
            return 0
        cur = self._totals()
        new = {
            label: cur[label] - self._base.get(label, 0)
            for label in cur
            if cur[label] > self._base.get(label, 0)
        }
        self._base = cur
        n = sum(new.values())
        if not n:
            return 0
        self.total_recompiles += n
        self.registry.counter("recompiles").inc(n)
        shapes = dict(self.shape_source) if self.shape_source else {}
        storm = self.total_recompiles >= self.storm_threshold
        logger.warning_rank0(
            "RECOMPILE%s: %d new XLA trace(s) (%s), %d total since warmup; "
            "last traced shapes: %s — recompiles at steady state usually "
            "mean unstable batch shapes (bucket them) or a jit signature "
            "drift (weak types, uncommitted scalars)",
            " STORM" if storm else "",
            n, ", ".join(f"{k}+{v}" for k, v in sorted(new.items())),
            self.total_recompiles, shapes,
        )
        return n

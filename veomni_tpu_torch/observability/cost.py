"""Program cost census: what each instrumented site costs the device.

Port of ``veomni_tpu/observability/cost.py``. The reference reads XLA's
``cost_analysis()`` and ``memory_analysis()`` of each compiled program;
eager torch has no compiled program to read, so the census keeps the
reference's data model and surfaces (:class:`ProgramCost`,
:class:`CostCensus`, :class:`CostWindow`, ``/debug/cost``, the ``cost.*``
registry families, ``VEOMNI_COST_CENSUS=0`` as the off switch) and measures
another way. :func:`instrument_site` wraps a call site (the train step, the
numerics step, the eval step, the serving engine's prefill and decode
buckets); on the first call of each (site, bucket), the bucket being the
input shapes, it runs the call under :class:`CountingMode`, a
``TorchDispatchMode`` that counts

* FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention), and
* bytes as each op's input plus output bytes (views and allocations move
  none), and
* the collectives (``c10d`` ops) by kind and result bytes, into the
  collective census (``observability/comm.py``) and ``comm_bytes``,

and records the call's wall as ``compile_s`` and, when the call raised the
card's allocator peak, that peak above what was allocated before it as
``temp_bytes`` (else ``temp_bytes`` stays unknown: the pass reads the
process-wide peak counter and never resets it). Every later call only
bumps ``calls``. A bucket is counted once a census for each ``program``,
the identity of what a site computes: the serving engine names its model
config and quantization, so a second engine or a respawned replica of the
same model reaching a bucket another one counted only notes its calls; a
site that names none counts its own buckets. A new program at a counted
(site, bucket) re-records it, as the reference re-records a recompile. The hand kernels K1-K6 launch through ctypes, below
the dispatcher, so each wrapper reports its own FLOPs and bytes
(:func:`note_kernel`), by the formulas of the Bound column of
``PERF.md``'s kernel table; without them the census would undercount
attention. A pass listens process-wide (the backward runs on the autograd
engine's thread), so a kernel another thread launches meanwhile, on a
serving replica's pump thread say, counts into it.

The counting pass slows the first call of each bucket by a Python
dispatch of each op, where the reference pays an XLA compile it runs
anyway. So the trainer's sites count always (a handful of
buckets, and its MFU window reads them), while an ``on_demand`` site, the
serving engine's, counts a new bucket only while a reader of the census
is open (:func:`open_reader`: a running :class:`MetricsExporter`, which
serves ``/debug/cost`` and the ``cost.*`` families); with none open the
serving hot path pays nothing.

Failure policy as the reference's (``:30-35``): the census must never cost
a training step. A failure of the measuring itself logs one warning and
turns the site into a plain call; a failure of the call it wraps (a kernel
that does not build or launch, an out-of-memory) raises as it would
unwrapped, and is never re-run.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from veomni_tpu_torch.observability.comm import (
    CommCount,
    collective_bytes,
    collective_kind,
    comm_census_enabled,
    get_comm_census,
    peak_interconnect_bandwidth,
)
from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def census_enabled() -> bool:
    """``VEOMNI_COST_CENSUS=0`` turns :func:`instrument_site` into identity."""
    return os.environ.get("VEOMNI_COST_CENSUS", "1") not in ("0", "")


def device_peaks() -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of the card in use; None without a card whose
    peaks are published (the window then reports achieved rates only)."""
    if not torch.cuda.is_available():
        return None
    from veomni_tpu_torch.utils.device import get_device_peak_bandwidth, get_device_peak_flops

    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        return get_device_peak_flops(dev), get_device_peak_bandwidth(dev)
    except ValueError:
        return None


@dataclass
class ProgramCost:
    """One (site, bucket)'s census record. ``kernel_flops``/``kernel_bytes``
    are the part the hand kernels reported."""

    site: str
    bucket: str
    flops: float = 0.0
    bytes_accessed: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    temp_bytes: Optional[float] = None  # None: the pass could not see the peak
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    comm_bytes: float = 0.0  # collective result bytes (observability/comm.py)
    compile_time_s: float = 0.0
    num_devices: int = 1
    calls: int = 0
    traces: int = 0
    _call_counter: Any = field(default=None, repr=False)
    _stamp: int = field(default=0, repr=False)
    _program: Any = field(default=None, repr=False)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in FLOPs/byte (0 when bytes unknown)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed else 0.0

    def bound(self) -> str:
        """Roofline verdict: ``compute`` | ``bandwidth`` | ``unknown`` (no
        counts, or no card with published peaks)."""
        peaks = device_peaks()
        if not self.flops or not self.bytes_accessed or peaks is None:
            return "unknown"
        return "compute" if self.flops / peaks[0] >= self.bytes_accessed / peaks[1] \
            else "bandwidth"

    def to_doc(self) -> Dict[str, Any]:
        return {
            "site": self.site,
            "bucket": self.bucket,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "kernel_flops": self.kernel_flops,
            "kernel_bytes": self.kernel_bytes,
            "temp_bytes": self.temp_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "comm_bytes": self.comm_bytes,
            "compile_time_s": self.compile_time_s,
            "num_devices": self.num_devices,
            "calls": self.calls,
            "traces": self.traces,
            "intensity_flops_per_byte": self.intensity,
            "bound": self.bound(),
        }


class CostCensus:
    """Thread-safe (site, bucket) -> :class:`ProgramCost` map: ``record``
    once per bucket (it also publishes the ``cost.*`` families),
    ``note_call`` on every call."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, str], ProgramCost] = {}
        self._claimed: set = set()  # (site, bucket, program) measured or being measured
        self._registry = registry
        self._stamp = 0

    def _reg(self) -> MetricsRegistry:
        return self._registry or get_registry()

    def record(self, site: str, bucket: str, *, compile_time_s: float = 0.0,
               num_devices: int = 1, program: Hashable = None,
               **fields: Optional[float]) -> ProgramCost:
        """Register one measured bucket of ``program``; re-recording keeps
        the call count, adds the measuring time and overwrites the counts
        and the program."""
        reg = self._reg()
        with self._lock:
            rec = self._programs.get((site, bucket))
            fresh = rec is None
            if fresh:
                rec = ProgramCost(site=site, bucket=bucket)
                self._programs[(site, bucket)] = rec
            for k, v in fields.items():
                if hasattr(rec, k):
                    setattr(rec, k, None if v is None else float(v))
            rec.compile_time_s += float(compile_time_s)
            rec.num_devices = max(1, int(num_devices))
            rec._program = program
            rec.traces += 1
            self._stamp += 1
            rec._stamp = self._stamp
            if rec._call_counter is None:
                rec._call_counter = reg.counter(f"cost.{site}.{bucket}.calls")
        prefix = f"cost.{site}.{bucket}"
        reg.gauge(f"{prefix}.flops").set(rec.flops)
        reg.gauge(f"{prefix}.bytes_accessed").set(rec.bytes_accessed)
        if rec.temp_bytes is not None:
            reg.gauge(f"{prefix}.temp_bytes").set(rec.temp_bytes)
        reg.gauge(f"{prefix}.argument_bytes").set(rec.argument_bytes)
        reg.gauge(f"{prefix}.output_bytes").set(rec.output_bytes)
        reg.gauge(f"{prefix}.compile_s").set(rec.compile_time_s)
        if fresh:
            reg.counter("cost.programs").inc()
        reg.histogram("cost.compile_s").observe(compile_time_s)
        logger.info_rank0(
            "cost census: %s/%s measured in %.3gs — %.3g GFLOPs (%.3g by the hand kernels), "
            "%.3g MB accessed, %s MB temp (%s-bound)",
            site, bucket, compile_time_s, rec.flops / 1e9, rec.kernel_flops / 1e9,
            rec.bytes_accessed / 1e6,
            "unknown" if rec.temp_bytes is None else f"{rec.temp_bytes / 1e6:.3g}", rec.bound(),
        )
        return rec

    def claim(self, site: str, bucket: str, program: Hashable, *,
              measure: bool = True) -> bool:
        """One call of (site, bucket) by ``program``: True when the caller
        is to measure it (the program's first call there in this census,
        when ``measure``); otherwise the call is noted on the bucket's
        record if the record is this program's. A bucket being measured on
        another thread has no record yet: its calls meanwhile go
        uncounted."""
        with self._lock:
            rec = self._programs.get((site, bucket))
            if rec is None or rec._program != program:
                key = (site, bucket, program)
                if measure and key not in self._claimed:
                    self._claimed.add(key)
                    return True
                return False
            rec.calls += 1
            counter = rec._call_counter
        if counter is not None:
            counter.inc()
        return False

    def note_call(self, site: str, bucket: str) -> None:
        with self._lock:
            rec = self._programs.get((site, bucket))
            if rec is None:
                return
            rec.calls += 1
            counter = rec._call_counter
        if counter is not None:
            counter.inc()

    def get(self, site: str, bucket: str) -> Optional[ProgramCost]:
        with self._lock:
            return self._programs.get((site, bucket))

    def latest(self, site: str) -> Optional[ProgramCost]:
        """The most recently recorded bucket of a site."""
        with self._lock:
            out = None
            for (s, _b), rec in self._programs.items():
                if s == site and (out is None or rec._stamp > out._stamp):
                    out = rec
            return out

    def programs(self, site: Optional[str] = None) -> List[ProgramCost]:
        with self._lock:
            return [rec for (s, _b), rec in self._programs.items() if site is None or s == site]

    def call_counts(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return {k: rec.calls for k, rec in self._programs.items()}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready census for ``/debug/cost`` and post-mortems."""
        progs = [rec.to_doc() for rec in self.programs()]
        return {
            "programs": progs,
            "totals": {
                "programs": len(progs),
                "compile_time_s": sum(p["compile_time_s"] for p in progs),
                "calls": sum(p["calls"] for p in progs),
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._claimed.clear()


_GLOBAL: Optional[CostCensus] = None
_GLOBAL_LOCK = threading.Lock()


def get_cost_census() -> CostCensus:
    """The process-wide census every instrumented site records into."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = CostCensus()
    return _GLOBAL


_READERS = 0  # guarded-by: _READERS_LOCK
_READERS_LOCK = threading.Lock()


def open_reader() -> None:
    """A reader of the census came up (a :class:`MetricsExporter`): while
    one is open, the ``on_demand`` sites measure their new buckets."""
    global _READERS
    with _READERS_LOCK:
        _READERS += 1


def close_reader() -> None:
    global _READERS
    with _READERS_LOCK:
        _READERS = max(0, _READERS - 1)


def readers_open() -> bool:
    return _READERS > 0


#: sites the MFU window ignores by default: the numerics sibling re-runs a
#: batch the train step's site already counted
DIAGNOSTIC_SITES: Tuple[str, ...] = ("numerics_step",)


class CostWindow:
    """Census-delta MFU/bandwidth over a wall-clock window (``:461-547``):
    ``begin()`` snapshots the call counts; ``end()`` multiplies each
    bucket's new calls by its census FLOPs/bytes and divides by the wall and
    the card's peaks; on the CPU there are none, and the window reports
    achieved rates with 0 utilization. ``comm_est_frac`` is the share of the
    wall the buckets' collectives would take unhidden at the peak link
    bandwidth (``observability/comm.py``)."""

    def __init__(self, census: Optional[CostCensus] = None,
                 sites: Optional[Tuple[str, ...]] = None,
                 exclude_sites: Optional[Tuple[str, ...]] = DIAGNOSTIC_SITES):
        self.census = census or get_cost_census()
        self.sites = tuple(sites) if sites else None
        self.exclude_sites = tuple(exclude_sites) if exclude_sites else ()
        self._t0: Optional[float] = None
        self._base: Dict[Tuple[str, str], int] = {}

    def begin(self) -> None:
        self._t0 = time.perf_counter()
        self._base = self.census.call_counts()

    def end(self) -> Dict[str, float]:
        """Close the window -> metric dict; re-arms for the next window."""
        if self._t0 is None:
            self.begin()
            return {}
        now = time.perf_counter()
        wall = max(now - self._t0, 1e-9)
        cur = self.census.call_counts()
        flops = bytes_acc = comm = 0.0
        ran = 0
        for key, calls in cur.items():
            if self.sites is not None and key[0] not in self.sites:
                continue
            if self.sites is None and key[0] in self.exclude_sites:
                continue
            delta = calls - self._base.get(key, 0)
            if delta <= 0:
                continue
            ran += delta
            rec = self.census.get(*key)
            if rec is not None:
                flops += delta * rec.flops
                bytes_acc += delta * rec.bytes_accessed
                comm += delta * rec.comm_bytes
        if not ran:
            # no instrumented call: no utilization statement (the train-end
            # window must not overwrite the last real window's gauges)
            self._t0, self._base = now, cur
            return {}
        peaks = device_peaks()
        peak_flops, peak_bw = peaks if peaks is not None else (float("inf"), float("inf"))
        out = {
            "mfu_pct": 100.0 * flops / wall / peak_flops,
            "bandwidth_util_pct": 100.0 * bytes_acc / wall / peak_bw,
            "census_tflops_s": flops / wall / 1e12,
            "census_window_s": wall,
            "comm_est_frac": min(1.0, comm / peak_interconnect_bandwidth() / wall),
        }
        self._t0, self._base = now, cur
        return out


_DEBUG_WINDOW: Optional[CostWindow] = None
_DEBUG_LOCK = threading.Lock()


def debug_cost_doc() -> Dict[str, Any]:
    """``/debug/cost`` body: the census plus a scrape-to-scrape MFU window
    (the first scrape arms it and reports an empty window)."""
    global _DEBUG_WINDOW
    census = get_cost_census()
    with _DEBUG_LOCK:
        if _DEBUG_WINDOW is None:
            _DEBUG_WINDOW = CostWindow(census)
        live = _DEBUG_WINDOW.end()
    doc = census.snapshot()
    doc["live"] = live
    return doc


# ---------------------------------------------------------------- counting
#: ops that move no data: allocations without a fill
_NO_BYTES = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
             "aten::new_empty_strided", "aten::resize_", "aten::set_"}


#: composite ops (no kernel of their own) whose products the flop formulas
#: see only in their decomposition
_DECOMPOSE = {"aten::matmul", "aten::einsum", "aten::linear", "aten::tensordot",
              "aten::bilinear"}


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in nested tuples, lists and dicts (an op's
    arguments and results; a plain walk, several times cheaper than a pytree
    flatten on the counting pass's every op)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class CountingMode(TorchDispatchMode):
    """Counts the FLOPs (``torch.utils.flop_counter``'s formulas) and bytes
    (inputs plus outputs of each op that moves data) of the ops dispatched
    under it, plus what the hand kernels report through
    :func:`note_kernel` while it is the active count."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.comm = CommCount() if comm_census_enabled() else None
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = collective_kind(func)
        if kind is not None:  # communication, not device-memory traffic
            if self.comm is not None:
                self.comm.add(kind, collective_bytes(func, args))
            return func(*args, **kwargs)
        fn = self._registry.get(func.overloadpacket)
        if func._schema.name in _DECOMPOSE:
            # under no_grad/inference mode these composites reach the mode
            # whole; they have no kernel of their own, so running their
            # decomposition is what dispatch would do: count its ops
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.is_view or func._schema.name in _NO_BYTES:
            return out
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        with self._lock:  # the backward may run on the autograd engine's thread
            self.flops += flops
            self.bytes += nbytes
        return out

    def note_kernel(self, flops: float, nbytes: float) -> None:
        with self._lock:
            self.kernel_flops += flops
            self.kernel_bytes += nbytes


_COUNTING: Optional[CountingMode] = None  # guarded-by: _COUNTING_LOCK
_COUNTING_LOCK = threading.Lock()


def note_kernel(work: Callable[[], Tuple[float, float]]) -> None:
    """A hand kernel's launch into the active counting pass: ``work()``
    gives its (FLOPs, bytes). It runs only while a pass listens (reckoning
    may read the segment ids on the host), outside the dispatch mode, so
    its own ops are not counted."""
    from torch.utils._python_dispatch import _disable_current_modes

    mode = _COUNTING
    if mode is None:
        return
    with _disable_current_modes():
        flops, nbytes = work()
    mode.note_kernel(flops, nbytes)


def batch_bucket(batch: Dict[str, Any]) -> str:
    """Census bucket of a step batch: the shape of its first tensor leaf
    (``train_step.py::_batch_bucket``)."""
    for v in batch.values():
        shape = getattr(v, "shape", None)
        if shape:
            return "x".join(str(int(d)) for d in shape)
    return f"leaves{len(batch)}"


_SITE_IDS = itertools.count()


class InstrumentedSite:
    """A call site whose buckets are counted into the census, each once a
    census for its ``program`` (by default the site's own), and whose calls
    are noted (see the module docstring). An ``on_demand`` site measures a
    new bucket only while a reader is open."""

    def __init__(self, site: str, fn: Callable, *,
                 bucket_fn: Optional[Callable[[tuple], str]] = None,
                 census: Optional[CostCensus] = None, on_demand: bool = False,
                 program: Hashable = None):
        self._site = site
        self._fn = fn
        self._bucket_fn = bucket_fn
        self._census_ref = census
        self._on_demand = on_demand
        self._program = program if program is not None else ("site", next(_SITE_IDS))
        self._disabled = False

    @property
    def _census(self) -> CostCensus:
        return self._census_ref or get_cost_census()

    def _disable(self, why: str, exc: Exception) -> None:
        self._disabled = True
        logger.warning_rank0(
            "cost census disabled for site %r (%s: %s: %s); the run continues census-blind",
            self._site, why, type(exc).__name__, exc)

    def __call__(self, *args, **kwargs):
        if self._disabled:
            return self._fn(*args, **kwargs)
        try:
            bucket = str(self._bucket_fn(args)) if self._bucket_fn else "call"
        except Exception as e:  # noqa: BLE001 - the census must never cost a step
            self._disable("bucket", e)
            return self._fn(*args, **kwargs)
        measure = not self._on_demand or readers_open()
        if self._census.claim(self._site, bucket, self._program, measure=measure):
            return self._measure(bucket, args, kwargs)
        return self._fn(*args, **kwargs)

    def _measure(self, bucket: str, args, kwargs):
        global _COUNTING
        try:
            mode = CountingMode()
            dev = _cuda_device(args)
            if dev is not None:
                torch.cuda.synchronize(dev)
                stats = torch.cuda.memory_stats(dev)
                base = stats["allocated_bytes.all.current"]
                peak0 = stats["allocated_bytes.all.peak"]
        except Exception as e:  # noqa: BLE001
            self._disable("setup", e)
            return self._fn(*args, **kwargs)
        with _COUNTING_LOCK:
            busy = _COUNTING is not None
            if not busy:
                _COUNTING = mode
        t0 = time.perf_counter()
        try:
            with mode:
                out = self._fn(*args, **kwargs)
            if dev is not None:
                torch.cuda.synchronize(dev)
        finally:
            if not busy:
                with _COUNTING_LOCK:
                    _COUNTING = None
        dt = time.perf_counter() - t0
        try:
            # the peak counter is the process's: only a call that raised it
            # shows its own peak
            peak = torch.cuda.max_memory_allocated(dev) if dev is not None else 0
            temp = peak - base if dev is not None and peak > peak0 else None
            comm = mode.comm.fields() if mode.comm is not None else {}
            self._census.record(
                self._site, bucket, compile_time_s=dt, program=self._program,
                flops=mode.flops + mode.kernel_flops,
                bytes_accessed=mode.bytes + mode.kernel_bytes,
                kernel_flops=mode.kernel_flops, kernel_bytes=mode.kernel_bytes,
                temp_bytes=temp, argument_bytes=_tensor_bytes(args),
                output_bytes=_tensor_bytes(out), comm_bytes=comm.get("comm_bytes", 0.0))
            if comm.get("collectives"):
                get_comm_census().record(self._site, bucket, num_devices=_world_size(), **comm)
            self._census.note_call(self._site, bucket)
        except Exception as e:  # noqa: BLE001
            self._disable("record", e)
        return out


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _cuda_device(args) -> Optional[torch.device]:
    leaves, _ = tree_flatten(args)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    for t in leaves:  # a train state: its model's parameters
        model = getattr(t, "model", None)
        if model is not None:
            p = next(model.parameters(), None)
            return p.device if p is not None and p.is_cuda else None
    return None


def instrument_site(site: str, fn: Callable, *,
                    bucket_fn: Optional[Callable[[tuple], str]] = None,
                    census: Optional[CostCensus] = None, on_demand: bool = False,
                    program: Hashable = None) -> Callable:
    """Wrap a call site so its buckets land in the cost census. Identity
    when ``VEOMNI_COST_CENSUS=0``."""
    if not census_enabled():
        return fn
    return InstrumentedSite(site, fn, bucket_fn=bucket_fn, census=census, on_demand=on_demand,
                            program=program)

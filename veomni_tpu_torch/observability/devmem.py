"""Live device-memory accounting: buffer census, watermarks, OOM forensics.

Port of ``veomni_tpu/observability/devmem.py`` (``:51-260``).
``kv_capacity_stats`` lives in ``serving/engine.py``.

* :func:`buffer_census` — torch has no ``jax.live_arrays()``, so the census
  walks ``gc.get_objects()`` for tensors and counts each storage once (by
  its ``untyped_storage()`` data pointer): a view, a slice or a parameter
  and its ``.data`` share one storage and are one buffer. The walk is slow
  (every object of the process), so it runs on demand (``/debug/memory``)
  and on an out-of-memory error, never each step.
* :func:`publish_memory_gauges` — the ``mem.*`` family each sync step:
  per card ``bytes_in_use`` (``torch.cuda.memory_allocated``) and
  ``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``), the host
  RSS (live on every device), and a process-lifetime high watermark of the
  cards' peaks.
* :func:`is_resource_exhausted` / :func:`oom_report` — the post-mortem hook:
  a ``torch.cuda.OutOfMemoryError`` (or an allocator message) escaping the
  train loop or the serving pump gains the buffer census and the cost
  census.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Dict, Optional

import torch

from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from veomni_tpu_torch.utils.helper import host_rss_bytes, live_memory_stats
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_WATERMARK_LOCK = threading.Lock()
_WATERMARK = {"bytes": 0.0}


def buffer_census(top_k: int = 10) -> Dict[str, Any]:
    """Every live tensor storage aggregated by (device, dtype, shape of the
    first tensor seen on it): ``{total_bytes, num_arrays, by_dtype: {dtype:
    {count, bytes}}, top: [{shape, dtype, device, count, bytes}, ...]}``,
    ``top`` sorted by bytes descending and cut to ``top_k``. A storage
    counts once, whatever views of it are alive; its bytes are the
    storage's, not a view's."""
    seen: Dict[tuple, tuple] = {}
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: some objects answer isinstance through
            # a deprecated __class__ property that warns
            if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
                continue
            st = obj.untyped_storage()
            key = (str(obj.device), st.data_ptr())
            if key in seen or st.data_ptr() == 0:
                continue
            seen[key] = (tuple(obj.shape), str(obj.dtype).removeprefix("torch."),
                         str(obj.device), float(st.nbytes()))
        except (RuntimeError, TypeError, ReferenceError):  # a sparse or dead tensor
            continue
    groups: Dict[tuple, Dict[str, Any]] = {}
    by_dtype: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for shape, dtype, device, nbytes in seen.values():
        total += nbytes
        g = groups.setdefault((shape, dtype, device), {
            "shape": list(shape), "dtype": dtype, "device": device, "count": 0, "bytes": 0.0})
        g["count"] += 1
        g["bytes"] += nbytes
        d = by_dtype.setdefault(dtype, {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += nbytes
    top = sorted(groups.values(), key=lambda g: -g["bytes"])[:max(0, top_k)]
    return {"total_bytes": total, "num_arrays": len(seen), "by_dtype": by_dtype, "top": top}


def live_buffer_bytes() -> float:
    """Sum of the live tensor storages' bytes (the census walk)."""
    return buffer_census(top_k=0)["total_bytes"]


def reset_watermark() -> None:
    """Tests only: forget the process-lifetime high watermark."""
    with _WATERMARK_LOCK:
        _WATERMARK["bytes"] = 0.0


def publish_memory_gauges(registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Refresh the ``mem.*`` family; returns what was published: the cards'
    ``device{i}_bytes_in_use`` / ``device{i}_peak_bytes_in_use`` (where a
    card is in use), ``host_rss_bytes`` and ``high_watermark_bytes`` (the
    largest summed card peak seen by this process)."""
    reg = registry or get_registry()
    stats = dict(live_memory_stats())
    peak_total = sum(v for k, v in stats.items() if k.endswith("peak_bytes_in_use"))
    with _WATERMARK_LOCK:
        _WATERMARK["bytes"] = max(_WATERMARK["bytes"], peak_total)
        stats["high_watermark_bytes"] = _WATERMARK["bytes"]
    reg.set_gauges("mem", stats)
    return stats


def debug_memory_doc(memory_fn=None, top_k: int = 10) -> Dict[str, Any]:
    """``/debug/memory`` body: the buffer census, the card's allocator
    readings, the watermark (+ the caller's pool-capacity document: the
    serving engine passes its ``kv_capacity``)."""
    doc: Dict[str, Any] = {"buffer_census": buffer_census(top_k=top_k)}
    doc["host_rss_bytes"] = host_rss_bytes()
    doc["device"] = {k: v for k, v in live_memory_stats().items() if k.startswith("device")}
    with _WATERMARK_LOCK:
        doc["high_watermark_bytes"] = _WATERMARK["bytes"]
    if memory_fn is not None:
        try:
            doc["pool"] = dict(memory_fn())
        except Exception as e:  # noqa: BLE001 - a broken scrape must not 500 the census
            doc["pool"] = {"error": str(e)}
    return doc


_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory", "OutOfMemoryError")


def is_resource_exhausted(exc: BaseException) -> bool:
    """A device allocator failure: ``torch.cuda.OutOfMemoryError``, or an
    exception whose message carries the allocator's words (so fault-injected
    drills and real failures take one path)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def attach_oom_extra(exc: BaseException, extra: Dict[str, Any]) -> Dict[str, Any]:
    """Merge :func:`oom_report` into a post-mortem ``extra`` dict when the
    exception is an allocator failure; otherwise a no-op. Never raises."""
    try:
        if is_resource_exhausted(exc):
            extra.update(oom_report())
    except Exception as forensic_err:  # noqa: BLE001
        extra["oom_report_error"] = str(forensic_err)
    return extra


def oom_report(top_k: int = 10) -> Dict[str, Any]:
    """The post-mortem payload for an OOM: the buffer census (what held the
    memory), the cards' allocator readings and the cost census (what each
    instrumented site needs on top). Never raises."""
    out: Dict[str, Any] = {}
    try:
        out["buffer_census"] = buffer_census(top_k=top_k)
    except Exception as e:  # noqa: BLE001
        out["buffer_census"] = {"error": str(e)}
    try:
        out["memory"] = live_memory_stats()
    except Exception as e:  # noqa: BLE001
        out["memory"] = {"error": str(e)}
    try:
        from veomni_tpu_torch.observability.cost import get_cost_census

        out["cost_census"] = get_cost_census().snapshot()
    except Exception as e:  # noqa: BLE001
        out["cost_census"] = {"error": str(e)}
    return out

"""Numerics & training-health observatory: per-layer-group telemetry with
non-finite provenance.

Port of ``veomni_tpu/observability/numerics.py`` (``:72-463``). The
reference computes :func:`tree_health` inside an instrumented sibling of
its jitted train step; the port's eager step
(``train/train_step.py::build_train_step(numerics_spec=...)``) calls it on
the steps it is due, on the card, and :class:`NumericsMonitor` fetches the
whole summary in one host copy.

Groups are keyed by the reference's leaf paths
(``models/jax_weights.py::reference_leaves``): a stacked leaf's per-layer
parameters are stacked back into the reference's ``[L, ...]`` leaf, so a
group's name and its per-layer vectors are the reference's. A leaf is
"stacked" for the statistics where a component of its path ends in
``layers`` (``_is_stacked``, ``:113``), as in the reference: a VLM tower's
``blocks`` are reduced to scalars there, and so here.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from veomni_tpu_torch.observability.flight_recorder import record as flight_record
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: merged overflow bucket when the cardinality cap still can't hold every
#: coarsened group name (deterministic: the sorted tail lands here)
REST_GROUP = "...rest"

#: provenance priority: a non-finite PARAM is upstream of every grad, and a
#: non-finite grad is upstream of the update it produces
PROVENANCE_KINDS = ("param", "grad", "update")

#: a leaf value: the reference's leaf, or the list of its per-layer tensors
LeafValue = Union[torch.Tensor, List[torch.Tensor]]


@dataclass(frozen=True)
class NumericsSpec:
    """Configuration of the health summary."""

    max_groups: int = 64
    eps: float = 1e-12


def _is_stacked(path: str) -> bool:
    """Per-layer statistics: some path component ends in ``layers``."""
    return any(part.endswith("layers") for part in path.split("."))


def build_groups(paths: Sequence[str], max_groups: int = 64) -> List[Tuple[str, List[int]]]:
    """Deterministic (name, member-leaf-indices) groups for the dotted leaf
    paths, cardinality-capped: start at leaf granularity; while over the
    cap, drop the trailing path component; if depth 1 still exceeds it,
    the sorted tail merges into :data:`REST_GROUP`."""
    max_groups = max(1, max_groups)
    names = list(paths)
    depth = max((n.count(".") + 1 for n in names), default=1)
    while depth > 1 and len(set(names)) > max_groups:
        depth -= 1
        names = [".".join(n.split(".")[:depth]) for n in names]
    distinct = sorted(set(names))
    if len(distinct) > max_groups:
        keep = set(distinct[: max_groups - 1])
        names = [n if n in keep else REST_GROUP for n in names]
    groups: Dict[str, List[int]] = {}
    for i, n in enumerate(names):
        groups.setdefault(n, []).append(i)
    return sorted(groups.items())


def _as_leaf(value: LeafValue) -> torch.Tensor:
    return torch.stack(value) if isinstance(value, (list, tuple)) else value


def _leaf_stats(x: torch.Tensor, stacked: bool):
    """(sumsq, count, absmax, nonfinite) for one leaf in f32, reduced over
    every axis but the leading layer axis when ``stacked``."""
    x = x.float()
    per_layer = stacked and x.ndim >= 1
    axes = tuple(range(1, x.ndim)) if per_layer else tuple(range(x.ndim))
    shape = x.shape[1:] if per_layer else x.shape
    n = float(math.prod(shape))
    finite = torch.isfinite(x)
    safe = torch.where(finite, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def red(fn, t):
        return fn(t, dim=axes) if axes else t

    return (
        red(torch.sum, safe * safe),
        torch.full((x.shape[0],) if per_layer else (), n, dtype=torch.float32, device=x.device),
        red(torch.amax, safe.abs()),
        red(torch.sum, (~finite).float()),
    )


def _dtype_max(dtypes) -> float:
    """Smallest finite max across the group's float dtypes; f32's if none."""
    best = None
    for dt in dtypes:
        if not dt.is_floating_point:
            continue
        m = float(torch.finfo(dt).max)
        if best is None or m < best:
            best = m
    return best if best is not None else float(torch.finfo(torch.float32).max)


def tree_health(paths: Sequence[str], params: Sequence[LeafValue], grads: Sequence[LeafValue],
                updates: Sequence[LeafValue], *, max_groups: int = 64,
                eps: float = 1e-12) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-group training-health summary (``tree_health``, ``:163``):
    ``{group: {stat: tensor}}``, per-layer vectors for stacked groups.

    ``paths[i]`` names the i-th reference leaf; ``params[i]``, ``grads[i]``
    and ``updates[i]`` hold its values (the leaf, or its per-layer tensors).
    Grad statistics read the token-normalized, mask-applied, pre-clip
    gradients; RMS and absmax count finite elements only, the non-finite
    ones are counted apart; ``overflow_margin_bits`` is ``log2(dtype_max /
    grad_absmax)`` of the group's narrowest float dtype."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    leaves = {"grad": grads, "param": params, "update": updates}
    for name, members in build_groups(paths, max_groups):
        stacked = all(_is_stacked(paths[i]) for i in members)
        if stacked:
            lens = {len(params[i]) if isinstance(params[i], (list, tuple))
                    else (params[i].shape[0] if params[i].ndim else 1) for i in members}
            stacked = len(lens) == 1
        acc = {}
        for kind, values in leaves.items():
            sumsq = cnt = absmax = nonfin = None
            for i in members:
                s, c, a, nf = _leaf_stats(_as_leaf(values[i]), stacked)
                sumsq = s if sumsq is None else sumsq + s
                cnt = c if cnt is None else cnt + c
                absmax = a if absmax is None else torch.maximum(absmax, a)
                nonfin = nf if nonfin is None else nonfin + nf
            acc[kind] = (sumsq, cnt, absmax, nonfin)
        g_sumsq, g_cnt, g_absmax, g_nonfin = acc["grad"]
        p_sumsq, p_cnt, _, p_nonfin = acc["param"]
        u_sumsq, u_cnt, _, u_nonfin = acc["update"]
        grad_rms = torch.sqrt(g_sumsq / torch.clamp(g_cnt, min=1.0))
        param_rms = torch.sqrt(p_sumsq / torch.clamp(p_cnt, min=1.0))
        update_rms = torch.sqrt(u_sumsq / torch.clamp(u_cnt, min=1.0))
        dtypes = [(params[i][0] if isinstance(params[i], (list, tuple)) else params[i]).dtype
                  for i in members]
        out[name] = {
            "grad_rms": grad_rms,
            "grad_absmax": g_absmax,
            "grad_nonfinite": g_nonfin,
            "param_rms": param_rms,
            "param_nonfinite": p_nonfin,
            "update_ratio": update_rms / (param_rms + eps),
            "update_nonfinite": u_nonfin,
            "overflow_margin_bits": (math.log2(_dtype_max(dtypes))
                                     - torch.log2(torch.clamp(g_absmax, min=eps))),
        }
    return out


#: per-stat worst-layer reduction the gauges publish for stacked groups
_GAUGE_REDUCE = {
    "grad_rms": max, "grad_absmax": max, "grad_nonfinite": max,
    "param_rms": max, "param_nonfinite": max, "update_ratio": max,
    "update_nonfinite": max,
    # margin: the layer CLOSEST to overflow is the one that matters
    "overflow_margin_bits": min,
}


class NumericsMonitor:
    """Host-side consumer of :func:`tree_health` outputs: ``observe`` (the
    interval cadence) rings and publishes worst-layer ``numerics.*``
    gauges; ``diagnose`` (the supervisor's anomaly re-run) also builds the
    non-finite provenance document. Thread-safe: the exporter's
    ``/debug/numerics`` reads from its own thread."""

    def __init__(self, history: int = 32, registry=None):
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=max(1, history))  # guarded-by: _lock
        self._registry = registry
        self.last_provenance: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        self.observed_steps = 0  # guarded-by: _lock

    def _reg(self):
        return self._registry or get_registry()

    @staticmethod
    def _to_doc(health) -> Dict[str, Dict[str, Any]]:
        """Health tree -> plain floats and lists in ONE device-to-host copy
        (the tensors flattened into one vector, split on the host)."""
        items = [(g, k, v) for g, stats in health.items() for k, v in stats.items()]
        if not items:
            return {}
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64) for _, _, v in items]).cpu()
        doc: Dict[str, Dict[str, Any]] = {}
        start = 0
        for group, stat, v in items:
            n = v.numel()
            vals = flat[start:start + n].tolist()
            start += n
            doc.setdefault(group, {})[stat] = vals[0] if v.ndim == 0 else vals
        return doc

    def observe(self, step: int, health) -> Dict[str, Dict[str, Any]]:
        """One interval summary: ring it and publish the gauges."""
        doc = self._to_doc(health)
        with self._lock:
            self._history.append({"step": int(step), "groups": doc})
            self.observed_steps += 1
        reg = self._reg()
        for group, stats in doc.items():
            for stat, val in stats.items():
                if isinstance(val, list):
                    val = _GAUGE_REDUCE.get(stat, max)(val) if val else 0.0
                reg.gauge(f"numerics.{group}.{stat}").set(val)
        reg.gauge("numerics.last_step").set(float(step))
        return doc

    @staticmethod
    def first_nonfinite(doc: Dict[str, Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """First offending (kind, group[, layer]): param before grad before
        update, groups in sorted order, a stacked group's first bad layer."""
        for kind in PROVENANCE_KINDS:
            for group in sorted(doc):
                nf = doc[group].get(f"{kind}_nonfinite", 0.0)
                vals = nf if isinstance(nf, list) else [nf]
                total = sum(vals)
                if total > 0:
                    out = {"group": group, "kind": kind, "nonfinite_count": float(total)}
                    if isinstance(nf, list):
                        out["layer"] = next(i for i, v in enumerate(vals) if v > 0)
                    return out
        return None

    def diagnose(self, step: int, health, injected: bool = False) -> Dict[str, Any]:
        """Build (and retain) the provenance document for an anomalous step
        re-run through the instrumented step."""
        doc = self._to_doc(health)
        first = self.first_nonfinite(doc)
        with self._lock:
            history = list(self._history)
        prov: Dict[str, Any] = {
            "step": int(step),
            "injected": bool(injected),
            "first_nonfinite": first,
            "groups": doc,
            "history": history,
        }
        with self._lock:
            self.last_provenance = prov
        reg = self._reg()
        reg.counter("numerics.diagnoses").inc()
        if first is not None:
            reg.counter("numerics.nonfinite_steps").inc()
            flight_record(
                "numerics.nonfinite", cid=str(step),
                group=first["group"], tensor_kind=first["kind"],
                layer=first.get("layer"), count=first["nonfinite_count"],
            )
            logger.warning_rank0(
                "NUMERICS: step %d first non-finite tensor is %s group %r%s "
                "(%d non-finite elements) — provenance retained for the "
                "post-mortem and /debug/numerics",
                step, first["kind"], first["group"],
                f" layer {first['layer']}" if "layer" in first else "",
                int(first["nonfinite_count"]),
            )
        else:
            flight_record("numerics.clean_diagnosis", cid=str(step), injected=injected)
            logger.warning_rank0(
                "NUMERICS: anomalous step %d re-ran clean — no non-finite "
                "tensor in grads/params/updates (host-injected drill, or a "
                "transient the re-run did not reproduce)", step,
            )
        return prov

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            history = list(self._history)
            prov = self.last_provenance
            observed = self.observed_steps
        return {
            "enabled": True,
            "observed_steps": observed,
            "latest": history[-1] if history else None,
            "history": history,
            "provenance": prov,
        }


_ACTIVE: Optional[NumericsMonitor] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = threading.Lock()


def set_active_monitor(monitor: Optional[NumericsMonitor]) -> Optional[NumericsMonitor]:
    """Install/uninstall the process's live monitor; returns the previous."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, monitor
    return prev


def get_active_monitor() -> Optional[NumericsMonitor]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def debug_numerics_doc() -> Dict[str, Any]:
    """``/debug/numerics`` body: the live monitor's snapshot, or a disabled
    stub naming the knob that turns the tier on."""
    mon = get_active_monitor()
    if mon is None:
        return {"enabled": False, "hint": "set train.observability_numerics_interval > 0"}
    return mon.snapshot()


def attach_numerics_extra(extra: Dict[str, Any]) -> None:
    """Fold the provenance/history into a post-mortem ``extra`` payload. No-op
    when the tier is off."""
    mon = get_active_monitor()
    if mon is None:
        return
    snap = mon.snapshot()
    if snap.get("provenance") or snap.get("latest"):
        extra["numerics"] = {"provenance": snap.get("provenance"),
                             "history": snap.get("history")}


@torch.no_grad()
def poison_param_group(module, pattern: str = "") -> str:
    """The ``step.params`` fault drill (``:437``): overwrite element
    ``(0, ..., 0)`` of the first float leaf of the reference's tree, in
    sorted-path order, whose path contains ``pattern`` (empty: the first),
    with NaN. For a stacked leaf that element is layer 0's. Returns the
    leaf's path, or "" when none matches."""
    from veomni_tpu_torch.models.jax_weights import reference_leaves

    for path, params, _ in sorted(reference_leaves(module), key=lambda leaf: leaf[0]):
        if (not pattern or pattern in path) and params[0].is_floating_point():
            params[0].view(-1)[0] = float("nan")
            return path
    return ""

"""Live collective census: what does each instrumented step communicate?

Port of ``veomni_tpu/observability/comm.py``. The reference parses the
optimized HLO of each compiled program for its collectives. Eager torch has
no program to parse, but every ``torch.distributed`` collective reaches the
dispatcher as a ``c10d`` op (FSDP2's all-gathers and reduce-scatters and
the parallel layer's own all-to-alls, all-reduces and ring sends alike), so
the cost census's counting pass (``observability/cost.py::CountingMode``)
sees them in the same pass that counts FLOPs (:class:`CommCount`). Per
(site, bucket), the cost census's keys:

* **bytes by collective kind** (all-reduce / all-gather / reduce-scatter /
  all-to-all / collective-permute), each op's result payload on this rank
  (the gathered tensor, the scattered shard, the received buffer), as the
  reference counts each collective's result shape per device;
* **predicted comm time**: the bytes over the card's peak interconnect
  bandwidth (:func:`peak_interconnect_bandwidth`), an order-of-magnitude
  link-budget estimate, not measured goodput;
* **overlappable / serialized**: the reference counts them from HLO
  dependencies. Eager execution exposes no dependency graph, so the port
  reports every collective as serialized and none as overlappable
  (``ROADMAP.md`` queue 3): the estimate is the unhidden upper bound.

The record rides into the cost census (``ProgramCost.comm_bytes``) and the
window's ``comm_est_frac``. ``VEOMNI_COMM_CENSUS=0`` turns the comm part off.
Gauges keep the reference's names: ``comm.{site}.{bucket}.bytes_{kind}``,
``.comm_bytes``, ``.comm_time_est_s``, ``.collectives``, ``.overlappable``,
``.serialized``, ``.pairs`` and the ``comm.programs`` counter.

:func:`plan_step_bytes` reckons the same bytes from the parallel plan and
the shapes alone, for the census to be held against.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

COMM_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: c10d op -> (kind, index of the argument holding the result payload)
_C10D_KINDS: Dict[str, Tuple[str, int]] = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "recv_": ("collective-permute", 0),
}


def comm_census_enabled() -> bool:
    """``VEOMNI_COMM_CENSUS=0`` keeps the counting pass comm-free."""
    return os.environ.get("VEOMNI_COMM_CENSUS", "1") not in ("0", "")


def peak_interconnect_bandwidth() -> float:
    """Nominal one-way interconnect bandwidth of the card in bytes/s: the
    H100 SXM's 18 NVLink-4 links x 25 GB/s (NVIDIA data sheet); on the CPU a
    nominal 1e10 that keeps the estimates finite, as the reference's."""
    import torch

    return 450e9 if torch.cuda.is_available() else 1e10


def _gauge_kind(kind: str) -> str:
    return kind.replace("-", "_")


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def collective_kind(func) -> Optional[str]:
    """The census kind of a dispatched op, or None for a non-collective."""
    if getattr(func, "namespace", None) != "c10d":
        return None
    entry = _C10D_KINDS.get(func._schema.name.split("::")[-1])
    return entry[0] if entry else None


def collective_bytes(func, args) -> int:
    """The result payload bytes of a c10d op's call (its output argument)."""
    entry = _C10D_KINDS[func._schema.name.split("::")[-1]]
    return _tensor_bytes(args[entry[1]]) if args else 0


@dataclass
class CommCost:
    """One (site, bucket)'s communication record."""

    site: str
    bucket: str
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    counts_by_kind: Dict[str, int] = field(default_factory=dict)
    comm_bytes: float = 0.0
    comm_time_est_s: float = 0.0
    collectives: int = 0
    overlappable: int = 0
    serialized: int = 0
    pairs: int = 0
    num_devices: int = 1

    def to_doc(self) -> Dict[str, Any]:
        return {
            "site": self.site, "bucket": self.bucket,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "counts_by_kind": dict(self.counts_by_kind),
            "comm_bytes": self.comm_bytes, "comm_time_est_s": self.comm_time_est_s,
            "collectives": self.collectives, "overlappable": self.overlappable,
            "serialized": self.serialized, "pairs": self.pairs,
            "num_devices": self.num_devices,
        }


class CommCount:
    """The collectives of one counting pass, by kind."""

    def __init__(self):
        self.bytes_by_kind: Dict[str, float] = {}
        self.counts_by_kind: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + float(nbytes)
            self.counts_by_kind[kind] = self.counts_by_kind.get(kind, 0) + 1

    def fields(self) -> Dict[str, Any]:
        n = sum(self.counts_by_kind.values())
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "counts_by_kind": dict(self.counts_by_kind),
                "comm_bytes": sum(self.bytes_by_kind.values()),
                "collectives": n, "overlappable": 0, "serialized": n, "pairs": 0}


class CommCensus:
    """Thread-safe (site, bucket) -> :class:`CommCost` map; records happen
    once a bucket (the counting pass) and publish the ``comm.*`` gauges."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, str], CommCost] = {}
        self._registry = registry

    def _reg(self) -> MetricsRegistry:
        return self._registry or get_registry()

    def record(self, site: str, bucket: str, *, num_devices: int = 1,
               **fields: Any) -> CommCost:
        reg = self._reg()
        with self._lock:
            rec = self._programs.get((site, bucket))
            fresh = rec is None
            if fresh:
                rec = CommCost(site=site, bucket=bucket)
                self._programs[(site, bucket)] = rec
            for k, v in fields.items():
                if hasattr(rec, k):
                    setattr(rec, k, v)
            rec.num_devices = max(1, int(num_devices))
            rec.comm_time_est_s = rec.comm_bytes / peak_interconnect_bandwidth()
        prefix = f"comm.{site}.{bucket}"
        for kind in COMM_KINDS:
            reg.gauge(f"{prefix}.bytes_{_gauge_kind(kind)}").set(
                rec.bytes_by_kind.get(kind, 0.0))
        reg.gauge(f"{prefix}.comm_bytes").set(rec.comm_bytes)
        reg.gauge(f"{prefix}.comm_time_est_s").set(rec.comm_time_est_s)
        reg.gauge(f"{prefix}.collectives").set(rec.collectives)
        reg.gauge(f"{prefix}.overlappable").set(rec.overlappable)
        reg.gauge(f"{prefix}.serialized").set(rec.serialized)
        reg.gauge(f"{prefix}.pairs").set(rec.pairs)
        if fresh:
            reg.counter("comm.programs").inc()
        if rec.collectives:
            logger.info_rank0(
                "comm census: %s/%s — %d collectives, %.3g MB/rank, est %.3g ms at peak link",
                site, bucket, rec.collectives, rec.comm_bytes / 1e6,
                rec.comm_time_est_s * 1e3)
        return rec

    def get(self, site: str, bucket: str) -> Optional[CommCost]:
        with self._lock:
            return self._programs.get((site, bucket))

    def programs(self, site: Optional[str] = None) -> List[CommCost]:
        with self._lock:
            return [rec for (s, _b), rec in self._programs.items() if site is None or s == site]

    def snapshot(self) -> Dict[str, Any]:
        progs = [rec.to_doc() for rec in self.programs()]
        return {"programs": progs,
                "totals": {"programs": len(progs),
                           "comm_bytes": sum(p["comm_bytes"] for p in progs),
                           "serialized": sum(p["serialized"] for p in progs)}}

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()


_GLOBAL: Optional[CommCensus] = None
_GLOBAL_LOCK = threading.Lock()


def get_comm_census() -> CommCensus:
    """The process-wide comm census the instrumented sites record into."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = CommCensus()
        return _GLOBAL


def plan_step_bytes(layout, micro_batches: int, rows: int, seq_local: int) -> Dict[str, float]:
    """Bytes by kind that one train step of a ``Transformer`` laid out by
    ``layout`` (``parallel/parallel_plan.py``) issues on this rank, reckoned
    from the plan and the shapes: ``micro_batches`` micro-batches of
    ``rows`` x ``seq_local`` tokens (the rank's sequence chunk). A remat
    region runs its forward collectives again in the backward: the whole
    layer under ``nothing``, the MLP (and so the MoE) under the policies that
    split the layer around its attention.

    * FSDP2: each decoder layer's sharded parameters gathered in the forward
      and again in the backward (resharded after the forward), the root's
      once; each group's gradient reduce-scattered once a backward (f32);
    * Ulysses, per attention layer: q/k/v scattered and the output gathered
      (four all-to-alls) forward and backward, and the segment ids gathered;
    * expert parallelism, per MoE layer: the token buckets, their expert ids
      and the results exchanged forward, the two gradients backward; the
      router's statistics summed over dp×sp (two all-reduces forward, one
      backward) and the drop fraction (one);
    * per step: the gradients of the parameters FSDP does not hold summed
      over their axes (one flat all-reduce a group), the metrics (f64) over
      dp×sp and the squared norm (f32) over the world."""
    import torch

    ps, model = layout.pstate, layout.module
    cfg = model.cfg
    act = torch.empty((), dtype=cfg.dtype).element_size()
    out: Dict[str, float] = {k: 0.0 for k in COMM_KINDS}

    def full_bytes(p):
        r = layout.rules[p]
        n = int(torch.Size(r.full_shape).numel())
        if r.kind == "fsdp":  # FSDP2 pads each shard to the same length
            g = ps.axis_size(ps.fsdp_axes)
            d = r.full_shape[r.dim]
            n = n // d * (-(-d // g) * g)
        return n * p.element_size(), n * 4 // ps.axis_size(ps.fsdp_axes)

    layers = list(model.layers)
    in_layer = {id(p) for layer in layers for p in layer.parameters()}
    root = [p for p in model.parameters() if id(p) not in in_layer]
    for params, gathers in [(list(layer.parameters()), 2) for layer in layers] + [(root, 1)]:
        sharded = [p for p in params if layout.rules[p].kind == "fsdp"]
        if not sharded:
            continue
        gathered = sum(full_bytes(p)[0] for p in sharded)
        scattered = sum(full_bytes(p)[1] for p in sharded)
        out["all-gather"] += micro_batches * gathers * gathered
        out["reduce-scatter"] += micro_batches * scattered
    from veomni_tpu_torch.models.transformer import _SPLIT_POLICIES

    tokens = rows * seq_local
    mlp_runs = 2 if cfg.remat else 1  # forward runs of a collective in the MLP
    attn_runs = 2 if cfg.remat and cfg.remat_policy not in _SPLIT_POLICIES else 1
    u = ps.ulysses_size
    if u > 1:
        from veomni_tpu_torch.parallel.sequence_parallel import UlyssesLayout

        lay = UlyssesLayout(u=u, hq=cfg.num_attention_heads, hkv=cfg.num_key_value_heads)
        qo = tokens * lay.hq * cfg.head_dim * act
        kv = tokens * lay.hkv_rep * cfg.head_dim * act
        per_layer = (attn_runs + 1) * (2 * qo + 2 * kv)
        out["all-to-all"] += micro_batches * len(layers) * per_layer
        out["all-gather"] += micro_batches * len(layers) * attn_runs * tokens * u * 4
    moe = [layer for layer in layers if layer.is_moe]
    if moe and ps.group(ps.dp_sp_axes) is not None:
        e = cfg.num_experts  # counts [E+1] and prob sums [E]; the sums' gradient
        out["all-reduce"] += micro_batches * len(moe) * (mlp_runs * (2 * e + 1) + e) * 4
    if moe and ps.ep_enabled:
        from veomni_tpu_torch.parallel.moe import capacity

        slots = ps.ep_size * capacity(cfg, tokens, ps.ep_size)
        h = cfg.hidden_size
        fwd = 2 * slots * h * act + slots * 8  # tokens, expert ids, results
        out["all-to-all"] += micro_batches * len(moe) * (mlp_runs * fwd + 2 * slots * h * act)
        out["all-reduce"] += micro_batches * 4  # the drop fraction, once a forward
    groups: Dict[Tuple[str, ...], int] = {}
    for p, r in layout.rules.items():
        if r.kind != "fsdp" and p.requires_grad and ps.group(r.grad_axes) is not None:
            groups[tuple(r.grad_axes)] = groups.get(tuple(r.grad_axes), 0) + p.numel() * 4
    out["all-reduce"] += sum(groups.values())
    # the loss and token sums with the loss fn's three scalar extras (loss_sum,
    # moe_aux_loss, moe_dropped_frac) in f64, and the squared norm in f32
    out["all-reduce"] += (2 + 3) * 8 + 4
    return {k: v for k, v in out.items() if v}

"""Cross-rank fleet view: heartbeats, straggler detection, skew telemetry.

Port of ``veomni_tpu/observability/fleet.py``:

1. **Heartbeats** (``heartbeat_path``, ``write_heartbeat``,
   ``read_heartbeats``, ``heartbeat_ages``, ``:82-167``): each rank (a
   trainer process, or a serving replica's pump worker, whose "rank" is its
   replica id) atomically rewrites ``heartbeat-<rank>.json`` in a
   directory; a reader names the rank whose file stopped aging, so a wedge
   is diagnosable from outside the process.
2. **Skew exchange** (:class:`FleetMonitor`, ``:169-434``): once per sync
   window each rank contributes ``(rank, mean step s, max step s, step)``
   to one all-gather; the table feeds the ``fleet.*`` gauges, the
   ``fleet.straggler`` flight event and a warning when a rank's mean
   exceeds ``straggler_factor`` x the other ranks' median. The transport is
   injectable (``exchange_fn``); the default is a ``torch.distributed``
   all-gather when a process group of at least ``min_ranks`` is
   initialized, and off otherwise, as the reference is off below 2
   processes.
3. **``/debug/fleet``** (:func:`debug_fleet_doc`): the last skew table and
   every heartbeat in the heartbeat directory.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from veomni_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

HEARTBEAT_RE = re.compile(r"^heartbeat-([A-Za-z0-9_.\-]+)\.json$")

#: a heartbeat older than this many seconds reads as stale in
#: :func:`heartbeat_ages` (callers may pass their own threshold)
DEFAULT_STALE_S = 120.0


def _rank_value(rank: Any) -> Any:
    """Numeric ranks stay ints (trainer semantics), anything else is a
    string identity (a replica id)."""
    s = str(rank)
    return int(s) if s.lstrip("-").isdigit() else s


def _rank_sort_key(rank: Any):
    """Ints first in numeric order, then string ranks lexically."""
    return (1, rank) if isinstance(rank, str) else (0, rank)


def heartbeat_path(dirpath: str, rank: Any) -> str:
    return os.path.join(dirpath, f"heartbeat-{rank}.json")


def write_heartbeat(dirpath: str, *, rank: Optional[Any] = None, global_step: int = 0,
                    step_time_s: float = 0.0, phase: str = "train",
                    extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Atomically rewrite this rank's heartbeat file. Never raises (a full or
    hung filesystem must not cost a step); returns the path or None."""
    if not dirpath:
        return None
    if rank is None:
        rank = _process_index()
    doc = {"schema": 1, "rank": _rank_value(rank), "pid": os.getpid(),
           "wall_time_s": time.time(), "global_step": int(global_step),
           "step_time_s": float(step_time_s), "phase": phase}
    if extra:
        doc.update(extra)
    path = heartbeat_path(dirpath, rank)
    try:
        os.makedirs(dirpath, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError as e:
        logger.debug("heartbeat write failed: %s", e)
        return None


def read_heartbeats(dirpath: str) -> List[Dict[str, Any]]:
    """Every parseable ``heartbeat-<rank>.json`` under ``dirpath``, sorted by
    rank; unreadable or torn files are skipped."""
    out: List[Dict[str, Any]] = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in sorted(names):
        m = HEARTBEAT_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(dirpath, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        doc.setdefault("rank", _rank_value(m.group(1)))
        out.append(doc)
    out.sort(key=lambda d: _rank_sort_key(d.get("rank", 0)))
    return out


def heartbeat_ages(dirpath: str, now: Optional[float] = None,
                   stale_after_s: float = DEFAULT_STALE_S) -> List[Dict[str, Any]]:
    """Per-rank freshness rows ``{rank, age_s, stale, global_step,
    step_time_s, phase}``."""
    now = time.time() if now is None else now
    rows = []
    for doc in read_heartbeats(dirpath):
        age = max(0.0, now - float(doc.get("wall_time_s", 0.0)))
        rows.append({"rank": doc.get("rank", -1), "age_s": age, "stale": age > stale_after_s,
                     "global_step": doc.get("global_step", 0),
                     "step_time_s": doc.get("step_time_s", 0.0),
                     "phase": doc.get("phase", "")})
    return rows


# -------------------------------------------------------------- skew exchange
def _default_exchange(local: np.ndarray) -> np.ndarray:
    """One all-gather of the local stats row over the default process group
    -> ``[world, k]`` (identical on every rank)."""
    import torch
    import torch.distributed as dist

    row = torch.from_numpy(local)
    if dist.get_backend() == "nccl":
        row = row.cuda()
    out = [torch.empty_like(row) for _ in range(dist.get_world_size())]
    dist.all_gather(out, row)
    return torch.stack(out).cpu().numpy()


def _process_group_size() -> tuple:
    """(world size, rank) of the default ``torch.distributed`` process group,
    or (1, this process's index) when none is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, _process_index()


def compute_skew(table: np.ndarray) -> Dict[str, float]:
    """Pure skew math over a gathered ``[world, >=2]`` stats table whose
    columns are ``(rank, mean_step_s, ...)``: median/max window step time,
    skew (max - median), and the slowest rank. Unit-testable without any
    exchange.

    The median EXCLUDES the slowest rank: with it included, a straggler
    inflates its own detection baseline — on a 2-rank fleet the trigger
    ``max > f * median(all)`` is mathematically unsatisfiable for any
    ``f >= 2`` (median = (a+b)/2 ⇒ b > a+b is impossible), and any small
    even fleet is skewed the same way. Excluding the suspect, the 2-rank
    baseline is simply the healthy rank's time."""
    ranks = table[:, 0].astype(int)
    means = table[:, 1].astype(float)
    slowest = int(np.argmax(means))
    others = np.delete(means, slowest)
    median = float(np.median(others)) if others.size else float(means[slowest])
    mx = float(means[slowest])
    return {
        "step_time_median_s": median,
        "step_time_max_s": mx,
        "step_time_skew_s": max(0.0, mx - median),
        "slowest_rank": int(ranks[slowest]),
        "slowest_mean_s": mx,
    }


class FleetMonitor:
    """Per-sync-window straggler detection + heartbeat emission.

    ``observe_window(global_step, mean_step_s, ...)`` is the single entry
    point (ObservabilityCallback calls it on the trainer's existing sync
    cadence — zero added device syncs): it writes the heartbeat, and, when
    the exchange is live (>= ``min_ranks`` processes and not disabled),
    gathers every rank's ``(rank, mean, max, step)`` row, publishes the
    ``fleet.*`` gauges, and raises the straggler alarm when a rank's window
    mean exceeds ``straggler_factor`` x the fleet median.

    The transport is injectable (``exchange_fn``): tests and single-process
    drills substitute a fake fleet; the default is the process group's
    all-gather.
    Failure policy: fleet telemetry must never kill a training step, but a
    rank that silently stops calling the gather would WEDGE its peers'
    next exchange (they block in the collective waiting for it) — so a
    failed exchange is RETRIED next window (collectives match in launch
    order, so our next call completes a peer's outstanding round and the
    fleet self-heals from a transient) and only
    :data:`MAX_CONSECUTIVE_EXCHANGE_FAILURES` straight failures disable it,
    with a loud warning that peers on the same knob must ride their
    collective timeout out of the final round."""

    #: straight exchange failures tolerated before this rank stops calling
    #: the all-gather (peers block until their collective timeout on the
    #: last round, then surface a distributed error — loud, not silent)
    MAX_CONSECUTIVE_EXCHANGE_FAILURES = 3

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 straggler_factor: float = 2.0,
                 heartbeat_dir: str = "",
                 exchange_fn: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 min_ranks: int = 2):
        if world_size is None or rank is None:
            pg_world, pg_rank = _process_group_size()
            world_size = pg_world if world_size is None else world_size
            rank = pg_rank if rank is None else rank
        self.registry = registry or get_registry()
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.straggler_factor = float(straggler_factor)
        self.heartbeat_dir = heartbeat_dir
        self.min_ranks = int(min_ranks)
        self._exchange = exchange_fn or _default_exchange
        self._exchange_disabled = self.world_size < self.min_ranks
        self._exchange_failures = 0  # consecutive; reset on success
        self._window_interval_s = 0.0  # observed sync cadence (debug_doc)
        self._last_window_t: Optional[float] = None
        self._lock = threading.Lock()
        self._last: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        self.straggler_count = 0
        set_active_monitor(self)

    @property
    def exchange_enabled(self) -> bool:
        return not self._exchange_disabled

    def observe_window(self, global_step: int, mean_step_s: float,
                       max_step_s: Optional[float] = None,
                       steps: int = 0,
                       exchange: bool = True) -> Optional[Dict[str, Any]]:
        """One sync window's contribution. Returns the skew dict when the
        exchange ran, else None (heartbeat is written either way).

        ``exchange=False`` writes the heartbeat but skips the skew gather —
        the caller's warmup absorption (ObservabilityCallback skips the
        FIRST sync window, which contains the step-1 compile: cross-host
        compile-wall skew — one rank's cold cache vs another's warm one —
        is not a straggler, the same reason the recompile detector arms
        after step 1). Every rank must pass the same value per window: the
        gather is a collective."""
        now = time.monotonic()
        if self._last_window_t is not None:
            self._window_interval_s = now - self._last_window_t
        self._last_window_t = now
        write_heartbeat(
            self.heartbeat_dir, rank=self.rank, global_step=global_step,
            step_time_s=mean_step_s,
            extra={"window_steps": int(steps)} if steps else None,
        )
        if not exchange or self._exchange_disabled:
            return None
        # everything rank-locally fallible happens BEFORE the collective:
        # the gather must be the only thing inside the try, so a failure is
        # (almost always) the transport itself — symmetric across ranks —
        # rather than a one-rank divergence
        local = np.asarray([
            float(self.rank), float(mean_step_s),
            float(max_step_s if max_step_s is not None else mean_step_s),
            float(global_step),
        ], dtype=np.float64)
        try:
            table = np.asarray(self._exchange(local), dtype=np.float64)
            table = table.reshape(-1, local.shape[0])
            self._exchange_failures = 0
        except Exception as e:
            # do NOT stop calling on the first failure: a rank that goes
            # silent wedges its peers' next gather. Retrying next window
            # pairs with a peer's outstanding round (collectives match in
            # launch order), so a transient self-heals; only a persistent
            # failure earns the disable.
            self._exchange_failures += 1
            if self._exchange_failures >= self.MAX_CONSECUTIVE_EXCHANGE_FAILURES:
                self._exchange_disabled = True
                logger.warning(
                    "fleet skew exchange disabled on rank %d after %d "
                    "consecutive failures (%s: %s) — per-rank heartbeats "
                    "keep flowing; peers still exchanging will block their "
                    "next window until the collective timeout surfaces a "
                    "distributed error",
                    self.rank, self._exchange_failures,
                    type(e).__name__, e,
                )
            else:
                logger.warning(
                    "fleet skew exchange failed on rank %d (%s: %s) — "
                    "retrying next sync window (%d/%d before disable)",
                    self.rank, type(e).__name__, e,
                    self._exchange_failures,
                    self.MAX_CONSECUTIVE_EXCHANGE_FAILURES,
                )
            return None
        skew = compute_skew(table)
        reg = self.registry
        reg.gauge("fleet.step_time_skew_s").set(skew["step_time_skew_s"])
        reg.gauge("fleet.step_time_median_s").set(skew["step_time_median_s"])
        reg.gauge("fleet.step_time_max_s").set(skew["step_time_max_s"])
        reg.gauge("fleet.slowest_rank").set(skew["slowest_rank"])
        straggling = (
            skew["step_time_median_s"] > 0.0
            and skew["step_time_max_s"]
            > self.straggler_factor * skew["step_time_median_s"]
        )
        if straggling:
            self.straggler_count += 1
            reg.counter("fleet.stragglers").inc()
            ratio = skew["step_time_max_s"] / skew["step_time_median_s"]
            from veomni_tpu_torch.observability.flight_recorder import record

            record("fleet.straggler", cid=str(skew["slowest_rank"]),
                   step=int(global_step), ratio=round(ratio, 3),
                   median_s=skew["step_time_median_s"],
                   max_s=skew["step_time_max_s"])
            logger.warning_rank0(
                "STRAGGLER: rank %d is %.2fx the other ranks' median step "
                "time (%.4gs vs %.4gs median) at step %d — check that "
                "rank's heartbeat/postmortem (scripts/fleet.py) before it "
                "wedges the next collective",
                skew["slowest_rank"], ratio, skew["step_time_max_s"],
                skew["step_time_median_s"], int(global_step),
            )
        doc = {
            **skew,
            "straggling": straggling,
            "global_step": int(global_step),
            "table": [
                {"rank": int(r[0]), "mean_step_s": float(r[1]),
                 "max_step_s": float(r[2]), "global_step": int(r[3])}
                for r in table
            ],
        }
        with self._lock:
            self._last = doc
        return skew

    def debug_doc(self) -> Dict[str, Any]:
        """``/debug/fleet`` body: local identity + last skew table +
        heartbeat freshness (the comm census is slice C's)."""
        with self._lock:
            last = dict(self._last) if self._last else None
        doc: Dict[str, Any] = {
            "enabled": True,
            "rank": self.rank,
            "world_size": self.world_size,
            "exchange_enabled": self.exchange_enabled,
            "straggler_factor": self.straggler_factor,
            "stragglers": self.straggler_count,
            "last_window": last,
            # staleness scaled to the observed sync cadence: on a run that
            # syncs every ~250s, a fixed 120s threshold would mark every
            # HEALTHY rank stale between windows and the flag could never
            # name the one wedged rank
            "heartbeats": heartbeat_ages(
                self.heartbeat_dir,
                stale_after_s=max(DEFAULT_STALE_S,
                                  3.0 * self._window_interval_s),
            ) if self.heartbeat_dir else [],
        }
        return doc


_ACTIVE: Optional[FleetMonitor] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = threading.Lock()


def set_active_monitor(monitor: Optional[FleetMonitor]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = monitor


def get_active_monitor() -> Optional[FleetMonitor]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def debug_fleet_doc() -> Dict[str, Any]:
    """Default ``/debug/fleet`` body when no explicit ``fleet_fn`` is wired:
    the active monitor's view, or a disabled stub."""
    mon = get_active_monitor()
    if mon is not None:
        return mon.debug_doc()
    return {"enabled": False, "heartbeats": []}

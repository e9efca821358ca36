"""Per-rank heartbeat files: liveness a process leaves on disk.

Port of the heartbeat functions of ``veomni_tpu/observability/fleet.py``
(``heartbeat_path``, ``write_heartbeat``, ``read_heartbeats``,
``heartbeat_ages``, ``:82-167``). Each rank (a trainer process, or a
serving replica's pump worker, whose "rank" is its replica id) atomically
rewrites ``heartbeat-<rank>.json`` in a directory; a reader names the rank
whose file stopped aging, so a wedge is diagnosable from outside the
process. The fleet monitor, the step-time skew exchange and ``/debug/fleet``
(``FleetMonitor``) are not ported yet (ROADMAP.md, slice E).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional

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

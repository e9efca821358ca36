"""Rank-aware logging (copy of ``veomni_tpu/utils/logging.py``).

Rank comes from ``torch.distributed`` once a process group exists, else from
the launcher's ``RANK`` environment variable, so a log call never creates a
process group.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"
_lock = threading.Lock()
_configured = False


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def _configure_root() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        root = logging.getLogger("veomni_tpu_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get("VEOMNI_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _configured = True


class _RankLogger(logging.LoggerAdapter):
    """Adds ``*_rank0`` / ``*_once`` variants like the reference logger."""

    def info_rank0(self, msg, *args, **kwargs):
        if _process_index() == 0:
            self.info(msg, *args, **kwargs)

    def warning_rank0(self, msg, *args, **kwargs):
        if _process_index() == 0:
            self.warning(msg, *args, **kwargs)

    def _first_time(self, msg, args) -> bool:
        key = msg % args if args else msg
        if not hasattr(self, "_once_seen"):
            self._once_seen = set()
        if key in self._once_seen:
            return False
        self._once_seen.add(key)
        return True

    def warning_once(self, msg, *args, **kwargs):
        if self._first_time(msg, args):
            self.warning(msg, *args, **kwargs)

    def info_once(self, msg, *args, **kwargs):
        if self._first_time(msg, args):
            self.info(msg, *args, **kwargs)


def get_logger(name: str = "veomni_tpu_torch") -> _RankLogger:
    _configure_root()
    if not name.startswith("veomni_tpu_torch"):
        name = f"veomni_tpu_torch.{name}"
    return _RankLogger(logging.getLogger(name), {})

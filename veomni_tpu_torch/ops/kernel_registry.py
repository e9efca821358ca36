"""Kernel registry: (op_name, impl_name) -> callable with hardware gating.

Port of ``veomni_tpu/ops/kernel_registry.py`` with the same ``(op, impl)``
names. The reference gates on device type plus ``requires_pallas``
(``kernel_registry.py:24-40``); here the gate is the device type of the
tensors an op is called with (``cuda``/``cpu``/``any``) plus a minimum SM
capability. Selection prefers the highest-priority available impl. A config
pin or ``VEOMNI_FORCE_EAGER_OPS=1`` is an explicit request and wins. Nothing
falls back on failure: an impl that is selected runs, or raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from veomni_tpu_torch.utils.device import get_sm_capability
from veomni_tpu_torch.utils.env import env_bool
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class KernelSpec:
    fn: Callable
    device_types: Tuple[str, ...] = ("any",)
    priority: int = 0  # higher wins
    name: str = ""
    min_sm: Optional[Tuple[int, int]] = None  # e.g. (9, 0) for Hopper

    def available(self, device: torch.device) -> bool:
        if "any" not in self.device_types and device.type not in self.device_types:
            return False
        if self.min_sm is not None:
            sm = get_sm_capability(device)
            return sm is not None and sm >= self.min_sm
        return True


class _KernelRegistry:
    def __init__(self):
        self._ops: Dict[str, Dict[str, KernelSpec]] = {}
        self._pins: Dict[str, str] = {}  # op -> impl name forced by config

    def register(
        self,
        op_name: str,
        impl_name: str,
        *,
        device_types: Tuple[str, ...] = ("any",),
        priority: int = 0,
        min_sm: Optional[Tuple[int, int]] = None,
    ):
        def _do(fn):
            self._ops.setdefault(op_name, {})[impl_name] = KernelSpec(
                fn=fn, device_types=device_types, priority=priority,
                name=impl_name, min_sm=min_sm,
            )
            self._resolve.cache_clear()
            return fn

        return _do

    def pin(self, op_name: str, impl_name: str) -> None:
        """Force an implementation (the ops_implementation config surface)."""
        self._pins[op_name] = impl_name
        self._resolve.cache_clear()

    def clear_pins(self) -> None:
        self._pins.clear()
        self._resolve.cache_clear()

    def pinned(self, op_name: str) -> Optional[str]:
        """The impl name an op is pinned to (None = auto-select), validated
        against the registered impls exactly like resolve() would."""
        pin = self._pins.get(op_name)
        if pin is not None:
            impls = self._ops.get(op_name, {})
            if pin not in impls:
                raise KeyError(f"op {op_name!r} has no impl {pin!r}: {sorted(impls)}")
        return pin

    def impls(self, op_name: str) -> Dict[str, KernelSpec]:
        return dict(self._ops.get(op_name, {}))

    def resolve(self, op_name: str, device) -> Callable:
        """The impl of ``op_name`` for tensors on ``device``."""
        return self._resolve(op_name, torch.device(device))

    @functools.lru_cache(maxsize=None)
    def _resolve(self, op_name: str, device: torch.device) -> Callable:
        impls = self._ops.get(op_name)
        if not impls:
            raise KeyError(f"no kernels registered for op {op_name!r}")
        pin = self.pinned(op_name)
        if pin is not None:
            return impls[pin].fn
        if env_bool("VEOMNI_FORCE_EAGER_OPS") and "xla" in impls:
            return impls["xla"].fn
        candidates = [s for s in impls.values() if s.available(device)]
        if not candidates:
            raise RuntimeError(f"no available impl for op {op_name!r} on {device}")
        best = max(candidates, key=lambda s: s.priority)
        logger.info_once("op %s on %s -> impl %s", op_name, device.type, best.name)
        return best.fn


KERNEL_REGISTRY = _KernelRegistry()


def resolve_op(op_name: str, device) -> Callable:
    return KERNEL_REGISTRY.resolve(op_name, device)


def apply_ops_config(pins: Optional[Dict[str, str]]) -> None:
    """Apply an ops_implementation config mapping {op: impl}."""
    KERNEL_REGISTRY.clear_pins()
    for op, impl in (pins or {}).items():
        KERNEL_REGISTRY.pin(op, impl)

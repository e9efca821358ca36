"""ParallelState at world size 1.

Port of ``veomni_tpu/parallel/parallel_state.py`` for one process on one
device: the same axis names, the same size properties, the named registry
and the ambient scoping (``use_parallel_state``), so the trainer builds and
scopes its state as the reference does. Every axis has size 1. A size
above 1 along any axis, or a ``torch.distributed`` world of more than one
process, raises ``NotImplementedError``: the mesh (a torch ``DeviceMesh``
with FSDP2, Ulysses and expert parallelism) is the port's slice C.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Canonical axis names, in mesh order (the reference's).
AXIS_PP = "pp"
AXIS_DP_REPLICATE = "dp_replicate"
AXIS_EP = "ep"
AXIS_FSDP = "fsdp"
AXIS_ULYSSES = "ulysses"
AXIS_CP = "cp"
AXIS_TP = "tp"

MESH_AXES: Tuple[str, ...] = (
    AXIS_PP,
    AXIS_DP_REPLICATE,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_ULYSSES,
    AXIS_CP,
    AXIS_TP,
)


@dataclass(frozen=True)
class ParallelState:
    """The reference's property surface over a one-device 'mesh'."""

    pp_size: int = 1
    dp_replicate_size: int = 1
    ep_size: int = 1
    fsdp_size: int = 1
    ulysses_size: int = 1
    cp_size: int = 1
    tp_size: int = 1
    name: str = "base"

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return {AXIS_PP: self.pp_size, AXIS_DP_REPLICATE: self.dp_replicate_size,
                AXIS_EP: self.ep_size, AXIS_FSDP: self.fsdp_size,
                AXIS_ULYSSES: self.ulysses_size, AXIS_CP: self.cp_size,
                AXIS_TP: self.tp_size}

    @property
    def world_size(self) -> int:
        n = 1
        for size in self.mesh_shape.values():
            n *= size
        return n

    @property
    def dp_shard_size(self) -> int:
        return self.ep_size * self.fsdp_size

    @property
    def dp_size(self) -> int:
        return self.dp_replicate_size * self.dp_shard_size

    @property
    def sp_size(self) -> int:
        return self.ulysses_size * self.cp_size

    @property
    def sp_enabled(self) -> bool:
        return self.sp_size > 1

    @property
    def ep_enabled(self) -> bool:
        return self.ep_size > 1

    @property
    def tp_enabled(self) -> bool:
        return self.tp_size > 1

    @property
    def pp_enabled(self) -> bool:
        return self.pp_size > 1

    @property
    def hsdp_enabled(self) -> bool:
        return self.dp_replicate_size > 1

    def data_parallel_index(self) -> int:
        return 0

    def describe(self) -> str:
        return (
            f"ParallelState(name={self.name!r}, world={self.world_size}, "
            f"pp={self.pp_size}, dp_replicate={self.dp_replicate_size}, "
            f"ep={self.ep_size}, fsdp={self.fsdp_size}, "
            f"ulysses={self.ulysses_size}, cp={self.cp_size}, tp={self.tp_size})"
        )


_REGISTRY: Dict[str, ParallelState] = {}
_tls = threading.local()


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_parallel_state(
    *,
    dp_replicate_size: int = 1,
    dp_shard_size: int = -1,
    ep_size: int = 1,
    ulysses_size: int = 1,
    cp_size: int = 1,
    tp_size: int = 1,
    pp_size: int = 1,
    name: str = "base",
) -> ParallelState:
    """Register a world-size-1 ParallelState under ``name``. ``-1`` infers
    an extent from the device count as in the reference, which here is 1."""
    sizes = {"dp_replicate_size": dp_replicate_size, "dp_shard_size": dp_shard_size,
             "expert_parallel_size": ep_size, "ulysses_parallel_size": ulysses_size,
             "context_parallel_size": cp_size, "tensor_parallel_size": tp_size,
             "pipeline_parallel_size": pp_size}
    for label, size in sizes.items():
        if size < 1 and size != -1:
            raise ValueError(f"{label} must be >= 1 or -1 (infer), got {size}")
    wide = {k: v for k, v in sizes.items() if v > 1}
    if wide or _process_count() > 1:
        raise NotImplementedError(
            f"parallel sizes {wide or {}} over {_process_count()} process(es): the port runs "
            "at world size 1; the device mesh (FSDP2, Ulysses, expert parallelism) is "
            "slice C of the port, not ported yet")
    state = ParallelState(name=name)
    _REGISTRY[name] = state
    logger.info_rank0("%s", state.describe())
    return state


def get_parallel_state(name: Optional[str] = None) -> ParallelState:
    """Current ambient state (innermost ``use_parallel_state``), or by name."""
    if name is not None:
        if name not in _REGISTRY:
            raise KeyError(f"no ParallelState named {name!r}; call init_parallel_state")
        return _REGISTRY[name]
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    if "base" in _REGISTRY:
        return _REGISTRY["base"]
    raise RuntimeError("init_parallel_state() has not been called")


def parallel_state_initialized(name: str = "base") -> bool:
    return name in _REGISTRY


def get_parallel_state_or_none() -> Optional[ParallelState]:
    try:
        return get_parallel_state()
    except RuntimeError:
        return None


@contextlib.contextmanager
def use_parallel_state(state_or_name):
    """Scope the ambient ParallelState (reference ``use_parallel_state``)."""
    state = (
        get_parallel_state(state_or_name)
        if isinstance(state_or_name, str)
        else state_or_name
    )
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(state)
    try:
        yield state
    finally:
        stack.pop()


def destroy_parallel_state() -> None:
    _REGISTRY.clear()
    if hasattr(_tls, "stack"):
        _tls.stack = []

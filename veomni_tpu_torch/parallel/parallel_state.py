"""ParallelState: one device mesh, many parallel axes.

Port of ``veomni_tpu/parallel/parallel_state.py``. The reference builds one
``jax.sharding.Mesh`` over ``(pp, dp_replicate, ep, fsdp, ulysses, cp,
tp)`` and names flattened groups as tuples of its axes; GSPMD then inserts
every collective. Here the same seven axes lay the ``torch.distributed``
ranks out row-major (rank = the mesh index of the rank's coordinates), and
each flattened group of the reference is a process group that this module
creates once, for every rank, when the state is built:

    dp_axes      = (dp_replicate, ep, fsdp)          the batch axis
    sp_axes      = (cp, ulysses)                     the sequence axis, cp outer
    fsdp_axes    = (ep, fsdp, ulysses, cp)           dense parameters shard
    ep_fsdp_axes = (fsdp,)                           expert features shard
    dp_sp_axes   = dp_axes + sp_axes                 loss and token reduction

plus each axis alone, ``ep_replicate_axes`` = (dp_replicate, ulysses, cp),
the axes an expert weight is replicated over, and those with fsdp (its
gradient's sum where the feature dim is not split). The dp axes need no
group: a rank's dp position is read from its coordinates. A group's ranks
are sorted, so a rank's place in it is its index over the group's axes in
mesh order; :meth:`ParallelState.axis_index` gives it in any order
(``sp_axes`` puts cp first). ``tp`` and ``pp`` are axes of the mesh that no plan shards over and
that do not split the batch, as in the reference: their ranks repeat the
same work.

At world size 1 no group exists and every axis has size 1, as before. The
named registry and the ambient scoping (``use_parallel_state``) are the
reference's, and :meth:`ParallelState.without_sp` is its per-module view
with sp 1 over the same mesh (the VLM towers run under it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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

#: the axis sets whose process groups a multi-process state creates
_GROUP_SETS: Tuple[Tuple[str, ...], ...] = (
    (AXIS_DP_REPLICATE,), (AXIS_EP,), (AXIS_FSDP,), (AXIS_ULYSSES,), (AXIS_CP,),
    (AXIS_EP, AXIS_FSDP, AXIS_ULYSSES, AXIS_CP),
    (AXIS_ULYSSES, AXIS_CP),
    (AXIS_DP_REPLICATE, AXIS_EP, AXIS_FSDP, AXIS_ULYSSES, AXIS_CP),
    (AXIS_DP_REPLICATE, AXIS_ULYSSES, AXIS_CP),
    (AXIS_DP_REPLICATE, AXIS_FSDP, AXIS_ULYSSES, AXIS_CP),
)


def _key(axes: Sequence[str]) -> Tuple[str, ...]:
    """Groups are keyed by their axes in mesh order (membership ignores order)."""
    return tuple(a for a in MESH_AXES if a in axes)


@dataclass(frozen=True)
class ParallelState:
    """The reference's property surface over a mesh of ranks.

    ``mesh`` holds the real extents in mesh order; the ``*_size`` fields are
    what the state reports (``without_sp`` reports ulysses and cp 1 over the
    same mesh). ``groups`` maps an axis set (mesh order) to this rank's
    process group; it is empty at world size 1."""

    pp_size: int = 1
    dp_replicate_size: int = 1
    ep_size: int = 1
    fsdp_size: int = 1
    ulysses_size: int = 1
    cp_size: int = 1
    tp_size: int = 1
    name: str = "base"
    rank: int = 0
    device_type: str = "cpu"
    mesh: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1)
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

    # ------------------------------------------------------------------ sizes
    @property
    def mesh_shape(self) -> Dict[str, int]:
        return dict(zip(MESH_AXES, self.mesh))

    @property
    def world_size(self) -> int:
        return int(np.prod(self.mesh))

    @property
    def dp_shard_size(self) -> int:
        """Reference's dp_shard (FSDP shard without SP) == ep * fsdp."""
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

    # ------------------------------------------------------------- axis views
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return (AXIS_DP_REPLICATE, AXIS_EP, AXIS_FSDP)

    @property
    def sp_axes(self) -> Tuple[str, ...]:
        """``cp`` outer: each cp rank owns one contiguous chunk of the global
        sequence (the ring's chunk-level causal skip assumes it), and the
        ulysses all-to-all reassembles each cp chunk contiguously."""
        return (AXIS_CP, AXIS_ULYSSES)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        """Dense parameters shard over these (reference 'dp_shard_sp')."""
        return (AXIS_EP, AXIS_FSDP, AXIS_ULYSSES, AXIS_CP)

    @property
    def ep_fsdp_axes(self) -> Tuple[str, ...]:
        """Axes an expert-parallel parameter's feature dim shards over."""
        return (AXIS_FSDP,)

    @property
    def ep_replicate_axes(self) -> Tuple[str, ...]:
        """Axes an expert weight is replicated over (its gradient sums there)."""
        return (AXIS_DP_REPLICATE, AXIS_ULYSSES, AXIS_CP)

    @property
    def dp_sp_axes(self) -> Tuple[str, ...]:
        """Loss-reduction axes (reference flattened 'dp_sp')."""
        return self.dp_axes + self.sp_axes

    # ------------------------------------------------------- ranks and groups
    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate along each mesh axis."""
        return dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(self.rank, self.mesh))))

    def axis_size(self, axes: Sequence[str]) -> int:
        shape = self.mesh_shape
        return int(np.prod([shape[a] for a in axes])) if axes else 1

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's position along ``axes`` (row-major in the given order)."""
        shape, coords = self.mesh_shape, self.coords
        index = 0
        for ax in axes:
            index = index * shape[ax] + coords[ax]
        return index

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes``; None when their extent is
        1 (a collective over one rank is the identity, and is skipped)."""
        if self.axis_size(axes) == 1:
            return None
        key = _key(axes)
        if key not in self.groups:
            raise KeyError(f"no process group over {key}: the mesh creates {sorted(self.groups)}")
        return self.groups[key]

    def group_ranks(self, axes: Sequence[str]) -> List[int]:
        """The global ranks of this rank's group over ``axes``, sorted."""
        grid = np.arange(self.world_size).reshape(self.mesh)
        index = tuple(slice(None) if a in axes else c for a, c in self.coords.items())
        return sorted(int(r) for r in grid[index].reshape(-1))

    def data_parallel_index(self) -> int:
        """This rank's position along the dp axes: the data shard it loads.
        The sp (and tp, pp) peers of one dp index load the same rows."""
        return self.axis_index(self.dp_axes)

    def sp_rank(self) -> int:
        """This rank's sequence chunk, cp outer and ulysses inner."""
        return self.axis_index(self.sp_axes) if self.sp_enabled else 0

    def without_sp(self) -> "ParallelState":
        """A scoped view that reports sp 1 over the same mesh: modules whose
        activations are replicated along the sequence (vision towers) run
        under it, so the sequence-parallel attention disengages."""
        return dataclasses.replace(self, ulysses_size=1, cp_size=1, name=f"{self.name}:no_sp")

    def describe(self) -> str:
        return (
            f"ParallelState(name={self.name!r}, world={self.world_size}, "
            f"pp={self.pp_size}, dp_replicate={self.dp_replicate_size}, "
            f"ep={self.ep_size}, fsdp={self.fsdp_size}, "
            f"ulysses={self.ulysses_size}, cp={self.cp_size}, tp={self.tp_size})"
        )


# --------------------------------------------------------------------------
# Registry + ambient scoping (reference parallel_state.py:659-691)
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, ParallelState] = {}
_tls = threading.local()


def _world() -> Tuple[int, int]:
    """(process count, this process's rank) of the ``torch.distributed`` world."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make_groups(mesh: Tuple[int, ...], rank: int) -> Dict[Tuple[str, ...], object]:
    """One process group per partition of every axis set, created in the
    same order on every rank (``new_group`` is collective); this rank keeps
    its own group of each set. A set of extent 1 gets none, but for the
    fsdp axes under dp_replicate: FSDP2's DDP mesh takes a shard group of
    one rank."""
    import torch.distributed as dist

    grid = np.arange(int(np.prod(mesh))).reshape(mesh)
    mine: Dict[Tuple[str, ...], object] = {}
    fsdp_axes = (AXIS_EP, AXIS_FSDP, AXIS_ULYSSES, AXIS_CP)
    for axes in _GROUP_SETS:
        dims = [MESH_AXES.index(a) for a in axes]
        rest = [d for d in range(len(mesh)) if d not in dims]
        rows = grid.transpose(rest + dims).reshape(-1, int(np.prod([mesh[d] for d in dims])))
        if rows.shape[1] == 1 and not (axes == fsdp_axes and mesh[1] > 1):
            continue
        for row in rows:
            ranks = sorted(int(r) for r in row)
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axes] = group
    return mine


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
    device_type: Optional[str] = None,
) -> ParallelState:
    """Lay the ``torch.distributed`` world out as the mesh and register the
    state under ``name``. ``dp_shard_size=-1`` infers the FSDP shard extent
    from the world size; ``dp_replicate_size=-1`` infers the replicate extent
    instead (the DDP mapping). ``ep_size`` must divide the (inferred)
    dp_shard. ``device_type`` ('cuda' or 'cpu') is where the groups'
    tensors live, for the FSDP mesh; by default the CPU."""
    for label, size in (("dp_replicate_size", dp_replicate_size),
                        ("dp_shard_size", dp_shard_size)):
        if size < 1 and size != -1:
            raise ValueError(f"{label} must be >= 1 or -1 (infer), got {size}")
    world, rank = _world()
    if dp_replicate_size == -1:
        if dp_shard_size == -1:
            raise ValueError("at most one of dp_replicate_size/dp_shard_size may be -1")
        known = pp_size * dp_shard_size * ulysses_size * cp_size * tp_size
        if world % known:
            raise ValueError(f"world size {world} not divisible by {known}")
        dp_replicate_size = world // known
    known = pp_size * dp_replicate_size * ulysses_size * cp_size * tp_size
    if dp_shard_size == -1:
        if world % known:
            raise ValueError(f"world size {world} not divisible by {known}")
        dp_shard_size = world // known
    if known * dp_shard_size != world:
        raise ValueError(f"mesh sizes {known * dp_shard_size} != device count {world}")
    if dp_shard_size % ep_size:
        raise ValueError(f"ep_size {ep_size} must divide dp_shard {dp_shard_size}")
    fsdp_size = dp_shard_size // ep_size
    mesh = (pp_size, dp_replicate_size, ep_size, fsdp_size, ulysses_size, cp_size, tp_size)
    groups = _make_groups(mesh, rank) if world > 1 else {}
    state = ParallelState(
        pp_size=pp_size, dp_replicate_size=dp_replicate_size, ep_size=ep_size,
        fsdp_size=fsdp_size, ulysses_size=ulysses_size, cp_size=cp_size, tp_size=tp_size,
        name=name, rank=rank, device_type=device_type or "cpu", mesh=mesh, groups=groups,
    )
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

"""Model-centric parallel plans: param-path patterns -> the dims and mesh
axes a parameter shards over, and the plan applied to a model.

Port of ``veomni_tpu/parallel/parallel_plan.py``. :class:`ParallelPlan`
and :meth:`ParallelPlan.spec_for` are the reference's: ordered regex rules
over the reference's parameter paths (``layers.experts.gate_proj``), the
symbolic tokens ``fsdp``/``ep``/``ep_fsdp``/``tp``/``sp`` resolved against
the ParallelState, the default FSDP rule (the first dim divisible by the
fsdp axes' extent), the shift past stacked-layer dims, and replication of a
dim the axes do not divide. ``spec_for`` returns one entry per dim: the
tuple of mesh axes it is split over (a single axis as its name), or None.

GSPMD applies a spec by itself; here :func:`apply_parallel_plan` applies it
to the port's modules (one per decoder layer, the reference's ``[in, out]``
layout, the stacked leaves mapped by ``models/jax_weights.py``). Each
parameter's per-layer spec (the stacked dim dropped) is one of three kinds:

* **fsdp**: one dim over the fsdp axes. FSDP2's ``fully_shard`` per
  decoder layer (and per vision-tower block), then at the root, shards it
  on that dim (``shard_placement_fn``) over the fsdp group, or, with
  ``dp_replicate > 1``, over the 2-D (replicate, shard) mesh (HSDP; DDP is
  HSDP with a shard group of one). Its gradients are reduce-scattered with
  a sum, not FSDP2's mean (``set_gradient_divide_factor(1)``): the train
  step divides once by the global token count.
* **expert**: the expert dim over ``ep`` (each rank keeps ``E/ep``
  experts) and a feature dim over ``ep_fsdp`` when the rules say so. FSDP
  ignores these; a gather hook all-gathers the feature shards where the
  layer reads the weight (its backward reduce-scatters the gradient), and
  :meth:`ParallelLayout.finish_grads` sums the gradient over the axes the
  expert is replicated on, never over ``ep``.
* **replicated**: no dim sharded (the router's ``()`` rule, a dim nothing
  divides). FSDP ignores it; its gradient is summed over dp×sp.

The LoRA rules merge in as in the reference (``trainer/base.py:350-357``);
under a multi-process mesh the adapters are replicated but for the expert
dim of an expert adapter, which follows its base weight over ``ep``
(``ROADMAP.md`` queue 3). A vision tower's stacked ``blocks`` are not a
stacked-layer prefix of the reference's plan, so the reference shards that
leaf's block dim; the port, one module per block, gives each block's
parameter the default rule on its own shape instead (queue 3 too).

:class:`ParallelLayout` also gathers the full state for a checkpoint or an
export and slices a full state back into the shards.
"""

from __future__ import annotations

import re
import types
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from veomni_tpu_torch.parallel.functional import all_gather
from veomni_tpu_torch.parallel.parallel_state import AXIS_EP, AXIS_TP, ParallelState
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SpecTemplate = Tuple[Optional[str], ...]
Spec = Tuple[Optional[Tuple[str, ...]], ...]


def _resolve_token(token: Optional[str], state: ParallelState):
    if token is None:
        return None
    if token == "fsdp":
        return state.fsdp_axes
    if token == "ep":
        return (AXIS_EP,)
    if token == "ep_fsdp":
        return state.ep_fsdp_axes
    if token == "tp":
        return (AXIS_TP,)
    if token == "sp":
        return state.sp_axes
    raise ValueError(f"unknown spec token {token!r}")


@dataclass
class ParallelPlan:
    """Declarative sharding rules, owned by the model family.

    rules: ordered {regex: spec template}; first match wins.
    default_fsdp: apply auto-FSDP to unmatched params.
    stacked_layer_prefixes: param paths under these prefixes carry leading
      scan-over-layers dim(s) that are never sharded (specs are shifted);
      an entry is a prefix or a ``(prefix, ndims)`` tuple."""

    rules: Dict[str, SpecTemplate] = field(default_factory=dict)
    default_fsdp: bool = True
    stacked_layer_prefixes: Tuple = ("layers", "dense_layers")

    def _default_spec(self, shape, state: ParallelState) -> SpecTemplate:
        if not self.default_fsdp or not shape:
            return ()
        fsdp_n = state.axis_size(state.fsdp_axes)
        if fsdp_n == 1:
            return ()
        for dim, size in enumerate(shape):
            if size % fsdp_n == 0 and size >= fsdp_n:
                return tuple("fsdp" if d == dim else None for d in range(len(shape)))
        return ()

    def spec_for(self, path: str, shape, state: ParallelState) -> Spec:
        """The reference's ``spec_for`` (``:111``): per dim of ``shape``, the
        mesh axes it shards over, or None."""
        shape = tuple(shape)
        shift = 0
        for entry in self.stacked_layer_prefixes:
            pfx, nd = entry if isinstance(entry, tuple) else (entry, 1)
            if re.search(rf"(^|\.){re.escape(pfx)}\.", path + "."):
                shift = max(shift, nd)
        shift = min(shift, max(len(shape) - 1, 0))
        stacked = shift > 0
        logical_shape = shape[shift:] if stacked else shape
        template: Optional[SpecTemplate] = None
        for pattern, tmpl in self.rules.items():
            if re.search(pattern, path):
                template = tmpl
                break
        if template is None:
            template = self._default_spec(logical_shape, state)
        resolved: List[Optional[Tuple[str, ...]]] = []
        for dim, token in enumerate(template):
            axes = _resolve_token(token, state)
            if axes is not None and dim < len(logical_shape):
                n = state.axis_size(axes)
                if logical_shape[dim] % n:
                    logger.warning_once(
                        "param %s dim %d size %d not divisible by %s=%d; replicating",
                        path, dim, logical_shape[dim], token, n)
                    axes = None
            resolved.append(axes)
        if stacked:
            resolved = [None] * shift + resolved
        out = tuple(resolved[: len(shape)])
        return out + (None,) * (len(shape) - len(out))

    def merge(self, other: "ParallelPlan") -> "ParallelPlan":
        rules = dict(self.rules)
        rules.update(other.rules)
        return ParallelPlan(
            rules=rules,
            default_fsdp=self.default_fsdp and other.default_fsdp,
            stacked_layer_prefixes=tuple(dict.fromkeys(
                self.stacked_layer_prefixes + other.stacked_layer_prefixes)),
        )


def lora_parallel_plan_rules() -> Dict[str, tuple]:
    """Adapter sharding (``veomni_tpu/lora/lora.py:123``): expert-batched
    adapters follow the expert plan."""
    return {
        r"layers\.experts\..*\.lora_a$": ("ep", "ep_fsdp", None),
        r"layers\.experts\..*\.lora_b$": ("ep", None, None),
        r"\.scale$": (),
    }


def model_parallel_plan(cfg) -> ParallelPlan:
    """The model family's plan (``veomni_tpu/models/auto.py:44-54``): a MoE
    config's experts shard their expert dim over ep and features over
    ep_fsdp, its router replicates; everything else takes the default."""
    text = getattr(cfg, "text", cfg)
    rules: Dict[str, tuple] = {}
    if getattr(text, "is_moe", False):
        rules[r"layers\.experts\..*"] = ("ep", "ep_fsdp", None)
        rules[r"layers\.router$"] = ()
    return ParallelPlan(rules=rules)


# ---------------------------------------------------------------------------
# applying a plan
# ---------------------------------------------------------------------------

@dataclass
class ParamRule:
    """How one parameter is laid out over the mesh (see the module doc)."""

    kind: str                          # "fsdp" | "expert" | "replicated"
    path: str                          # the reference's leaf path
    full_shape: Tuple[int, ...]        # the parameter's unsharded shape
    dim: Optional[int] = None          # fsdp: the shard dim
    ep_dim: Optional[int] = None       # expert: the expert dim
    feature_dim: Optional[int] = None  # expert: the dim sharded over ep_fsdp
    grad_axes: Tuple[str, ...] = ()    # axes a manual gradient sum runs over
    copies: int = 1                    # ranks holding each element


def param_rules(module: nn.Module, plan: ParallelPlan,
                pstate: ParallelState) -> Dict[nn.Parameter, ParamRule]:
    """{parameter: ParamRule} for every parameter of a ``Transformer``, a
    VLM composite or ``LoraAdapters`` (whose leaves are whole tensors). A
    stacked leaf's per-layer spec is the leaf's spec without its first dim."""
    from veomni_tpu_torch.models.jax_weights import reference_leaves

    lora = getattr(module, "named_jax_parameters", None) is not None
    rules: Dict[nn.Parameter, ParamRule] = {}
    for path, params, stacked in reference_leaves(module):
        shape = tuple(params[0].shape)
        spec = plan.spec_for(path, (1,) + shape, pstate)[1:] if stacked else \
            plan.spec_for(path, shape, pstate)
        for p in params:
            rules[p] = _rule(path, shape, spec, pstate, lora)
    return rules


def _rule(path: str, shape, spec: Spec, pstate: ParallelState, lora: bool) -> ParamRule:
    world = pstate.world_size
    ep_dim = next((d for d, ax in enumerate(spec) if ax == (AXIS_EP,)), None)
    if ep_dim is not None or ".experts." in f".{path}.":
        feature = next((d for d, ax in enumerate(spec)
                        if ax is not None and ax != (AXIS_EP,)), None)
        if lora:
            feature = None  # adapters: only the expert dim is split
        ep = pstate.ep_size if ep_dim is not None else 1
        f = pstate.axis_size(pstate.ep_fsdp_axes) if feature is not None else 1
        axes = pstate.ep_replicate_axes + (() if feature is not None else pstate.ep_fsdp_axes)
        return ParamRule("expert", path, shape, ep_dim=ep_dim, feature_dim=feature,
                         grad_axes=axes, copies=world // (ep * f))
    fsdp = [d for d, ax in enumerate(spec) if ax is not None]
    if fsdp and not lora:
        if len(fsdp) > 1 or spec[fsdp[0]] != pstate.fsdp_axes:
            raise NotImplementedError(f"param {path}: spec {spec} shards over axes no plan "
                                      "of the reference uses (tp, pp)")
        return ParamRule("fsdp", path, shape, dim=fsdp[0],
                         copies=world // pstate.axis_size(pstate.fsdp_axes))
    return ParamRule("replicated", path, shape, grad_axes=pstate.dp_sp_axes, copies=world)


def _chunk(t: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    """``torch.chunk`` semantics (FSDP2's): the index-th of n pieces, maybe empty."""
    pieces = torch.chunk(t, n, dim=dim)
    if index < len(pieces):
        return pieces[index]
    return t.narrow(dim, 0, 0)


def _fsdp_mesh(pstate: ParallelState):
    """FSDP2's mesh: the fsdp group, or (dp_replicate, fsdp) for HSDP."""
    from torch.distributed.device_mesh import DeviceMesh

    shard = pstate.group(pstate.fsdp_axes)
    rep = pstate.group((pstate.dp_axes[0],))
    if rep is None:
        if shard is None:
            return None
        return DeviceMesh.from_group(shard, pstate.device_type,
                                     mesh=pstate.group_ranks(pstate.fsdp_axes))
    grid = np.arange(pstate.world_size).reshape(pstate.mesh)
    axes = (pstate.dp_axes[0],) + pstate.fsdp_axes
    index = tuple(slice(None) if a in axes else c for a, c in pstate.coords.items())
    layout = grid[index].reshape(pstate.dp_replicate_size, -1)
    # DDP: a shard group of one rank (the state creates it for this case)
    shard = pstate.groups[_fsdp_key(pstate)] if shard is None else shard
    return DeviceMesh.from_group([rep, shard], pstate.device_type, mesh=layout.tolist(),
                                 mesh_dim_names=("dp_replicate", "dp_shard"))


def _fsdp_key(pstate: ParallelState):
    from veomni_tpu_torch.parallel.parallel_state import _key

    return _key(pstate.fsdp_axes)


def _sharded_modules(module: nn.Module) -> List[nn.Module]:
    """The modules that get a ``fully_shard`` of their own: decoder layers and
    vision-tower blocks, innermost first."""
    from veomni_tpu_torch.models.transformer import DecoderLayer

    out = []
    for m in module.modules():
        if isinstance(m, DecoderLayer) or type(m).__name__.endswith("Block"):
            out.append(m)
    return out


class ParallelLayout:
    """A model laid out over the mesh by :func:`apply_parallel_plan`."""

    def __init__(self, module: nn.Module, pstate: ParallelState,
                 rules: Dict[nn.Parameter, ParamRule]):
        self.module = module
        self.pstate = pstate
        self.rules = rules

    # -------------------------------------------------------------- gradients
    def finish_grads(self) -> None:
        """Sum the gradients FSDP2 does not reduce: replicated parameters over
        dp×sp, experts over the axes they are replicated on (one all-reduce
        of a flat buffer per group)."""
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for p, rule in self.rules.items():
            if rule.kind == "fsdp" or p.grad is None:
                continue
            if self.pstate.group(rule.grad_axes) is None:
                continue
            by_axes.setdefault(tuple(rule.grad_axes), []).append(p.grad)
        for axes, grads in by_axes.items():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.pstate.group(axes))
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def grad_norm(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]):
        """The global L2 norm of the gradients over every shard: each rank's
        squared local norms, each weighted by one over the ranks holding the
        same elements, summed over the world."""
        total = None
        for p, g in zip(params, grads):
            local = g.to_local() if hasattr(g, "to_local") else g
            term = local.float().pow(2).sum() / self.rules[p].copies
            total = term if total is None else total + term
        dist.all_reduce(total)
        return total.sqrt()

    # ------------------------------------------------------------- full state
    def full_tensor(self, p: nn.Parameter, t: torch.Tensor) -> torch.Tensor:
        """The unsharded value of ``t``, a tensor laid out as parameter
        ``p`` (the parameter itself, its gradient or an optimizer moment).
        Collective over the parameter's groups: every rank calls it."""
        rule = self.rules[p]
        if hasattr(t, "full_tensor"):  # an FSDP2 shard
            return self._gather_shards(p, t.to_local())
        if rule.kind != "expert" or tuple(t.shape) == tuple(rule.full_shape):
            return t
        if rule.feature_dim is not None:
            t = all_gather(t.contiguous(), self.pstate.group(self.pstate.ep_fsdp_axes),
                           rule.feature_dim)
        if rule.ep_dim is not None:
            t = all_gather(t.contiguous(), self.pstate.group((AXIS_EP,)), rule.ep_dim)
        return t

    def _gather_shards(self, p: nn.Parameter, local: torch.Tensor) -> torch.Tensor:
        """FSDP2's even pieces of ``p``'s dim (the plan shards only a
        divisible dim) all-gathered over the mesh's last dim. DTensor's own
        ``full_tensor`` goes through the functional collectives, which crash
        on CUDA tensors over gloo (ranks sharing a card); the c10d
        all-gather takes them."""
        mesh = p.device_mesh
        return all_gather(local.contiguous(), mesh.get_group(mesh.ndim - 1), self.rules[p].dim)

    def local_slice(self, p: nn.Parameter, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the unsharded value ``full`` of parameter ``p``."""
        rule, ps = self.rules[p], self.pstate
        if rule.kind == "fsdp":
            mesh = p.device_mesh  # the shard dim is the mesh's last
            return _chunk(full, rule.dim, mesh.size(mesh.ndim - 1),
                          mesh.get_local_rank(mesh.ndim - 1))
        if rule.kind == "expert":
            if rule.ep_dim is not None:
                full = _chunk(full, rule.ep_dim, ps.ep_size, ps.coords[AXIS_EP])
            if rule.feature_dim is not None:
                n = ps.axis_size(ps.ep_fsdp_axes)
                full = _chunk(full, rule.feature_dim, n, ps.axis_index(ps.ep_fsdp_axes))
        return full

    def to_layout(self, p: nn.Parameter, full: torch.Tensor) -> torch.Tensor:
        """``full`` laid out as parameter ``p``: a DTensor shard for an FSDP
        parameter, the local slice otherwise (on the parameter's device)."""
        local = self.local_slice(p, full).to(p.device)
        if self.rules[p].kind == "fsdp":
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(local.contiguous(), p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape, stride=p.stride())
        return local

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """{state_dict key: unsharded tensor} of the module (collective)."""
        out = {}
        for name, p in self.module.named_parameters():
            out[name] = self.full_tensor(p, p.detach())
        for name, b in self.module.named_buffers():
            out[name] = b.detach()
        return out

    @torch.no_grad()
    def load_full_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for name, p in self.module.named_parameters():
            local = self.local_slice(p, state[name]).to(p.device, p.dtype)
            target = p.to_local() if hasattr(p, "to_local") else p.data
            target.copy_(local)

    # ----------------------------------------------------------------- entry
    def entry(self, fn: Callable) -> Callable:
        """``fn(module, batch)`` run as the root's FSDP2 forward: the root's
        own parameters are gathered for the call and its gradients reduced
        after the backward (``register_fsdp_forward_method``)."""
        from torch.distributed.fsdp import FSDPModule, register_fsdp_forward_method

        module = self.module
        if not isinstance(module, FSDPModule):
            return fn
        self._entries = getattr(self, "_entries", 0) + 1
        name = f"_parallel_entry_{self._entries}"
        setattr(module, name, types.MethodType(lambda mod, batch: fn(mod, batch), module))
        register_fsdp_forward_method(module, name)
        bound = getattr(module, name)

        def run(mod, batch):
            return bound(batch) if mod is module else fn(mod, batch)

        return run


def _expert_gather(rule: ParamRule, pstate: ParallelState) -> Callable:
    group = pstate.group(pstate.ep_fsdp_axes)

    def gather(p):
        return all_gather(p, group, rule.feature_dim)

    return gather


def apply_parallel_plan(module: nn.Module, pstate: ParallelState,
                        plan: Optional[ParallelPlan] = None,
                        frozen: bool = False) -> Optional[ParallelLayout]:
    """Lay ``module`` out over the mesh per ``plan`` (the model family's by
    default). None at world size 1, where nothing changes. ``frozen``: a
    frozen LoRA base, whose dense weights stay replicated and whose experts
    keep only their ``ep`` split."""
    if pstate.world_size == 1:
        return None
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    cfg = getattr(module, "cfg", None)
    plan = plan or model_parallel_plan(cfg)
    rules = param_rules(module, plan, pstate)
    names = {p: n for n, p in module.named_parameters()}
    lora = getattr(module, "named_jax_parameters", None) is not None
    layout = ParallelLayout(module, pstate, rules)
    # each expert keeps its slice: E/ep experts, and its feature shard,
    # which the owning decoder layer gathers where it reads the weight
    for p, rule in rules.items():
        if rule.kind != "expert":
            continue
        if frozen:
            rule.feature_dim = None
            rule.grad_axes = pstate.ep_replicate_axes + pstate.ep_fsdp_axes
            rule.copies = pstate.world_size // (pstate.ep_size if rule.ep_dim is not None else 1)
        with torch.no_grad():
            p.data = layout.local_slice(p, p.data).clone()
        if rule.feature_dim is not None:
            owner = _layer_of(module, p)
            owner.gathers[_qualified(owner, p)] = _expert_gather(rule, pstate)
    # a frozen base, or a mesh whose fsdp axes and dp_replicate are 1, shards
    # no dense weight: each stays whole on every rank
    mesh = None if lora or frozen else _fsdp_mesh(pstate)
    if mesh is None:
        for rule in rules.values():
            if rule.kind == "fsdp":
                rule.kind, rule.dim = "replicated", None
                rule.grad_axes, rule.copies = pstate.dp_sp_axes, pstate.world_size
        return layout
    ignored = {p for p, r in rules.items() if r.kind != "fsdp"}

    def placement(p):
        return Shard(rules[p].dim)

    for sub in _sharded_modules(module):
        fully_shard(sub, mesh=mesh, shard_placement_fn=placement,
                    ignored_params={p for p in sub.parameters() if p in ignored})
    fully_shard(module, mesh=mesh, shard_placement_fn=placement, ignored_params=ignored)
    for sub in module.modules():
        if hasattr(sub, "set_gradient_divide_factor"):
            # a plain sum (gloo has no pre-multiplied sum, FSDP2's default here)
            sub.set_gradient_divide_factor(1.0)
            sub.set_force_sum_reduction_for_comms(True)
    # FSDP2 swapped each sharded parameter for a DTensor one: re-key the rules
    by_name = {names[p]: r for p, r in rules.items()}
    layout.rules = {p: by_name[n] for n, p in module.named_parameters()}
    return layout


def _layer_of(module: nn.Module, p: nn.Parameter) -> nn.Module:
    """The innermost module with a ``gathers`` table owning ``p``."""
    best = None
    for mod in module.modules():
        if hasattr(mod, "gathers") and any(q is p for q in mod.parameters()):
            best = mod
    return best


def _qualified(owner: nn.Module, p: nn.Parameter) -> str:
    for n, q in owner.named_parameters():
        if q is p:
            return n
    raise KeyError("parameter not under its owner")


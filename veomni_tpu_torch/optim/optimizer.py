"""Optimizer builder: the reference's ``build_optimizer`` on torch.

Port of ``veomni_tpu/optim/optimizer.py`` (``:25-61``): ``adamw``,
``anyprecision_adamw``, ``adafactor``, ``sgd`` and ``muon``
(``optim/muon.py``); any other name raises ``ValueError``. Every optimizer
here takes its learning rate from a closed-form schedule of its update
count ``num_updates``, read before each update (optax's
``scale_by_learning_rate``), times a parameter group's ``lr_scale``
(:func:`with_param_groups`).

``adamw`` is ``torch.optim.AdamW``, which computes ``optax.adamw``'s update
(eps outside the square root, decoupled weight decay scaled by the
learning rate) up to f32 rounding order. Its bookkeeping:

* weight decay follows the reference's mask, ``ndim > 1`` taken on the
  reference's tree (``optimizer.py:21-22``). That tree stacks per-layer
  leaves on a leading axis, so every per-layer parameter, norm weights
  included, has ``ndim > 1`` there and is decayed; only the unstacked
  top-level 1-D parameter (the final ``norm``) is not. The port keeps that
  behaviour, not the 1-D rule it reads like; a VLM's tree stacks its
  tower's blocks too, so of the tower only the merger's 1-D leaves are not
  decayed;
* a parameter without a gradient is still decayed, as optax decays every
  leaf of ``jax.grad``'s full tree: ``torch.optim.AdamW`` skips a parameter
  whose ``.grad`` is None, so ``train/train_step.py`` gives each one a
  zero gradient first. The deepseek router's ``e_score_correction_bias``
  reaches the loss only through the expert choice and is such a parameter:
  with a zero gradient its moments stay 0 and the step shrinks it by
  ``lr * weight_decay * p``, as the reference does.

The others follow optax's math step by step. ``anyprecision_adamw``
keeps its first moment in bf16 (its variance in f32), which
``torch.optim.AdamW`` cannot store; it and ``sgd`` update each parameter
on its own (:class:`ParamOptimizer`). Adafactor and Muon read a leaf of
the reference's tree (``models/jax_weights.py::reference_leaves``) whole
(:class:`LeafOptimizer`): Adafactor's block clip and parameter scale take
one RMS over a stacked ``[L, ...]`` leaf, and Muon orthogonalises a
stacked 1-D leaf as one matrix.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from veomni_tpu_torch.models.jax_weights import reference_leaves
from veomni_tpu_torch.optim import muon as muon_math
from veomni_tpu_torch.optim.lr_scheduler import Schedule

Leaf = Tuple[str, List[torch.Tensor], bool]  # (reference path, parameters, stacked)


def _decayed(name: str, param: torch.Tensor) -> bool:
    """``ndim > 1`` on the reference's tree: every stacked per-layer leaf
    (the text layers; a VLM's ``language_model.layers`` and tower
    ``blocks``, an omni thinker's audio ``layers``) and every matrix."""
    name = name.removeprefix("language_model.")
    return param.ndim > 1 or name.startswith(("layers.", "vision_tower.blocks.",
                                              "audio_tower.layers."))


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose learning rate is ``lr_schedule(n)`` for
    its ``n``-th update (counted from 0), times a group's ``lr_scale``
    (:func:`with_param_groups`)."""

    def __init__(self, params, lr_schedule: Schedule, **kwargs):
        super().__init__(params, lr=lr_schedule(0), **kwargs)
        self.lr_schedule = lr_schedule
        self.num_updates = 0

    def regrouped(self, groups) -> "AdamW":
        d = self.defaults
        return AdamW(groups, self.lr_schedule, betas=d["betas"], eps=d["eps"])

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.lr_schedule(self.num_updates)
        for group in self.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        loss = super().step(closure)
        self.num_updates += 1
        return loss


class ParamOptimizer(torch.optim.Optimizer):
    """An optimizer that updates each parameter with a gradient on its own,
    at ``lr_schedule(n) * lr_scale`` for its ``n``-th update. The optax
    count is ``num_updates + 1`` during an update; a skipped step (``step``
    not called) leaves it, and every moment, untouched. A subclass
    implements :meth:`update_param`."""

    def __init__(self, groups, lr_schedule: Schedule, **defaults):
        super().__init__(groups, dict(lr=lr_schedule(0), **defaults))
        self.lr_schedule = lr_schedule
        self.num_updates = 0
        self._options = dict(defaults)

    def regrouped(self, groups) -> "ParamOptimizer":
        return type(self)(groups, self.lr_schedule, **self._options)

    def _set_lrs(self) -> None:
        lr = self.lr_schedule(self.num_updates)
        for group in self.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)

    @torch.no_grad()
    def step(self, closure=None):
        self._set_lrs()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self.update_param(p, group, self.num_updates + 1)
        self.num_updates += 1

    def update_param(self, p: torch.Tensor, group: dict, count: int) -> None:
        raise NotImplementedError


class LeafOptimizer(ParamOptimizer):
    """A :class:`ParamOptimizer` that updates the reference's leaves one at
    a time, a stacked leaf's parameters together. A subclass implements
    :meth:`update_leaves`, reading a parameter's state and group through
    :meth:`key`.

    Muon's Newton–Schulz and Adafactor's block clip and RMS read a whole
    leaf. Over a mesh (``layout``, set by the trainer) each leaf's
    parameters and gradients are gathered whole on every rank and updated
    as at world size 1, and each rank keeps its part of the parameters and
    of the state, as the reference's ``resolve_state_shardings``
    (``veomni_tpu/train/train_step.py:71``) lays the state out: a state
    tensor of the parameter's shape (a moment) takes the parameter's layout
    (``ParallelLayout.to_layout``: FSDP2's shard, an expert's slice, whole
    where the parameter is replicated), and any other (Adafactor's factored
    row and column statistics, a stacked leaf's whole second moment) is cut
    along its first dim that the world divides. The state is gathered with
    the leaf for the update and cut again after it."""

    layout = None  # parallel/parallel_plan.py::ParallelLayout over a mesh

    def __init__(self, groups, lr_schedule: Schedule, leaves: Sequence[Leaf], **defaults):
        super().__init__(groups, lr_schedule, **defaults)
        self.leaves = list(leaves)
        self._owner: Dict[int, torch.Tensor] = {}
        # (id of the parameter, state name) -> the dim a statistic is cut
        # along, or "param" for a moment laid out as its parameter
        self._cut: Dict[Tuple[int, str], Union[int, str, None]] = {}

    def regrouped(self, groups) -> "LeafOptimizer":
        return type(self)(groups, self.lr_schedule, self.leaves, **self._options)

    def key(self, p: torch.Tensor) -> torch.Tensor:
        """The parameter whose state and group ``p`` (maybe its whole copy) uses."""
        return self._owner.get(id(p), p)

    @torch.no_grad()
    def step(self, closure=None):
        self._set_lrs()
        group_of = {p: group for group in self.param_groups for p in group["params"]}
        live = [leaf for leaf in self.leaves if leaf[1][0].grad is not None]
        if self.layout is None:
            self.update_leaves(live, group_of, self.num_updates + 1)
        else:
            self._update_whole(live, group_of)
        self.num_updates += 1

    def _update_whole(self, leaves, group_of) -> None:
        layout = self.layout
        whole_leaves, pairs = [], []
        for path, params, stacked in leaves:
            copies = []
            for p in params:
                w = layout.full_tensor(p, p.detach()).clone()
                w.grad = layout.full_tensor(p, p.grad)
                self._owner[id(w)] = p
                copies.append(w)
                pairs.append((p, w))
            whole_leaves.append((path, copies, stacked))
        owners = [p for p, _ in pairs if self.state.get(p)]
        for p in owners:
            self.state[p] = {k: self.gather_state(p, k, v) for k, v in self.state[p].items()}
        try:
            self.update_leaves(whole_leaves, group_of, self.num_updates + 1)
        finally:
            self._owner.clear()
        for p, w in pairs:
            local = p.to_local() if hasattr(p, "to_local") else p.data
            local.copy_(layout.local_slice(p, w))
            if self.state.get(p):
                self.state[p] = {k: self.cut_state(p, k, v) for k, v in self.state[p].items()}

    # ------------------------------------------------- the state over a mesh
    def gather_state(self, p: torch.Tensor, name: str, t):
        """State ``name`` of parameter ``p`` whole (collective: every rank
        calls it for the same tensors in the same order)."""
        if not torch.is_tensor(t) or t.ndim == 0 or self.layout is None:
            return t
        dim = self._cut.get((id(p), name))
        if dim == "param":
            return self.layout.full_tensor(p, t)
        if dim is None:
            return t
        import torch.distributed as dist

        world = dist.get_world_size()
        part = t.movedim(dim, 0).contiguous()
        out = part.new_empty((world * part.shape[0],) + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(out, part)
        return out.movedim(0, dim)

    def cut_state(self, p: torch.Tensor, name: str, t):
        """This rank's part of the whole state ``name`` of parameter ``p``."""
        if not torch.is_tensor(t) or t.ndim == 0 or self.layout is None:
            return t
        rule = self.layout.rules[p]
        if tuple(t.shape) == tuple(rule.full_shape):
            self._cut[(id(p), name)] = "param"
            return self.layout.to_layout(p, t)
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        dim = next((d for d, n in enumerate(t.shape) if n % world == 0 and n >= world), None)
        self._cut[(id(p), name)] = dim
        return t if dim is None else t.chunk(world, dim)[rank].clone()

    def update_leaves(self, leaves: List[Leaf], group_of, count: int) -> None:
        raise NotImplementedError


def _stack(tensors: List[torch.Tensor], stacked: bool) -> torch.Tensor:
    return torch.stack(tensors) if stacked else tensors[0]


def _scatter_update(params: List[torch.Tensor], stacked: bool, update: torch.Tensor) -> None:
    """``p += update`` for each parameter of a leaf (its row when stacked)."""
    for i, p in enumerate(params):
        p.add_(update[i] if stacked else update)


def _adam_direction(p, g, state, b1, b2, eps, count, mu_dtype=None):
    """optax ``scale_by_adam`` for one parameter: the moments in f32 (the
    first stored as ``mu_dtype``), the bias-corrected direction."""
    if not state:
        state["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype)
        state["exp_avg_sq"] = torch.zeros_like(p)
    # optax multiplies the stored moment by b1 taken in the moment's dtype
    # (a weakly typed scalar): for a bf16 moment that is bf16(0.9) = 0.8984375
    m = state["exp_avg"]
    mu = (1 - b1) * g + torch.tensor(b1, dtype=m.dtype).item() * m.to(g.dtype)
    nu = (1 - b2) * (g * g) + b2 * state["exp_avg_sq"]
    direction = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count)) + eps)
    state["exp_avg"] = mu.to(mu_dtype) if mu_dtype is not None else mu
    state["exp_avg_sq"] = nu
    return direction


class AnyPrecisionAdamW(ParamOptimizer):
    """``optax.adamw(mu_dtype=bfloat16)``: the first moment is computed in
    f32 from its stored bf16 value and stored back in bf16; the variance
    stays f32 (``optimizer.py:37-41``). Weight decay follows the AdamW
    mask (each group's ``weight_decay``)."""

    def update_param(self, p, group, count):
        b1, b2 = group["betas"]
        u = _adam_direction(p, p.grad, self.state[p], b1, b2, group["eps"], count,
                            mu_dtype=torch.bfloat16)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.add_(u, alpha=-group["lr"])

    def load_state_dict(self, state_dict):
        # the base class casts every float state to its parameter's dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


class SGD(ParamOptimizer):
    """``optax.sgd(lr)``: ``p - lr * g``, no momentum, no decay."""

    def update_param(self, p, group, count):
        p.add_(p.grad, alpha=-group["lr"])


def _factored_dims(shape, min_dim: int = 128) -> Optional[Tuple[int, int]]:
    """optax ``_factored_dims``: the two largest axes (second largest,
    largest) when the second largest is at least ``min_dim``."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # np.argsort's order
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


class Adafactor(LeafOptimizer):
    """``optax.adafactor(learning_rate=lr)`` at optax's defaults: factored
    second moments over the two largest axes of a leaf whose second
    largest is at least 128 (else a full one), decay ``1 - t**-0.8``, eps
    1e-30, the update clipped to block RMS 1, scaled by the learning rate
    and by the leaf's RMS (at least 1e-3). Each leaf is the reference's
    (stacked when the reference stacks it): the clip and the parameter
    scale take one RMS over all its layers. The leaf's state lives with
    its first parameter."""

    EPS = 1e-30
    DECAY = 0.8
    CLIP = 1.0
    MIN_SCALE = 1e-3

    def update_leaves(self, leaves, group_of, count):
        decay = 1.0 - float(count) ** -self.DECAY
        for _, params, stacked in leaves:
            g = _stack([p.grad for p in params], stacked)
            p = _stack(params, stacked)
            st = self.state[self.key(params[0])]
            sq = g * g + self.EPS
            dims = _factored_dims(tuple(g.shape))
            if dims is not None:
                d1, d0 = dims
                if not st:
                    st["v_row"] = torch.zeros_like(sq.mean(dim=d0))
                    st["v_col"] = torch.zeros_like(sq.mean(dim=d1))
                v_row = decay * st["v_row"] + (1.0 - decay) * sq.mean(dim=d0)
                v_col = decay * st["v_col"] + (1.0 - decay) * sq.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                st["v_row"], st["v_col"] = v_row, v_col
            else:
                if not st:
                    st["v"] = torch.zeros_like(g)
                v = decay * st["v"] + (1.0 - decay) * sq
                u = g * v ** -0.5
                st["v"] = v
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.CLIP, min=1.0)
            u = u * group_of[self.key(params[0])]["lr"]
            u = u * torch.clamp(torch.sqrt(torch.mean(p * p)), min=self.MIN_SCALE)
            _scatter_update(params, stacked, -u)


class Muon(LeafOptimizer):
    """``build_muon`` (``veomni_tpu/optim/muon.py:68-96``): Nesterov
    momentum 0.95 and Newton–Schulz on the ``muon`` leaves, then
    ``+ weight_decay * p`` and the learning rate; optax's AdamW at its
    default betas and eps, decaying every leaf, on the ``adamw`` leaves
    (``optim/muon.py`` says which). Both at the same schedule."""

    def __init__(self, groups, lr_schedule, leaves, **defaults):
        super().__init__(groups, lr_schedule, leaves, **defaults)
        self.labels = {path: muon_math.muon_label(
            path, params[0].ndim + (1 if stacked else 0)) for path, params, stacked in self.leaves}

    def update_leaves(self, leaves, group_of, count):
        mom = muon_math.MOMENTUM
        b1, b2 = muon_math.ADAMW_BETAS
        matrices, owners = [], []
        for path, params, stacked in leaves:
            if self.labels[path] == "adamw":
                for p in params:
                    group = group_of[self.key(p)]
                    u = _adam_direction(p, p.grad, self.state[self.key(p)], b1, b2,
                                        muon_math.ADAMW_EPS, count)
                    if group["weight_decay"]:
                        u = u + group["weight_decay"] * p
                    p.add_(u, alpha=-group["lr"])
                continue
            effs = []
            for p in params:
                st = self.state[self.key(p)]
                if not st:
                    st["momentum_buffer"] = torch.zeros_like(p)
                buf = mom * st["momentum_buffer"] + p.grad
                st["momentum_buffer"] = buf
                effs.append(mom * buf + p.grad)  # Nesterov
            matrices.append(_stack(effs, stacked))
            owners.append((params, stacked))
        orth = muon_math.orthogonalize_leaves(matrices)
        for o, (params, stacked) in zip(orth, owners):
            for i, p in enumerate(params):
                u = o[i] if stacked else o
                group = group_of[self.key(p)]
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.add_(u, alpha=-group["lr"])


def build_optimizer(
    model: nn.Module,
    *,
    optimizer: str = "adamw",
    lr: Union[float, Callable[[int], float]] = 1e-5,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> torch.optim.Optimizer:
    """The reference's ``build_optimizer`` over ``model``'s parameters:
    AdamW and ``anyprecision_adamw`` decay by the reference's mask, Muon
    decays every leaf, Adafactor and SGD do not decay (the reference passes
    them no weight decay)."""
    schedule = lr if callable(lr) else (lambda n: lr)
    named = list(model.named_parameters())
    if optimizer in ("adamw", "anyprecision_adamw"):
        decay = [p for n, p in named if _decayed(n, p)]
        rest = [p for n, p in named if not _decayed(n, p)]
        groups = [{"params": decay, "weight_decay": weight_decay},
                  {"params": rest, "weight_decay": 0.0}]
        if optimizer == "adamw":
            return AdamW(groups, schedule, betas=betas, eps=eps)
        return AnyPrecisionAdamW(groups, schedule, betas=tuple(betas), eps=eps)
    if optimizer == "muon":
        return Muon([{"params": [p for _, p in named], "weight_decay": weight_decay}],
                    schedule, reference_leaves(model))
    if optimizer == "adafactor":
        return Adafactor([{"params": [p for _, p in named]}], schedule, reference_leaves(model))
    if optimizer == "sgd":
        return SGD([{"params": [p for _, p in named]}], schedule)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def split_mixed_groups(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Over a mesh an FSDP2 parameter is a DTensor and a replicated or
    expert one a plain tensor, and a foreach update (AdamW's on the card)
    refuses a list that mixes them: each param group is split into its
    DTensor parameters and the rest, with the same options. The optimizer
    is returned as it is when no group mixes them; it must not have stepped."""
    groups = []
    for group in optimizer.param_groups:
        opts = {k: v for k, v in group.items() if k != "params"}
        for sharded in (True, False):
            params = [p for p in group["params"] if hasattr(p, "to_local") == sharded]
            if params:
                groups.append({**opts, "params": params})
    if len(groups) == len(optimizer.param_groups):
        return optimizer
    return optimizer.regrouped(groups)


def with_param_groups(
    optimizer: torch.optim.Optimizer,
    named_params: Sequence[Tuple[str, torch.Tensor]],
    *,
    freeze_patterns: Sequence[str] = (),
    lr_scales: Optional[Dict[str, float]] = None,
) -> torch.optim.Optimizer:
    """Per-module freeze and learning-rate scaling over the reference's leaf
    paths (``veomni_tpu/optim/optimizer.py:84-123``): a parameter whose path
    matches a ``freeze_patterns`` regex has its update scaled by 0 (the
    first match wins over ``lr_scales``); else the first matching
    ``lr_scales`` regex scales it; else 1. ``named_params`` are (path,
    parameter) pairs (``models/jax_weights.py::named_jax_parameters``).

    The reference multiplies the optimizer's whole update, decay included,
    by the scale. Every optimizer here applies its update at the learning
    rate, so each scale becomes a parameter group whose learning rate is
    the schedule's times the scale, which is the same update; at scale 0
    the parameter stays bit-unchanged while its moments still move, as in
    the reference. A scale follows a leaf's path, so a stacked leaf never
    spans two groups. Returns a new optimizer of the same kind over the
    same parameters (built before any step: it carries no state over)."""

    def scale_of(path: str) -> float:
        for pat in freeze_patterns:
            if re.search(pat, path):
                return 0.0
        for pat, scale in (lr_scales or {}).items():
            if re.search(pat, path):
                return float(scale)
        return 1.0

    if optimizer.state:
        raise ValueError("with_param_groups regroups a fresh optimizer, before its first step")
    scales = {id(p): scale_of(path) for path, p in named_params}
    groups = []
    for group in optimizer.param_groups:
        by_scale: Dict[float, list] = {}
        for p in group["params"]:
            by_scale.setdefault(scales[id(p)], []).append(p)
        for scale, params in by_scale.items():
            extra = {k: group[k] for k in ("weight_decay",) if k in group}
            groups.append({"params": params, "lr_scale": scale, **extra})
    return optimizer.regrouped(groups)

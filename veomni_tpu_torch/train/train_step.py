"""The training step: grad accumulation, clipping, optimizer update.

Port of ``veomni_tpu/train/train_step.py`` (``build_train_step``, ``:87``).
Loss/grad normalization follows the reference: token-sum losses are
accumulated over the A micro-batches of a ``[A, B, S]`` batch and the
gradients are divided once by the global valid-token count (``:159-176``),
so packing imbalance never skews them. Frozen modules' gradients are
zeroed (``grad_mask``, ``:177-178``), then a global-norm clip with
``min(1, max / (norm + 1e-6))`` (``:179-186``) and the optimizer update.

The loss fn's other scalar metrics (``loss_sum``, ``moe_aux_loss``, ...)
come back averaged over the micro-batches, vector ones summed, as the
reference's extras (``:145-174``).

``step_ok`` (finite loss and finite grad norm) is always returned; with
``skip_nonfinite`` a step that is not ok leaves parameters and optimizer
state untouched (``:197-204``). The reference gates on device; eager
PyTorch reads the flag on the host once per step, which is where the
metrics are read anyway.

The step updates the model and optimizer in place (the reference returns a
new state; PyTorch's idiom is in-place, which also saves a copy of the
weights and optimizer state).

Over a mesh (``layout``, ``parallel/parallel_plan.py::ParallelLayout``) the
reference's one program becomes one per rank, and the step reproduces its
global arithmetic: each rank's token-sum gradients are summed over the
ranks (FSDP2's reduce-scatter with a divide factor of 1, then
``layout.finish_grads`` for the parameters FSDP does not hold), the token
count and the loss sum are all-reduced over dp×sp, and the gradients are
divided once by the global count. The global-norm clip reads the norm of
every shard (``layout.grad_norm``), so ``step_ok`` and the skip gate agree
on every rank. The loss fn's scalar extras are averaged over dp×sp (a
global one, like the router's aux loss, stays what it is), ``loss_sum``
and vector extras summed.

``numerics_spec`` builds the numerics observatory's instrumented sibling
(``:176-216``): the same update, plus the per-group health summary of
``observability/numerics.py::tree_health`` over the token-normalized,
mask-applied, pre-clip gradients, the parameters before the update and
the update itself. In place, the update is read as the difference of a
parameter snapshot taken for that step alone. ``apply=False`` (the
supervisor's anomaly diagnosis, which the reference runs on a sibling
whose returned state it discards) computes the update and undoes it: the
parameters, the optimizer's moments and its update count are left
bit-unchanged. A skipped step (``skip_nonfinite``) still computes the
update it did not apply, as the reference's sibling does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, Optional, Sequence

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def build_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def build_train_step(
    loss_fn: Callable,
    *,
    max_grad_norm: float = 1.0,
    grad_mask: Optional[Sequence[torch.Tensor]] = None,
    scope: Optional[Callable[[nn.Module], ContextManager]] = None,
    skip_nonfinite: bool = False,
    numerics_spec=None,
    layout=None,
) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``loss_fn(model, micro_batch) -> (token_sum_loss, metrics)`` with
    ``metrics["ntokens"]``; ``batch`` leaves are ``[A, B, S]`` tensors.
    Metrics: ``loss``, ``grad_norm``, ``ntokens``, ``step_ok`` and the loss
    fn's extras (tensors on the model's device).

    ``grad_mask``: the parameters of frozen modules (``freeze_modules``),
    whose gradients are multiplied by 0 before the global-norm clip, so they
    neither shrink the others' clip budget nor count in ``grad_norm``
    (``:177-178``).

    ``scope(model)``: a context held over the micro-batches' forward and
    backward passes (LoRA: ``LoraAdapters.merged``, so that a backward which
    recomputes remat regions reads the merged weights again).

    With ``numerics_spec`` the step is ``train_step(state, batch,
    apply=True) -> (state, metrics, health)`` (see the module docstring).

    ``layout``: the model's ``ParallelLayout`` over a mesh of several ranks
    (None at world size 1)."""
    masked = {id(p) for p in grad_mask or ()}
    group = None
    if layout is not None:
        group = layout.pstate.group(layout.pstate.dp_sp_axes)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], apply: bool = True):
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        n_micro = next(iter(batch.values())).shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        ntokens = torch.zeros((), dtype=torch.int64, device=params[0].device)
        extras: Dict[str, torch.Tensor] = {}
        with scope(state.model) if scope else contextlib.nullcontext():
            for a in range(n_micro):
                micro = {k: v[a] for k, v in batch.items()}
                loss, metrics = loss_fn(state.model, micro)
                loss.backward()  # token-sum grads accumulate in p.grad
                loss_sum += loss.detach()
                ntokens += metrics["ntokens"]
                for k, v in metrics.items():
                    if k != "ntokens" and v.ndim <= 1:
                        extras[k] = extras.get(k, 0.0) + v.detach().float()
        # scalar extras average over micro-steps; vector extras accumulate
        extras = {k: v / n_micro if v.ndim == 0 else v for k, v in extras.items()}
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p, g in zip(params, grads):
            p.grad = g
        if layout is not None:
            layout.finish_grads()
            loss_sum, ntokens, extras = _reduce_metrics(loss_sum, ntokens, extras, group)
        # the rank's part of each gradient (an FSDP2 gradient is a DTensor shard)
        shards = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
        denom = ntokens.clamp(min=1).float()
        torch._foreach_div_(shards, denom)
        if masked:
            torch._foreach_mul_([g for p, g in zip(params, shards) if id(p) in masked], 0.0)
        if layout is not None:
            grad_norm = layout.grad_norm(params, grads)
        else:
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        health_grads = [g.clone() for g in grads] if numerics_spec is not None else None
        if max_grad_norm:
            torch._foreach_mul_(shards, torch.clamp(max_grad_norm / (grad_norm + 1e-6), max=1.0))
        step_ok = torch.isfinite(loss_sum) & torch.isfinite(grad_norm)
        applies = apply and (not skip_nonfinite or bool(step_ok))
        health = None
        if numerics_spec is None:
            if applies:
                state.optimizer.step()
        else:
            health = _instrumented_update(state, params, health_grads, numerics_spec, applies,
                                          layout)
        if apply:
            state.step += 1
        metrics = {
            "loss": loss_sum / denom,
            "grad_norm": grad_norm,
            "ntokens": ntokens,
            "step_ok": step_ok,
            **extras,
        }
        if numerics_spec is not None:
            return state, metrics, health
        return state, metrics

    return train_step


def _reduce_metrics(loss_sum, ntokens, extras, group):
    """The step's metrics over dp×sp: the loss and token sums and vector
    extras summed, scalar extras averaged (``loss_sum`` is a sum)."""
    import torch.distributed as dist

    if group is None:
        return loss_sum, ntokens, extras
    n = dist.get_world_size(group)
    names = sorted(extras)
    flat = torch.cat([loss_sum.double().reshape(1), ntokens.double().reshape(1)]
                     + [extras[k].reshape(-1).double() for k in names])
    dist.all_reduce(flat, group=group)
    out, offset = {}, 2
    for k in names:
        v = extras[k]
        piece = flat[offset:offset + v.numel()].view_as(v)
        offset += v.numel()
        out[k] = (piece if (v.ndim > 0 or k == "loss_sum") else piece / n).to(v.dtype)
    return flat[0].to(loss_sum.dtype), flat[1].round().to(ntokens.dtype), out


@torch.no_grad()
def _instrumented_update(state: TrainState, params, health_grads, spec, applies: bool,
                         layout=None):
    """The optimizer update with a parameter snapshot around it, then the
    health summary on the reference's leaves. When ``applies`` is false
    the update is undone: parameters copied back, the optimizer's state
    and update count restored to their snapshot. Over a mesh the summary
    reads the unsharded parameters, gradients and updates (gathered on
    every rank)."""
    from veomni_tpu_torch.models.jax_weights import reference_leaves
    from veomni_tpu_torch.observability.numerics import tree_health

    opt = state.optimizer
    all_params = list(state.model.parameters())
    before = {p: p.detach().clone() for p in all_params}
    saved = None
    if not applies:
        saved = ({p: {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state[p].items()}
                  for p in all_params if p in opt.state},
                 getattr(opt, "num_updates", None), [g["lr"] for g in opt.param_groups])
    opt.step()
    updates = {p: p.detach() - before[p] for p in all_params}
    if saved is not None:
        st, n, lrs = saved
        for p in all_params:
            p.copy_(before[p])
            opt.state.pop(p, None)
            if p in st:
                opt.state[p] = st[p]
        if n is not None:
            opt.num_updates = n
        for g, lr in zip(opt.param_groups, lrs):
            g["lr"] = lr
    grad_of = dict(zip(params, health_grads))
    leaves = reference_leaves(state.model)

    def values(table, ps, stacked):
        # a parameter outside the step (no gradient) reads as a zero gradient
        vals = [table[p] if p in table else torch.zeros_like(p) for p in ps]
        if layout is not None:
            vals = [layout.full_tensor(p, v) for p, v in zip(ps, vals)]
        return vals if stacked else vals[0]

    return tree_health(
        [path for path, _, _ in leaves],
        [values(before, ps, st) for _, ps, st in leaves],
        [values(grad_of, ps, st) for _, ps, st in leaves],
        [values(updates, ps, st) for _, ps, st in leaves],
        max_groups=spec.max_groups, eps=spec.eps,
    )

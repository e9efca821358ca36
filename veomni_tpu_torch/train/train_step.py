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
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, Optional, Sequence, Tuple

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
    recomputes remat regions reads the merged weights again)."""
    masked = {id(p) for p in grad_mask or ()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict]:
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
        denom = ntokens.clamp(min=1).float()
        torch._foreach_div_(grads, denom)
        if masked:
            torch._foreach_mul_([g for p, g in zip(params, grads) if id(p) in masked], 0.0)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if max_grad_norm:
            torch._foreach_mul_(grads, torch.clamp(max_grad_norm / (grad_norm + 1e-6), max=1.0))
        step_ok = torch.isfinite(loss_sum) & torch.isfinite(grad_norm)
        if not skip_nonfinite or bool(step_ok):
            state.optimizer.step()
        state.step += 1
        return state, {
            "loss": loss_sum / denom,
            "grad_norm": grad_norm,
            "ntokens": ntokens,
            "step_ok": step_ok,
            **extras,
        }

    return train_step

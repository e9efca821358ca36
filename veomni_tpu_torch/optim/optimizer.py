"""Optimizer builder: AdamW matching ``optax.adamw``.

Port of ``veomni_tpu/optim/optimizer.py`` (AdamW only). ``torch.optim.AdamW``
computes the same update as ``optax.adamw`` (eps outside the square root,
decoupled weight decay scaled by the learning rate) up to f32 rounding
order. What differs is bookkeeping, handled here:

* the learning rate follows a closed-form schedule of the update count,
  read before each update (optax's ``scale_by_learning_rate``);
* weight decay follows the reference's mask, ``ndim > 1`` taken on the
  reference's tree (``optimizer.py:21-22``). That tree stacks per-layer
  leaves on a leading axis, so every per-layer parameter, norm weights
  included, has ``ndim > 1`` there and is decayed; only the unstacked
  top-level 1-D parameter (the final ``norm``) is not. The port keeps that
  behaviour, not the 1-D rule it reads like;
* a parameter without a gradient is still decayed, as optax decays every
  leaf of ``jax.grad``'s full tree: ``torch.optim.AdamW`` skips a parameter
  whose ``.grad`` is None, so ``train/train_step.py`` gives each one a
  zero gradient first. The deepseek router's ``e_score_correction_bias``
  reaches the loss only through the expert choice and is such a parameter:
  with a zero gradient its moments stay 0 and the step shrinks it by
  ``lr * weight_decay * p``, as the reference does.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from veomni_tpu_torch.optim.lr_scheduler import Schedule


def _decayed(name: str, param: torch.Tensor) -> bool:
    return param.ndim > 1 or name.startswith("layers.")


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose learning rate is ``lr_schedule(n)`` for
    its ``n``-th update (counted from 0), times a group's ``lr_scale``
    (:func:`with_param_groups`)."""

    def __init__(self, params, lr_schedule: Schedule, **kwargs):
        super().__init__(params, lr=lr_schedule(0), **kwargs)
        self.lr_schedule = lr_schedule
        self.num_updates = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.lr_schedule(self.num_updates)
        for group in self.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        loss = super().step(closure)
        self.num_updates += 1
        return loss


def build_optimizer(
    model: nn.Module,
    *,
    lr: Union[float, Callable[[int], float]] = 1e-5,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> AdamW:
    """AdamW over ``model``'s parameters (the reference's other optimizers
    are not ported yet)."""
    named = list(model.named_parameters())
    decay = [p for n, p in named if _decayed(n, p)]
    rest = [p for n, p in named if not _decayed(n, p)]
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": rest, "weight_decay": 0.0}]
    schedule = lr if callable(lr) else (lambda n: lr)
    return AdamW(groups, schedule, betas=betas, eps=eps)


def with_param_groups(
    optimizer: AdamW,
    named_params: Sequence[Tuple[str, torch.Tensor]],
    *,
    freeze_patterns: Sequence[str] = (),
    lr_scales: Optional[Dict[str, float]] = None,
) -> AdamW:
    """Per-module freeze and learning-rate scaling over the reference's leaf
    paths (``veomni_tpu/optim/optimizer.py:84-123``): a parameter whose path
    matches a ``freeze_patterns`` regex has its update scaled by 0 (the
    first match wins over ``lr_scales``); else the first matching
    ``lr_scales`` regex scales it; else 1. ``named_params`` are (path,
    parameter) pairs (``models/jax_weights.py::named_jax_parameters``).

    The reference multiplies optax's whole AdamW update, decay included, by
    the scale. Here each scale is a parameter group whose learning rate is
    the schedule's times the scale: ``torch.optim.AdamW`` applies the decay
    and the Adam step both at that rate, which is the same update; at scale
    0 the parameter stays bit-unchanged while its moments still move, as in
    the reference. Returns a new optimizer over the same parameters (built
    before any step: it carries no state over)."""

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
            groups.append({"params": params, "weight_decay": group["weight_decay"],
                           "lr_scale": scale})
    defaults = optimizer.defaults
    return AdamW(groups, optimizer.lr_schedule, betas=defaults["betas"], eps=defaults["eps"])

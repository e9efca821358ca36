"""LR schedules: constant / linear / cosine with warmup + min-lr floor.

Port of ``veomni_tpu/optim/lr_scheduler.py``, which composes optax
schedules. As there, a schedule is a closed-form function of the update
count: update ``n`` (from 0) uses ``lr(n)``, so under warmup the first
update uses ``lr_start`` (0 by default).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda n: init
    return lambda n: (init - end) * (1.0 - min(max(n, 0), steps) / steps) + end


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""

    def schedule(n: int) -> float:
        n = min(n, steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * n / steps)) + alpha)

    return schedule


def build_lr_scheduler(
    lr_decay_style: str = "cosine",
    *,
    lr: float,
    train_steps: int,
    lr_warmup_ratio: float = 0.0,
    lr_warmup_steps: int = 0,
    lr_min: float = 0.0,
    lr_start: float = 0.0,
) -> Schedule:
    warmup = lr_warmup_steps or int(train_steps * lr_warmup_ratio)
    decay_steps = max(train_steps - warmup, 1)
    if lr_decay_style == "constant":
        main = lambda n: lr  # noqa: E731
    elif lr_decay_style == "linear":
        main = _linear(lr, lr_min, decay_steps)
    elif lr_decay_style == "cosine":
        main = _cosine(lr, decay_steps, lr_min / lr if lr else 0.0)
    else:
        raise ValueError(f"unknown lr_decay_style {lr_decay_style!r}")
    if not warmup:
        return main
    ramp = _linear(lr_start, lr, warmup)
    return lambda n: ramp(n) if n < warmup else main(n - warmup)

"""Learning-rate schedules (``train/schedules.py:27-72`` of the JAX
package), as plain functions of the optimiser's step count, and the
steps a cross-validation fold runs (their horizon).

The count is the number of updates applied before the one the rate is for
(optax evaluates a schedule at the count before its increment), so with a
warmup the first update has rate 0. ``constant`` with no warmup is the
plain-float path: ``make_lr_schedule`` returns None there.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

SCHEDULE_NAMES = ("constant", "cosine", "linear")


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: init -> end over ``steps``, then end."""

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: init -> init * alpha over ``steps``."""

    def schedule(count: int) -> float:
        decay = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1.0 - alpha) * decay + alpha)

    return schedule


def make_lr_schedule(
    name: str,
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    min_lr_ratio: float = 0.0,
) -> Optional[Callable[[int], float]]:
    """Linear warmup 0 -> base_lr over ``warmup_steps``, then the named
    decay from base_lr to ``base_lr * min_lr_ratio`` at ``total_steps``;
    the decay is evaluated at ``count - warmup_steps``, as
    ``optax.join_schedules`` does. None for constant without warmup."""
    if name not in SCHEDULE_NAMES:
        raise ValueError(f"unknown lr schedule {name!r}; choose from {SCHEDULE_NAMES}")
    warmup_steps = int(warmup_steps)
    total_steps = int(total_steps)
    if warmup_steps < 0 or total_steps < 1:
        raise ValueError("warmup_steps must be >= 0 and total_steps >= 1")
    if not 0.0 <= min_lr_ratio <= 1.0:
        raise ValueError("min_lr_ratio must be in [0, 1]")
    if name == "constant" and warmup_steps == 0:
        return None
    decay_steps = max(1, total_steps - warmup_steps)
    if name == "constant":
        decay = lambda count: base_lr  # noqa: E731
    elif name == "cosine":
        decay = _cosine(base_lr, decay_steps, min_lr_ratio)
    else:
        decay = _linear(base_lr, base_lr * min_lr_ratio, decay_steps)
    if warmup_steps == 0:
        return decay
    warmup = _linear(0.0, base_lr, warmup_steps)

    def joined(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return joined


def steps_per_fold(n_samples: int, k_folds: int, batch_size: int, epochs: int) -> int:
    """Optimiser steps one cross-validation fold runs
    (``train/schedules.py:64-72`` of the JAX package): the fold's train
    split keeps all but ``n // k`` of the samples, and the loader rounds a
    partial batch up."""
    train_size = n_samples - n_samples // int(k_folds) if k_folds > 1 else n_samples
    per_epoch = max(1, math.ceil(train_size / int(batch_size)))
    return max(1, per_epoch * int(epochs))

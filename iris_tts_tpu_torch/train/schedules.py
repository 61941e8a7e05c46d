"""Learning-rate and KL-weight schedules.

Counterpart of the JAX package's ``train/schedules.py``. Each learning-rate
schedule is a plain function ``step → lr`` with optax's formulas
(``warmup_cosine_decay_schedule``, which the G2P trainer calls under that
name, ``linear_schedule``, ``exponential_decay``, ``join_schedules``); the
train state reads it at the update count *before* the update, as optax
does.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    if transition_steps <= 0:  # optax: a constant init_value
        return lambda step: init_value

    def schedule(step: int) -> float:
        count = min(max(step, 0), transition_steps)
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _join(schedules, boundaries) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps`` (none when 0), then cosine
    decay to ``end_value`` over the remaining ``decay_steps -
    warmup_steps``, which must be positive."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine decay needs positive decay_steps "
                         f"(got {decay_steps} with {warmup_steps} warmup)")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def cosine(step: int) -> float:
        count = min(step, cos_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / cos_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return _join([_linear(init_value, peak_value, warmup_steps), cosine],
                 [warmup_steps])


def warmup_cosine(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_scale: float = 0.01,
) -> Schedule:
    """Linear warmup from ~0 → base_lr, then cosine decay to
    ``final_scale * base_lr``."""
    warmup_steps = max(1, warmup_steps)
    decay_steps = max(1, total_steps - warmup_steps)
    return warmup_cosine_decay_schedule(
        base_lr / warmup_steps, base_lr, warmup_steps,
        warmup_steps + decay_steps, base_lr * final_scale)


def warmup_exponential(
    base_lr: float,
    warmup_steps: int,
    decay_rate: float = 0.96,
    steps_per_decay: int = 1000,
) -> Schedule:
    """Linear warmup then exponential decay."""
    warmup_steps = max(1, warmup_steps)

    def decay(step: int) -> float:
        return base_lr * decay_rate ** (step / steps_per_decay)

    return _join([_linear(base_lr / warmup_steps, base_lr, warmup_steps),
                  decay], [warmup_steps])


def kl_weight_schedule(
    epoch: int,
    start: float = 0.001,
    end: float = 0.01,
    anneal_epochs: int = 20,
) -> float:
    """Linear KL annealing by epoch (reference: train_vae.py:232-239)."""
    if anneal_epochs <= 0:
        return end
    frac = min(1.0, max(0.0, epoch / anneal_epochs))
    return start + (end - start) * frac

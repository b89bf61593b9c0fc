"""Learning-rate schedules of the two trainer families.

Port of ``qasr_ijcnlp_tpu/train/schedule.py``, whose schedules are optax's
``linear_schedule``, ``cosine_decay_schedule(alpha=...)`` and
``join_schedules``: here plain functions of the step written with the same
float32 operations, so a schedule takes a Python int or the optimizer's
int32 count on the card (no host round trip a step) and returns a float32
scalar tensor on the count's device.

* :func:`warmup_cosine`: linear warmup to ``peak`` then cosine decay to
  ``min_ratio * peak`` (the classical token trainer, per step).
* :func:`cosine`: cosine decay from ``peak`` to ``min_lr`` (the quantum
  trainers).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[object], torch.Tensor]


def _count(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule(init_value, decay_steps, alpha)``."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(step):
        count = torch.clamp(_count(step), max=float(decay_steps))
        decay = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
        return init_value * ((1 - alpha) * decay + alpha)

    return schedule


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax ``linear_schedule`` (a polynomial of power 1)."""
    def schedule(step):
        count = torch.clamp(_count(step), 0.0, float(transition_steps))
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Schedule:
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``.  Without warmup
    the schedule starts at the peak (no step at learning rate 0)."""
    if warmup_steps <= 0:
        return _cosine_decay(peak_lr, max(total_steps, 1), min_ratio)
    boundary = max(warmup_steps, 1)
    warm = _linear(0.0, peak_lr, boundary)
    decay = _cosine_decay(peak_lr, max(total_steps - warmup_steps, 1), min_ratio)

    def schedule(step):
        count = torch.as_tensor(step)
        return torch.where(count < boundary, warm(count), decay(count - boundary))

    return schedule


def cosine(peak_lr: float, total_steps: int, min_lr: float = 0.0) -> Schedule:
    """Cosine decay from ``peak_lr`` to ``min_lr`` over ``total_steps``."""
    alpha = min_lr / peak_lr if peak_lr > 0 else 0.0
    return _cosine_decay(peak_lr, max(total_steps, 1), alpha)

"""LR schedules (port of prego_tpu/train/lr_schedule.py).

Parity surface: WarmupCosineLR (step_recognition/utils/lr_scheduler.py:13-89,
detectron2-style), enabled only with --lr_scheduler: linear warmup from
``warmup_factor`` to 1 over ``warmup_iters``, then cosine decay to 0 over
the remaining steps.

As in optax, the schedule is a function of the update index, the count of
updates made BEFORE this one: the first update takes ``schedule(0)``. The
train step sets the optimizer's lr from it before each update, rather than
stepping a ``LambdaLR`` after it, which would be one update late.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_schedule(
    base_lr: float,
    total_steps: int,
    warmup_iters: int = 500,
    warmup_factor: float = 1e-3,
) -> Callable[[int], float]:
    warmup_iters = min(warmup_iters, total_steps)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_iters:
            alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
            return base_lr * (warmup_factor * (1.0 - alpha) + alpha)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * step / max(total_steps, 1)))

    return schedule

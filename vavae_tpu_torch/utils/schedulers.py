"""Learning-rate schedules: plain functions of the step (port of
``vavae_tpu/utils/schedulers.py``).

  - ``warmup_cosine``: linear warmup to ``lr_max``, cosine to ``lr_min``
    (the reference's LambdaWarmUpCosineScheduler), computed in float32 as
    the JAX schedule is;
  - ``warmup_cosine_cycles``: the cycle-based variant (Scheduler2), each
    cycle with its own warmup, start, max and min;
  - ``cosine_epochs``: torch's CosineAnnealingLR as a function of the epoch.

The DiT trainer takes its cosine schedule from the config's ``scheduler:``
block (``train/dit_trainer.py``); these are the epoch-level and
cycle-based variants.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np


def warmup_cosine(lr_max: float, warmup_steps: int, total_steps: int, lr_start: float = 0.0,
                  lr_min: float = 0.0) -> Callable[[int], float]:
    """Linear warmup ``lr_start`` → ``lr_max`` over ``warmup_steps``, then
    cosine decay to ``lr_min`` at ``total_steps``."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(lr_start) + f32(lr_max - lr_start) * step / f32(max(warmup_steps, 1)))
        t = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                    f32(0.0), f32(1.0))
        return float(f32(lr_min) + f32(0.5 * (lr_max - lr_min)) * (f32(1.0) + np.cos(f32(np.pi) * t)))

    return schedule


def warmup_cosine_cycles(lr_maxes: Sequence[float], lr_mins: Sequence[float],
                         warmups: Sequence[int], cycle_lengths: Sequence[int],
                         lr_starts: Sequence[float] | None = None) -> Callable[[int], float]:
    """Cycle-based warmup-cosine: within each cycle a warmup from its
    ``lr_starts`` entry (default 0, not ``lr_mins``: the reference's
    separate ``f_start`` list) to its max, then cosine to its min. A step on
    a cycle boundary belongs to the earlier cycle, as in the reference."""
    if lr_starts is None:
        lr_starts = [0.0] * len(lr_maxes)
    ends = np.cumsum([0] + list(cycle_lengths))

    def schedule(step: int) -> float:
        step = int(step)
        cycle = next((i for i, end in enumerate(ends[1:]) if step <= end), len(cycle_lengths) - 1)
        s = step - int(ends[cycle])
        if s < warmups[cycle]:
            return lr_starts[cycle] + (lr_maxes[cycle] - lr_starts[cycle]) * s / max(warmups[cycle], 1)
        t = min((s - warmups[cycle]) / max(cycle_lengths[cycle] - warmups[cycle], 1), 1.0)
        return lr_mins[cycle] + 0.5 * (lr_maxes[cycle] - lr_mins[cycle]) * (1.0 + math.cos(math.pi * t))

    return schedule


def cosine_epochs(lr: float, t_max: int, eta_min: float = 0.0) -> Callable[[int], float]:
    """torch's CosineAnnealingLR as a function of the epoch, held at
    ``eta_min`` past ``t_max``."""

    def schedule(epoch: int) -> float:
        return eta_min + 0.5 * (lr - eta_min) * (1.0 + math.cos(math.pi * min(epoch, t_max) / max(t_max, 1)))

    return schedule

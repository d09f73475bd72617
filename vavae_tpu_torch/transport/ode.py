"""Fixed-grid euler ODE integrators (port of ``vavae_tpu/transport/ode.py``).

The JAX package scans over the time grid; here each step is one turn of a
Python loop. The grid is built in float64 numpy and cast to float32, as in
JAX. heun, Adams–Bashforth, dopri5 and the velocity caches are ROADMAP
Queue 1 item 6 ("Remaining samplers").
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def timestep_shift_grid(t: np.ndarray, shift: float) -> np.ndarray:
    """FLUX time warp t' = s·t / (1 + (s-1)·t)."""
    if shift <= 0:
        return t
    return shift * t / (1.0 + (shift - 1.0) * t)


def time_grid(t0: float, t1: float, num_steps: int, timestep_shift: float = 0.0) -> np.ndarray:
    t = np.linspace(t0, t1, num_steps, dtype=np.float64)
    return timestep_shift_grid(t, timestep_shift).astype(np.float32)


def odeint_euler(drift: Callable, x: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """Euler over the grid ``t``; returns the final state.

    drift(x, t_batched) -> dx/dt with t broadcast to (B,). The step is taken
    in x's dtype: a bf16 velocity is widened before the multiply, as JAX
    promotes ``dt.astype(x.dtype) * v``."""
    t = np.asarray(t, dtype=np.float32)
    for t_cur, t_next in zip(t[:-1], t[1:]):
        dt = float(t_next - t_cur)  # fp32 difference, as the JAX scan computes it
        tb = torch.full((x.shape[0],), float(t_cur), dtype=x.dtype, device=x.device)
        x = x + dt * drift(x, tb).to(x.dtype)
    return x


def odeint_euler_split(
    drift_a: Callable,
    drift_b: Callable,
    lift: Callable,
    x: torch.Tensor,
    t: np.ndarray,
    split_idx: int,
) -> torch.Tensor:
    """Euler with a phase change at ``t[split_idx]``: integrate with
    ``drift_a`` before the boundary, apply ``lift`` to the state, then
    integrate with ``drift_b``.

    For CFG-interval sampling: below the interval the guidance is discarded
    anyway, so that phase runs a cond-only model at half batch."""
    t = np.asarray(t, dtype=np.float32)
    n_steps = len(t) - 1
    split_idx = max(0, min(int(split_idx), n_steps))
    if split_idx > 0:
        x = odeint_euler(drift_a, x, t[: split_idx + 1])
    x = lift(x)
    if split_idx < n_steps:
        x = odeint_euler(drift_b, x, t[split_idx:])
    return x

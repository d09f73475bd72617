"""SDE integrators, Euler–Maruyama and Heun (port of
``vavae_tpu/transport/sde.py``).

Each runs ``len(t) - 1`` steps of the fixed step ``dt = t[1] - t[0]``.
``noise`` (optional, shape ``(len(t) - 1, *x.shape)``) holds the Wiener
draws, one standard normal per step, in place of draws from ``generator``:
the tests hand the JAX package's draws to both integrators.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vavae_tpu_torch.transport.ode import batch_time


def _draws(noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
           x: torch.Tensor, steps: int):
    if noise is None:
        return (torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
                for _ in range(steps))
    if noise.shape[0] != steps:
        raise ValueError(f"noise holds {noise.shape[0]} steps, the grid {steps}")
    return (w.to(device=x.device, dtype=x.dtype) for w in noise)


def sdeint_euler(drift: Callable, diffusion: Callable, x: torch.Tensor, t: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Euler–Maruyama over the grid ``t``; returns (x, mean_x) at its end.
    drift(x, t_b) and diffusion(x, t_b) take t broadcast to (B,)."""
    t = np.asarray(t, dtype=np.float32)
    dt = t[1] - t[0]
    sq_dt = float(np.sqrt(dt))
    mean_x = x
    for t_cur, w in zip(t[:-1], _draws(noise, generator, x, t.shape[0] - 1)):
        t_b = batch_time(t_cur, x)
        dw = w * sq_dt
        d = drift(x, t_b).to(x.dtype)
        g = diffusion(x, t_b)
        mean_x = x + d * float(dt)
        x = mean_x + torch.sqrt(2.0 * g).to(x.dtype) * dw
    return x, mean_x


def sdeint_heun(drift: Callable, diffusion: Callable, x: torch.Tensor, t: np.ndarray,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic Heun over the grid ``t``: the noise is added first, then a
    Heun step of the drift from there; returns (x, x after the noise) at
    the end."""
    t = np.asarray(t, dtype=np.float32)
    dt = t[1] - t[0]
    sq_dt = float(np.sqrt(dt))
    xhat = x
    for t_cur, w in zip(t[:-1], _draws(noise, generator, x, t.shape[0] - 1)):
        t_b = batch_time(t_cur, x)
        dw = w * sq_dt
        g = diffusion(x, t_b)
        xhat = x + torch.sqrt(2.0 * g).to(x.dtype) * dw
        k1 = drift(xhat, t_b).to(x.dtype)
        xp = xhat + float(dt) * k1
        k2 = drift(xp, t_b + float(dt)).to(x.dtype)
        x = xhat + float(np.float32(0.5) * dt) * (k1 + k2)
    return x, xhat

"""Cost of a sampler configuration in CFG-forward equivalents (port of
``vavae_tpu/transport/cost.py``).

Unit: one full-batch CFG model forward = 1.0. The cond-only phase before
``cfg_interval_start`` runs at half batch and counts 0.5 per call.
"""
from __future__ import annotations

import math

import numpy as np

from vavae_tpu_torch.transport import ode as ode_mod


def split_idx(transport, num_steps: int, shift: float, start: float,
              reverse: bool = False) -> int:
    """Cond-only step count before MODEL-t reaches ``cfg_interval_start`` on
    the shifted grid. The CFG gate is on model time, which ascends under
    the reverse mirror too."""
    t0, t1 = transport.check_interval(eval=True, sde=False, reverse=reverse)
    g = ode_mod.time_grid(t0, t1, num_steps, shift)
    model_t = (1.0 - g) if reverse else g
    return int(np.searchsorted(model_t[:-1], start))


def fixed_grid_cost(transport, num_steps: int, shift: float, start: float,
                    method: str = "euler", cache_interval: int = 1,
                    reverse: bool = False) -> float:
    """The fixed-grid methods: the cond-only phase at half batch, heun two
    evaluations per step, the velocity cache thinning the CFG phase only."""
    s = split_idx(transport, num_steps, shift, start, reverse)
    per = 2.0 if method == "heun" else 1.0
    n_cfg = (num_steps - s if cache_interval <= 1
             else math.ceil((num_steps - s) / cache_interval))
    return per * (0.5 * s + n_cfg)


def adaptive_cache_cost(transport, num_steps: int, shift: float, start: float,
                        cfg_evals, reverse: bool = False) -> float:
    """The adaptive velocity cache: exact euler at half batch below the
    interval, then the CFG phase's evaluation count from the sampler's
    stats (``{"cfg_evals": n, ...}``)."""
    s = split_idx(transport, num_steps, shift, start, reverse)
    return 0.5 * s + float(int(cfg_evals))


def dopri5_cost(stats) -> float:
    """One dopri5 run's cost from its controller stats: 2 evaluations seed
    the integrator, 6 per attempted step; the cond phase at half batch."""
    return float(sum(
        wgt * (2 + 6 * (int(st["naccept"]) + int(st["nreject"])))
        for ph, wgt in (("cond", 0.5), ("cfg", 1.0))
        for st in [stats[ph]] if st is not None))

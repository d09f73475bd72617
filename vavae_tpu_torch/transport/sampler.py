"""Sampler facade (port of the euler paths of ``vavae_tpu/transport/sampler.py``).

Each ``sample_*`` returns a function ``(x_init, model_fn, ...) -> x_final``.
Integrators other than euler, the velocity caches, the SDE and the
likelihood samplers are ROADMAP Queue 1 item 6 ("Remaining samplers") and
raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from vavae_tpu_torch.transport import ode as ode_mod
from vavae_tpu_torch.transport.transport import Transport

_LATER = "is not ported yet (ROADMAP Queue 1 item 6, remaining samplers)"


def split_idx(transport: Transport, num_steps: int, shift: float, start: float,
              reverse: bool = False) -> int:
    """Cond-only step count before MODEL-t reaches ``cfg_interval_start`` on
    the shifted grid (``vavae_tpu/transport/cost.py:split_idx``). The CFG
    gate is on model time, which ascends under the reverse mirror too."""
    t0, t1 = transport.check_interval(eval=True, sde=False, reverse=reverse)
    g = ode_mod.time_grid(t0, t1, num_steps, shift)
    model_t = (1.0 - g) if reverse else g
    return int(np.searchsorted(model_t[:-1], start))


class Sampler:
    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.drift_fn()

    def _maybe_reversed_drift(self, reverse: bool) -> Callable:
        base = self.drift
        if reverse:
            return lambda x, t, model_fn, **kw: base(x, torch.ones_like(t) * (1.0 - t),
                                                     model_fn, **kw)
        return base

    def sample_ode(
        self,
        *,
        sampling_method: str = "dopri5",
        num_steps: int = 50,
        atol: float = 1e-6,
        rtol: float = 1e-3,
        max_steps: int = 1000,
        reverse: bool = False,
        timestep_shift: float = 0.0,
    ) -> Callable:
        if sampling_method not in ("euler", "Euler"):
            raise NotImplementedError(f"ODE method {sampling_method!r} {_LATER}")
        drift = self._maybe_reversed_drift(reverse)
        t0, t1 = self.transport.check_interval(eval=True, sde=False, reverse=reverse)
        grid = ode_mod.time_grid(t0, t1, num_steps, timestep_shift)

        def _sample(x: torch.Tensor, model_fn: Callable, **model_kwargs: Any) -> torch.Tensor:
            return ode_mod.odeint_euler(
                lambda xv, tv: drift(xv, tv, model_fn, **model_kwargs), x, grid
            )

        return _sample

    def sample_ode_cfg(
        self,
        *,
        num_steps: int = 250,
        timestep_shift: float = 0.0,
        cfg_interval_start: float = 0.0,
        reverse: bool = False,
        cache_interval: int = 1,
        cache_order: int = 1,
        cache_adaptive: bool = False,
        cache_tol: float = 0.02,
        cache_max_interval: int = 8,
        multistep_order: int = 1,
        sampling_method: str = "euler",
        rtol: float = 1e-3,
        atol: float = 1e-6,
        max_steps: int = 1000,
        return_stats: bool = False,
    ) -> Callable:
        """Euler CFG sampler with the interval split run as two phases: the
        cond-only phase at half batch below ``cfg_interval_start``, then
        the [cond | uncond] CFG phase.

        Returns fn(x (B,...), model_cond_fn, model_cfg_fn) -> (B,...) where
        model_cond_fn takes batch B and model_cfg_fn takes 2B. The cache,
        multistep and dopri5 arguments keep the JAX signature; any setting
        that would engage them raises."""
        if sampling_method not in ("euler", "Euler"):
            raise NotImplementedError(f"CFG ODE method {sampling_method!r} {_LATER}")
        if cache_interval > 1 or cache_adaptive or multistep_order > 1:
            raise NotImplementedError(f"velocity cache / multistep sampling {_LATER}")
        if return_stats:
            raise NotImplementedError(f"return_stats {_LATER}")
        drift = self._maybe_reversed_drift(reverse)
        t0, t1 = self.transport.check_interval(eval=True, sde=False, reverse=reverse)
        grid = ode_mod.time_grid(t0, t1, num_steps, timestep_shift)
        sidx = split_idx(self.transport, num_steps, timestep_shift, cfg_interval_start, reverse)

        def _sample(x: torch.Tensor, model_cond_fn: Callable,
                    model_cfg_fn: Callable) -> torch.Tensor:
            B = x.shape[0]
            out = ode_mod.odeint_euler_split(
                lambda xv, tv: drift(xv, tv, model_cond_fn),
                lambda xv, tv: drift(xv, tv, model_cfg_fn),
                lambda xv: torch.cat([xv, xv], dim=0),
                x, grid, sidx,
            )
            return out[:B]

        _sample.split_idx = sidx
        return _sample

    def sample_sde(self, **kw: Any) -> Callable:
        raise NotImplementedError(f"SDE sampling {_LATER}")

    def sample_ode_likelihood(self, **kw: Any) -> Callable:
        raise NotImplementedError(f"ODE likelihood {_LATER}")

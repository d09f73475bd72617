"""Sampler facade (port of the euler paths of ``vavae_tpu/transport/sampler.py``).

Each ``sample_*`` returns a function ``(x_init, model_fn, ...) -> x_final``.
``sample_ode_cfg`` takes the JAX keyword set and refuses the same configs
with ``ValueError``. Integrators other than euler, the velocity caches, the
SDE and the likelihood samplers are ROADMAP Queue 1 item 6 ("Remaining
samplers") and raise ``NotImplementedError`` here.
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


def _check_cfg_knobs(sampling_method: str, cache_interval: int, cache_order: int,
                     cache_adaptive: bool, cache_tol: float, cache_max_interval: int,
                     multistep_order: int, return_stats: bool) -> None:
    """The build-time checks of the JAX ``sample_ode_cfg``
    (``vavae_tpu/transport/sampler.py``), in its order and with its messages:
    each config it refuses raises ``ValueError`` here too, whether or not
    the port runs the knob yet."""
    if sampling_method not in ("euler", "Euler") and (
            cache_interval > 1 or multistep_order > 1 or cache_adaptive):
        raise ValueError(
            "cache_interval/cache_adaptive/multistep_order are euler-grid accelerations — "
            f"not composable with sampling_method={sampling_method!r}")
    if return_stats and sampling_method != "dopri5" and not cache_adaptive:
        raise ValueError("return_stats is only meaningful for dopri5 or cache_adaptive")
    if multistep_order > 1 and (cache_interval > 1 or cache_adaptive):
        raise ValueError("multistep_order and the velocity cache are mutually exclusive "
                         "accelerations — pick one")
    if cache_adaptive and cache_interval > 1:
        raise ValueError("cache_adaptive replaces the fixed cache_interval — set "
                         "velocity_cache_interval back to 1 (or drop it)")
    if cache_adaptive and not (cache_tol > 0.0):
        raise ValueError(f"cache_adaptive needs cache_tol > 0, got {cache_tol}")
    if cache_adaptive and cache_max_interval < 1:
        raise ValueError(f"cache_max_interval must be >= 1, got {cache_max_interval}")
    # checked even while the knob is inert, so that a typo fails when written
    if cache_order not in (0, 1, 2):
        raise ValueError(f"cache_order must be 0, 1 or 2, got {cache_order}")
    if multistep_order not in (1, 2, 3):
        raise ValueError(f"multistep_order must be 1 (euler), 2 or 3, got {multistep_order}")


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
        model_cond_fn takes batch B and model_cfg_fn takes 2B. The arguments
        are the JAX sampler's, checked as it checks them when the sampler is
        built (``ValueError`` on the same configs, in the same order); a
        valid setting that would engage heun, dopri5, the velocity cache or
        multistep then raises ``NotImplementedError``."""
        if sampling_method not in ("euler", "Euler", "heun", "Heun", "dopri5"):
            raise NotImplementedError(f"CFG ODE method {sampling_method}")
        _check_cfg_knobs(sampling_method, cache_interval, cache_order, cache_adaptive, cache_tol,
                         cache_max_interval, multistep_order, return_stats)
        if sampling_method not in ("euler", "Euler"):
            raise NotImplementedError(f"CFG ODE method {sampling_method!r} {_LATER}")
        if cache_interval > 1 or cache_adaptive or multistep_order > 1:
            raise NotImplementedError(f"velocity cache / multistep sampling {_LATER}")
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

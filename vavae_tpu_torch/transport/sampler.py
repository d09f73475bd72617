"""Sampler facade (port of ``vavae_tpu/transport/sampler.py``).

Each ``sample_*`` returns a function of the initial state and the model.
The ODE samplers take ``(x, model_fn, ...)``; the SDE sampler and the
likelihood also take a ``torch.Generator`` for their draws, or the draws
themselves (``noise``, ``eps``), which the tests take from the JAX package.
``sample_ode_cfg`` refuses the configs the JAX sampler refuses, with its
``ValueError`` messages, when it is built.

The likelihood's Hutchinson divergence is εᵀ(Jᵀε), a vector-Jacobian
product through the model by ``torch.autograd.grad``, where JAX takes the
Jacobian-vector product εᵀ(Jε): the same number, and on the card it runs
the attention backward kernel, which has no forward-mode rule. It needs
autograd, so it runs under ``torch.enable_grad()`` whatever the caller's
grad mode, and cannot run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from vavae_tpu_torch.transport import ode as ode_mod
from vavae_tpu_torch.transport import paths
from vavae_tpu_torch.transport import sde as sde_mod
from vavae_tpu_torch.transport.cost import split_idx
from vavae_tpu_torch.transport.transport import Transport

__all__ = ["Sampler", "split_idx"]


def _check_cfg_knobs(sampling_method: str, cache_interval: int, cache_order: int,
                     cache_adaptive: bool, cache_tol: float, cache_max_interval: int,
                     multistep_order: int, return_stats: bool) -> None:
    """The build-time checks of the JAX ``sample_ode_cfg``, in its order and
    with its messages."""
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
        self.score = transport.score_fn()

    def _maybe_reversed_drift(self, reverse: bool) -> Callable:
        """Under ``reverse`` the grid descends 1 → 0 and the model sees
        1 - grid-time."""
        base = self.drift
        if reverse:
            return lambda x, t, model_fn, **kw: base(x, torch.ones_like(t) * (1.0 - t),
                                                     model_fn, **kw)
        return base

    # -- ODE -----------------------------------------------------------------

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
        """fn(x, model_fn, **model_kwargs) -> x at the end: euler, heun, ab2,
        ab3 on the (shifted) grid of ``num_steps`` points, or dopri5."""
        if sampling_method not in ("euler", "Euler", "heun", "Heun", "ab2", "ab3", "dopri5"):
            raise NotImplementedError(f"ODE method {sampling_method}")
        drift = self._maybe_reversed_drift(reverse)
        t0, t1 = self.transport.check_interval(eval=True, sde=False, reverse=reverse)
        grid = ode_mod.time_grid(t0, t1, num_steps, timestep_shift)

        def _sample(x: torch.Tensor, model_fn: Callable, **model_kwargs: Any) -> torch.Tensor:
            d = lambda xv, tv: drift(xv, tv, model_fn, **model_kwargs)  # noqa: E731
            if sampling_method in ("euler", "Euler"):
                return ode_mod.odeint_euler(d, x, grid)
            if sampling_method in ("heun", "Heun"):
                return ode_mod.odeint_heun(d, x, grid)
            if sampling_method in ("ab2", "ab3"):
                return ode_mod.odeint_ab(d, x, grid, order=int(sampling_method[2]))
            return ode_mod.odeint_dopri5(d, x, t0, t1, rtol=rtol, atol=atol,
                                         max_steps=max_steps)

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
        """CFG sampler with the interval split run as two phases: the
        cond-only phase at half batch below ``cfg_interval_start`` (model
        time), then the [cond | uncond] CFG phase.

        Returns fn(x (B,...), model_cond_fn, model_cfg_fn) -> (B,...) where
        model_cond_fn takes batch B and model_cfg_fn takes 2B. Per phase:
        euler (exact, or thinned by ``cache_interval`` with a
        ``cache_order`` forecast, or ``cache_adaptive``, whose interval
        follows the forecast error toward ``cache_tol``), Adams–Bashforth of
        ``multistep_order`` (history restarts at the boundary), heun (a step
        crossing the boundary stays in its phase) or dopri5 (``num_steps``
        and the shift are unused; the boundary sits at model-t =
        ``cfg_interval_start``, clamped into the span). ``return_stats``
        (dopri5, adaptive cache) returns ``(x, stats)``: dopri5
        ``{"cond": stats or None, "cfg": stats}``, the adaptive cache
        ``{"cfg_evals": n, "noise_floor": floor}``."""
        if sampling_method not in ("euler", "Euler", "heun", "Heun", "dopri5"):
            raise NotImplementedError(f"CFG ODE method {sampling_method}")
        _check_cfg_knobs(sampling_method, cache_interval, cache_order, cache_adaptive, cache_tol,
                         cache_max_interval, multistep_order, return_stats)
        drift = self._maybe_reversed_drift(reverse)
        t0, t1 = self.transport.check_interval(eval=True, sde=False, reverse=reverse)
        grid = ode_mod.time_grid(t0, t1, num_steps, timestep_shift)
        sidx = split_idx(self.transport, num_steps, timestep_shift, cfg_interval_start, reverse)
        cond_grid, cfg_grid = grid[: sidx + 1], grid[sidx:]

        def _sample(x: torch.Tensor, model_cond_fn: Callable, model_cfg_fn: Callable):
            B = x.shape[0]
            d_cond = lambda xv, tv: drift(xv, tv, model_cond_fn)  # noqa: E731
            d_cfg = lambda xv, tv: drift(xv, tv, model_cfg_fn)  # noqa: E731
            lift = lambda xv: torch.cat([xv, xv], dim=0)  # noqa: E731
            if sampling_method in ("heun", "Heun"):
                if sidx > 0:
                    x = ode_mod.odeint_heun(d_cond, x, cond_grid)
                return ode_mod.odeint_heun(d_cfg, lift(x), cfg_grid)[:B]
            if sampling_method == "dopri5":
                tb = (1.0 - cfg_interval_start) if reverse else cfg_interval_start
                lo, hi = sorted((t0, t1))
                tb = float(min(max(tb, lo), hi))
                stats: dict = {"cond": None, "cfg": None}
                if tb != t0:
                    x, stats["cond"] = ode_mod.odeint_dopri5(
                        d_cond, x, t0, tb, rtol=rtol, atol=atol, max_steps=max_steps,
                        with_stats=True)
                out, stats["cfg"] = ode_mod.odeint_dopri5(
                    d_cfg, lift(x), tb, t1, rtol=rtol, atol=atol, max_steps=max_steps,
                    with_stats=True)
                return (out[:B], stats) if return_stats else out[:B]
            if multistep_order > 1:
                if sidx > 0:
                    x = ode_mod.odeint_ab(d_cond, x, cond_grid, order=multistep_order)
                return ode_mod.odeint_ab(d_cfg, lift(x), cfg_grid, order=multistep_order)[:B]
            if cache_adaptive:
                if sidx > 0:
                    x = ode_mod.odeint_euler(d_cond, x, cond_grid)
                out, n_evals, floor = ode_mod.odeint_euler_cached_adaptive(
                    d_cfg, lift(x), cfg_grid, tol=cache_tol, max_interval=cache_max_interval,
                    order=cache_order, with_stats=True, with_floor=True)
                return ((out[:B], {"cfg_evals": n_evals, "noise_floor": floor})
                        if return_stats else out[:B])
            if cache_interval <= 1:
                return ode_mod.odeint_euler_split(d_cond, d_cfg, lift, x, grid, sidx)[:B]
            if sidx > 0:
                x = ode_mod.odeint_euler(d_cond, x, cond_grid)
            return ode_mod.odeint_euler_cached(d_cfg, lift(x), cfg_grid, cache_interval,
                                               order=cache_order)[:B]

        _sample.split_idx = sidx
        return _sample

    # -- SDE -----------------------------------------------------------------

    def sample_sde(
        self,
        *,
        sampling_method: str = "Euler",
        diffusion_form: str = "SBDM",
        diffusion_norm: float = 1.0,
        last_step: Optional[str] = "Mean",
        last_step_size: float = 0.04,
        num_steps: int = 250,
    ) -> Callable:
        """fn(x, model_fn, generator=None, noise=None, **model_kwargs) -> x:
        Euler–Maruyama or Heun over ``num_steps`` grid points up to
        1 - ``last_step_size``, then the ``last_step`` (Mean, Tweedie, Euler
        or None). The drift and the score of a step share one model call."""
        if sampling_method not in ("Euler", "Heun"):
            raise NotImplementedError(f"SDE method {sampling_method}")
        if last_step not in (None, "Mean", "Tweedie", "Euler"):
            raise NotImplementedError(last_step)
        transport = self.transport
        path = transport.path
        if last_step is None:
            last_step_size = 0.0

        def diffusion_fn(x, t):
            return paths.diffusion_coeff(path, x, t, form=diffusion_form, norm=diffusion_norm)

        def sde_drift(x, t, model_fn, **kw):
            out = model_fn(x, t, **kw)
            once = lambda *_a, **_k: out  # noqa: E731
            return self.drift(x, t, once) + diffusion_fn(x, t) * self.score(x, t, once)

        t0, t1 = transport.check_interval(eval=True, sde=True, diffusion_form=diffusion_form,
                                          last_step_size=last_step_size)
        grid = ode_mod.linspace_f32(t0, t1, num_steps)
        integrate = sde_mod.sdeint_euler if sampling_method == "Euler" else sde_mod.sdeint_heun

        def last_step_fn(x, t, model_fn, **kw):
            if last_step is None:
                return x
            if last_step == "Mean":
                return x + sde_drift(x, t, model_fn, **kw) * last_step_size
            if last_step == "Tweedie":
                alpha = path.alpha(t[0])[0]
                sigma = path.sigma(t[0])[0]
                return x / alpha + (sigma ** 2) / alpha * self.score(x, t, model_fn, **kw)
            return x + self.drift(x, t, model_fn, **kw) * last_step_size

        def _sample(x: torch.Tensor, model_fn: Callable,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None, **model_kwargs: Any) -> torch.Tensor:
            d = lambda xv, tv: sde_drift(xv, tv, model_fn, **model_kwargs)  # noqa: E731
            x, _ = integrate(d, diffusion_fn, x, grid, generator=generator, noise=noise)
            ts = torch.full((x.shape[0],), float(t1), dtype=x.dtype, device=x.device)
            return last_step_fn(x, ts, model_fn, **model_kwargs)

        return _sample

    # -- likelihood ------------------------------------------------------------

    def sample_ode_likelihood(
        self,
        *,
        sampling_method: str = "dopri5",
        num_steps: int = 50,
        atol: float = 1e-6,
        rtol: float = 1e-3,
    ) -> Callable:
        """fn(x, model_fn, generator=None, eps=None, **kw) -> (logp (B,), z):
        the probability-flow ODE integrated from the data x back to the
        prior over the (x, logp) state, with the Hutchinson divergence at a
        Rademacher ε (drawn from ``generator`` unless given), by dopri5 or,
        with ``sampling_method="euler"``, on a grid of ``num_steps`` points."""
        if sampling_method not in ("dopri5", "euler"):
            raise NotImplementedError(f"likelihood method {sampling_method}")
        transport = self.transport
        base_drift = self.drift
        t0, t1 = transport.check_interval(eval=True)

        def _sample(x: torch.Tensor, model_fn: Callable,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None, **kw: Any):
            B = x.shape[0]
            if eps is None:
                eps = torch.randint(0, 2, x.shape, generator=generator, device=x.device)
                eps = eps.to(x.dtype) * 2.0 - 1.0
            eps = eps.to(device=x.device, dtype=x.dtype)

            def aug_drift(state, t_b):
                xv, _ = state
                t_rev = torch.ones_like(t_b) * (1.0 - t_b)
                with torch.enable_grad():
                    xg = xv.detach().requires_grad_(True)
                    drift_val = base_drift(xg, t_rev, model_fn, **kw)
                    (vjp,) = torch.autograd.grad(drift_val, xg,
                                                 grad_outputs=eps.to(drift_val.dtype))
                logp_grad = torch.sum((vjp * eps).reshape(B, -1), dim=-1)
                return (-drift_val.detach(), logp_grad)

            logp0 = torch.zeros((B,), dtype=x.dtype, device=x.device)
            if sampling_method == "dopri5":
                xv, delta_logp = ode_mod.odeint_dopri5(aug_drift, (x, logp0), t0, t1,
                                                       rtol=rtol, atol=atol)
            else:
                xv, delta_logp = x, logp0
                grid = ode_mod.linspace_f32(t0, t1, num_steps)
                for t_cur, t_next in zip(grid[:-1], grid[1:]):
                    dt = float(t_next - t_cur)
                    dx, dlogp = aug_drift((xv, delta_logp), ode_mod.batch_time(t_cur, x))
                    xv, delta_logp = xv + dt * dx.to(x.dtype), delta_logp + dt * dlogp
            return transport.prior_logp(xv) - delta_logp, xv

        return _sample

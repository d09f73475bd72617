"""ODE integrators (port of ``vavae_tpu/transport/ode.py``).

The JAX package scans over the time grid; here each step is one turn of a
Python loop. The grid is built in float64 numpy and cast to float32, as in
JAX. Time and every controller quantity (dopri5's t, dt and error ratio,
the adaptive cache's interval, noise floor and relative error) are float32
numpy scalars combined in the JAX package's operation order, so the
accepted, rejected and evaluated counts are JAX's; a Python float would
carry float64 and drift from them. A decision that depends on the state
(dopri5's accept, the adaptive cache's next interval) reads one float32
from the device, one synchronisation per step or evaluation.

The state is updated in its own dtype: a model output is cast to it where
JAX casts (``.astype(x.dtype)``), and elsewhere widened as JAX promotes a
float32 step against a bf16 velocity.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

F32 = np.float32


def timestep_shift_grid(t: np.ndarray, shift: float) -> np.ndarray:
    """FLUX time warp t' = s·t / (1 + (s-1)·t)."""
    if shift <= 0:
        return t
    return shift * t / (1.0 + (shift - 1.0) * t)


def time_grid(t0: float, t1: float, num_steps: int, timestep_shift: float = 0.0) -> np.ndarray:
    t = np.linspace(t0, t1, num_steps, dtype=np.float64)
    return timestep_shift_grid(t, timestep_shift).astype(np.float32)


def linspace_f32(t0: float, t1: float, num: int) -> np.ndarray:
    """The SDE and likelihood grid, ``jnp.linspace(t0, t1, num,
    dtype=float32)`` bit for bit as a jitted JAX sampler computes it (XLA
    folds it as a constant): with r = 1/div in float32, the interior points
    are start·(1 - i·r) + i·(stop·r) and the last one is stop itself."""
    start, stop = F32(t0), F32(t1)
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    r = F32(1.0) / F32(div)
    i = np.arange(div, dtype=np.float32)
    out = start * (F32(1.0) - i * r) + i * (stop * r)
    return np.concatenate([out, [stop]]).astype(np.float32)


def batch_time(t, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Time ``t`` broadcast to x's batch, in x's dtype unless ``dtype``."""
    return torch.full((x.shape[0],), float(t), dtype=dtype or x.dtype, device=x.device)


def odeint_euler(drift: Callable, x: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """Euler over the grid ``t``; returns the final state.

    drift(x, t_batched) -> dx/dt with t broadcast to (B,). The step is taken
    in x's dtype: a bf16 velocity is widened before the multiply, as JAX
    promotes ``dt.astype(x.dtype) * v``."""
    t = np.asarray(t, dtype=np.float32)
    for t_cur, t_next in zip(t[:-1], t[1:]):
        dt = float(t_next - t_cur)  # fp32 difference, as the JAX scan computes it
        x = x + dt * drift(x, batch_time(t_cur, x)).to(x.dtype)
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


def odeint_euler_cached(drift: Callable, x: torch.Tensor, t: np.ndarray,
                        cache_interval: int = 1, order: int = 1) -> torch.Tensor:
    """Euler evaluating the model every ``cache_interval``-th step; between
    evaluations the velocity is forecast from the last evaluations: ``order``
    0 holds the last one, 1 extrapolates linearly from the last two, 2
    quadratically (Newton divided differences) from the last three, each
    gated in once enough evaluations exist. ``cache_interval=1`` is
    ``odeint_euler``."""
    if order not in (0, 1, 2):
        raise ValueError(f"velocity-cache order must be 0, 1 or 2, got {order}")
    if cache_interval <= 1:
        return odeint_euler(drift, x, t)
    t = np.asarray(t, dtype=np.float32)
    o1, o2 = F32(1.0 if order >= 1 else 0.0), F32(1.0 if order >= 2 else 0.0)
    v_last = d1 = d2 = torch.zeros_like(x)
    t_last = t_prev = t[0]
    for i, (t_cur, t_next) in enumerate(zip(t[:-1], t[1:])):
        if i % cache_interval == 0:
            v = drift(x, batch_time(t_cur, x)).to(x.dtype)
            g1 = F32(0.0 if i == 0 else 1.0)
            safe1 = F32(1.0) if i == 0 else t_cur - t_last
            new_d1 = float(g1) * (v - v_last) / float(safe1)
            # d2 needs three evaluations: the carried d1 is valid from the second
            g2 = F32(0.0 if i <= cache_interval else 1.0)
            safe2 = F32(1.0) if i <= cache_interval else t_cur - t_prev
            d2 = float(g2) * (new_d1 - d1) / float(safe2)
            v_last, d1, t_last, t_prev = v, new_d1, t_cur, t_last
        else:
            dt, dtp = t_cur - t_last, t_cur - t_prev
            v = v_last + float(o1 * dt) * d1 + float(o2 * dt * dtp) * d2
        x = x + float(t_next - t_cur) * v
    return x


def round_half_even(k: np.float32) -> int:
    """``jnp.round``: halves round to even."""
    return int(np.round(k))


def odeint_euler_cached_adaptive(drift: Callable, x: torch.Tensor, t: np.ndarray,
                                 tol: float = 0.02, max_interval: int = 8, order: int = 1,
                                 with_stats: bool = False, with_floor: bool = False):
    """Velocity-cached euler whose interval is controlled: at each model
    evaluation the relative error e of the ``order``-degree forecast against
    the evaluated velocity (batch-global, fp32) sets the next gap,
    k ← clip(k · clip(0.9 · (tol/e_x)^(1/(order+1)), 0.25, 2), 1, max_interval),
    carried as a float and rounded half to even when the next evaluation is
    scheduled (``wait = round(k) - 1`` forecast steps). e_x is the excess of
    e over a noise floor, the minimum of the first three post-warm-up gap-1
    errors; the first ``order + 1`` evaluations (warm-up) and those three
    run at gap 1. ``with_stats`` returns ``(x, n_evals)``, with
    ``with_floor`` ``(x, n_evals, floor)`` (inf if calibration never
    finished)."""
    if order not in (0, 1, 2):
        raise ValueError(f"velocity-cache order must be 0, 1 or 2, got {order}")
    if max_interval < 1:
        raise ValueError(f"max_interval must be >= 1, got {max_interval}")
    t = np.asarray(t, dtype=np.float32)
    o1, o2 = F32(1.0 if order >= 1 else 0.0), F32(1.0 if order >= 2 else 0.0)
    tol, warm, n_floor = F32(tol), order + 1, 3
    power = F32(1.0 / (order + 1))
    v_e = d1 = d2 = torch.zeros_like(x)
    t_e = t_pe = t[0]
    wait, k_f, floor, n_evals = 0, F32(1.0), F32(np.inf), 0

    def forecast_at(tq):
        dt, dtp = tq - t_e, tq - t_pe
        return v_e + float(o1 * dt) * d1 + float(o2 * dt * dtp) * d2

    for t_cur, t_next in zip(t[:-1], t[1:]):
        if wait <= 0:
            v = drift(x, batch_time(t_cur, x)).to(x.dtype)
            dv = (v - forecast_at(t_cur)).float()
            e = torch.sqrt(torch.mean(torch.square(dv)))
            vn = torch.sqrt(torch.mean(torch.square(v.float())))
            e_rel = F32((e / torch.clamp_min(vn, 1e-20)).item())
            if warm <= n_evals < warm + n_floor:
                floor = np.minimum(floor, e_rel)
            with np.errstate(invalid="ignore", over="ignore"):
                excess = np.sqrt(np.maximum(np.square(e_rel) - np.square(floor), F32(0.0)))
                factor = np.clip(F32(0.9) * (tol / np.maximum(excess, F32(1e-12))) ** power,
                                 F32(0.25), F32(2.0))
            k_f = F32(np.clip(k_f * factor, F32(1.0), F32(max_interval)))
            if n_evals < warm + n_floor:
                k_f = F32(1.0)
            wait = round_half_even(k_f) - 1
            g1 = F32(1.0 if n_evals >= 1 else 0.0)
            safe1 = F32(1.0) if n_evals == 0 else t_cur - t_e
            new_d1 = float(g1) * (v - v_e) / float(safe1)
            g2 = F32(1.0 if n_evals >= 2 else 0.0)
            safe2 = F32(1.0) if n_evals <= 1 else t_cur - t_pe
            d2 = float(g2) * (new_d1 - d1) / float(safe2)
            v_e, d1, t_e, t_pe = v, new_d1, t_cur, t_e
            n_evals += 1
        else:
            v = forecast_at(t_cur)
            wait -= 1
        x = x + float(t_next - t_cur) * v
    if with_stats:
        return (x, n_evals, floor) if with_floor else (x, n_evals)
    return x


def odeint_heun(drift: Callable, x: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """Heun (RK2) over the grid ``t``: two model evaluations per step."""
    t = np.asarray(t, dtype=np.float32)
    for t_cur, t_next in zip(t[:-1], t[1:]):
        dt = t_next - t_cur
        k1 = drift(x, batch_time(t_cur, x))
        k2 = drift(x + float(dt) * k1.to(x.dtype), batch_time(t_next, x))
        x = x + float(dt * F32(0.5)) * (k1 + k2).to(x.dtype)
    return x


def odeint_ab(drift: Callable, x: torch.Tensor, t: np.ndarray, order: int = 3) -> torch.Tensor:
    """Variable-step Adams–Bashforth of order 1, 2 or 3: one model
    evaluation per step; the Newton polynomial through the last ``order``
    velocities is integrated exactly over each step,
    x += h·v + (h²/2)·d1 + (h³/3 + g·h²/2)·d2 with h the step and g the
    previous gap. Order 3 takes its first step with Heun, order 2 with euler."""
    if order not in (1, 2, 3):
        raise ValueError(f"Adams-Bashforth order must be 1, 2 or 3, got {order}")
    t = np.asarray(t, dtype=np.float32)
    if order == 1 or t.shape[0] < 3:
        return odeint_euler(drift, x, t)
    use_d2 = F32(1.0 if order >= 3 else 0.0)
    if order >= 3:
        dt0 = t[1] - t[0]
        v0 = drift(x, batch_time(t[0], x)).to(x.dtype)
        k2 = drift(x + float(dt0) * v0, batch_time(t[1], x)).to(x.dtype)
        x = x + float(dt0 * F32(0.5)) * (v0 + k2)
        start = 1
    else:
        v0 = torch.zeros_like(x)
        start = 0
    v_prev, d1_prev, t_prev1, t_prev2 = v0, torch.zeros_like(x), t[0], t[0]
    for i in range(start, t.shape[0] - 1):
        t_cur, t_next = t[i], t[i + 1]
        v = drift(x, batch_time(t_cur, x)).to(x.dtype)
        dt1 = t_cur - t_prev1
        g1 = F32(1.0 if i >= 1 else 0.0)
        safe1 = F32(1.0) if i == 0 else dt1
        d1 = float(g1) * (v - v_prev) / float(safe1)
        g2 = use_d2 * F32(1.0 if i >= 2 else 0.0)
        safe2 = F32(1.0) if i <= 1 else t_cur - t_prev2
        d2 = float(g2) * (d1 - d1_prev) / float(safe2)
        h, g = t_next - t_cur, dt1
        c1 = h * h * F32(0.5)
        c2 = h * h * h / F32(3.0) + g * h * h * F32(0.5)
        x = x + (float(h) * v + float(c1) * d1 + float(c2) * d2)
        v_prev, d1_prev, t_prev1, t_prev2 = v, d1, t_cur, t_prev1
    return x


# -- adaptive Dormand-Prince 5(4) --------------------------------------------

# Butcher tableau (the coefficients of torchdiffeq's dopri5)
_DOPRI_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DOPRI_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DOPRI_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
# torchdiffeq's dopri5 midpoint weights (DPS_C_MID) for the quartic dense output
_DOPRI_MID = np.array([
    6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
])


def _axpy(ys: list, c, ks: list) -> list:
    """y + c·k over the state's leaves, c a float32 scalar."""
    return [y + float(c) * k for y, k in zip(ys, ks)]


def _rms(leaves: list, n_total: int) -> torch.Tensor:
    ssq = sum(torch.sum(torch.square(l)) for l in leaves)
    return torch.sqrt(ssq / n_total)


def _f32(t: torch.Tensor) -> np.float32:
    return F32(t.item())


def odeint_dopri5(drift: Callable, x: Any, t0: float, t1: float, rtol: float = 1e-3,
                  atol: float = 1e-6, max_steps: int = 1000, with_stats: bool = False) -> Any:
    """Adaptive Dormand–Prince 5(4) with torchdiffeq's dopri5 semantics:
    Hairer's initial step (``_select_initial_step``), the controller
    factor clip(0.9·ratio^(-1/5), dfactor, 10) with dfactor 1 on accepted
    and 0.2 on rejected steps (×10 at ratio 0), FSAL, and steps that
    overshoot t1, the result at t1 taken from the quartic dense output.

    ``x`` is a tensor or a tuple of tensors (the likelihood's (x, logp));
    the error norm is the RMS over all of them, computed in float32, and
    the drift sees each leaf in its own dtype. ``t1 < t0`` integrates the
    time-mirrored field over [t1, t0]. ``with_stats`` also returns
    ``{"naccept", "nreject", "exhausted"}``; ``exhausted`` means
    ``max_steps`` ran out before t1, and the result is then the state
    reached so far."""
    if t1 < t0:
        def mirrored(xv, tv):
            out = drift(xv, (t0 + t1) - tv)
            return tuple(-l for l in out) if isinstance(out, (tuple, list)) else -out

        return odeint_dopri5(mirrored, x, t1, t0, rtol=rtol, atol=atol,
                             max_steps=max_steps, with_stats=with_stats)
    is_tree = isinstance(x, (tuple, list))
    leaves = list(x) if is_tree else [x]
    in_dtypes = [l.dtype for l in leaves]
    n_total = sum(l.numel() for l in leaves)
    ref = leaves[0]
    xf = [l.float() for l in leaves]
    t1_32 = F32(t1)

    def f(xv: list, tv) -> list:
        xs = [l.to(d) for l, d in zip(xv, in_dtypes)]
        out = drift(tuple(xs) if is_tree else xs[0], batch_time(tv, ref, torch.float32))
        return [l.float() for l in (out if is_tree else [out])]

    def error_ratio(x_new, x_old, err) -> np.float32:
        scaled = [e / (torch.maximum(a.abs(), b.abs()) * rtol + atol)
                  for e, a, b in zip(err, x_old, x_new)]
        return _f32(_rms(scaled, n_total))

    f0 = f(xf, F32(t0))
    # torchdiffeq _select_initial_step (Hairer-Norsett-Wanner II.4)
    scale = [l.abs() * rtol + atol for l in xf]
    d0 = _f32(_rms([a / s for a, s in zip(xf, scale)], n_total))
    d1 = _f32(_rms([a / s for a, s in zip(f0, scale)], n_total))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        h0 = F32(1e-6) if min(d0, d1) < F32(1e-5) else F32(0.01) * d0 / d1
        f1 = f(_axpy(xf, h0, f0), F32(t0) + h0)
        d2 = _f32(_rms([(a - b) / s for a, b, s in zip(f1, f0, scale)], n_total)) / h0
        if max(d1, d2) <= F32(1e-15):
            h1 = max(F32(1e-6), h0 * F32(1e-3))
        else:
            h1 = (F32(0.01) / max(d1, d2)) ** F32(0.2)
    dt = F32(min(min(F32(100.0) * h0, h1), F32(abs(t1 - t0))))

    xv, t, out = xf, F32(t0), xf
    na = nr = 0
    while t < t1_32 and na + nr < max_steps:
        ks = [f0]
        for i in range(1, 7):
            xi = xv
            for j, aij in enumerate(_DOPRI_A[i]):
                xi = _axpy(xi, dt * F32(aij), ks[j])
            ks.append(f(xi, t + F32(_DOPRI_C[i]) * dt))
        x5, err = xv, [torch.zeros_like(l) for l in xv]
        for i in range(7):
            if _DOPRI_B5[i] != 0.0:
                x5 = _axpy(x5, dt * F32(_DOPRI_B5[i]), ks[i])
            db = _DOPRI_B5[i] - _DOPRI_B4[i]
            if db != 0.0:
                err = _axpy(err, dt * F32(db), ks[i])

        ratio = error_ratio(x5, xv, err)
        accept = bool(ratio <= F32(1.0))
        # torchdiffeq _optimal_step_size: never shrink an accepted step
        dfactor = F32(1.0) if accept else F32(0.2)
        if ratio == F32(0.0):
            factor = F32(10.0)
        else:
            with np.errstate(divide="ignore", over="ignore"):
                factor = np.minimum(F32(10.0), np.maximum(F32(0.9) * ratio ** F32(-0.2), dfactor))
        if accept and t + dt >= t1_32:
            # dense output at t1 (torchdiffeq _interp_fit: the quartic
            # through y0, y1, y_mid, f0 and f1)
            y_mid = xv
            for i in range(7):
                if _DOPRI_MID[i] != 0.0:
                    y_mid = _axpy(y_mid, dt * F32(_DOPRI_MID[i]), ks[i])
            s = float(np.clip((t1_32 - t) / max(dt, F32(1e-20)), F32(0.0), F32(1.0)))
            two_dt, fdt = float(F32(2.0) * dt), float(dt)
            out = []
            for y0l, y1l, yml, f0l, f1l in zip(xv, x5, y_mid, f0, ks[6]):
                a = two_dt * (f1l - f0l) - 8.0 * (y1l + y0l) + 16.0 * yml
                b = fdt * (5.0 * f0l - 3.0 * f1l) + 18.0 * y0l + 14.0 * y1l - 32.0 * yml
                c = fdt * (f1l - 4.0 * f0l) - 11.0 * y0l - 5.0 * y1l + 16.0 * yml
                d = fdt * f0l
                out.append(((((a * s + b) * s + c) * s + d) * s) + y0l)
        if accept:
            xv, t, f0 = x5, F32(t + dt), ks[6]
            na += 1
        else:
            nr += 1
        dt = F32(dt * factor)
    done = bool(t >= t1_32)
    if not done:  # max_steps ran out: the state reached, not the initial one
        out = xv
    result = [l.to(d) for l, d in zip(out, in_dtypes)]
    result = tuple(result) if is_tree else result[0]
    if with_stats:
        return result, {"naccept": na, "nreject": nr, "exhausted": not done}
    return result

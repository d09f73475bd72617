"""The port's integrators and samplers against the JAX package's on the same
inputs: every ODE integrator (euler, heun, Adams–Bashforth, the fixed and
adaptive velocity caches, dopri5) and both SDE integrators on toy drifts,
dopri5's controller counts and the adaptive cache's evaluation count
(equal), the cost functions (equal), the grids (bit-equal) and the
likelihood on an analytic model.

Tolerances: 1e-5 relative for the integrators (fp32 on both sides, only
the summation order of the norms and the elementwise fusion differ), the
adaptive cache's noise floor within 1e-6, the counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5


def _field(kind, xp):
    """Toy drifts f(x, t_b): linear, nonlinear (curved in x and t) and stiff."""
    if kind == "linear":
        return lambda x, t: -0.7 * x + 0.3 * t.reshape(-1, *([1] * (x.ndim - 1)))
    if kind == "nonlinear":
        return lambda x, t: (xp.sin(3.0 * t.reshape(-1, *([1] * (x.ndim - 1)))) * xp.cos(x)
                             - 0.5 * x + 0.3 * xp.sin(5.0 * x))
    return lambda x, t: -20.0 * x + xp.sin(40.0 * t.reshape(-1, *([1] * (x.ndim - 1))))


FIELDS = ("linear", "nonlinear", "stiff")


def _x0(seed=0, shape=(2, 3, 4, 2)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(fn_jax, fn_torch, kind, x0):
    want = fn_jax(_field(kind, jnp), jnp.asarray(x0))
    got = fn_torch(_field(kind, torch), torch.from_numpy(x0))
    return got, want


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)


# -- grids, rounding, costs --------------------------------------------------------


@pytest.mark.parametrize("t0,t1,n", [(0.0, 1.0, 250), (0.0, 0.96, 50), (1e-3, 0.96, 37),
                                     (0.0, 1.0, 10), (0.001, 0.999, 2), (1.0, 0.0, 17)])
def test_linspace_grid_bit_equal(t0, t1, n):
    """The SDE and likelihood grids: ``jnp.linspace(..., dtype=float32)`` as
    the jitted JAX samplers compute it, a constant XLA folds. (Called
    eagerly, XLA's CPU kernel fuses a multiply-add and may differ in the
    last ulp.)"""
    import jax

    from vavae_tpu_torch.transport.ode import linspace_f32

    want = np.asarray(jax.jit(lambda: jnp.linspace(t0, t1, n, dtype=jnp.float32))())
    got = linspace_f32(t0, t1, n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_interval_rounding_is_half_to_even():
    """The adaptive cache rounds its interval as ``jnp.round`` does."""
    from vavae_tpu_torch.transport.ode import round_half_even

    ks = np.array([0.5, 1.0, 1.5, 2.5, 3.5, 4.4999, 4.5, 5.5, 6.5, 7.5, 7.50001], np.float32)
    want = np.asarray(jnp.round(jnp.asarray(ks))).astype(int).tolist()
    assert [round_half_even(k) for k in ks] == want
    assert [round_half_even(k) for k in ks] == torch.round(torch.from_numpy(ks)).int().tolist()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("steps,shift,start", [(250, 0.3, 0.11), (50, 0.3, 0.11), (37, 1.0, 0.0),
                                               (300, 0.1, 0.11), (10, 2.0, 0.5)])
def test_cost_functions_equal(steps, shift, start, reverse):
    from vavae_tpu.transport import cost as jcost
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import cost, create_transport

    jt, tt = jax_transport(), create_transport()
    assert cost.split_idx(tt, steps, shift, start, reverse) == jcost.split_idx(
        jt, steps, shift, start, reverse)
    for method in ("euler", "heun"):
        for k in (1, 2, 3, 4):
            assert cost.fixed_grid_cost(tt, steps, shift, start, method, k, reverse) == \
                jcost.fixed_grid_cost(jt, steps, shift, start, method, k, reverse)
    for evals in (1, 17, steps):
        assert cost.adaptive_cache_cost(tt, steps, shift, start, evals, reverse) == \
            jcost.adaptive_cache_cost(jt, steps, shift, start, evals, reverse)
    for stats in ({"cond": None, "cfg": {"naccept": 7, "nreject": 2}},
                  {"cond": {"naccept": 3, "nreject": 0}, "cfg": {"naccept": 11, "nreject": 5}}):
        assert cost.dopri5_cost(stats) == jcost.dopri5_cost(stats)


def test_split_idx_importable_from_sampler():
    from vavae_tpu_torch.transport import cost, sampler

    assert sampler.split_idx is cost.split_idx


# -- fixed-grid integrators ----------------------------------------------------------


def _grid(reverse=False, kind="linear"):
    """30 points at shift 0.3 (the production shift); for the stiff field
    50 uniform points, which keep h·20 inside every method's stability
    region (on the shifted grid the last steps leave it, and the unstable
    growth then amplifies rounding)."""
    from vavae_tpu_torch.transport.ode import time_grid

    t0, t1 = (1.0, 0.0) if reverse else (0.0, 1.0)
    if kind == "stiff":
        return time_grid(t0, t1, 50, 0.0)
    return time_grid(t0, t1, 30, 0.3)


def _fixed(name):
    """(jax fn, port fn) of a fixed-grid integrator: (drift, x, grid) -> x."""
    from vavae_tpu.transport import ode as jode
    from vavae_tpu_torch.transport import ode

    if name == "heun":
        return jode.odeint_heun, ode.odeint_heun
    if name in ("ab2", "ab3"):
        o = int(name[2])
        return (lambda d, x, g: jode.odeint_ab(d, x, g, order=o),
                lambda d, x, g: ode.odeint_ab(d, x, g, order=o))
    if name == "euler":
        return jode.odeint_euler, ode.odeint_euler
    k, o = int(name[6]), int(name[-1])  # "cachek3o1"
    return (lambda d, x, g: jode.odeint_euler_cached(d, x, g, k, order=o),
            lambda d, x, g: ode.odeint_euler_cached(d, x, g, k, order=o))


FIXED = ("euler", "heun", "ab2", "ab3", "cachek2o0", "cachek3o1", "cachek3o2", "cachek4o2")


@pytest.mark.parametrize("kind", FIELDS)
@pytest.mark.parametrize("name", FIXED)
def test_fixed_grid_integrators_match_jax(name, kind):
    jfn, tfn = _fixed(name)
    g = _grid(kind=kind)
    got, want = _run(lambda d, x: jfn(d, x, jnp.asarray(g)), lambda d, x: tfn(d, x, g),
                     kind, _x0(1))
    assert max_rel(_np(got), want) < TOL


@pytest.mark.parametrize("name", ["heun", "ab3", "cachek3o2"])
def test_fixed_grid_integrators_reverse_grid(name):
    """A descending grid (the reverse mirror's)."""
    jfn, tfn = _fixed(name)
    g = _grid(reverse=True)
    got, want = _run(lambda d, x: jfn(d, x, jnp.asarray(g)), lambda d, x: tfn(d, x, g),
                     "nonlinear", _x0(2))
    assert max_rel(_np(got), want) < TOL


@pytest.mark.parametrize("kind", FIELDS)
@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("tol,max_interval", [(0.02, 8), (1e-3, 5)])
def test_adaptive_cache_matches_jax(order, kind, tol, max_interval):
    """Equal evaluation counts, the state within 1e-5, the noise floor
    within 1e-6."""
    from vavae_tpu.transport import ode as jode
    from vavae_tpu_torch.transport import ode

    g = _grid(kind=kind)
    kw = dict(tol=tol, max_interval=max_interval, order=order, with_stats=True, with_floor=True)
    x0 = _x0(3)
    want, n_want, floor_want = jode.odeint_euler_cached_adaptive(
        _field(kind, jnp), jnp.asarray(x0), jnp.asarray(g), **kw)
    got, n_got, floor_got = ode.odeint_euler_cached_adaptive(
        _field(kind, torch), torch.from_numpy(x0), g, **kw)
    assert n_got == int(n_want)
    print(f"evaluations {n_got} of {g.shape[0] - 1} steps")
    floor_want = float(floor_want)
    if np.isinf(floor_want):
        assert np.isinf(floor_got)
    else:
        assert abs(float(floor_got) - floor_want) <= 1e-6
    assert max_rel(_np(got), want) < TOL
    x_only = ode.odeint_euler_cached_adaptive(_field(kind, torch), torch.from_numpy(x0), g,
                                              tol=tol, max_interval=max_interval, order=order)
    assert torch.equal(x_only, got)
    _, n_only = ode.odeint_euler_cached_adaptive(_field(kind, torch), torch.from_numpy(x0), g,
                                                 tol=tol, max_interval=max_interval, order=order,
                                                 with_stats=True)
    assert n_only == n_got


def test_integrators_refuse_bad_orders():
    from vavae_tpu_torch.transport import ode

    x, g = torch.zeros(1, 2), _grid()
    with pytest.raises(ValueError, match="order must be 0, 1 or 2"):
        ode.odeint_euler_cached(lambda x, t: x, x, g, 1, order=3)
    with pytest.raises(ValueError, match="order must be 0, 1 or 2"):
        ode.odeint_euler_cached_adaptive(lambda x, t: x, x, g, order=3)
    with pytest.raises(ValueError, match="max_interval must be >= 1"):
        ode.odeint_euler_cached_adaptive(lambda x, t: x, x, g, max_interval=0)
    with pytest.raises(ValueError, match="order must be 1, 2 or 3"):
        ode.odeint_ab(lambda x, t: x, x, g, order=4)


# -- dopri5 ---------------------------------------------------------------------------


def _stats(s):
    return int(s["naccept"]), int(s["nreject"]), bool(s["exhausted"])


@pytest.mark.parametrize("kind", FIELDS)
@pytest.mark.parametrize("span", [(0.0, 1.0), (1.0, 0.0), (0.0, 0.11), (0.11, 1.0)])
@pytest.mark.parametrize("rtol,atol", [(1e-3, 1e-6), (1e-5, 1e-7)])
def test_dopri5_matches_jax(kind, span, rtol, atol):
    """Accepted, rejected and exhausted equal, forward and reverse (t1 < t0,
    the time mirror), on each phase span of the CFG sampler."""
    from vavae_tpu.transport import ode as jode
    from vavae_tpu_torch.transport import ode

    t0, t1 = span
    kw = dict(rtol=rtol, atol=atol, with_stats=True)
    x0 = _x0(4)
    want, sw = jode.odeint_dopri5(_field(kind, jnp), jnp.asarray(x0), t0, t1, **kw)
    got, sg = ode.odeint_dopri5(_field(kind, torch), torch.from_numpy(x0), t0, t1, **kw)
    assert _stats(sg) == _stats(sw)
    assert sg["naccept"] >= 1
    assert max_rel(_np(got), want) < TOL


@pytest.mark.parametrize("max_steps", [1, 2, 3])
def test_dopri5_exhaustion_matches_jax(max_steps):
    """max_steps runs out before t1: exhausted, the state reached so far."""
    from vavae_tpu.transport import ode as jode
    from vavae_tpu_torch.transport import ode

    kw = dict(rtol=1e-3, atol=1e-6, max_steps=max_steps, with_stats=True)
    x0 = _x0(5)
    want, sw = jode.odeint_dopri5(_field("nonlinear", jnp), jnp.asarray(x0), 0.0, 1.0, **kw)
    got, sg = ode.odeint_dopri5(_field("nonlinear", torch), torch.from_numpy(x0), 0.0, 1.0, **kw)
    assert _stats(sg) == _stats(sw) and sg["exhausted"]
    assert sg["naccept"] + sg["nreject"] == max_steps
    assert max_rel(_np(got), want) < TOL


@pytest.mark.parametrize("span", [(0.0, 1.0), (1.0, 0.0)])
def test_dopri5_pytree_state_matches_jax(span):
    """A (x, logp) state: one error norm over both leaves, a (B,) leaf
    beside the (B, ...) one."""
    from vavae_tpu.transport import ode as jode
    from vavae_tpu_torch.transport import ode

    def drift(xp):
        f = _field("nonlinear", xp)

        def aug(state, t):
            x, lp = state
            v = f(x, t)
            return (v, (v * x).reshape(x.shape[0], -1).sum(-1) * 0.1 + 0.0 * lp)
        return aug

    x0, lp0 = _x0(6), np.zeros((2,), np.float32)
    kw = dict(rtol=1e-3, atol=1e-6, with_stats=True)
    (wx, wl), sw = jode.odeint_dopri5(drift(jnp), (jnp.asarray(x0), jnp.asarray(lp0)), *span, **kw)
    (gx, gl), sg = ode.odeint_dopri5(drift(torch), (torch.from_numpy(x0), torch.from_numpy(lp0)),
                                     *span, **kw)
    assert _stats(sg) == _stats(sw)
    assert max_rel(_np(gx), wx) < TOL and max_rel(_np(gl), wl) < TOL


# -- SDE ----------------------------------------------------------------------------------


FORMS = ("constant", "SBDM", "sigma", "linear", "decreasing", "increasing-decreasing")


def _velocity(xp):
    """An analytic velocity model (no parameters), smooth in x and t."""
    return lambda x, t: -0.8 * x + 0.1 * xp.sin(3.0 * t).reshape(-1, 1, 1, 1) + 0.05 * xp.cos(x)


@pytest.mark.parametrize("last_step", ["Mean", "Tweedie", "Euler", None])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("method", ["Euler", "Heun"])
def test_sample_sde_matches_jax(method, form, last_step):
    """The same Wiener increments through both samplers (and the paths'
    diffusion coefficients on the way)."""
    from vavae_tpu.transport import Sampler as JaxSampler
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import Sampler, create_transport

    kw = dict(sampling_method=method, diffusion_form=form, last_step=last_step,
              last_step_size=0.04, num_steps=12)
    x0 = _x0(7)
    noise = np.random.default_rng(8).standard_normal((11, *x0.shape)).astype(np.float32)
    want = JaxSampler(jax_transport(sample_eps=1e-3)).sample_sde(**kw)(
        None, jnp.asarray(x0), _velocity(jnp), noise=jnp.asarray(noise))
    got = Sampler(create_transport(sample_eps=1e-3)).sample_sde(**kw)(
        torch.from_numpy(x0), _velocity(torch), noise=torch.from_numpy(noise))
    assert np.isfinite(_np(got)).all()
    assert max_rel(_np(got), want) < TOL


def test_sde_noise_must_cover_the_grid():
    from vavae_tpu_torch.transport import Sampler, create_transport

    fn = Sampler(create_transport()).sample_sde(num_steps=5)
    with pytest.raises(ValueError, match="noise holds 3 steps, the grid 4"):
        fn(torch.zeros(1, 2, 2, 1), _velocity(torch), noise=torch.zeros(3, 1, 2, 2, 1))


def test_sde_draws_from_the_generator():
    from vavae_tpu_torch.transport import Sampler, create_transport

    fn = Sampler(create_transport()).sample_sde(sampling_method="Heun", diffusion_form="sigma",
                                                num_steps=5)
    x = torch.zeros(2, 2, 2, 1)
    a = fn(x, _velocity(torch), generator=torch.Generator().manual_seed(1))
    b = fn(x, _velocity(torch), generator=torch.Generator().manual_seed(1))
    c = fn(x, _velocity(torch), generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("form", FORMS)
def test_diffusion_coeff_matches_jax(form):
    from vavae_tpu.transport import paths as jpaths
    from vavae_tpu.transport.transport import PathType as JPathType
    from vavae_tpu.transport.transport import _PATHS as JPATHS
    from vavae_tpu_torch.transport import paths
    from vavae_tpu_torch.transport.transport import _PATHS, PathType

    x = _x0(9)
    t = np.linspace(0.05, 0.95, 2).astype(np.float32)
    for name in ("LINEAR", "GVP", "VP"):
        want = jpaths.diffusion_coeff(JPATHS[JPathType[name]], jnp.asarray(x), jnp.asarray(t),
                                      form=form, norm=0.7)
        got = paths.diffusion_coeff(_PATHS[PathType[name]], torch.from_numpy(x),
                                    torch.from_numpy(t), form=form, norm=0.7)
        assert max_rel(_np(got), want) < TOL


# -- likelihood ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,kw", [("euler", dict(num_steps=40)),
                                       ("dopri5", dict(rtol=1e-5, atol=1e-7))])
def test_likelihood_on_an_analytic_model_matches_jax(method, kw):
    """The port's εᵀ(Jᵀε) against JAX's εᵀ(Jε) on a model with a dense
    Jacobian (its transpose differs), with the same ε."""
    import jax

    from vavae_tpu.transport import Sampler as JaxSampler
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import Sampler, create_transport

    rs = np.random.default_rng(10)
    x0 = rs.standard_normal((2, 3, 3, 2)).astype(np.float32)
    W = (0.3 * rs.standard_normal((18, 18))).astype(np.float32)

    def model(xp, mat):
        def fn(x, t):
            flat = x.reshape(x.shape[0], -1)
            y = xp.tanh(flat @ mat) * (1.0 + t.reshape(-1, 1)) - 0.5 * flat
            return y.reshape(x.shape)
        return fn

    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.randint(key, x0.shape, 0, 2).astype(jnp.float32) * 2.0 - 1.0)
    lw, zw = JaxSampler(jax_transport()).sample_ode_likelihood(sampling_method=method, **kw)(
        key, jnp.asarray(x0), model(jnp, jnp.asarray(W)))
    lg, zg = Sampler(create_transport()).sample_ode_likelihood(sampling_method=method, **kw)(
        torch.from_numpy(x0), model(torch, torch.from_numpy(W)), eps=torch.from_numpy(eps))
    assert max_rel(_np(zg), zw) < TOL
    assert max_rel(_np(lg), lw) < TOL

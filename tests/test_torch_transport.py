"""Euler sampling parity: time grids, the CFG split index, and final latents
from the same noise through the JAX sampler and the port's.

Tolerance 1e-4 relative: a tiny fp32 DiT (TF32 off, JAX at ``highest``)
integrated over 10 steps, where only summation order differs per step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread, tiny_dit_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4


@pytest.mark.parametrize("steps,shift", [(250, 0.3), (10, 0.0), (37, 2.0)])
def test_time_grid_equal(steps, shift):
    from vavae_tpu.transport import ode as jode
    from vavae_tpu_torch.transport import ode

    np.testing.assert_array_equal(ode.time_grid(0.0, 1.0, steps, shift),
                                  jode.time_grid(0.0, 1.0, steps, shift))
    np.testing.assert_array_equal(ode.timestep_shift_grid(np.linspace(0, 1, 5), shift),
                                  jode.timestep_shift_grid(np.linspace(0, 1, 5), shift))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("steps,shift,start", [(250, 0.3, 0.11), (10, 0.3, 0.11), (50, 1.0, 0.0)])
def test_split_idx_equal(steps, shift, start, reverse):
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu.transport.cost import split_idx as jax_split_idx
    from vavae_tpu_torch.transport import create_transport
    from vavae_tpu_torch.transport.sampler import split_idx

    assert split_idx(create_transport(), steps, shift, start, reverse) == jax_split_idx(
        jax_transport(), steps, shift, start, reverse)


def test_production_split_and_launch_count():
    """At the production settings (250 steps, shift 0.3, start 0.11) the
    cond-only phase is 73 of 249 steps, and every step runs one model
    evaluation: 249 per sampling call."""
    from vavae_tpu_torch.transport import Sampler, create_transport

    fn = Sampler(create_transport()).sample_ode_cfg(
        num_steps=250, timestep_shift=0.3, cfg_interval_start=0.11)
    calls = {"cond": 0, "cfg": 0}

    def cond(x, t):
        calls["cond"] += 1
        return torch.zeros_like(x)

    def cfg(x, t):
        calls["cfg"] += 1
        return torch.zeros_like(x)

    out = fn(torch.ones((2, 1)), cond, cfg)
    assert out.shape == (2, 1)
    assert calls["cond"] == fn.split_idx == 73 and calls["cond"] + calls["cfg"] == 249


def _models(seed=0):
    jm, params, tm = tiny_dit_pair(seed=seed, patch_size=2)
    rs = np.random.default_rng(seed + 10)
    z = rs.standard_normal((2, 8, 8, 4)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    return jm, params, tm, z, y


def test_sample_ode_cfg_split_euler_matches_jax():
    from vavae_tpu.transport import Sampler as JaxSampler
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import Sampler, create_transport

    jm, params, tm, z, y = _models(seed=4)
    y_in = np.concatenate([y, np.full_like(y, 10)])
    kw = dict(num_steps=10, timestep_shift=0.3, cfg_interval_start=0.11)

    jfn = JaxSampler(jax_transport()).sample_ode_cfg(**kw)
    want = np.asarray(jfn(
        jnp.asarray(z),
        lambda x, t: jm.apply({"params": params}, x, t, jnp.asarray(y)),
        lambda x, t: jm.forward_with_cfg(params, x, t, jnp.asarray(y_in), 4.0),
    ))
    fn = Sampler(create_transport()).sample_ode_cfg(**kw)
    yt, yint = torch.from_numpy(y).long(), torch.from_numpy(y_in).long()
    with torch.no_grad():
        got = fn(torch.from_numpy(z), lambda x, t: tm(x, t, yt),
                 lambda x, t: tm.forward_with_cfg(x, t, yint, 4.0)).numpy()
    assert fn.split_idx > 0  # both phases ran
    assert max_rel(got, want) < TOL


def test_sample_ode_euler_matches_jax():
    from vavae_tpu.transport import Sampler as JaxSampler
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import Sampler, create_transport

    jm, params, tm, z, y = _models(seed=5)
    kw = dict(sampling_method="euler", num_steps=10, timestep_shift=0.3)
    want = np.asarray(JaxSampler(jax_transport()).sample_ode(**kw)(
        jnp.asarray(z), lambda x, t: jm.apply({"params": params}, x, t, jnp.asarray(y))))
    yt = torch.from_numpy(y).long()
    with torch.no_grad():
        got = Sampler(create_transport()).sample_ode(**kw)(
            torch.from_numpy(z), lambda x, t: tm(x, t, yt)).numpy()
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("kw", [dict(sampling_method="heun"), dict(cache_interval=2),
                                dict(multistep_order=3), dict(sampling_method="dopri5")])
def test_unported_samplers_raise(kw):
    """The CFG samplers that raised NotImplementedError before they were
    ported (heun, the velocity cache, multistep, dopri5) now build and
    run, each calling the model and returning the state's shape."""
    from vavae_tpu_torch.transport import Sampler, create_transport

    fn = Sampler(create_transport()).sample_ode_cfg(num_steps=10, cfg_interval_start=0.11, **kw)
    calls = []

    def model(x, t):
        calls.append(x.shape[0])
        return -x

    out = fn(torch.ones((2, 3)), model, model)
    assert out.shape == (2, 3) and torch.isfinite(out).all()
    assert calls and set(calls) == {2, 4}  # the cond-only and the CFG phase ran

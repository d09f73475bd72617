"""Every sampler branch on the tiny DiT pair of ``test_torch_common.py``
through both packages with the same inputs: ``sample_ode`` (heun, ab2,
ab3, dopri5), each ``sample_ode_cfg`` branch (its ``return_stats`` and
``reverse``), the likelihood with the same ε, and ``build_sample_fn`` in
SDE mode and with the DiT-S micro-Doppler config's dopri5 ``sample:``
block, with the same z and Wiener draws.

Tolerance 1e-4 relative (fp32, TF32 off, JAX at ``highest``: the model's
summation order differs per evaluation); dopri5's counts and the adaptive
cache's evaluation count equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, tiny_dit_pair

TOL = 1e-4
NULL = 10  # the tiny pair's num_classes: the CFG null label


@pytest.fixture(scope="module")
def pair():
    jm, params, tm = tiny_dit_pair(seed=4, patch_size=2)
    rs = np.random.default_rng(14)
    z = rs.standard_normal((2, 8, 8, 4)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    return jm, params, tm, z, y


def _samplers(**transport):
    from vavae_tpu.transport import Sampler as JaxSampler
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import Sampler, create_transport

    return JaxSampler(jax_transport(**transport)), Sampler(create_transport(**transport))


def _stats_equal(got, want):
    for key in ("naccept", "nreject", "exhausted"):
        assert int(got[key]) == int(want[key]), (key, got, want)


@pytest.mark.parametrize("method", ["heun", "ab2", "ab3", "dopri5"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sample_ode_matches_jax(pair, method, reverse):
    jm, params, tm, z, y = pair
    js, ts = _samplers()
    kw = dict(sampling_method=method, num_steps=8, timestep_shift=0.3, reverse=reverse)
    want = js.sample_ode(**kw)(jnp.asarray(z),
                               lambda x, t: jm.apply({"params": params}, x, t, jnp.asarray(y)))
    yt = torch.from_numpy(y).long()
    with torch.no_grad():
        got = ts.sample_ode(**kw)(torch.from_numpy(z), lambda x, t: tm(x, t, yt))
    assert max_rel(got.numpy(), np.asarray(want)) < TOL


CFG_BRANCHES = {
    "heun": dict(sampling_method="heun"),
    "dopri5": dict(sampling_method="dopri5"),
    "dopri5_stats": dict(sampling_method="dopri5", return_stats=True),
    "dopri5_no_interval": dict(sampling_method="dopri5", return_stats=True,
                               cfg_interval_start=0.0),
    "ab2": dict(multistep_order=2),
    "ab3": dict(multistep_order=3),
    "cache_k3_o1": dict(cache_interval=3, cache_order=1),
    "cache_k3_o2": dict(cache_interval=3, cache_order=2),
    "cache_k2_o0": dict(cache_interval=2, cache_order=0),
    "adaptive": dict(cache_adaptive=True),
    "adaptive_stats": dict(cache_adaptive=True, return_stats=True, cache_tol=0.005),
    "adaptive_o2": dict(cache_adaptive=True, cache_tol=0.005, cache_order=2),
}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", list(CFG_BRANCHES))
def test_sample_ode_cfg_branches_match_jax(pair, name, reverse):
    """Every branch of the CFG sampler; with ``return_stats`` the same
    structure (dopri5 ``{"cond", "cfg"}``, the adaptive cache
    ``{"cfg_evals", "noise_floor"}``) and equal counts. (The order-2
    cache's noise floor on this model, about 1e-5, lies at the two
    packages' per-evaluation agreement, so its stats are held on the toy
    drifts of ``test_torch_samplers.py`` instead.)"""
    jm, params, tm, z, y = pair
    js, ts = _samplers()
    y_in = np.concatenate([y, np.full_like(y, NULL)])
    kw = dict(num_steps=12, timestep_shift=0.3, cfg_interval_start=0.11, reverse=reverse)
    kw.update(CFG_BRANCHES[name])
    want = js.sample_ode_cfg(**kw)(
        jnp.asarray(z),
        lambda x, t: jm.apply({"params": params}, x, t, jnp.asarray(y)),
        lambda x, t: jm.forward_with_cfg(params, x, t, jnp.asarray(y_in), 4.0))
    yt, yint = torch.from_numpy(y).long(), torch.from_numpy(y_in).long()
    with torch.no_grad():
        got = ts.sample_ode_cfg(**kw)(torch.from_numpy(z), lambda x, t: tm(x, t, yt),
                                      lambda x, t: tm.forward_with_cfg(x, t, yint, 4.0))
    if kw.get("return_stats"):
        (got, stats), (want, jstats) = got, want
        assert set(stats) == set(jstats)
        if "cfg_evals" in stats:
            assert stats["cfg_evals"] == int(jstats["cfg_evals"])
            assert abs(float(stats["noise_floor"]) - float(jstats["noise_floor"])) <= 1e-6
        else:
            assert (stats["cond"] is None) == (jstats["cond"] is None)
            for phase in ("cond", "cfg"):
                if stats[phase] is not None:
                    _stats_equal(stats[phase], jstats[phase])
    assert got.shape == z.shape
    assert max_rel(got.numpy(), np.asarray(want)) < TOL


@pytest.mark.parametrize("method,kw", [("euler", dict(num_steps=6)), ("dopri5", {})])
def test_likelihood_on_the_dit_matches_jax(pair, method, kw):
    """The port's εᵀ(Jᵀε) through the DiT (autograd) against JAX's εᵀ(Jε)
    (``jax.jvp``), with the same ε; outside any grad mode the sampler
    turns autograd on itself."""
    jm, params, tm, z, y = pair
    js, ts = _samplers()
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.randint(key, z.shape, 0, 2).astype(jnp.float32) * 2.0 - 1.0)
    lw, zw = js.sample_ode_likelihood(sampling_method=method, **kw)(
        key, jnp.asarray(z), lambda x, t: jm.apply({"params": params}, x, t, jnp.asarray(y)))
    yt = torch.from_numpy(y).long()
    with torch.no_grad():
        lg, zg = ts.sample_ode_likelihood(sampling_method=method, **kw)(
            torch.from_numpy(z), lambda x, t: tm(x, t, yt), eps=torch.from_numpy(eps))
    assert max_rel(zg.numpy(), np.asarray(zw)) < TOL
    assert max_rel(lg.numpy(), np.asarray(lw)) < TOL


def test_likelihood_refuses_inference_mode(pair):
    """autograd cannot record inference tensors: the likelihood raises
    there instead of returning a wrong divergence."""
    _, _, tm, z, y = pair
    _, ts = _samplers()
    fn = ts.sample_ode_likelihood(sampling_method="euler", num_steps=3)
    yt = torch.from_numpy(y).long()
    with torch.inference_mode(), pytest.raises(RuntimeError):
        fn(torch.from_numpy(z), lambda x, t: tm(x, t, yt))


# -- build_sample_fn --------------------------------------------------------------------


def _pipeline_cfg(sample, model=None):
    return {
        "data": {"image_size": 16, "num_classes": 10, "latent_norm": False},
        "vae": {"downsample_ratio": 2},
        "transport": {"path_type": "Linear", "prediction": "velocity"},
        "sample": sample,
        "train": {"global_seed": 0},
    }


def _jax_draws(rng, B, z_shape_tail, sde_steps=None, cfg=True):
    """The draws of the JAX pipeline's ``generate``: z from the first split
    of ``rng``, then (SDE) one normal per step from the second half's
    splits, over the sampler's state ([z | z] with CFG)."""
    rng, z_rng = jax.random.split(rng)
    z = jax.random.normal(z_rng, (B, *z_shape_tail), jnp.float32)
    if sde_steps is None:
        return np.array(z), None
    shape = (2 * B if cfg else B, *z_shape_tail)
    keys = jax.random.split(rng, sde_steps)
    noise = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in keys])
    return np.array(z), noise


@pytest.mark.parametrize("method,form,last_step", [("Euler", "sigma", "Mean"),
                                                   ("Heun", "linear", "Tweedie")])
def test_build_sample_fn_sde_matches_jax(pair, method, form, last_step):
    """SDE mode: CFG on the concatenated batch with the interval gate in the
    model (no split), the same z and Wiener draws."""
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.utils.config import Config

    jm, params, tm, _, y = pair
    cfg = _pipeline_cfg({"mode": "SDE", "sampling_method": method, "diffusion_form": form,
                         "last_step": last_step, "last_step_size": 0.04,
                         "num_sampling_steps": 8, "cfg_scale": 4.0, "cfg_interval_start": 0.11})
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jax_build_sample_fn(JaxConfig(cfg), jm, params)(rng, jnp.asarray(y)))
    z, noise = _jax_draws(rng, 2, (8, 8, 4), sde_steps=7)
    got = build_sample_fn(Config(cfg), tm, device="cpu")(y, z=z, noise=noise).numpy()
    assert max_rel(got, want) < TOL


def test_build_sample_fn_microdoppler_dopri5_matches_jax(pair):
    """The DiT-S micro-Doppler config's ``sample:`` block (dopri5, atol
    1e-6, rtol 1e-3, CFG 10 gated at 0.11, shift 0.1, reverse off) on the
    tiny pair, the same z: the split-CFG dopri5 program of both pipelines."""
    import yaml

    from test_torch_common import REPO
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.utils.config import Config

    jm, params, tm, _, y = pair
    sample = yaml.safe_load((REPO / "vavae_tpu/configs/dit_s_microdoppler.yaml").read_text())["sample"]
    assert sample["sampling_method"] == "dopri5" and sample["cfg_scale"] == 10.0
    cfg = _pipeline_cfg(sample)
    rng = jax.random.PRNGKey(12)
    want = np.asarray(jax_build_sample_fn(JaxConfig(cfg), jm, params)(rng, jnp.asarray(y)))
    z, _ = _jax_draws(rng, 2, (8, 8, 4))
    got = build_sample_fn(Config(cfg), tm, device="cpu")(y, z=z).numpy()
    assert np.isfinite(got).all()
    assert max_rel(got, want) < TOL

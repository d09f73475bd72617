"""The sampling pipeline's set-up against the JAX package's: the latent
stats ``load_latent_stats`` returns for a dump without a stats cache, and
the configs that ``Sampler.sample_ode_cfg`` and ``build_sample_fn`` refuse
or warn about when the sampler is built.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_common import one_thread, tiny_dit_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# the JAX sampler's invalid ``sample_ode_cfg`` configs, one per build-time
# check (vavae_tpu/transport/sampler.py), each beside valid defaults
INVALID_CFG_KNOBS = {
    "heun_with_cache": dict(sampling_method="heun", cache_interval=2),
    "dopri5_with_multistep": dict(sampling_method="dopri5", multistep_order=2),
    "heun_with_adaptive_cache": dict(sampling_method="heun", cache_adaptive=True),
    "return_stats_plain_euler": dict(return_stats=True),
    "multistep_with_cache": dict(multistep_order=2, cache_interval=2),
    "multistep_with_adaptive_cache": dict(multistep_order=3, cache_adaptive=True),
    "adaptive_with_interval": dict(cache_adaptive=True, cache_interval=2),
    "adaptive_zero_tol": dict(cache_adaptive=True, cache_tol=0.0),
    "adaptive_zero_max_interval": dict(cache_adaptive=True, cache_max_interval=0),
    "cache_order_3": dict(cache_order=3),
    "multistep_order_4": dict(multistep_order=4),
}


@pytest.mark.parametrize("name", list(INVALID_CFG_KNOBS))
def test_sample_ode_cfg_refuses_what_jax_refuses(name):
    """Both samplers raise ValueError with the same message, so the checks
    run in the same order."""
    from vavae_tpu.transport import Sampler as JaxSampler
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.transport import Sampler, create_transport

    kw = dict(num_steps=10, timestep_shift=0.3, cfg_interval_start=0.11, **INVALID_CFG_KNOBS[name])
    with pytest.raises(ValueError) as jax_err:
        JaxSampler(jax_transport()).sample_ode_cfg(**kw)
    with pytest.raises(ValueError) as err:
        Sampler(create_transport()).sample_ode_cfg(**kw)
    assert str(err.value) == str(jax_err.value)


def _sample_cfg(**sample):
    return {
        "data": {"image_size": 16, "num_classes": 10, "latent_norm": False},
        "vae": {"downsample_ratio": 2},
        "transport": {"path_type": "Linear", "prediction": "velocity"},
        "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 10,
                   "cfg_scale": 4.0, "cfg_interval_start": 0.11, "timestep_shift": 0.3,
                   **sample},
        "train": {"global_seed": 0},
    }


def test_pipelines_warn_on_euler_only_knobs():
    """heun with multistep_order 2: both pipelines name the knob that the
    program ignores, then build their heun sampler, which runs."""
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.utils.config import Config

    cfg = _sample_cfg(sampling_method="heun", multistep_order=2, num_sampling_steps=3)
    jm, params, tm = tiny_dit_pair(seed=1, patch_size=2)
    with pytest.warns(UserWarning, match=r"sample\.multistep_order only applies"):
        jax_build_sample_fn(JaxConfig(cfg), jm, params)
    with pytest.warns(UserWarning, match=r"sample\.multistep_order only applies"):
        generate = build_sample_fn(Config(cfg), tm, device="cpu")
    out = generate([1, 2], generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 8, 8, 4) and torch.isfinite(out).all()


def test_pipelines_refuse_velocity_cache_order_3():
    """velocity_cache_order reaches the sampler on the split-euler path, so
    a value outside 0-2 fails in both pipelines when they are built."""
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.utils.config import Config

    cfg = _sample_cfg(velocity_cache_order=3)
    jm, params, tm = tiny_dit_pair(seed=1, patch_size=2)
    with pytest.raises(ValueError, match="cache_order must be 0, 1 or 2, got 3"):
        jax_build_sample_fn(JaxConfig(cfg), jm, params)
    with pytest.raises(ValueError, match="cache_order must be 0, 1 or 2, got 3"):
        build_sample_fn(Config(cfg), tm, device="cpu")


def _write_shards(d, sizes=(9, 6), C=4, S=4, seed=0):
    """Latent shards as the extraction writes them, with no stats cache."""
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    rs = np.random.default_rng(seed)
    os.makedirs(d)
    for i, n in enumerate(sizes):
        lat = (rs.standard_normal((n, C, S, S)) * rs.uniform(0.5, 2.0, (1, C, 1, 1))
               + rs.standard_normal((1, C, 1, 1))).astype(np.float32)
        write_safetensors(os.path.join(d, f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 10, (n,)).astype(np.int32)})


def test_load_latent_stats_computes_and_caches_like_jax(tmp_path):
    """A dump without ``latents_stats.safetensors``: both packages compute
    the stats from the shards (each on its own copy, since the first call
    writes the cache), equal within 1e-6, and the port writes the cache,
    which a second call reads back."""
    from vavae_tpu.pipelines.sample import load_latent_stats as jax_load_latent_stats
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import load_latent_stats
    from vavae_tpu_torch.utils.config import Config

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _write_shards(port_dir)
    shutil.copytree(port_dir, jax_dir)
    cfg = {"data": {"latent_norm": True}}
    want = jax_load_latent_stats(JaxConfig({"data": {**cfg["data"], "data_path": jax_dir}}))
    got = load_latent_stats(Config({"data": {**cfg["data"], "data_path": port_dir}}))
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape == (1, 4, 1, 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    assert os.path.exists(os.path.join(port_dir, "latents_stats.safetensors"))
    again = load_latent_stats(Config({"data": {**cfg["data"], "data_path": port_dir}}))
    for a, g in zip(again, got):
        np.testing.assert_array_equal(a, g)


@pytest.mark.parametrize("data_path", [None, "missing"])
def test_load_latent_stats_needs_a_directory(tmp_path, data_path):
    """latent_norm on without a directory raises FileNotFoundError in both
    packages; latent_norm off returns None."""
    from vavae_tpu.pipelines.sample import load_latent_stats as jax_load_latent_stats
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import load_latent_stats
    from vavae_tpu_torch.utils.config import Config

    data = {"latent_norm": True}
    if data_path is not None:
        data["data_path"] = str(tmp_path / data_path)
    for load, config in ((jax_load_latent_stats, JaxConfig), (load_latent_stats, Config)):
        with pytest.raises(FileNotFoundError, match="not a directory"):
            load(config({"data": data}))
        assert load(config({"data": {**data, "latent_norm": False}})) is None

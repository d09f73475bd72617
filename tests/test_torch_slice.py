"""The whole first slice on the CPU: tiny DiT → split-CFG euler sampling →
un-normalisation → tiny VA-VAE decode to uint8, through the port and
through the JAX package's own ``build_sample_fn`` and ``VA_VAE``; once with
the production block and once with qk-norm, and once at 48×48 latents
(N = 2,304 tokens, the port's long route).

The JAX sampler draws its noise inside ``generate``; the test draws the
same noise from the same key split and hands it to the port's
``generate(z=...)``. Latents agree to 1e-4 relative (fp32, TF32 off: only
summation order differs); images to one uint8 step (clamp-and-truncate at
integer boundaries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import max_rel, one_thread, tiny_dit_pair, tiny_vae_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CFG = {
    "data": {"image_size": 16, "num_classes": 10, "latent_norm": False,
             "latent_multiplier": 0.9},
    "vae": {"downsample_ratio": 2},
    "transport": {"path_type": "Linear", "prediction": "velocity"},
    "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 10,
               "cfg_scale": 4.0, "cfg_interval_start": 0.11, "timestep_shift": 0.3,
               "cfg_channels": None},
    "train": {"global_seed": 0},
}


def _check_slice(tmp_path, cfg=CFG, labels=(1, 5, 9), **dit_kw):
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.utils.config import Config

    S = cfg["data"]["image_size"]
    s = S // cfg["vae"]["downsample_ratio"]
    jm, params, tm = tiny_dit_pair(seed=6, **{"patch_size": 2, "input_size": s, **dit_kw})
    jv, tv = tiny_vae_pair(tmp_path, seed=7, img_size=S)
    rs = np.random.default_rng(8)
    stats = (rs.standard_normal((1, 4, 1, 1)).astype(np.float32),
             rs.uniform(0.5, 2.0, (1, 4, 1, 1)).astype(np.float32))
    labels = np.array(labels, np.int32)
    B = len(labels)

    rng = jax.random.PRNGKey(11)
    jgen = jax_build_sample_fn(JaxConfig(cfg), jm, params, stats)
    want = np.asarray(jgen(rng, jnp.asarray(labels)))
    _, z_rng = jax.random.split(rng)  # generate's own draw of the initial noise
    z = np.array(jax.random.normal(z_rng, (B, s, s, 4), jnp.float32))

    gen = build_sample_fn(Config(cfg), tm, stats, device="cpu")
    got = gen(labels, z=z).numpy()
    assert got.shape == want.shape == (B, s, s, 4)
    assert max_rel(got, want) < 1e-4

    want_img = jv.decode_to_images(jnp.asarray(want))
    got_img = tv.decode_to_images(got)
    assert got_img.dtype == np.uint8 and got_img.shape == (B, S, S, 3)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1


def test_slice_sampling_and_decode_match_jax(tmp_path):
    _check_slice(tmp_path)


def test_slice_qknorm_sampling_and_decode_match_jax(tmp_path):
    """The same with RMSNorm q/k norms: attention goes through the port's
    ``dot_product_attention`` (on the card, ``flash_attention``)."""
    _check_slice(tmp_path, use_qknorm=True)


def test_slice_long_sequence_sampling_and_decode_match_jax(tmp_path, monkeypatch):
    """The same at N > 1024, as at 1024² on the f16 VAE: a DiT of depth 2,
    hidden 64, 2 heads, patch 1 on 48×48 latents (N = 2,304 tokens, the
    port's long route), 96² images from the f2 VAE, whose 8×8 attention level
    is gone so only its mid-block attention runs. Every DiT attention call
    takes the long route."""
    from vavae_tpu_torch.ops import flash_attention as fa

    calls = []
    original = fa._long_forward
    monkeypatch.setattr(fa, "_long_forward", lambda *a: calls.append(1) or original(*a))
    cfg = {**CFG, "data": {**CFG["data"], "image_size": 96},
           "sample": {**CFG["sample"], "num_sampling_steps": 6}}
    _check_slice(tmp_path, cfg, labels=(2, 7), patch_size=1, hidden_size=64, num_heads=2)
    assert len(calls) == 2 * (6 - 1)  # depth 2, one forward per step


def test_demo_sampling_writes_grid(tmp_path, monkeypatch):
    """do_sample end to end on the CPU from a JAX-format train state and a
    reference-format latent-stats cache: the demo grid is a PNG of the
    expected size."""
    import torch
    from PIL import Image

    from vavae_tpu.train.checkpoint import save_state_file
    from vavae_tpu.train.dit_trainer import TrainState
    from vavae_tpu_torch.pipelines.sample import do_sample
    from vavae_tpu_torch.utils.config import Config
    from test_torch_common import tiny_vae_config

    _, params, _ = tiny_dit_pair(seed=9, patch_size=2)
    ckpt = tmp_path / "0000001.safetensors"
    # the JAX package's own train-state writer (EMA and raw params)
    save_state_file(str(ckpt), TrainState(step=np.zeros((), np.int32), params=params,
                                          ema_params=params, opt_state=None))
    data = tmp_path / "latents"
    data.mkdir()
    # a dump: one shard (the dataset, as the JAX one, needs shards) and the
    # reference-format stats cache, which it reads instead of computing them
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    lat = np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(np.float32)
    write_safetensors(str(data / "shard_000.safetensors"), {
        "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
        "labels": np.zeros((2,), np.int32)})
    torch.save({"mean": torch.zeros(1, 4, 1, 1), "std": torch.ones(1, 4, 1, 1)},
               data / "latents_stats.pt")

    cfg = Config(CFG).merged_with({
        "ckpt_path": str(ckpt),
        "data": {"latent_norm": True, "data_path": str(data)},
        "vae": {"config": tiny_vae_config(tmp_path)},
        "model": {"model_type": "LightningDiT-S/2", "use_swiglu": True, "use_rope": True,
                  "use_rmsnorm": True, "in_chans": 4},
        "sample_folder": str(tmp_path / "out"),
        "demo_labels": [0, 1, 2],
    })
    # the tiny DiT stands in for S/2: same registry path, narrower widths
    import vavae_tpu_torch.models.dit as dit

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    folder = do_sample(cfg, demo=True, device="cpu")
    grid = np.asarray(Image.open(f"{folder}/demo_grid.png"))
    assert grid.shape == (16, 48, 3) and grid.dtype == np.uint8

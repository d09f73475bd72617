"""VA-VAE parity: a tiny f2d4 VAE (ch 32, ch_mult (1, 2), attention at its
8x8 resolution so AttnBlock runs in the encoder and the decoder), random
non-zero weights through the bridge, fp32.

Tolerance 1e-4 relative: full fp32 on both sides (TF32 off); flax's
GroupNorm takes the variance as E[x²]−E[x]², torch as E[(x−μ)²], which
differ by rounding only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread, tiny_vae_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4


def _latents(seed=0, B=2):
    return np.random.default_rng(seed).standard_normal((B, 8, 8, 4)).astype(np.float32)


def test_vae_decode_matches_jax(tmp_path):
    jv, tv = tiny_vae_pair(tmp_path, seed=1)
    z = _latents()
    want = np.asarray(jv.decode(jnp.asarray(z)))
    got = tv.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert max_rel(got, want) < TOL
    assert any(k.startswith("decoder.up.1.attn.0") for k in tv.model.state_dict())


def test_vae_decode_without_level_attention_matches_jax(tmp_path):
    """At 32² the 8×8 attention level of ``attn_resolutions`` matches no
    level of the f2 VAE, as the f16d32 VAE's 16×16 level matches none at
    1024²: only the mid-block attention (over 16×16 = 256 tokens) runs."""
    jv, tv = tiny_vae_pair(tmp_path, seed=8, img_size=32)
    z = np.random.default_rng(9).standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jv.decode(jnp.asarray(z)))
    got = tv.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert max_rel(got, want) < TOL
    keys = tv.model.state_dict()
    assert any(k.startswith("decoder.mid.attn_1") for k in keys)
    assert not any(".attn." in k for k in keys if k.startswith(("decoder.up", "encoder.down")))


def test_vae_encode_moments_match_jax(tmp_path):
    jv, tv = tiny_vae_pair(tmp_path, seed=2)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = jv.encode_moments(jnp.asarray(x))
    got = tv.encode_moments(torch.from_numpy(x))
    assert max_rel(got.mean.numpy(), np.asarray(want.mean)) < TOL
    assert max_rel(got.logvar.numpy(), np.asarray(want.logvar)) < TOL
    assert tv.encode_images(torch.from_numpy(x)).shape == (2, 8, 8, 4)


def test_decode_to_images_uint8_matches_jax(tmp_path):
    # uint8 after clamp(127.5·x + 128): values on either side of an integer
    # boundary may land one apart
    jv, tv = tiny_vae_pair(tmp_path, seed=4)
    z = 3.0 * _latents(seed=5)
    want = jv.decode_to_images(jnp.asarray(z))
    got = tv.decode_to_images(torch.from_numpy(z))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert len(np.unique(got)) > 10  # not saturated


def test_marvae_has_no_decoder_attention():
    from vavae_tpu_torch.models.vae import AutoencoderKL

    keys = AutoencoderKL(embed_dim=4, ch=32, ch_mult=(1, 2), resolution=32,
                         model_type="marvae").state_dict()
    assert any(k.startswith("encoder.mid.attn_1") for k in keys)
    assert not any(".attn." in k for k in keys if k.startswith("decoder.up"))


def test_checkpoints_load(tmp_path):
    """A reference-named VAE state dict (the JAX exporter's output, wrapped
    as a LDM ``.ckpt`` with loss weights beside it) and a JAX-package
    ``.safetensors`` param file both load strictly into the port's facade
    and decode as the JAX VAE does."""
    import yaml

    from vavae_tpu.train.checkpoint import save_state_file
    from vavae_tpu.utils.torch_export import vae_params_to_torch
    from vavae_tpu_torch.tokenizer import VA_VAE
    from test_torch_common import TINY_DDCONFIG, tiny_vae_config

    jv, _ = tiny_vae_pair(tmp_path, seed=6)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in vae_params_to_torch(jv.params).items()}
    sd["loss.logvar"] = torch.zeros(())
    ckpt = tmp_path / "vae.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    cfg = tmp_path / "with_ckpt.yaml"
    cfg.write_text(yaml.safe_dump({"ckpt_path": str(ckpt), "model": {"params": {
        "embed_dim": 4, "ddconfig": TINY_DDCONFIG}}}))
    z = _latents(seed=7)
    want = np.asarray(jv.decode(jnp.asarray(z)))
    tv = VA_VAE(str(cfg), img_size=16, device="cpu")
    assert max_rel(tv.decode(torch.from_numpy(z)).numpy(), want) < TOL

    st = tmp_path / "vae.safetensors"
    save_state_file(str(st), jv.params)
    tv = VA_VAE(tiny_vae_config(tmp_path), ckpt_path=str(st), img_size=16, device="cpu")
    assert max_rel(tv.decode(torch.from_numpy(z)).numpy(), want) < TOL

"""JAX → torch export (utils/torch_export.py): exact roundtrip identity
through the torch_convert importers, plus strict-shape loads into the ACTUAL
reference torch modules with forward parity — proving checkpoints trained
here can go back to the reference code."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vavae_tpu.utils.torch_convert import dit_params_from_torch, vae_params_from_torch
from vavae_tpu.utils.torch_export import dit_params_to_torch, vae_params_to_torch
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb, f"tree structure differs:\n{ta}\nvs\n{tb}"
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_dit_export_roundtrip():
    """params -> torch sd -> params is the identity (incl. the RoPE
    split-half column permutation and the scan-stacked block axis)."""
    from vavae_tpu.models.dit import LightningDiT

    kw = dict(
        input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
        num_heads=4, num_classes=8, use_qknorm=True, use_swiglu=True,
        use_rope=True, use_rmsnorm=True,
    )
    model = LightningDiT(**kw)
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
    )["params"]
    params = jax.device_get(params)

    sd = dit_params_to_torch(params, patch_size=2, rope_heads=kw["num_heads"])
    back = dit_params_from_torch(
        sd, depth=kw["depth"], use_swiglu=True, use_rmsnorm=True,
        rope_heads=kw["num_heads"],
    )
    _tree_equal(params, back)


def test_vae_export_roundtrip():
    """VAE params -> reference-named state dict -> params is the identity
    (all levels incl. shortcut/attn/resample convs)."""
    from vavae_tpu.models.vae import AutoencoderKL

    model = AutoencoderKL(embed_dim=8, ch_mult=(1, 2), resolution=64)
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 64, 64, 3)), sample=False,
    )["params"]
    params = jax.device_get(params)

    sd = vae_params_to_torch(params)
    back = vae_params_from_torch(sd, ch_mult=(1, 2), resolution=64)
    _tree_equal(params, back)


@pytest.mark.slow
def test_dit_export_loads_into_reference_with_forward_parity():
    """The exported state dict strict-loads into the ACTUAL reference
    LightningDiT (every trainable parameter present, correct shapes) and the
    torch forward matches our forward on the same input."""
    import os

    from tests.test_dit_parity import REF_DIR, _load_reference_dit

    if not os.path.isdir(REF_DIR):
        pytest.skip("reference tree not mounted")
    try:
        ref_mod = _load_reference_dit()
    except Exception as e:
        pytest.skip(f"cannot load reference DiT: {e}")
    import torch

    from vavae_tpu.models.dit import LightningDiT

    kw = dict(
        input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
        num_heads=4, num_classes=8, class_dropout_prob=0.1,
        use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True,
    )
    ours = LightningDiT(**kw)
    params = ours.init(
        {"params": jax.random.PRNGKey(3)},
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
    )["params"]
    params = jax.device_get(params)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in dit_params_to_torch(
              params, patch_size=2, rope_heads=kw["num_heads"],
              input_size=kw["input_size"]).items()}

    torch.manual_seed(0)
    ref = ref_mod.LightningDiT(**kw).eval()
    missing, unexpected = ref.load_state_dict(sd, strict=False)
    assert not unexpected, f"exported keys unknown to the reference: {unexpected}"
    # anything missing must be a non-trainable buffer (e.g. cached rotary
    # freqs), never a parameter
    param_names = {n for n, _ in ref.named_parameters()}
    missing_params = [m for m in missing if m in param_names]
    assert not missing_params, f"export dropped parameters: {missing_params}"

    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 8, 8)).astype(np.float32)
    t = np.asarray([0.2, 0.5, 0.8], np.float32)
    y = np.asarray([1, 4, 7], np.int64)
    with torch.no_grad():
        out_ref = ref(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)
        ).numpy()
    out_j = ours.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
        jnp.asarray(t), jnp.asarray(y.astype(np.int32)),
    )
    out_j = np.transpose(np.asarray(out_j), (0, 3, 1, 2))
    np.testing.assert_allclose(out_j, out_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.slow
def test_vae_export_loads_into_reference_with_forward_parity():
    """Exported VAE weights strict-load into the reference AutoencoderKL and
    its encode moments match ours on the same image."""
    import importlib.util
    import types

    try:
        import torch

        if "torchvision" not in sys.modules:
            tv = types.ModuleType("torchvision")
            tv.transforms = types.ModuleType("torchvision.transforms")
            sys.modules["torchvision"] = tv
            sys.modules["torchvision.transforms"] = tv.transforms
        spec = importlib.util.spec_from_file_location(
            "ref_autoencoder", "/root/reference/LightningDiT/tokenizer/autoencoder.py"
        )
        ref_ae = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref_ae)
        RefVAE = ref_ae.AutoencoderKL
    except Exception:
        pytest.skip("reference tokenizer unavailable")

    from vavae_tpu.models.vae import AutoencoderKL

    ours = AutoencoderKL(embed_dim=8, ch_mult=(1, 2), resolution=256)
    params = ours.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)), sample=False,
    )["params"]
    params = jax.device_get(params)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in vae_params_to_torch(params).items()}

    torch.manual_seed(0)
    ref = RefVAE(embed_dim=8, ch_mult=(1, 2)).eval()
    missing, unexpected = ref.load_state_dict(sd, strict=False)
    assert not unexpected, f"exported keys unknown to the reference: {unexpected}"
    param_names = {n for n, _ in ref.named_parameters()}
    missing_params = [m for m in missing if m in param_names]
    assert not missing_params, f"export dropped parameters: {missing_params}"

    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 3, 64, 64)).astype(np.float32) * 0.5
    with torch.no_grad():
        post_ref = ref.encode(torch.from_numpy(x))
        mom_ref = np.concatenate(
            [post_ref.mean.numpy(), post_ref.logvar.numpy()], axis=1
        )
    post_j = ours.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
        method=AutoencoderKL.encode,
    )
    mom_j = np.concatenate(
        [np.asarray(post_j.mean), np.asarray(post_j.logvar)], axis=-1
    )
    mom_j = np.transpose(mom_j, (0, 3, 1, 2))
    np.testing.assert_allclose(mom_j, mom_ref, rtol=2e-4, atol=2e-4)

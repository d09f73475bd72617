"""LightningDiT forward parity: the port against the JAX package through the
weight bridge, with random non-zero weights, in fp32.

Tolerance 1e-4 relative to the output's largest magnitude: both sides run
full fp32 (TF32 off, JAX at ``highest``), so only summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread, tiny_dit_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4


def _inputs(B: int, size: int, C: int, seed: int = 0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, size, size, C)).astype(np.float32)
    t = rs.uniform(0, 1, (B,)).astype(np.float32)
    y = rs.integers(0, 10, (B,)).astype(np.int32)
    return x, t, y


VARIANTS = {
    # the production block: SwiGLU + RMSNorm + RoPE, head dim 144/2 = 72
    "swiglu_rms_rope_p1": dict(patch_size=1),
    "swiglu_rms_rope_p2": dict(patch_size=2),
    # the wo_shift / Mlp / LayerNorm variant, no RoPE
    "wo_shift_mlp_ln": dict(patch_size=2, use_swiglu=False, use_rmsnorm=False,
                            use_rope=False, wo_shift=True),
    # the QK-norm branch (plain attention op): RMSNorm and LayerNorm q/k norms
    "qknorm_rms_rope": dict(patch_size=2, use_qknorm=True),
    "qknorm_ln": dict(patch_size=2, use_qknorm=True, use_rmsnorm=False, use_rope=False),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_dit_forward_matches_jax(name):
    jm, params, tm = tiny_dit_pair(seed=1, **VARIANTS[name])
    x, t, y = _inputs(3, 8, 4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long()).numpy()
    assert got.shape == want.shape == (3, 8, 8, 4)
    assert np.abs(want).max() > 0.1  # the random weights make a non-trivial field
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("cfg_channels", [None, 3])
@pytest.mark.parametrize("t_val", [0.05, 0.5])
def test_forward_with_cfg_matches_jax(cfg_channels, t_val):
    """[cond | uncond] batched CFG with the interval gate: at t below the
    start the conditional output stands, above it the guided one."""
    jm, params, tm = tiny_dit_pair(seed=2, patch_size=2)
    x, _, y = _inputs(2, 8, 4, seed=3)
    x2 = np.concatenate([x, x])
    y2 = np.concatenate([y, np.full_like(y, 10)])
    t2 = np.full((4,), t_val, np.float32)
    kw = dict(cfg_interval=True, cfg_interval_start=0.11, cfg_channels=cfg_channels)
    want = np.asarray(jm.forward_with_cfg(params, jnp.asarray(x2), jnp.asarray(t2),
                                          jnp.asarray(y2), 4.0, **kw))
    with torch.no_grad():
        got = tm.forward_with_cfg(torch.from_numpy(x2), torch.from_numpy(t2),
                                  torch.from_numpy(y2).long(), 4.0, **kw).numpy()
    assert max_rel(got, want) < TOL


def test_registry_and_create_dit_match_jax():
    """Same registry names; create_dit maps the production ``model:`` block
    to the same architecture (built on the meta device: no memory)."""
    from vavae_tpu.models.dit import LightningDiT_models as jax_models
    from vavae_tpu.models.dit import create_dit as jax_create
    from vavae_tpu_torch.models.dit import LightningDiT_models, create_dit

    assert sorted(LightningDiT_models) == sorted(jax_models)
    model_cfg = {"model_type": "LightningDiT-XL/1", "use_qknorm": False, "use_swiglu": True,
                 "use_rope": True, "use_rmsnorm": True, "wo_shift": False, "in_chans": 32,
                 "bf16": True}
    tm = create_dit(model_cfg, 16, 1000, device="meta")
    jm = jax_create(model_cfg, 16, 1000)
    assert (tm.depth, tm.num_heads, tm.in_channels) == (jm.depth, jm.num_heads, jm.in_channels)
    assert tm.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    assert tm.x_embedder.proj.weight.shape == (1152, 32)
    assert tm.blocks[0].mlp.w12.weight.shape == (2 * 3072, 1152)
    n_params = sum(p.numel() for p in tm.parameters())
    assert 670e6 < n_params < 680e6  # LightningDiT-XL/1: 675M


def test_fresh_dit_outputs_zero_like_jax():
    """The JAX init zeroes adaLN and the final layer; so does the port's."""
    from vavae_tpu_torch.models.dit import LightningDiT

    tm = LightningDiT(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=1,
                      num_heads=2, num_classes=10)
    x, t, y = _inputs(2, 8, 4)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    assert out.shape == (2, 8, 8, 4) and torch.count_nonzero(out) == 0


def test_reference_checkpoint_loads_through_rope_permutation(tmp_path):
    """A reference-layout ``.pt`` (the JAX package's exporter undoes the
    split-half RoPE permutation and emits the conv patch embedding) loads
    through ``load_dit_params`` into the same weights the bridge gives."""
    from vavae_tpu.utils.torch_export import dit_params_to_torch
    from vavae_tpu_torch.models.dit import LightningDiT
    from vavae_tpu_torch.pipelines.sample import load_dit_params

    jm, params, tm = tiny_dit_pair(seed=5, patch_size=2)
    ref = dit_params_to_torch(params, patch_size=2, rope_heads=jm.num_heads, input_size=8)
    ema = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()}
    path = tmp_path / "ref.pt"
    torch.save({"model": {k: 0 * v for k, v in ema.items()}, "ema": ema}, path)
    loaded = LightningDiT(input_size=8, patch_size=2, in_channels=4, hidden_size=144, depth=2,
                          num_heads=2, num_classes=10, use_swiglu=True, use_rmsnorm=True,
                          use_rope=True)
    load_dit_params(loaded, str(path))  # EMA preferred
    want = tm.state_dict()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)

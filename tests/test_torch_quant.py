"""INT8 quantization of the port against the JAX package
(``vavae_tpu/ops/quant.py``, ``apps/quantize_dit.py``): the int8 values and
scales bit-equal (the port's weights are the JAX kernels transposed), the
quantized tiny-DiT tree leaf for leaf in the JAX layout, the int8
product's int32 accumulators equal (the CPU's int32 path, and
``torch._int_mm`` behind the zero padding the card's route adds) with the
outputs to 1e-6 relative, int8 files read across the packages, and
``quantize_dit.main`` on a tiny config: sizes and compression equal, the
output and sample deviations to the tolerances stated at the test."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import one_thread, tiny_dit_pair  # noqa: F401
from vavae_tpu.ops import quant as jq
from vavae_tpu_torch.ops import quant as tq
from vavae_tpu_torch.utils.safetensors_io import flatten
from vavae_tpu_torch.utils.weights import dit_jax_path, dit_state_to_jax

pytestmark = pytest.mark.usefixtures("one_thread")


def _kernel(shape, seed=0):
    rs = np.random.default_rng(seed)
    w = rs.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                                # an all-zero channel: scale 1e-12
    w[..., 1, 1] = 127.0                           # absmax 127: scale 1, ties at .5 below
    w[..., 2:9, 1] = np.arange(7) - 3.5
    return w


@pytest.mark.parametrize("shape", [(24, 40), (3, 24, 40)], ids=["2d", "stacked"])
def test_quantize_kernel_bit_equal(shape):
    """JAX (…, in, out) against the port's (…, out, in): values and scales
    bit-equal, halves rounded to even on both sides; dequantized equal."""
    w = _kernel(shape)
    want = jq.quantize_kernel(jnp.asarray(w))
    got = tq.quantize_kernel(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    assert got["values"].dtype == torch.int8 and got["scales"].dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(got["values"].numpy(), -1, -2),
                                  np.asarray(want["values"]))
    np.testing.assert_array_equal(np.swapaxes(got["scales"].numpy(), -1, -2),
                                  np.asarray(want["scales"]))
    np.testing.assert_array_equal(np.swapaxes(tq.dequantize_kernel(got).numpy(), -1, -2),
                                  np.asarray(jq.dequantize_kernel(want)))


@pytest.fixture(scope="module")
def tiny_dit():
    return tiny_dit_pair(seed=7)


def _leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten(jax.device_get(tree)).items()}


@pytest.mark.parametrize("targets", [jq.DEFAULT_TARGETS, ("qkv", "adaLN")], ids=["all", "some"])
def test_quantize_params_tree_matches_jax(tiny_dit, targets):
    """quantize_params on the tiny DiT through the bridge: every leaf of the
    JAX layout bit-equal (int8 values stacked over the blocks), the same
    kernels quantized, and dequantize_params back to JAX's."""
    _, params, tm = tiny_dit
    want_q, want_layout = jq.quantize_params(params, targets)
    got_q, layout = tq.quantize_params(dict(tm.named_parameters()), targets)
    want, got = _leaves(want_q), _leaves(dit_state_to_jax(got_q))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {"|".join(dit_jax_path(k)) for k in layout} == set(flatten(want_layout))
    deq = _leaves(dit_state_to_jax(tq.dequantize_params(got_q)))
    for k, v in _leaves(jq.dequantize_params(want_q)).items():
        np.testing.assert_array_equal(deq[k], v, err_msg=k)
    assert tq.quantized_size_bytes(got_q) == jq.quantized_size_bytes(want_q)
    assert (tq.quantized_size_bytes(dict(tm.named_parameters()))
            == jq.quantized_size_bytes(params))


def _jax_int8_acc(x, q):
    """The int32 accumulators of the JAX int8_matmul (its body up to the
    dot_general)."""
    x_absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    x_scale = jnp.maximum(x_absmax / 127.0, 1e-12)
    x_q = jnp.clip(jnp.round(x / x_scale), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(x_q, q["values"], (((x.ndim - 1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))


@pytest.mark.parametrize("M,K,N", [(40, 64, 48), (5, 12, 20)])
def test_int8_matmul_matches_jax(M, K, N):
    """Accumulators equal on the CPU's int32 path and through the card
    route's padding to torch._int_mm's shapes (M > 16, K and N multiples of
    8; here on the CPU's _int_mm); outputs to 1e-6 relative."""
    rs = np.random.default_rng(M)
    x = rs.standard_normal((M, K)).astype(np.float32) * 3.0
    w = _kernel((K, N), seed=M)
    qj = jq.quantize_kernel(jnp.asarray(w))
    qt = tq.quantize_kernel(torch.from_numpy(w.T.copy()))
    want_acc = _jax_int8_acc(jnp.asarray(x), qj)
    out, acc = tq.int8_matmul(torch.from_numpy(x), qt, return_acc=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    xq, _ = tq.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tq._int_mm_padded(xq, qt["values"]).numpy(), want_acc)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), qj))
    assert np.abs(out.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_int8_files_restore_across_packages(tiny_dit, tmp_path):
    """The port's int8 file restores in JAX with quantize_params(eval_shape)
    as the target, and the JAX package's file in the port, bit-equal."""
    from vavae_tpu.train.checkpoint import restore_checkpoint, save_state_file
    from vavae_tpu_torch.apps.quantize_dit import load_int8, save_int8

    jm, params, tm = tiny_dit
    got_q, _ = tq.quantize_params(dict(tm.named_parameters()))
    port_file = save_int8(str(tmp_path / "port.safetensors"), got_q)
    target = jax.eval_shape(lambda p: jq.quantize_params(p)[0], params)
    target = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), target)
    restored = restore_checkpoint(port_file, target)
    want_q, _ = jq.quantize_params(params)
    for k, v in _leaves(want_q).items():
        r = _leaves(restored)[k]
        assert r.dtype == v.dtype, k
        np.testing.assert_array_equal(r, v, err_msg=k)

    jax_file = save_state_file(str(tmp_path / "jax.safetensors"), want_q)
    back = load_int8(jax_file)
    assert set(back) == set(got_q)
    for k, v in got_q.items():
        if isinstance(v, dict):
            for part in ("values", "scales"):
                assert back[k][part].dtype == v[part].dtype
                np.testing.assert_array_equal(back[k][part].numpy(), v[part].numpy())
        else:
            np.testing.assert_array_equal(back[k].numpy(), v.detach().numpy())


def test_quantize_dit_main_matches_jax(tiny_dit, tmp_path, monkeypatch):
    """Both CLIs on a tiny config and the same checkpoint, the port fed the
    JAX forward inputs and sampling noise: fp and int8 sizes and the
    compression equal; mean_abs_rel_error to 1e-4 relative and
    sample_latent_rel_l2 to 1e-3 relative of JAX's (fp32, 4 euler steps:
    the int8 rounding is shared, the forwards differ in summation order);
    the port's --out file equals its in-memory tree."""
    import yaml

    from vavae_tpu.apps import quantize_dit as jqd
    from vavae_tpu.models import dit as jdit
    from vavae_tpu_torch.apps import quantize_dit as tqd
    from vavae_tpu_torch.apps.lora_finetune import export_merged
    from vavae_tpu_torch.models import dit as tdit
    from vavae_tpu_torch.pipelines import sample as tsample

    _, _, tm = tiny_dit
    for mod in (jdit, tdit):
        monkeypatch.setitem(mod._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    ckpt = export_merged(str(tmp_path), 1, tm.state_dict())
    cfg = {"ckpt_path": ckpt, "data": {"image_size": 16, "num_classes": 10},
           "vae": {"downsample_ratio": 2},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4},
           "transport": {"path_type": "Linear", "prediction": "velocity"},
           "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 4,
                      "cfg_scale": 4.0, "cfg_interval_start": 0.11, "timestep_shift": 0.3},
           "train": {"global_seed": 3}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    common = ["--config", str(path), "--batch_size", "4", "--reps", "1", "--sample_check", "2"]
    monkeypatch.setattr(sys, "argv", ["quantize_dit"] + common
                        + ["--report", str(tmp_path / "jax.json")])
    jqd.main()
    want = json.loads((tmp_path / "jax.json").read_text())

    # the JAX draws: x from PRNGKey(1), the sampler's z from split(PRNGKey(seed))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, 8, 4)))
    z = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(3))[1], (2, 8, 8, 4)))
    inputs = tqd.example_inputs
    monkeypatch.setattr(tqd, "example_inputs", lambda *a: (torch.from_numpy(x),) + inputs(*a)[1:])
    build = tsample.build_sample_fn

    def with_jax_noise(*a, **kw):
        gen = build(*a, **kw)
        return lambda labels, generator=None: gen(labels, z=z)

    monkeypatch.setattr(tsample, "build_sample_fn", with_jax_noise)
    out = str(tmp_path / "port_int8.safetensors")
    got = tqd.main(common + ["--device", "cpu", "--out", out])
    for key in ("fp_size_mb", "int8_size_mb", "compression"):
        assert got[key] == want[key], key
    assert abs(got["mean_abs_rel_error"] - want["mean_abs_rel_error"]) <= \
        1e-4 * want["mean_abs_rel_error"]
    assert abs(got["sample_latent_rel_l2"] - want["sample_latent_rel_l2"]) <= \
        1e-3 * want["sample_latent_rel_l2"]
    back, (mem, _) = tqd.load_int8(out), tq.quantize_params(dict(tm.named_parameters()))
    for k, v in mem.items():
        if isinstance(v, dict):
            np.testing.assert_array_equal(back[k]["values"].numpy(), v["values"].numpy())

"""The port's stdlib msgpack codec against flax's serialization, and the
JAX package's legacy ``.msgpack`` checkpoints read by the port: which file
a resume takes (the JAX tie rule), and a DiT train-state resume, a
``train_vavae`` stage resume and a sampling load, each equal to the JAX
package's restore of the same file, bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_common import one_thread, randomize  # noqa: F401
from test_torch_train_vavae import DDCONFIG, tiny_cfg
from vavae_tpu.train import checkpoint as jckpt
from vavae_tpu_torch.train import checkpoint as tckpt
from vavae_tpu_torch.utils import msgpack_io

pytestmark = pytest.mark.usefixtures("one_thread")


def _tree(rs):
    return {
        "params": {"w": rs.standard_normal((3, 5)).astype(np.float32),
                   "b16": np.asarray(jnp.asarray(rs.standard_normal(7), jnp.bfloat16)),
                   "i": rs.integers(-9, 9, (4,)).astype(np.int64),
                   "u8": rs.integers(0, 255, (2, 2)).astype(np.uint8),
                   "flag": np.asarray([True, False])},
        "step": np.asarray(12, np.int32),
        "scalar": np.float32(2.5),
        "py": {"int": -40, "big": 70000, "float": 1.25, "str": "x" * 40, "none": None,
               "complex": complex(1.0, -2.0), "bool": True},
        "empty": {},
        "many": {str(i): np.arange(i, dtype=np.float32) for i in range(18)},
    }


def _port_view(tree):
    """The tree as the port holds it: bf16 as ``Bf16Bits``."""
    if isinstance(tree, dict):
        return {k: _port_view(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return tree.view(np.uint16).view(msgpack_io.Bf16Bits)
    return tree


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


def test_encoder_writes_flax_bytes():
    """Byte for byte flax's ``msgpack_serialize``: sorted keys, bf16, numpy
    and Python scalars, None, complex, empty dicts, maps of more than 15."""
    tree = _tree(np.random.default_rng(0))
    assert msgpack_io.encode(_port_view(tree)) == serialization.msgpack_serialize(tree)


def test_decoder_reads_flax_bytes():
    tree = _tree(np.random.default_rng(1))
    got = msgpack_io.decode(serialization.msgpack_serialize(tree))
    assert isinstance(got["params"]["b16"], msgpack_io.Bf16Bits)
    np.testing.assert_array_equal(msgpack_io.widen(got["params"]["b16"]),
                                  np.asarray(tree["params"]["b16"], np.float32))
    _assert_same(got, _port_view(tree))
    # and flax reads the port's bytes back to the same tree
    _assert_same(serialization.msgpack_restore(msgpack_io.encode(_port_view(tree))), tree)


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE travel as chunk dicts (12 chunks here, so
    the chunk maps keep their index order, not sorted order)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    rs = np.random.default_rng(2)
    tree = {"w": rs.standard_normal((12, 16)).astype(np.float32),
            "h": np.asarray(jnp.asarray(rs.standard_normal((9, 8)), jnp.bfloat16)),
            "small": np.ones(3, np.float32)}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert msgpack_io.encode(_port_view(tree)) == flax_bytes
    _assert_same(msgpack_io.decode(flax_bytes), _port_view(tree))


def test_decoder_rejects_trailing_and_truncated_bytes():
    data = serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="trailing"):
        msgpack_io.decode(data + b"\xc0")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.decode(data[:-2])


# -- which file a resume takes (ROADMAP F3) ------------------------------------------


@pytest.mark.parametrize("files,want", [
    (["0000100.msgpack", "0000050.safetensors"], "0000100.msgpack"),
    (["0000100.msgpack"], "0000100.msgpack"),
    (["0000100.msgpack", "0000100.safetensors", "0000050.msgpack"], "0000100.safetensors"),
    (["0000007.safetensors", "config.json", "best"], "0000007.safetensors"),
])
def test_latest_checkpoint_follows_jax(tmp_path, files, want):
    for name in files:
        (tmp_path / name).touch()
    got = tckpt.latest_checkpoint(str(tmp_path))
    assert got == jckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / want)


# -- restores of JAX-written msgpack states ---------------------------------------------


def _dit_trainers(grad_accum=1):
    from test_torch_common import tiny_dit_pair
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.dit_trainer import DiTTrainer as JaxTrainer
    from vavae_tpu.transport import create_transport as jax_transport
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport import create_transport

    jm, params, tm = tiny_dit_pair(0)
    jt = JaxTrainer(jm, jax_transport("Linear", "velocity"),
                    make_mesh(devices=jax.devices("cpu")[:1]), max_grad_norm=1.0,
                    grad_accum=grad_accum, adam_mu_dtype="bfloat16" if grad_accum > 1 else None)
    tt = DiTTrainer(tm, create_transport("Linear", "velocity"), max_grad_norm=1.0,
                    grad_accum=grad_accum, adam_mu_dtype="bfloat16" if grad_accum > 1 else None)
    return jm, params, jt, tt


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_dit_train_state_resume_from_jax_msgpack(tmp_path, grad_accum):
    """``do_train``'s resume path: a JAX DiT TrainState (AdamW behind
    clip_by_global_norm; with MultiSteps and a bf16 first moment) written
    as legacy msgpack restores into the port equal to the JAX restore."""
    jm, params, jt, tt = _dit_trainers(grad_accum)
    shapes = jax.eval_shape(lambda: jt.init_state(jax.random.PRNGKey(0), (1, 8, 8, 4)))
    js = randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 3)
    js = jax.tree_util.tree_map(lambda a, s: np.asarray(jnp.asarray(a, s.dtype)), js, shapes)
    js = js.replace(step=np.asarray(100, np.int32))
    if grad_accum > 1:
        js = js.replace(opt_state=js.opt_state._replace(mini_step=np.asarray(1, np.int32)))
    path = tmp_path / "0000100.msgpack"
    path.write_bytes(serialization.to_bytes(js))
    (tmp_path / "0000050.safetensors").touch()
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest == str(path)
    with pytest.warns(UserWarning, match="split-half RoPE"):
        want = jckpt.restore_checkpoint(latest, js)
    state = tt.init_state()
    with pytest.warns(UserWarning, match="split-half RoPE"):
        tckpt.restore_checkpoint(latest, state)
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    for tree, got in ((want.params, state.params), (want.ema_params, state.ema_params)):
        sd = dit_state_from_jax(jax.device_get(tree))
        for name, t in zip(state.names, got):
            assert torch.equal(t, sd[name]), name
    adam = tckpt.find_adam(serialization.to_state_dict(want.opt_state))
    for group, got in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        sd = dit_state_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), adam[group]))
        for name, t in zip(state.names, got):
            assert torch.equal(t.float(), sd[name]), (group, name)
    assert state.opt.count == int(adam["count"]) and state.step == 100
    if grad_accum > 1:
        assert state.mini_step == 1
        sd = dit_state_from_jax(jax.device_get(want.opt_state.acc_grads))
        for name, t in zip(state.names, state.acc_grads):
            assert torch.equal(t, sd[name])


def test_sampling_load_from_jax_msgpack(tmp_path):
    """``load_dit_params`` on a legacy msgpack: the EMA weights JAX's
    ``load_dit_params`` returns, bit for bit; ``weight_init`` reads its
    ``params``."""
    import logging

    from vavae_tpu.pipelines.sample import load_dit_params as jax_load
    from vavae_tpu_torch.pipelines.sample import load_dit_params
    from vavae_tpu_torch.pipelines.train_dit import load_weight_init
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    jm, params, jt, tt = _dit_trainers()
    ema = randomize(params, 7)
    state = {"step": np.asarray(3, np.int32), "params": params, "ema_params": ema,
             "opt_state": None}
    path = str(tmp_path / "0000003.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(state))
    with pytest.warns(UserWarning, match="split-half RoPE"):
        want = dit_state_from_jax(jax.device_get(jax_load(None, jm, path)))
    with pytest.warns(UserWarning, match="split-half RoPE"):
        load_dit_params(tt.model, path)
    for name, t in tt.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    fresh = tt.init_state()
    with pytest.warns(UserWarning, match="split-half RoPE"):
        load_weight_init(path, fresh, tt.model, logging.getLogger("t"))
    raw = dit_state_from_jax(params)
    for name, t in zip(fresh.names, fresh.params):
        assert torch.equal(t, raw[name])


def test_vavae_stage_resume_from_jax_msgpack(tmp_path):
    """``train_vavae.run_stages`` on a stage directory holding a JAX
    VAETrainState as legacy msgpack: it counts the file, restores it (equal
    to the JAX restore) and chains on."""
    from vavae_tpu.models.vae import AutoencoderKL as JaxVAE
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.vae_trainer import VAETrainer as JaxTrainer
    from vavae_tpu_torch.pipelines import train_vavae as tv
    from vavae_tpu_torch.utils.safetensors_io import flatten

    vae = JaxVAE(embed_dim=4, ch=DDCONFIG["ch"], ch_mult=tuple(DDCONFIG["ch_mult"]),
                 resolution=32, num_res_blocks=1, attn_resolutions=(), z_channels=4)
    jt = JaxTrainer(vae, make_mesh(devices=jax.devices("cpu")[:1]), use_vf=False,
                    frozen_bf16=False)
    shapes = jax.eval_shape(lambda: jt.init_state(jax.random.PRNGKey(0)))
    js = randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 4)
    js = jax.tree_util.tree_map(lambda a, s: np.asarray(a, s.dtype), js, shapes)
    js = js.replace(step=np.asarray(6, np.int32),
                    disc_batch_stats=jax.tree_util.tree_map(np.abs, js.disc_batch_stats))
    stage = tmp_path / "out" / "stage1"
    os.makedirs(stage)
    (stage / "0000006.msgpack").write_bytes(serialization.to_bytes(js))
    json.dump({"epochs_done": 1}, open(stage / "epoch.json", "w"))
    with pytest.warns(UserWarning, match="split-half RoPE"):
        want = jckpt.restore_checkpoint(str(stage / "0000006.msgpack"), js)
    with pytest.warns(UserWarning, match="split-half RoPE"):
        state = tv.run_stages(tiny_cfg(), dataset=None, stages=[{"epochs": 1}],
                              output_dir=str(tmp_path / "out"), batch_size=4, device="cpu")
    got, _ = tckpt.vae_state_tensors(state)
    ref = flatten(jax.tree_util.tree_map(np.asarray, {
        "step": want.step, "gen_params": want.gen_params, "disc_params": want.disc_params,
        "disc_batch_stats": want.disc_batch_stats,
        "gen_opt": {"0": want.gen_opt[0]._asdict()}, "disc_opt": {"0": want.disc_opt[0]._asdict()}}))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

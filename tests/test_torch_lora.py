"""LoRA finetuning of the port against the JAX package, on the CPU in fp32:
the adapter targets and the merge (1e-6 max-abs), LoRA files read across the
two packages (both tree layouts), ``LoRATrainer`` steps from the JAX state
with the JAX draws (adapters, EMA and Adam moments within 1e-4 relative;
``alpha`` and the base weights untouched), and ``lora_finetune`` end to end
from a JAX-layout ``.msgpack`` base, whose merged export samples the JAX
package's latents from the same weights and noise (1e-4 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_common import max_rel, one_thread, tiny_dit_pair  # noqa: F401
from test_torch_train import _frob_rel, _jax_draws, create_jax_transport
from vavae_tpu.train import lora as jlora
from vavae_tpu_torch.train import lora as tlora
from vavae_tpu_torch.utils.weights import dit_state_from_jax

pytestmark = pytest.mark.usefixtures("one_thread")

RANK, ALPHA = 4, 8.0


def _jax_lora(params, seed=1, b_scale=0.05):
    """JAX adapters with B moved off zero (so the merge is not the base)."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), params, RANK, ALPHA)
    rs = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (b_scale * rs.standard_normal(np.shape(x))).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x), lora)


def _unstacked(tree):
    """The scan-stacked JAX tree in the ``block_{i}`` layout."""
    stacked = tree["blocks"]["block"]
    depth = next(iter(jax.tree_util.tree_leaves(stacked))).shape[0]
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for i in range(depth):
        out[f"block_{i}"] = jax.tree_util.tree_map_with_path(
            lambda p, x: x if p[-1].key == "alpha" else x[i], stacked)
    return out


def test_targets_and_merge_match_jax():
    _, params, tm = tiny_dit_pair(0)
    jl = _jax_lora(params)
    lora = tlora.lora_from_jax(jl)
    base = dict(tm.named_parameters())
    assert sorted(lora) == sorted(n for n in base if tlora.is_target(n))
    assert "x_embedder.proj.weight" in lora and "blocks.1.mlp.w3.weight" in lora
    assert tlora.lora_size(lora) == jlora.lora_size(jl)
    want = dit_state_from_jax(jax.device_get(jlora.merge_lora(params, jl, RANK)))
    got = tlora.merge_lora(base, lora, RANK)
    for name in base:
        w = want[name].numpy()
        g = (got[name] if name in got else base[name]).detach().numpy()
        assert np.abs(g - w).max() <= 1e-6, name
    assert max(np.abs(got[n].detach().numpy() - base[n].detach().numpy()).max() for n in got) > 1e-3


def test_lora_files_cross_packages(tmp_path):
    """The port's file restores in the JAX ``load_lora`` into the JAX tree;
    JAX's file (scan-stacked, and with unstacked blocks) reads in the port
    to the same adapters; a port round trip is bit-exact."""
    _, params, _ = tiny_dit_pair(0)
    jl = _jax_lora(params)
    lora = tlora.lora_from_jax(jl)
    path = str(tmp_path / "port.msgpack")
    tlora.save_lora(path, lora)
    back = jlora.load_lora(path, jax.tree_util.tree_map(np.zeros_like, jl))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), back, jl)
    for tree, name in ((jl, "jax.msgpack"), (_unstacked(jl), "jax_blocks.msgpack")):
        jpath = str(tmp_path / name)
        jlora.save_lora(jpath, tree)
        got = tlora.load_lora(jpath)
        assert sorted(got) == sorted(lora)
        for n in lora:
            for k in ("a", "b", "alpha"):
                assert torch.equal(got[n][k], lora[n][k]), (name, n, k)
    again = tlora.load_lora(path)
    tlora.save_lora(str(tmp_path / "again.msgpack"), again)
    assert (tmp_path / "again.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()


def _with_alpha(tree):
    """A masked moment tree (``alpha`` an empty node) with alpha 0 filled in."""
    if isinstance(tree, dict) and "a" in tree:
        return {"a": tree["a"], "b": tree["b"], "alpha": np.zeros((), np.float32)}
    return {k: _with_alpha(v) for k, v in tree.items()}


def _batch(seed: int, B: int = 4):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((B, 8, 8, 4)).astype(np.float32),
            rs.integers(0, 10, (B,)).astype(np.int32))


@pytest.mark.parametrize("max_grad_norm", [None, 1e-3])
def test_trainer_steps_match_jax(max_grad_norm):
    """Two steps from the JAX state with the JAX draws (label dropout off:
    flax's stream cannot be replayed). The 1e-3 clip bites on both steps."""
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.lora_trainer import LoRATrainer as JaxTrainer
    from vavae_tpu.train.lora_trainer import LoRAState
    from vavae_tpu_torch.train.checkpoint import find_adam
    from vavae_tpu_torch.train.lora_trainer import LoRATrainer
    from vavae_tpu_torch.transport import create_transport

    jm, params, tm = tiny_dit_pair(seed=2, class_dropout_prob=0.0)
    kw = dict(use_lognorm=True, use_cosine_loss=True)
    opt = dict(rank=RANK, alpha=ALPHA, lr=1e-2, weight_decay=0.01, ema_decay=0.9,
               max_grad_norm=max_grad_norm)
    jtr = create_jax_transport(**kw)
    jt = JaxTrainer(jm, jtr, make_mesh(devices=jax.devices("cpu")[:1]), **opt)
    jl = _jax_lora(params, b_scale=0.0)
    jstate = jt.replicate(LoRAState(step=jnp.zeros((), jnp.int32), lora=jl,
                                    ema_lora=jax.tree_util.tree_map(jnp.copy, jl),
                                    opt_state=jt.tx.init(jl)))
    base = jt.replicate(params)
    pt = LoRATrainer(tm, create_transport(**kw), **opt)
    state = pt.init_state()
    for n, ad in tlora.lora_from_jax(jl).items():
        for k in ad:
            state.lora[n][k].copy_(ad[k])
            state.ema_lora[n][k].copy_(ad[k])
    base_before = {k: v.clone() for k, v in tm.state_dict().items()}
    rng = jax.random.PRNGKey(3)
    for step in range(2):
        x, y = _batch(20 + step)
        t, x0 = _jax_draws(jtr, jax.random.fold_in(rng, step), x.shape)
        jstate, jmetrics = jt.train_step(jstate, base, rng, jt.shard_batch((x, y)))
        m = pt.train_step(state, (x, y), draws=(np.array(t), np.array(x0),
                                                torch.zeros(len(y), dtype=torch.long)))
        assert max_rel(m["loss"].item(), float(jmetrics["loss"])) < 1e-5, step
    host = jax.device_get(jstate)
    adam = find_adam(serialization.to_state_dict(host.opt_state))
    order = list(state.lora)
    for got, tree in ((state.lora, host.lora), (state.ema_lora, host.ema_lora)):
        want = tlora.lora_from_jax(tree)
        g = [got[n][k].numpy() for n in order for k in ("a", "b", "alpha")]
        w = [want[n][k].numpy() for n in order for k in ("a", "b", "alpha")]
        assert _frob_rel(g, w) < 1e-4
    for moments, tree in ((state.opt.mu, adam["mu"]), (state.opt.nu, adam["nu"])):
        want = tlora.lora_from_jax(_with_alpha(tree))
        g = [t.numpy() for t in moments]
        w = [want[n][k].numpy() for n in order for k in ("a", "b")]
        assert _frob_rel(g, w) < 1e-4
    assert state.opt.count == int(adam["count"]) == 2
    for n in order:
        assert state.lora[n]["alpha"].item() == ALPHA == float(np.asarray(
            host.lora["blocks"]["block"]["attn"]["qkv"]["kernel"]["alpha"]))
        assert state.lora[n]["b"].abs().max() > 0
    for k, v in tm.state_dict().items():
        assert torch.equal(v, base_before[k]), k


def test_lora_finetune_end_to_end(tmp_path, monkeypatch):
    """``lora_finetune.main`` on the CPU from a JAX-layout msgpack base: the
    LoRA file holds the EMA adapters (JAX's ``load_lora`` reads it), the
    merged export loads in both packages' samplers, and sampling from it
    with the same noise gives the JAX package's latents."""
    import yaml

    from test_torch_pipelines import _write_shards
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.pipelines.sample import load_dit_params as jax_load
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.apps import lora_finetune
    from vavae_tpu_torch.models import dit
    from vavae_tpu_torch.pipelines.sample import build_sample_fn, load_dit_params
    from vavae_tpu_torch.utils.config import Config

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    jm, params, tm = tiny_dit_pair(seed=6)
    base = tmp_path / "base.msgpack"
    base.write_bytes(serialization.msgpack_serialize(
        {"step": np.asarray(9, np.int32), "params": params, "ema_params": params,
         "opt_state": None}))
    _write_shards(str(tmp_path / "latents"), sizes=(12,), C=4, S=8)
    cfg = {"data": {"data_path": str(tmp_path / "latents"), "image_size": 128,
                    "num_classes": 10, "latent_norm": False, "latent_multiplier": 1.0},
           "vae": {"downsample_ratio": 16},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4, "class_dropout_prob": 0.1},
           "transport": {"path_type": "Linear", "prediction": "velocity",
                         "use_lognorm": True, "use_cosine_loss": True},
           "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 4,
                      "cfg_scale": 4.0, "timestep_shift": 0.3},
           "optimizer": {"max_grad_norm": 1.0},
           "train": {"global_seed": 0, "log_every": 1}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out"
    with pytest.warns(UserWarning, match="split-half RoPE"):
        res = lora_finetune.main(["--config", str(tmp_path / "cfg.yaml"), "--base_ckpt", str(base),
                                  "--rank", "4", "--alpha", "8", "--steps", "2", "--lr", "1e-2",
                                  "--batch_size", "4", "--out_dir", str(out), "--export_merged",
                                  "--device", "cpu"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    state = res["state"]
    jl = jlora.load_lora(res["lora_path"], jlora.init_lora(jax.random.PRNGKey(0), params, 4, 8.0))
    ema = tlora.lora_to_jax(state.ema_lora)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jl, ema)
    assert res["merged_path"] == str(out / "0000002.safetensors")

    merged = res["trainer"].merged_params(state)
    load_dit_params(tm, res["merged_path"])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, merged[k]), k
    jparams = jax_load(None, jm, res["merged_path"])
    rng = jax.random.PRNGKey(5)
    labels = np.array([1, 7], np.int32)
    want = np.asarray(jax_build_sample_fn(JaxConfig(cfg), jm, jparams)(rng, jnp.asarray(labels)))
    _, z_rng = jax.random.split(rng)
    z = np.array(jax.random.normal(z_rng, (2, 8, 8, 4), jnp.float32))
    got = build_sample_fn(Config(cfg), tm.eval(), device="cpu")(labels, z=z).numpy()
    assert max_rel(got, want) < 1e-4


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_adapter_gradients_under_remat(policy):
    """With per-block remat (the production config's ``use_checkpoint``),
    the backward runs each block's forward again; it must see the merged
    weights too: the adapter gradients equal those without remat."""
    from vavae_tpu_torch.train.lora_trainer import LoRATrainer
    from vavae_tpu_torch.transport import create_transport

    _, params, tm = tiny_dit_pair(seed=3, class_dropout_prob=0.0)
    pt = LoRATrainer(tm, create_transport(use_cosine_loss=True), rank=RANK, alpha=ALPHA)
    state = pt.init_state()
    with torch.no_grad():
        for ad in state.lora.values():
            ad["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    x, y = (torch.from_numpy(a) for a in _batch(7))
    gen = torch.Generator().manual_seed(2)
    t, x0 = torch.rand(len(y), generator=gen), torch.randn(x.shape, generator=gen)
    drop = torch.zeros(len(y), dtype=torch.long)
    want = pt.loss_and_grads(state.lora, x, y.long(), t, x0, drop)[2]
    tm.use_checkpoint, tm.checkpoint_policy = True, policy
    got = pt.loss_and_grads(state.lora, x, y.long(), t, x0, drop)[2]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-9)
    assert max(g.abs().max().item() for g in got) > 0

"""Iterative self-training of the port against the JAX package
(``vavae_tpu/apps/iterative_finetune.py``).

- The JAX package's stub test (``tests/test_apps.py::
  test_iterative_training_injects_synthetic``), on the port.
- A real small case: the tiny DiT, the tiny VA-VAE (16 px), a tiny ResNet
  classifier (biased towards users 0 and 1, so both accept), 2 rounds × 2
  steps at batch 4, confidence 0, euler-3 sampling without CFG (with label
  dropout off the DiT has no null-class row), the same weights in both
  packages. The
  port is fed JAX's draws: the sampler's initial noise (recorded from each
  JAX sampling call's key) and the trainer's t and x0 (``fold_in`` of the
  round's key and the step); label dropout is off (it cannot be replayed).
  Both encode to the posterior mode (torch cannot replay JAX's posterior
  draw). Held: the accepted counts exactly; the decoded images equal but
  for one uint8 level in at most 0.5% of the values (3 of 3,072 measured),
  the encoder on the same images to 1e-5 (7e-7 measured), so the injected
  latents to 2e-3 of their largest element (7.8e-4 measured, from those
  pixels); the final losses to 1e-4 relative, and the weights and EMA after the
  four steps as ``test_torch_train.py`` holds three trainer steps (1e-4
  relative Frobenius, 2·lr a step per element).
- ``main`` end to end on the CPU (a tiny config with ``latent_norm``, a
  classifier file, latent shards), whose saved state restores.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import one_thread, randomize, tiny_dit_pair, tiny_vae_pair  # noqa: F401
from vavae_tpu.apps import iterative_finetune as jit_
from vavae_tpu_torch.apps import iterative_finetune as tit
from vavae_tpu_torch.utils.safetensors_io import write_safetensors

pytestmark = pytest.mark.usefixtures("one_thread")


def test_iterative_training_injects_synthetic():
    """Accepted samples are re-encoded and mixed into the training set; each
    round re-keys the data shuffle with its index."""
    rng_np = np.random.default_rng(0)
    calls = {"steps": 0, "extra": []}

    class State:
        step = 0

    class StubTrainer:
        def train_step(self, state, batch):
            calls["steps"] += 1
            state.step += 1
            return {"loss": torch.tensor(0.5)}

    def decode_fn(latents):
        return rng_np.integers(30, 220, size=(len(latents), 8, 8, 3)).astype(np.uint8)

    def classifier_fn(x):
        probs = np.zeros((len(x), 2), np.float32)
        probs[:, 1] = 0.99
        probs[:, 0] = 0.01
        return probs

    def real_batches_fn(extra_z, extra_y, iteration):
        calls["extra"].append(None if extra_z is None else len(extra_z))
        calls.setdefault("iters", []).append(iteration)
        while True:
            yield np.zeros((4, 2, 2, 4), np.float32), np.zeros((4,), np.int32)

    it = tit.IterativeTraining(
        trainer=StubTrainer(),
        generate_fn_builder=lambda s: lambda gen, labels: torch.zeros((len(labels), 2, 2, 4)),
        decode_fn=decode_fn, encode_fn=lambda x: np.zeros((len(x), 2, 2, 4), np.float32),
        classifier_fn=classifier_fn, num_users=2, iterations=2, steps_per_iteration=3,
        samples_per_user=8, confidence=0.9, device="cpu",
    )
    state, history = it.run(State(), real_batches_fn)
    assert state.step == 6 and calls["steps"] == 6
    # user 1 accepted 8 each round, user 0 none → 8 synthetic latents injected
    assert calls["extra"] == [8, 8]
    assert calls["iters"] == [0, 1]
    assert [h["accepted"] for h in history] == [8, 8]
    assert all(np.isfinite(h["final_loss"]) for h in history)


def write_shards(root, n=8, seed=0, size=8, channels=4, classes=10):
    rs = np.random.default_rng(seed)
    lat = rs.standard_normal((n, channels, size, size)).astype(np.float32)
    write_safetensors(str(root / "latents_rank00_shard000.safetensors"), {
        "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
        "labels": rs.integers(0, classes, (n,)).astype(np.int32)})


SAMPLE = {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 3, "cfg_scale": 4.0,
          "cfg_interval_start": 0.11, "timestep_shift": 0.3}
MULT = 0.18215
OPT = dict(lr=1e-3, ema_decay=0.9)


def _classifier_pair():
    """A tiny ResNet (one block a stage) with the same weights in both
    packages, its head biased towards classes 0 and 1."""
    from vavae_tpu.models import resnet as jres
    from vavae_tpu_torch.models import resnet as tres
    from vavae_tpu_torch.utils.weights import resnet_state_from_jax

    jm = jres.ResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1))
    v = jax.device_get(jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 16, 16, 3))))
    v = {"params": randomize(v["params"], 2), "batch_stats": v["batch_stats"]}
    v["params"]["fc"]["bias"][:2] += 4.0
    tm = tres.ResNet18(10, stage_sizes=(1, 1, 1, 1))
    tm.load_state_dict(resnet_state_from_jax(v), strict=True)
    tm.eval()

    def jax_fn(x):
        return np.asarray(jax.nn.softmax(jm.apply(v, jnp.asarray(x), train=False)))

    @torch.no_grad()
    def port_fn(x):
        return torch.softmax(tm(torch.as_tensor(np.asarray(x))), -1).numpy()

    return jax_fn, port_fn


def test_two_rounds_match_jax(tmp_path):
    from test_torch_train import _frob_rel, _jax_draws, create_jax_transport
    from vavae_tpu.data.latent_dataset import ImgLatentDataset as JaxDataset
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.pipelines.sample import build_sample_fn as jax_build_sample_fn
    from vavae_tpu.train.dit_trainer import DiTTrainer as JaxTrainer
    from vavae_tpu.train.dit_trainer import TrainState as JaxState
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport import create_transport
    from vavae_tpu_torch.utils.config import Config
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    write_shards(tmp_path)
    jm, params, tm = tiny_dit_pair(seed=6, class_dropout_prob=0.0)
    jv, tv = tiny_vae_pair(tmp_path, seed=2)
    jclf, tclf = _classifier_pair()
    # no CFG here: without label dropout the DiT has no null-class row
    cfg = {"data": {"image_size": 16, "num_classes": 10}, "vae": {"downsample_ratio": 2},
           "transport": {"path_type": "Linear", "prediction": "velocity"},
           "sample": {**SAMPLE, "cfg_scale": 1.0}}
    run_kw = dict(num_users=2, iterations=2, steps_per_iteration=2, samples_per_user=4,
                  confidence=0.0, batch_size=4, max_batches_per_user=2)

    # -- JAX, as its main wires it (one CPU device) ----------------------------------------
    jtr = create_jax_transport()
    jt = JaxTrainer(jm, jtr, make_mesh(devices=jax.devices("cpu")[:1]), **OPT)
    jstate = jt.replicate(JaxState(step=jnp.zeros((), jnp.int32), params=params,
                                   ema_params=jax.tree_util.tree_map(jnp.copy, params),
                                   opt_state=jt.tx.init(params)))
    jdata = JaxDataset(str(tmp_path), latent_norm=False, latent_multiplier=MULT)
    base = jax_build_sample_fn(JaxConfig(cfg), jm, params, latent_stats=jdata.latent_stats)
    noise, extras, images = [], {"jax": [], "port": []}, {"jax": [], "port": []}

    def encode_mode(vae, side, x):
        """The posterior mode, times the multiplier; the images recorded."""
        images[side].append(x)
        return np.asarray(vae.encode_moments(x).mean) * MULT

    def jax_generate_builder(st):
        def generate(rng, labels):
            noise.append(np.asarray(jax.random.normal(jax.random.split(rng)[1],
                                                      (len(labels), 8, 8, 4))))
            return base.jit_fn(st.ema_params, rng, labels)
        return generate

    def jax_batches(extra_z, extra_y, iteration):  # the closure of the JAX main
        extras["jax"].append(extra_z)
        order = None if extra_z is None else np.random.default_rng(iteration).permutation(
            len(extra_z))
        ei = 0
        for lats, labels in jdata.batches(4, seed=iteration, process_index=0, process_count=1):
            yield lats, labels
            if order is not None and ei < len(order):
                ez, ey = extra_z[order][ei:ei + 4], extra_y[order][ei:ei + 4]
                ei += len(ez)
                if len(ez) == 4:
                    yield ez.astype(np.float32), ey.astype(np.int32)

    jrun = jit_.IterativeTraining(
        trainer=jt, generate_fn_builder=jax_generate_builder, decode_fn=jv.decode_to_images,
        encode_fn=lambda x: encode_mode(jv, "jax", x),
        classifier_fn=jclf, **run_kw)
    jstate, jhist = jrun.run(jstate, jax_batches)

    # -- the port, fed the JAX draws ------------------------------------------------------
    trainer = DiTTrainer(tm, create_transport(), **OPT)
    state = trainer.init_state()
    sample_model = __import__("copy").deepcopy(tm)
    generate = build_sample_fn(Config(cfg), sample_model, latent_stats=jdata.latent_stats,
                               device="cpu")
    calls = iter(noise)

    def port_generate_builder(st):
        with torch.no_grad():
            torch._foreach_copy_(list(sample_model.parameters()), st.ema_params)
        return lambda gen, labels: generate(labels, z=next(calls))

    class JaxDraws:
        def train_step(self, st, batch):
            rng = jax.random.fold_in(jax.random.PRNGKey(0), st.step // 2)
            t, x0 = _jax_draws(jtr, jax.random.fold_in(rng, st.step), batch[0].shape)
            return trainer.train_step(st, batch, draws=(t, x0, None))

    data = ImgLatentDataset(str(tmp_path), latent_norm=False, latent_multiplier=MULT)

    def port_batches(extra_z, extra_y, iteration):
        extras["port"].append(extra_z)
        return tit.interleaved_batches(data, 4, extra_z, extra_y, iteration)

    prun = tit.IterativeTraining(
        trainer=JaxDraws(), generate_fn_builder=port_generate_builder,
        decode_fn=tv.decode_to_images,
        encode_fn=lambda x: encode_mode(tv, "port", x),
        classifier_fn=tclf, device="cpu", **run_kw)
    state, hist = prun.run(state, port_batches)

    assert next(calls, None) is None
    assert [h["accepted"] for h in hist] == [h["accepted"] for h in jhist]
    assert all(h["accepted"] > 0 for h in hist)
    for g, w in zip(images["port"], images["jax"]):
        # the decodes round to the same uint8 but for a value or few
        assert g.shape == w.shape and np.abs(g - w).max() <= 2 / 255 + 1e-6
        assert (g != w).mean() <= 5e-3
        enc = tv.encode_moments(w).mean.numpy()
        assert np.abs(enc - np.asarray(jv.encode_moments(w).mean)).max() <= 1e-5 * np.abs(enc).max()
    for g, w in zip(extras["port"], extras["jax"]):
        assert g.shape == w.shape and np.abs(g - w).max() <= 2e-3 * np.abs(w).max()
    for g, w in zip(hist, jhist):
        assert abs(g["final_loss"] - w["final_loss"]) <= 1e-4 * abs(w["final_loss"])
    assert state.step == 4 == int(jstate.step)
    for got, want in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        want = dit_state_from_jax(jax.device_get(want))
        g = [t.detach().numpy() for t in got]
        w = [want[n].numpy() for n in state.names]
        assert _frob_rel(g, w) < 1e-4
        assert max(np.abs(a - b).max() for a, b in zip(g, w)) <= 4 * 2 * OPT["lr"]


def test_main_end_to_end(tmp_path, monkeypatch):
    """``main`` on the CPU: a tiny DiT checkpoint, the tiny VA-VAE, a baseline
    classifier file of ``data.num_classes`` classes, latent shards with
    ``latent_norm``; 2 rounds × 2 steps, confidence 0; the saved train state
    restores into a fresh one equal."""
    import yaml

    from test_torch_common import tiny_vae_config
    from vavae_tpu_torch.apps.lora_finetune import export_merged
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, save_classifier
    from vavae_tpu_torch.models import dit
    from vavae_tpu_torch.train.checkpoint import restore_checkpoint
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport import create_transport

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    _, _, tm = tiny_dit_pair(seed=3)
    ckpt = export_merged(str(tmp_path), 5, tm.state_dict())
    (tmp_path / "lat").mkdir()
    write_shards(tmp_path / "lat", n=8, seed=1)
    clf = ClassifierTrainer(num_classes=10, device="cpu")
    clf_path = save_classifier(str(tmp_path / "clf.safetensors"), clf, clf.init_state(0))
    cfg = {"ckpt_path": ckpt,
           "data": {"image_size": 16, "num_classes": 10, "num_users": 2, "latent_norm": True,
                    "data_path": str(tmp_path / "lat")},
           "vae": {"downsample_ratio": 2, "config": tiny_vae_config(tmp_path)},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4},
           "transport": {"path_type": "Linear", "prediction": "velocity"},
           "sample": SAMPLE, "train": {"global_seed": 0}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    state, history, saved = tit.main(
        ["--config", str(path), "--classifier_ckpt", clf_path, "--iterations", "2",
         "--steps_per_iteration", "2", "--samples_per_user", "2", "--confidence", "0",
         "--batch_size", "2", "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert [h["iteration"] for h in history] == [0, 1] and state.step == 4
    assert all(np.isfinite(h["final_loss"]) for h in history)
    assert json.dumps(history)  # plain numbers
    fresh = DiTTrainer(dit.create_dit(cfg["model"] | {}, 8, 10, device="cpu"),
                       create_transport()).init_state()
    back = restore_checkpoint(saved, fresh)
    assert back.step == 4
    for a, b in zip(back.params + back.ema_params, state.params + state.ema_params):
        assert torch.equal(a, b.detach())

"""Classifier-filtered generation of the port against the JAX package: the
rejection loop with the same stub sampler, decoder, classifier and feature
function returns JAX's stats and kept images exactly, for each gate; the
filter metrics; ``num_real_users``; ``run`` end to end on the CPU at a tiny
size (a DiT checkpoint, the tiny VA-VAE, a baseline classifier file); and the
app entry points' refusal to fall back to the CPU."""
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_common import one_thread, tiny_vae_config  # noqa: F401
from vavae_tpu.apps import generate_and_filter as jgf
from vavae_tpu_torch.apps import generate_and_filter as tgf
from vavae_tpu_torch.utils.png import read_png

pytestmark = pytest.mark.usefixtures("one_thread")

GATES = {
    "confidence": dict(),
    "margin": dict(min_margin=0.3),
    "pixel": dict(pixel_range=(60.0, 200.0)),
    "prototype": dict(max_prototype_sim=0.2),
    "diversity": dict(min_diversity=0.9),
    "all": dict(min_margin=0.2, pixel_range=(40.0, 220.0), max_prototype_sim=0.5,
                min_diversity=0.5),
}


class Stubs:
    """Deterministic stand-ins, the same for both packages: the k-th
    generate call gives latents k, whose decode is a fixed random batch
    (some of it flat or dark); the classifier and the features are fixed
    functions of the images."""

    def __init__(self, B=16, K=4, seed=0):
        rs = np.random.default_rng(seed)
        self.images = rs.integers(0, 256, (64, B, 6, 6, 3)).astype(np.uint8)
        self.images[:, ::5] //= 8       # dark: below the pixel band
        self.images[:, 1::7] = 128      # flat: std 0
        self.W = rs.standard_normal((6 * 6 * 3, K)).astype(np.float32) * 0.2
        self.F = rs.standard_normal((6 * 6 * 3, 8)).astype(np.float32)
        self.calls = 0

    def generate(self, rng, labels):
        self.calls += 1
        return np.full((len(labels),), self.calls - 1)

    def decode(self, latents):
        return self.images[int(np.asarray(latents)[0])]

    def classify(self, x):
        z = np.asarray(x, np.float32).reshape(len(x), -1) @ self.W
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def features(self, x):
        return np.asarray(x, np.float32).reshape(len(x), -1) @ self.F


@pytest.mark.parametrize("gate", list(GATES))
def test_filter_loop_matches_jax(gate, tmp_path):
    cfg_kw = dict(confidence_threshold=0.4, target_per_user=12, batch_size=16, max_batches=6,
                  **GATES[gate])
    protos = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    runs = {}
    for name, mod, rng in (("jax", jgf, jax.random.PRNGKey(0)),
                           ("port", tgf, torch.Generator().manual_seed(0))):
        stubs = Stubs()
        runs[name] = mod.generate_and_filter_for_user(
            2, stubs.generate, stubs.decode, stubs.classify, mod.FilterConfig(**cfg_kw), rng,
            feature_fn=stubs.features, prototypes=protos, return_images=True,
            save_dir=str(tmp_path / name) if name == "port" else None)
    want, got = runs["jax"], runs["port"]
    images = got.pop("images")
    np.testing.assert_array_equal(images, want.pop("images"))
    assert got == want
    assert 0 < got["accepted"] and got["batches"] <= 6
    if got["accepted"]:
        files = sorted(os.listdir(tmp_path / "port" / "user_02"))
        assert len(files) == got["accepted"]
        for f, im in zip(files, images):
            np.testing.assert_array_equal(read_png(str(tmp_path / "port" / "user_02" / f)), im)


def test_filter_loop_nothing_accepted_matches_jax():
    cfg = dict(confidence_threshold=0.999, target_per_user=4, batch_size=16, max_batches=2)
    want = jgf.generate_and_filter_for_user(1, *(lambda s: (s.generate, s.decode, s.classify))(
        Stubs()), jgf.FilterConfig(**cfg), jax.random.PRNGKey(0), return_images=True)
    got = tgf.generate_and_filter_for_user(1, *(lambda s: (s.generate, s.decode, s.classify))(
        Stubs()), tgf.FilterConfig(**cfg), None, return_images=True)
    np.testing.assert_array_equal(got.pop("images"), want.pop("images"))
    assert got == want and got["accepted"] == 0


def test_filter_metrics_match_jax():
    rs = np.random.default_rng(0)
    for feats in (np.ones((10, 8), np.float32), rs.standard_normal((10, 8)).astype(np.float32),
                  rs.standard_normal((1, 8)).astype(np.float32)):
        assert tgf.feature_diversity(feats) == jgf.feature_diversity(feats)
    imgs = rs.integers(0, 256, (6, 8, 8, 3)).astype(np.uint8)
    imgs[0], imgs[1] = 0, 128
    np.testing.assert_array_equal(tgf.pixel_sanity(imgs, 5, 250), jgf.pixel_sanity(imgs, 5, 250))


@pytest.mark.parametrize("data,sample", [
    ({"num_classes": 32, "num_users": 31}, {}),
    ({"num_classes": 32}, {"null_class": 31}),
    ({"num_classes": 10}, {}),
])
def test_num_real_users_matches_jax(data, sample):
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu.utils.config import num_real_users as jax_num
    from vavae_tpu_torch.utils.config import Config, num_real_users

    cfg = {"data": data, "sample": sample}
    assert num_real_users(Config(cfg)) == jax_num(JaxConfig(cfg))


def test_run_end_to_end(tmp_path, monkeypatch):
    """``run`` on the CPU: a tiny DiT checkpoint, the tiny VA-VAE (16 px),
    a baseline classifier file of ``data.num_classes`` classes; every user
    gets ``batch_size × max_batches`` samples at confidence 0, and each kept
    image is written as a PNG."""
    import yaml

    from test_torch_common import tiny_dit_pair
    from vavae_tpu_torch.apps.lora_finetune import export_merged
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, save_classifier
    from vavae_tpu_torch.models import dit

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    _, _, tm = tiny_dit_pair(seed=3)
    ckpt = export_merged(str(tmp_path), 5, tm.state_dict())
    clf = ClassifierTrainer(num_classes=10, device="cpu")
    clf_path = save_classifier(str(tmp_path / "clf.safetensors"), clf, clf.init_state(0))
    cfg = {"ckpt_path": ckpt,
           "data": {"image_size": 16, "num_classes": 10, "latent_norm": False},
           "vae": {"downsample_ratio": 2, "config": tiny_vae_config(tmp_path)},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4},
           "transport": {"path_type": "Linear", "prediction": "velocity"},
           "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 3,
                      "cfg_scale": 4.0},
           "train": {"global_seed": 0}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "filtered"
    res = tgf.run(str(path), user_ids=[0, 3],
                  filter_cfg=tgf.FilterConfig(confidence_threshold=0.0, target_per_user=100,
                                              batch_size=2, max_batches=2, pixel_range=None),
                  save_dir=str(out), classifier_ckpt=clf_path, device="cpu")
    for uid in (0, 3):
        st = res[uid]
        assert st["generated"] == 4 and st["batches"] == 2
        assert 0 <= st["accepted"] <= 4
        assert st["acceptance_rate"] == st["accepted"] / 4
        files = sorted(os.listdir(out / f"user_{uid:02d}")) if st["accepted"] else []
        assert len(files) == st["accepted"]
        for f in files:
            assert read_png(str(out / f"user_{uid:02d}" / f)).shape == (16, 16, 3)


def test_app_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """Without a GPU the app CLIs raise unless ``--device cpu`` is passed."""
    from vavae_tpu_torch.apps import classifier_eval, lora_finetune, train_classifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"data": {"image_size": 16, "num_classes": 2}, "train": {}}')
    for main, args in (
        (lora_finetune.main, ["--config", str(cfg), "--base_ckpt", "x.safetensors"]),
        (train_classifier.main, ["--real_dir", str(tmp_path)]),
        (classifier_eval.main, ["--classifier_ckpt", "x", "--split_file", "x"]),
        (tgf.main, ["--config", str(cfg), "--classifier_ckpt", "x"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)

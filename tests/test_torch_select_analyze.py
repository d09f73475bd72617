"""User selection and sample metrics of the port against the JAX package
(``vavae_tpu/apps/select_users.py``, ``apps/analyze_metrics.py``): the
statistics, rankings, cohorts, per-sample metrics, summaries, thresholds
and pass rates exactly equal on seeded probabilities and features; the
generated-tree reader byte-equal to JAX's PIL path on PNGs that need a
BICUBIC resize (RGB, gray, RGBA, palette); and both ``main``s on the CPU on
a tiny split and tree, whose reports equal the JAX functions applied to the
port classifier's outputs."""
import json
import os

import numpy as np
import pytest

from test_torch_common import one_thread  # noqa: F401
from vavae_tpu.apps import analyze_metrics as jam
from vavae_tpu.apps import select_users as jsu
from vavae_tpu_torch.apps import analyze_metrics as tam
from vavae_tpu_torch.apps import select_users as tsu

pytestmark = pytest.mark.usefixtures("one_thread")


def same(a, b) -> bool:
    """Exact equality of nested reports, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


def _probs(n=60, k=7, seed=0):
    rs = np.random.default_rng(seed)
    z = rs.standard_normal((n, k)).astype(np.float32) * 2.0
    labels = rs.integers(0, k, n)
    z[np.arange(n), labels] += rs.uniform(0, 3, n).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True), labels


@pytest.mark.parametrize("strategy", ["best", "worst", "median", "spread"])
def test_select_users_matches_jax(strategy):
    probs, labels = _probs()
    stats = tsu.user_classifier_stats(probs, labels)
    assert same(stats, jsu.user_classifier_stats(probs, labels))
    for key in ("mean_target_prob", "accuracy", "mean_margin"):
        assert tsu.rank_users(stats, key) == jsu.rank_users(stats, key)
    for n, floor in ((3, 0.0), (10, 0.0), (4, 0.3)):
        assert (tsu.select_users(stats, n, strategy, floor)
                == jsu.select_users(stats, n, strategy, floor))
    with pytest.raises(ValueError):
        tsu.select_users(stats, 3, "nearest")


class Stubs:
    def __init__(self, k=5, size=6, seed=1):
        rs = np.random.default_rng(seed)
        self.W = rs.standard_normal((size * size * 3, k)).astype(np.float32) * 0.3
        self.F = rs.standard_normal((size * size * 3, 8)).astype(np.float32)

    def classify(self, x):
        z = np.asarray(x, np.float32).reshape(len(x), -1) @ self.W
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def features(self, x):
        return np.asarray(x, np.float32).reshape(len(x), -1) @ self.F


@pytest.mark.parametrize("protos", [False, True], ids=["plain", "prototypes"])
def test_sample_metrics_match_jax(protos):
    """compute_sample_metrics (batch 16 over 40 images), summary,
    recommended thresholds at two percentiles and the real-vs-generated
    report: exactly JAX's."""
    rs = np.random.default_rng(2)
    stubs = Stubs()
    real = rs.integers(0, 256, (40, 6, 6, 3)).astype(np.uint8)
    gen = rs.integers(30, 220, (33, 6, 6, 3)).astype(np.uint8)
    real_y, gen_y = rs.integers(0, 5, 40), rs.integers(0, 5, 33)
    kw = dict(batch_size=16)
    if protos:
        kw.update(feature_fn=stubs.features,
                  prototypes=rs.standard_normal((5, 8)).astype(np.float32))
    results = {}
    for name, mod in (("jax", jam), ("port", tam)):
        r = mod.compute_sample_metrics(real, real_y, stubs.classify, **kw)
        g = mod.compute_sample_metrics(gen, gen_y, stubs.classify, **kw)
        results[name] = (r, g, r.summary(), mod.recommend_thresholds_from_real(r, 10.0),
                         mod.compare_real_vs_generated(r, g))
    for got, want in zip(results["port"][:2], results["jax"][:2]):
        for col in ("confidence", "margin", "correct", "prototype_sim", "pixel_mean", "pixel_std"):
            a, b = getattr(got, col), getattr(want, col)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), col
    assert same(results["port"][2:], results["jax"][2:])


def _write_tree(root, seed=3):
    """user_XX/NNNNN.png at 20×14 px (RGB, gray, RGBA, palette)."""
    from PIL import Image

    rs = np.random.default_rng(seed)
    for u, mode in ((0, "RGB"), (2, "L"), (5, "RGBA"), (7, "P")):
        d = os.path.join(root, f"user_{u:02d}")
        os.makedirs(d)
        for i in range(2):
            rgb = rs.integers(0, 256, (14, 20, 3)).astype(np.uint8)
            im = Image.fromarray(rgb)
            if mode == "RGBA":
                im = Image.fromarray(np.concatenate(
                    [rgb, rs.integers(0, 256, (14, 20, 1)).astype(np.uint8)], -1), "RGBA")
            elif mode != "RGB":
                im = im.convert(mode)
            im.save(os.path.join(d, f"{i:05d}.png"))


def test_load_image_dir_matches_jax_pil(tmp_path):
    _write_tree(str(tmp_path))
    for size in (16, 24):
        want = jam._load_image_dir(str(tmp_path), size)
        got = tam._load_image_dir(str(tmp_path), size)
        assert got[0].dtype == np.uint8 and got[0].shape == (8, size, size, 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(FileNotFoundError, match="no user_"):
        tam._load_image_dir(str(tmp_path / "user_00"), 16)


def write_split_and_classifier(root, num_classes=8, size=(26, 22)):
    """A split file over ``ID_{u}`` PNG folders (users 0, 2, 5, 7, three
    images each) and a fresh baseline classifier file."""
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, save_classifier
    from vavae_tpu_torch.utils.png import write_pngs

    rs = np.random.default_rng(4)
    entries = []
    for u in (0, 2, 5, 7):
        d = os.path.join(root, "real", f"ID_{u}")
        os.makedirs(d)
        for i in range(3):
            p = os.path.join(d, f"{i}.png")
            write_pngs(rs.integers(0, 256, (1, size[1], size[0], 3)).astype(np.uint8), [p])
            entries.append({"path": p, "user_id": u})
    split = os.path.join(root, "split.json")
    with open(split, "w") as f:
        json.dump({"train": entries, "val": entries}, f)
    clf = ClassifierTrainer(num_classes=num_classes, device="cpu")
    path = save_classifier(os.path.join(root, "clf.safetensors"), clf, clf.init_state(5))
    return split, path


def port_classifier(path, num_classes=8):
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier

    trainer = ClassifierTrainer(num_classes=num_classes, device="cpu")
    state = restore_classifier(path, trainer, trainer.init_state(0))
    return trainer.predict_fn(state), trainer.feature_fn(state)


def test_mains_match_jax_functions(tmp_path):
    """select_users.main and analyze_metrics.main (both report forms) on
    the CPU at 16 px: each report is the JAX functions applied to the port
    classifier's probabilities of the same images."""
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    split, clf = write_split_and_classifier(str(tmp_path))
    _write_tree(str(tmp_path / "gen"))
    predict, _ = port_classifier(clf)
    ds = SplitFileDataset(split, "val", image_size=16)
    x = np.stack([ds[i][0] for i in range(len(ds))])
    y = np.asarray([ds[i][1] for i in range(len(ds))])
    common = ["--classifier_ckpt", clf, "--split_file", split, "--num_classes", "8",
              "--image_size", "16", "--device", "cpu"]

    got = tsu.main(common + ["--n", "3", "--strategy", "spread", "--out",
                             str(tmp_path / "sel.json")])
    stats = jsu.user_classifier_stats(predict(x), y)
    assert same(got, {"selected": jsu.select_users(stats, 3, "spread"), "stats": stats})
    assert json.loads((tmp_path / "sel.json").read_text())["selected"] == got["selected"]

    real_u8 = np.clip((x + 1) * 127.5, 0, 255).astype(np.uint8)
    real = jam.compute_sample_metrics(real_u8, y, predict)
    got = tam.main(common + ["--percentile", "10"])
    assert same(got, {"real": real.summary(),
                      "recommended_thresholds": jam.recommend_thresholds_from_real(real, 10.0)})
    gen_u8, gen_y = jam._load_image_dir(str(tmp_path / "gen"), 16)
    got = tam.main(common + ["--generated_dir", str(tmp_path / "gen"),
                             "--out", str(tmp_path / "report.json")])
    want = jam.compare_real_vs_generated(real, jam.compute_sample_metrics(gen_u8, gen_y, predict))
    assert same(got, want)
    assert same(json.loads((tmp_path / "report.json").read_text()),
                json.loads(json.dumps(want, default=str)))


def test_app_layer_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """Without a GPU every new entry point raises unless ``--device cpu`` is
    passed, before it reads a file."""
    import torch

    from vavae_tpu_torch.apps import (
        domain_adaptation,
        generation_evaluator,
        iterative_finetune,
        quantize_dit,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"data": {"image_size": 16, "num_classes": 2}, "train": {}}')
    for main, args in (
        (quantize_dit.main, ["--config", str(cfg)]),
        (tsu.main, ["--classifier_ckpt", "x", "--split_file", "x"]),
        (tam.main, ["--classifier_ckpt", "x", "--split_file", "x"]),
        (generation_evaluator.main, ["--classifier_ckpt", "x", "--split_file", "x",
                                     "--generated_dir", "x"]),
        (iterative_finetune.main, ["--config", str(cfg), "--classifier_ckpt", "x"]),
        (domain_adaptation.main, ["--classifier_ckpt", "x", "--target_split_file", "x"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)

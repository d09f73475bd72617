"""Few-shot domain adaptation of the port against the JAX package
(``vavae_tpu/apps/domain_adaptation.py``) on a tiny ResNet (one block a
stage, 16 px) and the domain-adaptive classifier, and ``utils/kmeans.py``
against scikit-learn.

Tolerances (relative: max |port − JAX| over max |JAX| per statistic):
  - target batch-norm statistics, each LCCS variant, and the statistics of
    ``lccs_pnc_combined``: ``STAT_TOL``. The JAX package recovers each
    chunk's moments as (new − 0.9·old)/0.1 from its fp32 running-average
    update, which multiplies fp32 rounding by about 10; the port reads the
    moments directly.
  - the domain-adaptive classifier keeps dropout on in its train-mode
    passes, and flax's masks cannot be replayed: everything before the
    dropout (the backbone and ``proj_bn``) is held with dropout at 0.3,
    ``cls_bn`` (after the first dropout) with the rate set to 0.
  - probabilities and features after adaptation: ``PROB_TOL`` max-abs.
  - everything numpy (prototypes, fusions, NCC, ensembles, the splits and
    support selections, the t-test, the grids): exactly equal; the
    k-means of ``select_support("diversity")`` and the ``diversity``
    prototypes on well-separated features, where the clustering is unique.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import one_thread, randomize  # noqa: F401
from vavae_tpu.apps import domain_adaptation as jda
from vavae_tpu.models import resnet as jres
from vavae_tpu_torch.apps import domain_adaptation as tda
from vavae_tpu_torch.models import resnet as tres
from vavae_tpu_torch.utils.safetensors_io import flatten
from vavae_tpu_torch.utils.weights import resnet_state_from_jax, resnet_state_to_jax

pytestmark = pytest.mark.usefixtures("one_thread")

S = 16
STAT_TOL = 1e-4
PROB_TOL = 1e-5


def _variables(module, seed):
    variables = jax.device_get(jax.jit(lambda k: module.init(
        {"params": k}, jnp.zeros((1, S, S, 3)), train=False))(jax.random.PRNGKey(0)))
    rs = np.random.default_rng(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rs.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else 0.1 * rs.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": randomize(variables["params"], seed), "batch_stats": stats}


def _pair(kind, dropout=0.3):
    if kind == "resnet":
        jm, tm = (jres.ResNet18(num_classes=5, stage_sizes=(1, 1, 1, 1)),
                  tres.ResNet18(5, stage_sizes=(1, 1, 1, 1)))
    else:
        jm, tm = (jres.DomainAdaptiveClassifier(num_classes=5, dropout_rate=dropout),
                  tres.DomainAdaptiveClassifier(5, dropout_rate=dropout))
    v = _variables(jm, 3)
    tm.load_state_dict(resnet_state_from_jax(v), strict=True)
    tm.eval()
    return jm, v, tm, {k: v.detach() for k, v in tm.named_parameters()}, tda.model_stats(tm)


@pytest.fixture(scope="module")
def resnet():
    return _pair("resnet")


def _images(n, seed=4):
    return np.random.default_rng(seed).uniform(-1, 1, (n, S, S, 3)).astype(np.float32)


def _rels(got_stats, want_tree) -> dict:
    """Per statistic: max |port − JAX| / max |JAX|, keyed like the JAX tree."""
    got = flatten(resnet_state_to_jax(got_stats)["batch_stats"])
    want = {k: np.asarray(v, np.float64) for k, v in flatten(jax.device_get(want_tree)).items()}
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in want}


@pytest.mark.parametrize("kind,dropout", [("resnet", 0.3), ("domain_adaptive", 0.3),
                                          ("domain_adaptive", 0.0)])
def test_target_bn_stats_match_jax(kind, dropout, resnet):
    """Pooled support statistics over chunks of 8 (8 + 8 + 4 images)."""
    jm, v, tm, params, stats = resnet if kind == "resnet" else _pair(kind, dropout)
    x = _images(20)
    want = jda.compute_target_bn_stats(jm, v["params"], v["batch_stats"], x, batch_size=8)
    got = tda.compute_target_bn_stats(tm, params, stats, x, batch_size=8)
    rels = _rels(got, want)
    if kind == "domain_adaptive" and dropout:
        rels = {k: r for k, r in rels.items() if not k.startswith("cls_bn")}
    elif kind == "domain_adaptive":
        rels = {k: r for k, r in rels.items() if k.startswith("cls_bn")}
    assert rels and max(rels.values()) < STAT_TOL, rels


def test_lccs_variants_match_jax(resnet):
    """The fusion, the adapter (and its restore), the progressive fold, the
    mean shift and the per-layer fusion."""
    jm, v, tm, params, stats = resnet
    x = _images(12, seed=5)
    src = v["batch_stats"]
    want_t = jda.compute_target_bn_stats(jm, v["params"], src, x, batch_size=8)
    got_t = tda.compute_target_bn_stats(tm, params, stats, x, batch_size=8)
    cases = {
        "adapt": (jda.LCCSAdapter(jm, v["params"], src).adapt(x, 0.3),
                  tda.LCCSAdapter(tm, params, stats).adapt(x, 0.3)),
        "fuse": (jda.lccs_fuse_stats(src, want_t, 0.7), tda.lccs_fuse_stats(stats, got_t, 0.7)),
        "per_layer": (jda.lccs_fuse_stats_per_layer(src, want_t, {"layer1": 0.6, "bn1/mean": 0.1}),
                      tda.lccs_fuse_stats_per_layer(stats, got_t, {"layer1": 0.6,
                                                                   "bn1/mean": 0.1})),
        "progressive": (jda.lccs_progressive(jm, v["params"], src, x, momentum=0.2,
                                             iterations=2, batch_size=8),
                        tda.lccs_progressive(tm, params, stats, x, momentum=0.2, iterations=2,
                                             batch_size=8)),
        "mean_shift": (jda.lccs_mean_shift(jm, v["params"], src, x, shift=0.4, batch_size=8),
                       tda.lccs_mean_shift(tm, params, stats, x, shift=0.4, batch_size=8)),
    }
    for name, (want, got) in cases.items():
        rels = _rels(got, want)
        assert max(rels.values()) < STAT_TOL, (name, rels)
    assert tda.LCCSAdapter(tm, params, stats).restore() is stats
    # the source statistics are untouched by every pass
    for k, t in tda.model_stats(tm).items():
        assert torch.equal(t, stats[k])


def _features(n=40, k=4, d=12, seed=0, separated=False):
    rs = np.random.default_rng(seed)
    labels = np.repeat(np.arange(k), n // k)
    centers = rs.standard_normal((k, d)) * (20.0 if separated else 1.0)
    feats = (centers[labels] + rs.standard_normal((n, d))).astype(np.float32)
    z = rs.standard_normal((n, k + 1)) * 2.0
    probs = np.exp(z - z.max(-1, keepdims=True))
    return feats, labels, (probs / probs.sum(-1, keepdims=True)).astype(np.float32)


def _eq(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
        return True
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return True


def test_prototypes_fusions_and_ncc_match_jax():
    feats, labels, probs = _features()
    sep, sep_labels, _ = _features(n=60, k=3, d=8, seed=1, separated=True)
    for nw in (True, False):
        _eq(tda.build_prototypes(feats, labels, 5, nw), jda.build_prototypes(feats, labels, 5, nw))
    for strategy, kw in (("simple_mean", {}), ("weighted_mean", {"probs": probs}),
                         ("weighted_mean", {}), ("augmented", {"augment_factor": 0.2}),
                         ("adaptive", {"temperature": 0.5}), ("uncertainty", {"probs": probs}),
                         ("diversity", {"num_select": None})):
        _eq(tda.build_prototypes_strategy(feats, labels, 5, strategy, **kw),
            jda.build_prototypes_strategy(feats, labels, 5, strategy, **kw))
    # k-means selects: well-separated features (three blobs of 20, two picked per class)
    sub = np.repeat(np.arange(6), 10)  # two sub-blobs a class
    blobs = (sep + 8.0 * np.random.default_rng(2).standard_normal((6, 8))[sub]).astype(np.float32)
    _eq(tda.build_prototypes_strategy(blobs, sep_labels, 3, "diversity", num_select=2),
        jda.build_prototypes_strategy(blobs, sep_labels, 3, "diversity", num_select=2))
    protos = jda.build_prototypes(feats, labels, 5)
    for kw in ({}, {"confidence_adaptive": False, "fusion_weight": 0.3, "temperature": 0.05}):
        _eq(tda.pnc_probs(feats, probs, protos, **kw), jda.pnc_probs(feats, probs, protos, **kw))
    for metric in ("cosine", "euclidean"):
        _eq(tda.ncc_classify(feats, protos, metric, 0.02), jda.ncc_classify(feats, protos, metric,
                                                                             0.02))
    other = np.roll(probs, 1, axis=0)
    for method in ("confidence_weighted", "max_confidence", "average", "lccs_only"):
        _eq(tda.ensemble_predict_probs(probs, other, method),
            jda.ensemble_predict_probs(probs, other, method))
    _eq(tda.adapted_ensemble_probs([probs, other]), jda.adapted_ensemble_probs([probs, other]))
    for fn, args in ((tda.ncc_classify, (feats, protos, "manhattan")),
                     (tda.build_prototypes_strategy, (feats, labels, 5, "median")),
                     (tda.ensemble_predict_probs, (probs, other, "vote"))):
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("strategy", ["random", "confidence", "diversity", "uncertainty",
                                      "balanced"])
def test_select_support_matches_jax(strategy):
    feats, labels, probs = _features(n=48, k=6, seed=3, separated=True)
    for size in (6, 48, 60):
        _eq(tda.select_support(feats, labels, probs, size, strategy, seed=7),
            jda.select_support(feats, labels, probs, size, strategy, seed=7))


def test_splits_ttest_and_grids_match_jax():
    feats, labels, probs = _features(n=30, k=3, seed=5)
    for per_class, weight in ((2, 0.5), (4, 0.2), (20, 0.9)):
        _eq(tda.smart_select_support(feats, labels, probs, per_class, weight),
            jda.smart_select_support(feats, labels, probs, per_class, weight))
    uneven = np.random.default_rng(6).integers(0, 5, 37)
    for per_class, seed in ((2, 42), (5, 1)):
        _eq(tda.strategic_split(uneven, per_class, seed), jda.strategic_split(uneven, per_class,
                                                                               seed))
    a, b = [0.61, 0.7, 0.64, 0.72], [0.6, 0.65, 0.6, 0.7]
    assert tda.paired_t_test(a, b) == jda.paired_t_test(a, b)

    def eval_fn(cfg):
        return round(cfg["lccs_alpha"] * cfg["pnc_temperature"] * 7 % 1, 6)

    assert tda.hyperparameter_search(eval_fn, tda.DEFAULT_SEARCH_SPACE) == \
        jda.hyperparameter_search(eval_fn, jda.DEFAULT_SEARCH_SPACE)
    assert tda.DEFAULT_SEARCH_SPACE == jda.DEFAULT_SEARCH_SPACE
    assert tda.EVAL_CONFIG == jda.EVAL_CONFIG
    assert tda.full_method_grid() == jda.full_method_grid()
    quick = {**jda.EVAL_CONFIG, "lccs": {**jda.EVAL_CONFIG["lccs"], "weighted": {"alphas": [0.2]}}}
    assert tda.full_method_grid(quick) == jda.full_method_grid(quick)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_evaluate_and_combined_match_jax(resnet):
    """evaluate_adaptation with and without PNC, and lccs_pnc_combined for
    each LCCS method and two prototype builders: statistics to STAT_TOL,
    prototypes and fused probabilities to PROB_TOL, accuracies equal."""
    jm, v, tm, params, stats = resnet
    sup, test = _images(10, seed=8), _images(12, seed=9)
    sup_y, test_y = np.arange(10) % 5, np.arange(12) % 5
    for method, kw, strategy in (("weighted", {}, None),
                                 ("progressive", {"momentum": 0.1, "iterations": 2}, None),
                                 ("mean_shift", {"shift": 0.5}, "uncertainty")):
        common = dict(alpha=0.4, lccs_method=method, lccs_params=kw,
                      prototype_strategy=strategy, pnc_cfg={"temperature": 0.2})
        w_stats, w_protos, w_predict = jda.lccs_pnc_combined(
            jm, v["params"], v["batch_stats"], sup, sup_y, 5, **common)
        g_stats, g_protos, g_predict = tda.lccs_pnc_combined(
            tm, params, stats, sup, sup_y, 5, **common)
        assert max(_rels(g_stats, w_stats).values()) < STAT_TOL, method
        assert _max_abs(g_protos, w_protos) < PROB_TOL, method
        assert _max_abs(g_predict(test), w_predict(test)) < PROB_TOL, method
        for protos in (None, g_protos):
            got = tda.evaluate_adaptation(tm, params, g_stats, test, test_y, protos,
                                          {"temperature": 0.2}, batch_size=5)
            want = jda.evaluate_adaptation(jm, v["params"], w_stats, test, test_y,
                                           None if protos is None else w_protos,
                                           {"temperature": 0.2}, batch_size=5)
            assert (got.accuracy, got.per_class_acc) == (want.accuracy, want.per_class_acc)
    with pytest.raises(ValueError, match="lccs_method"):
        tda.lccs_pnc_combined(tm, params, stats, sup, sup_y, 5, lccs_method="hybrid")


def test_kmeans_matches_sklearn():
    """Well-separated blobs: the points nearest each centre are sklearn's;
    random data: the best inertia within 1e-6 relative of sklearn's (a
    float32 summation apart; 2.4e-8 to 1.1e-7 measured at 155 × 512)."""
    from sklearn.cluster import KMeans as SKMeans

    from vavae_tpu_torch.utils.kmeans import KMeans

    rs = np.random.default_rng(0)
    centers = rs.standard_normal((6, 16)) * 10
    X = (centers[rs.integers(0, 6, 90)] + rs.standard_normal((90, 16))).astype(np.float32)

    def picked(km):
        return sorted(int(np.argmin(np.linalg.norm(X - c, axis=1))) for c in km.cluster_centers_)

    want = SKMeans(n_clusters=6, random_state=42, n_init=10).fit(X)
    got = KMeans(n_clusters=6, random_state=42, n_init=10).fit(X)
    assert picked(got) == picked(want)
    assert abs(got.inertia_ - want.inertia_) <= 1e-6 * want.inertia_
    for k in (3, 20):
        X = rs.standard_normal((80, 24)).astype(np.float32)
        want = SKMeans(n_clusters=k, random_state=42, n_init=10).fit(X)
        got = KMeans(n_clusters=k, random_state=42, n_init=10).fit(X)
        assert abs(got.inertia_ - want.inertia_) <= 1e-6 * want.inertia_, k
        assert got.labels_.shape == (80,) and got.cluster_centers_.shape == (k, 24)
    with pytest.raises(ValueError):
        KMeans(n_clusters=81).fit(X)


def test_main_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the CPU: 4 users × 5 target images at 16 px, a baseline
    classifier file (JAX layout, random weights), 2 support images a class,
    three reference-grid combinations, the NCC supplement and the
    confidence-weighted ensemble: the same split, baseline, grid accuracies,
    best configuration and NCC accuracies."""
    import sys

    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, save_classifier
    from vavae_tpu_torch.utils.png import write_pngs

    rs = np.random.default_rng(11)
    entries = []
    for u in range(4):
        d = tmp_path / f"ID_{u}"
        d.mkdir()
        base = rs.integers(0, 256, (4, 4, 3))
        for i in range(5):
            img = np.clip(np.repeat(np.repeat(base, 5, 0), 5, 1)
                          + rs.integers(-30, 31, (20, 20, 3)), 0, 255).astype(np.uint8)
            write_pngs(img[None], [str(d / f"{i}.png")])
            entries.append({"path": str(d / f"{i}.png"), "user_id": u})
    split = tmp_path / "target.json"
    split.write_text(json.dumps({"val": entries}))
    clf = ClassifierTrainer(num_classes=4, device="cpu")
    state = clf.init_state(2)
    with torch.no_grad():
        for n, p in zip(state.names, state.params):
            if n == "fc.weight":
                p.mul_(30.0)  # a classifier whose predictions move with the statistics
    path = save_classifier(str(tmp_path / "clf.safetensors"), clf, state)
    args = ["--classifier_ckpt", path, "--target_split_file", str(split), "--num_classes", "4",
            "--image_size", "16", "--support_per_class", "2", "--reference_grid", "--limit", "3",
            "--ncc", "--ensemble", "confidence_weighted"]
    monkeypatch.setattr(sys, "argv", ["da"] + args + ["--out", str(tmp_path / "jax.json")])
    jda.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    got = tda.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert 0.0 <= got["ensemble_accuracy"] <= 1.0
    assert os.path.getsize(tmp_path / "port.json") > 0

"""Generation evaluation of the port against the JAX package
(``vavae_tpu/apps/generation_evaluator.py``): the confidence histogram,
identity preservation, diversity, kNN coverage, the weighted score in both
diversity modes (with their undefined and empty cases) and the thresholds
exactly equal on seeded probabilities and features; ``pairwise_lpips``
over the port's LPIPS against the JAX LPIPS on the same weights (1e-4
relative, the LPIPS tolerance of ``test_torch_tokenizer_eval.py``); and
``main`` on the CPU on a tiny tree, feature and LPIPS diversity, against
the JAX functions applied to the port classifier's outputs."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread  # noqa: F401
from test_torch_select_analyze import _write_tree, port_classifier, same, write_split_and_classifier
from test_torch_tokenizer_eval import _jax_lpips_params
from vavae_tpu.apps import generation_evaluator as jge
from vavae_tpu_torch.apps import generation_evaluator as tge

pytestmark = pytest.mark.usefixtures("one_thread")


def _case(n, k=6, d=10, seed=0):
    rs = np.random.default_rng(seed)
    z = rs.standard_normal((n, k)) * 2.0
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32), \
        rs.standard_normal((n, d)).astype(np.float32), rs.integers(0, k, n)


@pytest.mark.parametrize("n_gen,n_real", [(12, 9), (1, 9), (7, 1), (5, 3)])
def test_metrics_match_jax(n_gen, n_real):
    probs, feats, labels = _case(n_gen)
    _, real, _ = _case(n_real, seed=1)
    assert same(tge.confidence_histogram(probs, labels, 8),
                jge.confidence_histogram(probs, labels, 8))
    for u in (0, 3):
        assert same(tge.identity_preservation(probs, u), jge.identity_preservation(probs, u))
    pairs = np.abs(np.random.default_rng(2).standard_normal(6)).astype(np.float32) * 0.05
    for lp in (None, pairs):
        assert same(tge.intra_class_diversity(feats, lp), jge.intra_class_diversity(feats, lp))
    for k in (1, 5):
        assert same(tge.knn_coverage(feats, real, k), jge.knn_coverage(feats, real, k))
    for metric, lp in (("feature", None), ("lpips", pairs), ("lpips", pairs[:0])):
        args = (probs, feats, real, 2)
        got = tge.ComprehensiveGenerationEvaluator(diversity_metric=metric).evaluate_user(
            *args, lpips_pairs=lp)
        want = jge.ComprehensiveGenerationEvaluator(diversity_metric=metric).evaluate_user(
            *args, lpips_pairs=lp)
        assert same(got, want)
    with pytest.raises(ValueError, match="lpips_pairs"):
        tge.ComprehensiveGenerationEvaluator(diversity_metric="lpips").evaluate_user(
            probs, feats, real, 0)
    metrics = {"confidence": probs.max(-1), "margin": feats[:, 0]}
    assert same(tge.recommend_thresholds(metrics, 7.5), jge.recommend_thresholds(metrics, 7.5))


@pytest.fixture(scope="module")
def lpips_pair():
    from vavae_tpu_torch.models.lpips import LPIPS
    from vavae_tpu_torch.utils.weights import lpips_state_from_jax

    params = _jax_lpips_params(5)
    model = LPIPS()
    model.load_state_dict(lpips_state_from_jax(params), strict=True)
    return params, model.eval()


def test_pairwise_lpips_matches_jax(lpips_pair):
    """60 images subsampled to 50 by the default generator, the first 9
    paired (36 pairs, two forwards of 32 and 4): the port's LPIPS to 1e-4
    relative of JAX's, the pair order JAX's."""
    from vavae_tpu.models.lpips import LPIPS as JaxLPIPS

    params, model = lpips_pair
    imgs = np.random.default_rng(6).uniform(-1, 1, (60, 16, 16, 3)).astype(np.float32)
    jm = JaxLPIPS()
    want = jge.pairwise_lpips(
        imgs, lambda a, b: np.asarray(jm.apply({"params": params}, jnp.asarray(a),
                                               jnp.asarray(b))), pair_limit=9)

    calls = []

    @torch.no_grad()
    def port_pair_fn(a, b):
        calls.append(len(a))
        return model(torch.from_numpy(a), torch.from_numpy(b)).numpy()

    got = tge.pairwise_lpips(imgs, port_pair_fn, pair_limit=9)
    assert calls == [32, 4] and got.shape == want.shape == (36,)
    assert max_rel(got, want) < 1e-4
    assert tge.pairwise_lpips(imgs[:1], port_pair_fn).shape == (0,)


def test_main_matches_jax_functions(tmp_path, lpips_pair, monkeypatch):
    """generation_evaluator.main on the CPU at 16 px (users 0, 2, 5 have
    real samples, 7 has none) with feature and LPIPS diversity: the report
    is the JAX evaluator applied to the port classifier's probabilities and
    features, and the port LPIPS's pairs."""
    from vavae_tpu.apps.analyze_metrics import _load_image_dir
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    split, clf = write_split_and_classifier(str(tmp_path))
    # user 7 without real samples: drop it from the split
    data = json.loads(open(split).read())
    data["val"] = [e for e in data["val"] if e["user_id"] != 7]
    open(split, "w").write(json.dumps(data))
    _write_tree(str(tmp_path / "gen"))
    _, model = lpips_pair
    weights = str(tmp_path / "lpips.pth")
    torch.save(model.state_dict(), weights)
    monkeypatch.setenv("VAVAE_LPIPS_WEIGHTS", weights)
    predict, features = port_classifier(clf)

    ds = SplitFileDataset(split, "val", image_size=16)
    real_x = np.stack([ds[i][0] for i in range(len(ds))])
    real_y = np.asarray([ds[i][1] for i in range(len(ds))])
    gen_u8, gen_y = _load_image_dir(str(tmp_path / "gen"), 16)
    gen_x = gen_u8.astype(np.float32) / 127.5 - 1.0
    gp, gf, rf = predict(gen_x), features(gen_x), features(real_x)
    pair_fn = tge.lpips_pair_fn_for("cpu")
    common = ["--classifier_ckpt", clf, "--split_file", split, "--generated_dir",
              str(tmp_path / "gen"), "--num_classes", "8", "--image_size", "16", "--device", "cpu"]
    for diversity in ("feature", "lpips"):
        got = tge.main(common + ["--diversity", diversity])
        ev = jge.ComprehensiveGenerationEvaluator(diversity_metric=diversity)
        for uid in (0, 2, 5):
            m = gen_y == uid
            pairs = tge.pairwise_lpips(gen_x[m], pair_fn) if diversity == "lpips" else None
            assert same(got[uid], ev.evaluate_user(gp[m], gf[m], rf[real_y == uid], uid,
                                                   lpips_pairs=pairs)), (diversity, uid)
        assert np.isnan(got[7]["coverage"]) and "no real samples" in got[7]["note"]
        want7 = {**jge.identity_preservation(gp[gen_y == 7], 7),
                 **jge.intra_class_diversity(gf[gen_y == 7])}
        assert same({k: got[7][k] for k in want7}, want7)

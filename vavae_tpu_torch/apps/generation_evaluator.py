"""Generation-quality evaluation for the micro-Doppler pipeline (port of
``vavae_tpu/apps/generation_evaluator.py``).

Per user: confidence histogram, identity preservation, intra-class
diversity (feature cosine, or pairwise LPIPS by the port's
``models/lpips.py``, 32 pairs a forward), kNN feature coverage against the
real data, and the weighted overall score. The metrics are numpy, as in the
JAX package. ``python -m vavae_tpu_torch.apps.generation_evaluator`` runs
the classifier and LPIPS on the card unless ``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.generation_evaluator --classifier_ckpt clf.safetensors \\
        --generated_dir output/filtered_samples --split_file split.json [--diversity lpips]
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


def confidence_histogram(probs: np.ndarray, labels: np.ndarray, bins: int = 20) -> Dict:
    """Per-user confidence statistics (evaluate_generation_quality.py:89-160)."""
    conf = probs.max(axis=-1)
    pred = probs.argmax(axis=-1)
    correct = pred == labels
    hist, edges = np.histogram(conf, bins=bins, range=(0.0, 1.0))
    return {
        "mean_confidence": float(conf.mean()),
        "accuracy": float(correct.mean()),
        "hist": hist.tolist(),
        "edges": edges.tolist(),
        "above_95": float((conf > 0.95).mean()),
    }


def identity_preservation(
    gen_probs: np.ndarray, target_user: int
) -> Dict:
    """How often generated samples classify as their target user (:80-107)."""
    pred = gen_probs.argmax(axis=-1)
    conf = gen_probs.max(axis=-1)
    match = pred == target_user
    return {
        "identity_acc": float(match.mean()),
        "mean_target_prob": float(gen_probs[:, target_user].mean()),
        "mean_conf_when_match": float(conf[match].mean()) if match.any() else 0.0,
    }


def intra_class_diversity(
    features: np.ndarray, lpips_pairs: Optional[np.ndarray] = None
) -> Dict:
    """Feature-space diversity = 1 − mean pairwise cosine sim; optional LPIPS
    pairwise mean (:108-148). A single sample has NO pairs — diversity is
    undefined (NaN), matching the reference's empty-upper-triangle mean; the
    old 1.0 rewarded degenerate one-image users with the MAXIMAL score."""
    n = len(features)
    if n < 2:
        return {"feature_diversity": float("nan")}
    f = features / np.maximum(np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
    sim = f @ f.T
    feat_div = float(1.0 - (sim.sum() - np.trace(sim)) / (n * (n - 1)))
    out = {"feature_diversity": feat_div}
    if lpips_pairs is not None:
        out["lpips_diversity"] = float(np.mean(lpips_pairs))
    return out


def pairwise_lpips(
    images: np.ndarray,
    lpips_pair_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    sample_size: int = 50,
    pair_limit: int = 20,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Pairwise perceptual distances, reference-exact protocol
    (comprehensive_generation_evaluator.py:113-127): random-subsample to
    ``sample_size`` when larger, then all (i, j) pairs over the first
    ``pair_limit`` samples. ``lpips_pair_fn(a, b)`` takes two (B, H, W, C)
    batches and returns (B,) distances (batched here — the reference loops
    one pair per forward; same numbers, O(B) fewer dispatches)."""
    if len(images) > sample_size:
        rng = rng or np.random.default_rng(0)
        images = images[rng.permutation(len(images))[:sample_size]]
    n = min(len(images), pair_limit)
    idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if not idx:
        return np.empty((0,), np.float32)
    a = np.stack([images[i] for i, _ in idx])
    b = np.stack([images[j] for _, j in idx])
    out = []
    for s in range(0, len(a), 32):
        out.append(np.asarray(lpips_pair_fn(a[s:s + 32], b[s:s + 32])))
    return np.concatenate(out).reshape(-1)


def knn_coverage(
    gen_features: np.ndarray, real_features: np.ndarray, k: int = 5
) -> Dict:
    """Coverage/precision-style kNN metrics (:149-200): fraction of real
    samples whose kNN ball contains a generated sample, and mean distance
    from generated to nearest real."""
    def _norm(f):
        return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)

    g, r = _norm(gen_features), _norm(real_features)
    if len(r) < 2:
        # a single real sample has no finite neighbour: the kNN radius is
        # undefined and any coverage number would be fiction
        return {
            "coverage": float("nan"),
            "mean_nearest_real_dist": float((1.0 - g @ r.T).min(axis=-1).mean()),
        }
    d_rr = 1.0 - r @ r.T
    np.fill_diagonal(d_rr, np.inf)
    # with fewer than k+1 real samples, use the farthest finite neighbour
    k = min(k, len(r) - 1)
    knn_radius = np.sort(d_rr, axis=-1)[:, k - 1]  # per-real kNN radius
    d_rg = 1.0 - r @ g.T
    covered = (d_rg.min(axis=-1) <= knn_radius).mean()
    fidelity = float((1.0 - g @ r.T).min(axis=-1).mean())
    return {"coverage": float(covered), "mean_nearest_real_dist": fidelity}


@dataclasses.dataclass
class ComprehensiveGenerationEvaluator:
    """Weighted overall score (comprehensive_generation_evaluator.py:255-285):
    weights 0.5/0.3/0.2, identity_score = top1_accuracy × mean target
    confidence (:105).

    ``diversity_metric`` picks the diversity component:
      - "feature" (fast default): feature-cosine diversity ×2 capped at 1 —
        no O(n²) LPIPS forwards; a DOCUMENTED deviation from the reference.
      - "lpips" (reference-exact): mean pairwise LPIPS ×10 capped at 1
        (:146,262) over the :113-127 subsampling protocol; pass the
        precomputed ``lpips_pairs`` (see ``pairwise_lpips``).

    Undefined components (single-sample diversity, single-real-sample
    coverage) make the overall score NaN with an explanatory note instead
    of propagating silently."""

    identity_weight: float = 0.5
    diversity_weight: float = 0.3
    coverage_weight: float = 0.2
    diversity_metric: str = "feature"

    def evaluate_user(
        self,
        gen_probs: np.ndarray,
        gen_features: np.ndarray,
        real_features: np.ndarray,
        target_user: int,
        lpips_pairs: Optional[np.ndarray] = None,
    ) -> Dict:
        ident = identity_preservation(gen_probs, target_user)
        div = intra_class_diversity(gen_features, lpips_pairs)
        cov = knn_coverage(gen_features, real_features)
        identity_score = ident["identity_acc"] * ident["mean_target_prob"]
        if self.diversity_metric == "lpips":
            if lpips_pairs is None:
                raise ValueError(
                    "diversity_metric='lpips' needs lpips_pairs (pairwise_lpips)")
            # reference :262: min(1, mean_lpips * 10); :146 means an empty
            # pair list scores 0, not NaN — match that quirk exactly
            lp = float(np.mean(lpips_pairs)) if len(lpips_pairs) else 0.0
            div_component = min(1.0, lp * 10.0)
        else:
            div_component = min(div["feature_diversity"] * 2.0, 1.0)
        components = {
            "identity": self.identity_weight * identity_score,
            "diversity": self.diversity_weight * div_component,
            "coverage": self.coverage_weight * cov["coverage"],
        }
        undefined = [k for k, v in components.items() if not np.isfinite(v)]
        out = {**ident, **div, **cov, "identity_score": float(identity_score)}
        if undefined:
            out["overall_score"] = float("nan")
            out["note"] = (
                f"overall undefined — component(s) {undefined} have too few "
                "samples (diversity needs ≥2 generated, coverage ≥2 real)"
            )
        else:
            out["overall_score"] = float(sum(components.values()))
        return out


def recommend_thresholds(
    real_metrics: Dict[str, np.ndarray], percentile: float = 5.0
) -> Dict[str, float]:
    """Data-driven filter thresholds from real-data metric distributions
    (analyze_real_data_metrics.py:315-362): use the low percentile of each
    real-data metric as the acceptance floor for generated samples."""
    return {
        name: float(np.percentile(values, percentile))
        for name, values in real_metrics.items()
    }


def lpips_pair_fn_for(device: str = "cuda") -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """``lpips_pair_fn`` over the port's LPIPS (``load_lpips``: weights from
    ``VAVAE_LPIPS_WEIGHTS``/``VAVAE_VGG16_WEIGHTS``): two (B, H, W, C)
    batches in [-1, 1] → (B,) distances, fp32 with TF32 off."""
    import torch

    from vavae_tpu_torch.models.lpips import load_lpips
    from vavae_tpu_torch.utils.device import full_fp32

    model = load_lpips(device=device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def pair_fn(a, b):
        with full_fp32():
            d = model(torch.as_tensor(np.asarray(a, np.float32), device=dev),
                      torch.as_tensor(np.asarray(b, np.float32), device=dev))
        return d.float().cpu().numpy().reshape(-1)

    return pair_fn


def main(argv=None) -> Dict:
    """Per-user identity / diversity / coverage composite scores for a
    generated-sample tree; returns the report."""
    import argparse
    import json

    from vavae_tpu_torch.apps.analyze_metrics import _load_image_dir
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--classifier_ckpt", required=True)
    ap.add_argument("--generated_dir", required=True)
    ap.add_argument("--split_file", required=True, help="real data for coverage")
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "improved", "calibrated", "domain_adaptive"])
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--diversity", default="feature", choices=["feature", "lpips"],
                    help="diversity component: fast feature-cosine (default) "
                         "or pairwise LPIPS (needs "
                         "VAVAE_LPIPS_WEIGHTS/VAVAE_VGG16_WEIGHTS)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = ClassifierTrainer(num_classes=args.num_classes, mode=args.mode,
                                device=args.device)
    state = restore_classifier(args.classifier_ckpt, trainer, trainer.init_state(0))
    predict = trainer.predict_fn(state)
    features = trainer.feature_fn(state)

    def batched(fn, x, bs=64):
        return np.concatenate(
            [np.asarray(fn(x[s : s + bs])) for s in range(0, len(x), bs)]
        )

    ds = SplitFileDataset(args.split_file, args.split, image_size=args.image_size)
    pairs = [ds[i] for i in range(len(ds))]
    real_x = np.stack([p[0] for p in pairs])
    real_labels = np.asarray([p[1] for p in pairs], np.int64)
    real_feats = batched(features, real_x)

    gen_imgs, gen_labels = _load_image_dir(args.generated_dir, args.image_size)
    gen_x = gen_imgs.astype(np.float32) / 127.5 - 1.0
    gen_probs = batched(predict, gen_x)
    gen_feats = batched(features, gen_x)

    lpips_pair_fn = lpips_pair_fn_for(args.device) if args.diversity == "lpips" else None

    ev = ComprehensiveGenerationEvaluator(diversity_metric=args.diversity)
    report = {}
    for uid in np.unique(gen_labels):
        m = gen_labels == uid
        rm = real_labels == uid
        if not rm.any():
            # coverage against OTHER users' features would be a silently
            # wrong metric — report identity/diversity only
            r = {
                **identity_preservation(gen_probs[m], int(uid)),
                **intra_class_diversity(gen_feats[m]),
                "coverage": float("nan"),
                "overall_score": float("nan"),
                "note": f"no real samples for user {uid} in split "
                        f"'{args.split}' — coverage/overall undefined",
            }
            report[int(uid)] = r
            print(f"user {uid}: {r['note']}")
            continue
        pairs = (pairwise_lpips(gen_x[m], lpips_pair_fn)
                 if lpips_pair_fn is not None else None)
        report[int(uid)] = ev.evaluate_user(
            gen_probs[m], gen_feats[m], real_feats[rm], int(uid),
            lpips_pairs=pairs,
        )
        r = report[int(uid)]
        print(
            f"user {uid}: identity {r['identity_acc']:.3f} diversity "
            f"{r['feature_diversity']:.3f} coverage {r['coverage']:.3f} "
            f"overall {r['overall_score']:.3f}"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"written to {args.out}")
    return report


if __name__ == "__main__":
    main()

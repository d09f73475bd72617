"""Classifier evaluation report on real (or generated) data (port of
``vavae_tpu/apps/classifier_eval.py``): overall, top-5 and per-user
accuracy, the confusion matrix, confidence-binned reliability with its ECE,
and the reliability verdict with its warnings. ``python -m
vavae_tpu_torch.apps.classifier_eval`` restores a classifier file (the
port's or the JAX package's) and writes the JSON report. Runs on the card
unless ``--device cpu`` is passed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


def confusion_matrix(pred: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels, pred), 1)
    return cm


def reliability_bins(
    confidence: np.ndarray, correct: np.ndarray, bins: int = 10
) -> Dict:
    """Confidence-binned accuracy (reliability diagram data) + ECE."""
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(confidence, edges) - 1, 0, bins - 1)
    bin_acc, bin_conf, bin_n = [], [], []
    ece = 0.0
    for b in range(bins):
        mask = idx == b
        n = int(mask.sum())
        acc = float(correct[mask].mean()) if n else 0.0
        conf = float(confidence[mask].mean()) if n else 0.0
        bin_acc.append(acc)
        bin_conf.append(conf)
        bin_n.append(n)
        ece += n / max(len(confidence), 1) * abs(acc - conf)
    return {
        "bin_edges": edges.tolist(),
        "bin_accuracy": bin_acc,
        "bin_confidence": bin_conf,
        "bin_count": bin_n,
        "ece": float(ece),
    }


def reliability_verdict(
    accuracy: float,
    high_conf_accuracy: float,
    user_accuracies,
) -> Dict:
    """Can this classifier be trusted to filter generated samples?

    Reference thresholds (test_classifier_on_real_data.py:268-316):
    ≥95% HIGHLY RELIABLE, ≥85% RELIABLE, ≥70% MODERATELY RELIABLE, else
    UNRELIABLE; warnings when per-user accuracy std > 0.2 (user bias) or
    high-confidence accuracy trails overall by > 0.1 (miscalibration)."""
    if accuracy >= 0.95:
        verdict = "HIGHLY RELIABLE"
    elif accuracy >= 0.85:
        verdict = "RELIABLE"
    elif accuracy >= 0.70:
        verdict = "MODERATELY RELIABLE"
    else:
        verdict = "UNRELIABLE"
    warnings = []
    user_std = float(np.std(list(user_accuracies))) if len(user_accuracies) else 0.0
    if user_std > 0.2:
        warnings.append("high per-user accuracy variance: classifier may be "
                        "biased toward certain users")
    if high_conf_accuracy < accuracy - 0.1:
        warnings.append("high-confidence samples LESS accurate than average: "
                        "confidence calibration issues")
    return {"verdict": verdict, "user_accuracy_std": user_std,
            "warnings": warnings}


def evaluate_classifier(
    classifier_fn: Callable[[np.ndarray], np.ndarray],
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    batch_size: int = 64,
    in_range_uint8: Optional[bool] = None,
) -> Dict:
    """Full report: overall + per-user accuracy, confusion matrix, top-k,
    reliability/ECE. ``images`` uint8 NHWC or float [-1,1]."""
    if in_range_uint8 is None:
        in_range_uint8 = images.dtype == np.uint8
    preds, confs, top5 = [], [], []
    for s in range(0, len(images), batch_size):
        x = images[s : s + batch_size]
        if in_range_uint8:
            x = x.astype(np.float32) / 127.5 - 1.0
        probs = np.asarray(classifier_fn(x))
        preds.append(probs.argmax(-1))
        confs.append(probs.max(-1))
        k = min(5, probs.shape[-1])
        topk = np.argsort(probs, axis=-1)[:, -k:]
        top5.append((topk == labels[s : s + batch_size, None]).any(-1))
    pred = np.concatenate(preds)
    conf = np.concatenate(confs)
    correct = pred == labels
    cm = confusion_matrix(pred, labels, num_classes)
    per_user = {
        int(c): float(correct[labels == c].mean())
        for c in np.unique(labels)
    }
    # high-confidence (>0.9) subset stats (test_classifier_on_real_data.py
    # analyze_results:212-224)
    hc = conf > 0.9
    hc_acc = float(correct[hc].mean()) if hc.any() else 0.0
    acc = float(correct.mean())
    return {
        "accuracy": acc,
        "top5_accuracy": float(np.concatenate(top5).mean()),
        "mean_confidence": float(conf.mean()),
        "confidence_std": float(conf.std()),
        "high_conf_ratio": float(hc.mean()),
        "high_conf_accuracy": hc_acc,
        "per_user_accuracy": per_user,
        "worst_users": sorted(per_user, key=per_user.get)[:5],
        "confusion_matrix": cm.tolist(),
        "reliability": reliability_bins(conf, correct),
        "reliability_verdict": reliability_verdict(acc, hc_acc, list(per_user.values())),
    }


def main(argv=None) -> Dict:
    import argparse
    import json

    from vavae_tpu_torch.apps.train_classifier import (
        MODES,
        ClassifierTrainer,
        restore_classifier,
    )
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--classifier_ckpt", required=True)
    ap.add_argument("--split_file", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--mode", default="baseline", choices=list(MODES))
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = ClassifierTrainer(num_classes=args.num_classes, mode=args.mode, device=args.device)
    state = restore_classifier(args.classifier_ckpt, trainer, trainer.init_state(0))

    ds = SplitFileDataset(args.split_file, args.split, image_size=args.image_size)
    images, labels = zip(*(ds[i] for i in range(len(ds))))
    report = evaluate_classifier(trainer.predict_fn(state), np.stack(images),
                                 np.asarray(labels, np.int64), args.num_classes,
                                 batch_size=args.batch_size)
    verdict = report["reliability_verdict"]
    print(f"accuracy {report['accuracy']:.4f}  top5 {report['top5_accuracy']:.4f}  "
          f"ece {report['reliability']['ece']:.4f}  worst users {report['worst_users']}")
    print(f"reliability verdict: {verdict['verdict']}")
    for w in verdict["warnings"]:
        print(f"  warning: {w}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.out}")
    return report


if __name__ == "__main__":
    main()

"""Statistics-based user selection for generation experiments (port of
``vavae_tpu/apps/select_users.py``).

Ranks users by how reliably the classifier identifies their real samples
(accuracy, mean confidence, margin, mean target probability), then picks
the best, worst, median or an evenly spread cohort for the generation and
domain-adaptation experiments. The statistics are numpy, as in the JAX
package; ``python -m vavae_tpu_torch.apps.select_users`` runs the
classifier on the card unless ``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.select_users --classifier_ckpt clf.safetensors \\
        --split_file split.json --n 10 --strategy best
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def user_classifier_stats(
    probs: np.ndarray, labels: np.ndarray
) -> Dict[int, Dict[str, float]]:
    """Per-user accuracy / mean confidence / mean margin from real-data probs."""
    stats: Dict[int, Dict[str, float]] = {}
    pred = probs.argmax(axis=-1)
    conf = probs.max(axis=-1)
    top2 = np.sort(probs, axis=-1)[:, -2]
    for u in np.unique(labels):
        m = labels == u
        stats[int(u)] = {
            "accuracy": float((pred[m] == u).mean()),
            "mean_confidence": float(conf[m].mean()),
            "mean_margin": float((conf[m] - top2[m]).mean()),
            "mean_target_prob": float(probs[m, u].mean()),
            "n": int(m.sum()),
        }
    return stats


def rank_users(
    stats: Dict[int, Dict[str, float]],
    key: str = "mean_target_prob",
) -> List[int]:
    return sorted(stats, key=lambda u: stats[u][key], reverse=True)


def select_users(
    stats: Dict[int, Dict[str, float]],
    n: int = 10,
    strategy: str = "best",
    min_accuracy: float = 0.0,
) -> List[int]:
    """strategy: best | worst | median | spread (even coverage of the range)."""
    ranked = [u for u in rank_users(stats) if stats[u]["accuracy"] >= min_accuracy]
    if strategy == "best":
        return ranked[:n]
    if strategy == "worst":
        return ranked[-n:]
    if strategy == "median":
        mid = len(ranked) // 2
        lo = max(mid - n // 2, 0)
        return ranked[lo : lo + n]
    if strategy == "spread":
        idx = np.linspace(0, len(ranked) - 1, num=min(n, len(ranked))).astype(int)
        return [ranked[i] for i in idx]
    raise ValueError(strategy)


def main(argv=None) -> dict:
    """Classifier statistics on real validation data → ranked and selected
    user ids; returns {"selected", "stats"}."""
    import argparse
    import json

    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--classifier_ckpt", required=True)
    ap.add_argument("--split_file", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "improved", "calibrated", "domain_adaptive"])
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--strategy", default="best",
                    choices=["best", "worst", "median", "spread"])
    ap.add_argument("--min_accuracy", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = ClassifierTrainer(num_classes=args.num_classes, mode=args.mode,
                                device=args.device)
    state = restore_classifier(args.classifier_ckpt, trainer, trainer.init_state(0))
    predict = trainer.predict_fn(state)

    ds = SplitFileDataset(args.split_file, args.split, image_size=args.image_size)
    probs, labels = [], []
    for s in range(0, len(ds), 64):
        batch = [ds[i] for i in range(s, min(s + 64, len(ds)))]
        x = np.stack([b[0] for b in batch])
        probs.append(np.asarray(predict(x)))
        labels.extend(int(b[1]) for b in batch)
    stats = user_classifier_stats(np.concatenate(probs), np.asarray(labels))
    selected = select_users(stats, n=args.n, strategy=args.strategy,
                            min_accuracy=args.min_accuracy)
    print(f"selected ({args.strategy}, n={args.n}): {selected}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"selected": selected, "stats": stats}, f, indent=2)
        print(f"written to {args.out}")
    return {"selected": selected, "stats": stats}


if __name__ == "__main__":
    main()

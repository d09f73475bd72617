"""Filtering-metric distributions and data-driven thresholds (port of
``vavae_tpu/apps/analyze_metrics.py``).

Per-sample metrics (confidence, margin, prototype similarity, pixel mean
and spread) over generated and real images, with percentile summaries;
acceptance thresholds from the low percentiles of the real data; the share
of generated samples that would pass them. The metrics are numpy, as in the
JAX package. Generated trees (``user_XX/NNNNN.png``) are read by the port's
PNG decoder and resized by ``utils/pil_resize.py`` (PIL's BICUBIC, bit for
bit). ``python -m vavae_tpu_torch.apps.analyze_metrics`` runs the
classifier on the card unless ``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.analyze_metrics --classifier_ckpt clf.safetensors \\
        --split_file split.json --generated_dir output/filtered_samples
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass
class SampleMetrics:
    """Per-sample metric columns over one dataset (rows align)."""

    confidence: np.ndarray            # top-1 softmax prob
    margin: np.ndarray                # top-1 − top-2 prob
    correct: np.ndarray               # pred == label
    prototype_sim: Optional[np.ndarray] = None  # max cosine to class prototypes
    pixel_mean: Optional[np.ndarray] = None
    pixel_std: Optional[np.ndarray] = None

    def summary(self, percentiles=(1, 5, 25, 50, 75, 95, 99)) -> Dict:
        out = {}
        for name in ("confidence", "margin", "prototype_sim", "pixel_mean", "pixel_std"):
            col = getattr(self, name)
            if col is None:
                continue
            out[name] = {
                "mean": float(np.mean(col)),
                "std": float(np.std(col)),
                **{f"p{p}": float(np.percentile(col, p)) for p in percentiles},
            }
        out["accuracy"] = float(np.mean(self.correct))
        return out


def compute_sample_metrics(
    images_uint8: np.ndarray,
    labels: np.ndarray,
    classifier_fn: Callable[[np.ndarray], np.ndarray],
    feature_fn: Optional[Callable] = None,
    prototypes: Optional[np.ndarray] = None,
    batch_size: int = 64,
) -> SampleMetrics:
    """Run the classifier (and optional feature/prototype path) over a set of
    images and collect the per-sample filter metrics."""
    confs, margins, corrects, protos = [], [], [], []
    for s in range(0, len(images_uint8), batch_size):
        imgs = images_uint8[s : s + batch_size]
        x = imgs.astype(np.float32) / 127.5 - 1.0
        probs = np.asarray(classifier_fn(x))
        srt = np.sort(probs, axis=-1)
        confs.append(srt[:, -1])
        margins.append(srt[:, -1] - srt[:, -2])
        corrects.append(probs.argmax(-1) == labels[s : s + batch_size])
        if feature_fn is not None and prototypes is not None:
            f = np.asarray(feature_fn(x))
            fn = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
            pn = prototypes / np.maximum(
                np.linalg.norm(prototypes, axis=-1, keepdims=True), 1e-12
            )
            protos.append((fn @ pn.T).max(axis=-1))
    flat = images_uint8.reshape(len(images_uint8), -1).astype(np.float32)
    return SampleMetrics(
        confidence=np.concatenate(confs),
        margin=np.concatenate(margins),
        correct=np.concatenate(corrects),
        prototype_sim=np.concatenate(protos) if protos else None,
        pixel_mean=flat.mean(axis=-1),
        pixel_std=flat.std(axis=-1),
    )


def recommend_thresholds_from_real(
    real: SampleMetrics, percentile: float = 5.0
) -> Dict[str, float]:
    """Acceptance floors for generated samples = the low percentile of the
    REAL data's metric distributions (analyze_real_data_metrics.py:315-362).
    prototype_sim gets an UPPER bound (reject near-duplicates) from the high
    percentile instead."""
    out = {
        "min_confidence": float(np.percentile(real.confidence, percentile)),
        "min_margin": float(np.percentile(real.margin, percentile)),
        "pixel_mean_range": (
            float(np.percentile(real.pixel_mean, percentile)),
            float(np.percentile(real.pixel_mean, 100 - percentile)),
        ),
        "min_pixel_std": float(np.percentile(real.pixel_std, percentile)),
    }
    if real.prototype_sim is not None:
        out["max_prototype_sim"] = float(
            np.percentile(real.prototype_sim, 100 - percentile)
        )
    return out


def compare_real_vs_generated(
    real: SampleMetrics, generated: SampleMetrics
) -> Dict:
    """Side-by-side distribution report (analyze_filtering_metrics.py output
    format): summaries plus the fraction of generated samples that would pass
    real-data-derived thresholds."""
    thresholds = recommend_thresholds_from_real(real)
    passing = (
        (generated.confidence >= thresholds["min_confidence"])
        & (generated.margin >= thresholds["min_margin"])
        & (generated.pixel_mean >= thresholds["pixel_mean_range"][0])
        & (generated.pixel_mean <= thresholds["pixel_mean_range"][1])
        & (generated.pixel_std >= thresholds["min_pixel_std"])
    )
    if generated.prototype_sim is not None and "max_prototype_sim" in thresholds:
        passing &= generated.prototype_sim <= thresholds["max_prototype_sim"]
    return {
        "real": real.summary(),
        "generated": generated.summary(),
        "recommended_thresholds": thresholds,
        "generated_pass_rate": float(passing.mean()),
    }


def save_report(report: Dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    return path


def _load_image_dir(path: str, image_size: int):
    """Generated-sample layout: {path}/user_XX/NNNNN.png → (uint8 NHWC,
    labels), each image as PIL's ``convert("RGB").resize((S, S),
    BICUBIC)`` gives it."""
    import re
    from glob import glob

    from vavae_tpu_torch.utils.pil_resize import resize_uint8
    from vavae_tpu_torch.utils.png import read_png

    imgs, labels = [], []
    for udir in sorted(glob(os.path.join(path, "user_*"))):
        m = re.search(r"user_(\d+)", os.path.basename(udir))
        uid = int(m.group(1)) if m else 0
        for p in sorted(glob(os.path.join(udir, "*.png"))):
            imgs.append(resize_uint8(read_png(p), (image_size, image_size), "bicubic"))
            labels.append(uid)
    if not imgs:
        raise FileNotFoundError(
            f"no user_*/NNNNN.png images under {path!r} — empty filter "
            "output (try a lower --confidence) or a mistyped --generated_dir"
        )
    return np.stack(imgs), np.asarray(labels, np.int64)


def main(argv=None) -> Dict:
    """Metric distributions on real data (→ recommended thresholds),
    optionally compared against a generated-sample directory; returns the
    report."""
    import argparse

    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--classifier_ckpt", required=True)
    ap.add_argument("--split_file", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--generated_dir", default=None,
                    help="user_XX/NNNNN.png tree from generate_and_filter")
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "improved", "calibrated", "domain_adaptive"])
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--percentile", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = ClassifierTrainer(num_classes=args.num_classes, mode=args.mode,
                                device=args.device)
    state = restore_classifier(args.classifier_ckpt, trainer, trainer.init_state(0))
    predict = trainer.predict_fn(state)

    ds = SplitFileDataset(args.split_file, args.split, image_size=args.image_size)
    pairs = [ds[i] for i in range(len(ds))]
    real_imgs = np.stack([
        np.clip((p[0] + 1) * 127.5, 0, 255).astype(np.uint8) for p in pairs
    ])
    real_labels = np.asarray([p[1] for p in pairs], np.int64)
    real = compute_sample_metrics(real_imgs, real_labels, predict)

    if args.generated_dir:
        gen_imgs, gen_labels = _load_image_dir(args.generated_dir, args.image_size)
        gen = compute_sample_metrics(gen_imgs, gen_labels, predict)
        report = compare_real_vs_generated(real, gen)
        print(
            f"real acc {report['real']['accuracy']:.3f}, generated acc "
            f"{report['generated']['accuracy']:.3f}, pass rate "
            f"{report['generated_pass_rate']:.3f}"
        )
    else:
        report = {
            "real": real.summary(),
            "recommended_thresholds": recommend_thresholds_from_real(
                real, args.percentile
            ),
        }
        print(
            f"real acc {report['real']['accuracy']:.3f}; thresholds: "
            f"{report['recommended_thresholds']}"
        )
    if args.out:
        print(f"written to {save_report(report, args.out)}")
    return report


if __name__ == "__main__":
    main()

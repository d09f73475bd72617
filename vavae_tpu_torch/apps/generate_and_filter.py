"""Classifier-filtered conditional generation (port of
``vavae_tpu/apps/generate_and_filter.py``).

Per user: sample a CFG batch, decode it, classify it, keep the images the
classifier assigns to the user with confidence above the threshold (and
through the optional gates: top-1/top-2 margin, a mean-pixel sanity band,
similarity to real-data prototypes, batch feature diversity), until
``target_per_user`` are kept or ``max_batches`` batches are spent. The
features are computed once on the full batch, so every call has one shape.
Kept images are written as PNGs (``utils/png.py``). Runs on the card
unless ``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.generate_and_filter --config CFG.yaml \\
        --classifier_ckpt clf.safetensors ckpt_path=DIT.safetensors
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vavae_tpu_torch.train.dit_trainer import step_seed
from vavae_tpu_torch.utils.png import write_pngs


@dataclasses.dataclass
class FilterConfig:
    confidence_threshold: float = 0.95
    target_per_user: int = 800
    batch_size: int = 100
    # None: the config's sample.cfg_scale; a value overrides it
    cfg_scale: Optional[float] = None
    max_batches: int = 200  # bounds the reference's unbounded loop
    # the advanced gates; None disables one
    min_margin: Optional[float] = None           # top-1 − top-2 probability
    min_diversity: Optional[float] = None        # batch feature diversity
    max_prototype_sim: Optional[float] = None    # rejects near-copies of real data
    pixel_range: tuple = (5.0, 250.0)            # mean-pixel sanity band


def feature_diversity(features: np.ndarray) -> float:
    """1 − mean pairwise cosine similarity."""
    f = features / np.maximum(np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
    sim = f @ f.T
    n = len(f)
    if n < 2:
        return 1.0
    off_diag = (sim.sum() - np.trace(sim)) / (n * (n - 1))
    return float(1.0 - off_diag)


def pixel_sanity(images_uint8: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """False for all-black, all-white or flat images."""
    flat = images_uint8.reshape(len(images_uint8), -1)
    means, stds = flat.mean(axis=-1), flat.std(axis=-1)
    return (means > lo) & (means < hi) & (stds > 1.0)


def generate_and_filter_for_user(
    user_id: int,
    generate_fn: Callable,
    decode_fn: Callable,
    classifier_fn: Callable[[np.ndarray], np.ndarray],
    cfg: FilterConfig,
    generator: Optional[torch.Generator] = None,
    feature_fn: Optional[Callable] = None,
    prototypes: Optional[np.ndarray] = None,
    save_dir: Optional[str] = None,
    return_images: bool = False,
) -> Dict:
    """Rejection-sample until ``cfg.target_per_user`` images are kept.

    generate_fn(generator, labels) -> latents; decode_fn(latents) -> uint8
    NHWC; classifier_fn(images in [-1, 1]) -> softmax probabilities."""
    kept: List[np.ndarray] = []
    stats = {"generated": 0, "accepted": 0, "batches": 0}
    labels = torch.full((cfg.batch_size,), user_id, dtype=torch.long)

    while len(kept) < cfg.target_per_user and stats["batches"] < cfg.max_batches:
        images = decode_fn(generate_fn(generator, labels))  # uint8 NHWC
        x = images.astype(np.float32) / 127.5 - 1.0
        probs = np.asarray(classifier_fn(x))
        stats["generated"] += len(images)
        stats["batches"] += 1

        pred = probs.argmax(axis=-1)
        conf = probs.max(axis=-1)
        accept = (pred == user_id) & (conf > cfg.confidence_threshold)
        if cfg.min_margin is not None:
            top2 = np.sort(probs, axis=-1)[:, -2]
            accept &= (conf - top2) >= cfg.min_margin
        if cfg.pixel_range is not None:
            accept &= pixel_sanity(images, *cfg.pixel_range)
        # features once, on the full batch: one shape for every call, and the
        # prototype and diversity gates share them
        need_feats = feature_fn is not None and (
            (cfg.max_prototype_sim is not None and prototypes is not None)
            or cfg.min_diversity is not None)
        feats = np.asarray(feature_fn(x)) if need_feats else None
        if cfg.max_prototype_sim is not None and prototypes is not None and feature_fn:
            fn = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)
            pn = prototypes / np.maximum(np.linalg.norm(prototypes, axis=-1, keepdims=True), 1e-12)
            accept &= (fn @ pn.T).max(axis=-1) <= cfg.max_prototype_sim

        batch_kept = [images[i] for i in np.where(accept)[0]]
        if cfg.min_diversity is not None and feature_fn and batch_kept:
            if feature_diversity(feats[accept]) < cfg.min_diversity:
                batch_kept = batch_kept[: max(1, len(batch_kept) // 2)]
        kept.extend(batch_kept)
        stats["accepted"] = len(kept)

    kept = kept[: cfg.target_per_user]
    stats["accepted"] = len(kept)
    if save_dir and kept:
        user_dir = os.path.join(save_dir, f"user_{user_id:02d}")
        os.makedirs(user_dir, exist_ok=True)
        write_pngs(np.stack(kept),
                   [os.path.join(user_dir, f"{i:05d}.png") for i in range(len(kept))])
    stats["acceptance_rate"] = stats["accepted"] / max(stats["generated"], 1)
    if return_images:
        stats["images"] = np.stack(kept) if kept else np.zeros(
            (0,) + (images.shape[1:] if stats["batches"] else (0,)), np.uint8)
    return stats


def run(config_path: str, user_ids: Optional[List[int]] = None,
        filter_cfg: Optional[FilterConfig] = None, save_dir: str = "output/filtered_samples",
        classifier_ckpt: Optional[str] = None, overrides: tuple = (),
        device: str | torch.device = "cuda") -> Dict[int, Dict]:
    """DiT (``ckpt_path``) + VA-VAE + classifier over the users
    (``num_real_users`` of the config by default). The classifier is a
    baseline one of ``data.num_classes`` classes, as in the JAX package.
    Under a launcher (``parallel/mesh.py``) process r takes users r,
    r + world, … (each user's draws are seeded by its id, so together the
    processes write what one would) and returns its own users' results,
    once every process's files are written."""
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines.sample import (
        build_sample_fn,
        load_dit_params,
        load_latent_stats,
    )
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.parallel import mesh as mesh_lib
    from vavae_tpu_torch.utils.config import load_config, num_real_users

    dev = mesh_lib.multihost_init(device)
    cfg = load_config(config_path, overrides=overrides)
    filter_cfg = filter_cfg or FilterConfig()
    if filter_cfg.cfg_scale is not None:
        cfg.sample.cfg_scale = float(filter_cfg.cfg_scale)
    if not classifier_ckpt:
        raise ValueError(
            "classifier_ckpt is required: filtering against a random-init classifier accepts "
            "~nothing and burns the full max_batches×batch_size sampling budget per user "
            "(train one with apps.train_classifier and pass --classifier_ckpt)")
    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev)
    load_dit_params(model, cfg.ckpt_path)
    model.eval()
    # the de-normalisation stats the config asks for, or a refusal
    generate = build_sample_fn(cfg, model, load_latent_stats(cfg), device=dev)
    vae = VA_VAE(cfg.get("vae", {}).get("config"), ckpt_path=cfg.get("vae", {}).get("ckpt_path"),
                 img_size=cfg.data.image_size, device=dev)

    trainer = ClassifierTrainer(num_classes=cfg.data.num_classes, device=dev)
    state = restore_classifier(classifier_ckpt, trainer, trainer.init_state(0))
    classifier_fn, feature_fn = trainer.predict_fn(state), trainer.feature_fn(state)

    if user_ids is None:
        user_ids = list(range(num_real_users(cfg)))
    user_ids = user_ids[mesh_lib.process_index()::mesh_lib.process_count()]
    seed = cfg.train.get("global_seed", 0)
    results = {}
    for uid in user_ids:
        gen = torch.Generator(device=dev).manual_seed(step_seed(seed, uid))
        stats = generate_and_filter_for_user(
            uid, lambda g, labels: generate(labels, generator=g), vae.decode_to_images,
            classifier_fn, filter_cfg, gen, feature_fn=feature_fn, save_dir=save_dir)
        print(f"user {uid}: {stats}")
        results[uid] = stats
    mesh_lib.barrier()
    return results


def main(argv=None) -> Dict[int, Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--classifier_ckpt", default=None)
    ap.add_argument("--save_dir", default="output/filtered_samples")
    ap.add_argument("--users", default=None, help="comma-separated user ids")
    ap.add_argument("--target", type=int, default=800)
    ap.add_argument("--confidence", type=float, default=0.95)
    ap.add_argument("--batch_size", type=int, default=100)
    ap.add_argument("--cfg_scale", type=float, default=None,
                    help="override sample.cfg_scale (the reference app uses 12)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotlist config overrides")
    args = ap.parse_args(argv)
    users = [int(u) for u in args.users.split(",")] if args.users else None
    return run(args.config, user_ids=users,
               filter_cfg=FilterConfig(confidence_threshold=args.confidence,
                                       target_per_user=args.target, batch_size=args.batch_size,
                                       cfg_scale=args.cfg_scale),
               save_dir=args.save_dir, classifier_ckpt=args.classifier_ckpt,
               overrides=tuple(args.overrides), device=args.device)


if __name__ == "__main__":
    main()

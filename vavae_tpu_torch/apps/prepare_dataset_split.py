"""Micro-Doppler dataset split: a folder of user folders → a train/val JSON
(port of ``vavae_tpu/apps/prepare_dataset_split.py``).

Each user's images are split 8:2 by a permutation of
``np.random.default_rng(seed)`` (one stream for all users, in sorted user
order); the manifest is ``{"train": [{"path", "user_id"}], "val": [...],
"user_map": {folder: id}}``, and ``validate_split`` checks it for leaks.

    python -m vavae_tpu_torch.apps.prepare_dataset_split --data_root DIR [--output S.json]
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np

from vavae_tpu_torch.data.image_folder import IMG_EXTS


def create_dataset_split(data_root: str, output_file: str, train_ratio: float = 0.8,
                         seed: int = 42) -> dict:
    users = sorted(d for d in os.listdir(data_root) if os.path.isdir(os.path.join(data_root, d)))
    rng = np.random.default_rng(seed)
    split = {"train": [], "val": [], "user_map": {u: i for i, u in enumerate(users)}}
    for uid, user in enumerate(users):
        files = sorted(f for f in glob(os.path.join(data_root, user, "**", "*"), recursive=True)
                       if f.endswith(IMG_EXTS))
        order = rng.permutation(len(files))
        n_train = int(round(len(files) * train_ratio))
        for rank, idx in enumerate(order):
            entry = {"path": files[idx], "user_id": uid}
            (split["train"] if rank < n_train else split["val"]).append(entry)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "w") as f:
        json.dump(split, f, indent=2)
    return split


def validate_split(split_file: str) -> dict:
    """Counts of users, train and val entries and their per-user split;
    raises when a path is in both splits."""
    with open(split_file) as f:
        split = json.load(f)
    stats: dict = {"num_users": len(split.get("user_map", {})),
                   "train": len(split["train"]), "val": len(split["val"])}
    train_paths = {e["path"] for e in split["train"]}
    val_paths = {e["path"] for e in split["val"]}
    stats["overlap"] = len(train_paths & val_paths)
    if stats["overlap"]:
        raise ValueError(f"{split_file}: {stats['overlap']} paths in both train and val")
    per_user: dict = {}
    for e in split["train"]:
        per_user.setdefault(e["user_id"], [0, 0])[0] += 1
    for e in split["val"]:
        per_user.setdefault(e["user_id"], [0, 0])[1] += 1
    stats["per_user"] = per_user
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output", default="dataset_split.json")
    ap.add_argument("--train_ratio", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    split = create_dataset_split(args.data_root, args.output, args.train_ratio, args.seed)
    print(f"train {len(split['train'])}, val {len(split['val'])}, users {len(split['user_map'])}")
    print(validate_split(args.output))


if __name__ == "__main__":
    main()

"""Convert legacy ``.pt`` latent dumps into latent shards (port of
``vavae_tpu/apps/convert_latents.py``).

Reads ``{split}_latents.pt`` in any of the reference's layouts: a dict with
``latents`` (and ``user_ids``), a list of per-sample dicts keyed
``latent``/``tensor``/``latents`` (or their first tensor) with
``user_id``, a list of tensors, or one stacked (N, C, H, W) tensor (or one
(C, H, W) sample). Writes the channel mean and std over (N, H, W) as
``latents_stats.pt`` ((C, 1, 1) tensors, the reference's cache) and
``latents_stats.safetensors`` ((1, C, 1, 1), the port's), and shards of
``shard_size`` as ``latents_rank00_shard{k:03d}.safetensors`` holding
``latents``, ``latents_flip`` (equal to ``latents``: the dumps carry no
flip) and ``labels``. The reference writes all-zero labels whatever the
dump holds, and so does this by default; ``--use_labels`` keeps the user
ids. ``data/latent_dataset.ImgLatentDataset`` reads the result.

    python -m vavae_tpu_torch.apps.convert_latents --input_dir DIR --output_dir OUT
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from vavae_tpu_torch.utils.safetensors_io import write_safetensors


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return np.asarray(t, np.float32)
    return t.detach().cpu().to(torch.float32).numpy()


def load_legacy_latents(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A legacy latent dump in any accepted layout → (latents (N, C, H, W)
    float32, user ids (N,) int64 or None)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    user_ids: Optional[np.ndarray] = None
    if isinstance(data, dict):
        latents = data["latents"]
        if data.get("user_ids") is not None:
            user_ids = np.asarray(data["user_ids"], np.int64)
    elif isinstance(data, (list, tuple)):
        if not data:
            raise ValueError(f"{path}: empty latent list")
        if isinstance(data[0], dict):
            lat_list, uid_list = [], []
            for item in data:
                key = next((k for k in ("latent", "tensor", "latents") if k in item), None)
                if key is None:
                    key = next((k for k, v in item.items() if isinstance(v, torch.Tensor)), None)
                    if key is None:
                        continue  # the reference skips entries without a tensor
                lat_list.append(item[key])
                uid_list.append(int(item.get("user_id", 0)))
            latents = torch.stack([torch.as_tensor(t) for t in lat_list])
            user_ids = np.asarray(uid_list, np.int64)
        else:
            latents = torch.stack([torch.as_tensor(t) for t in data])
    else:
        latents = data.unsqueeze(0) if data.dim() == 3 else data
    lat = _to_numpy(latents)
    if lat.ndim != 4:
        raise ValueError(f"{path}: expected [N,C,H,W] latents, got {lat.shape}")
    if user_ids is not None and len(user_ids) != len(lat):
        raise ValueError(f"{path}: {len(user_ids)} user_ids for {len(lat)} latents")
    return lat, user_ids


def convert_split(input_dir: str, output_dir: str, split: str, shard_size: int = 1000,
                  use_labels: bool = False) -> int:
    """``{input_dir}/{split}_latents.pt`` → the stats caches and shards in
    ``output_dir``; returns the number of shards."""
    src = os.path.join(input_dir, f"{split}_latents.pt")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    os.makedirs(output_dir, exist_ok=True)
    latents, user_ids = load_legacy_latents(src)
    n = len(latents)
    mean = latents.mean(axis=(0, 2, 3), keepdims=True)  # (1, C, 1, 1)
    std = latents.std(axis=(0, 2, 3), keepdims=True, ddof=1)
    torch.save({"mean": torch.from_numpy(mean[0]), "std": torch.from_numpy(std[0])},
               os.path.join(output_dir, "latents_stats.pt"))
    write_safetensors(os.path.join(output_dir, "latents_stats.safetensors"),
                      {"mean": mean, "std": std})
    labels = (user_ids.astype(np.int64) if use_labels and user_ids is not None
              else np.zeros(n, np.int64))
    shards = 0
    for start in range(0, n, shard_size):
        chunk = latents[start:start + shard_size]
        write_safetensors(
            os.path.join(output_dir, f"latents_rank00_shard{shards:03d}.safetensors"),
            {"latents": chunk, "latents_flip": chunk, "labels": labels[start:start + shard_size]})
        shards += 1
    print(f"{split}: {n} latents -> {shards} shards in {output_dir}")
    return shards


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_dir", default="./latents", help="dir holding {train,val}_latents.pt")
    ap.add_argument("--output_dir", default="./latents_safetensors")
    ap.add_argument("--splits", default="train,val")
    ap.add_argument("--shard_size", type=int, default=1000)
    ap.add_argument("--use_labels", action="store_true",
                    help="keep the user ids as labels (the reference writes zeros)")
    args = ap.parse_args(argv)
    for split in [s for s in args.splits.split(",") if s]:
        convert_split(args.input_dir, os.path.join(args.output_dir, split), split,
                      shard_size=args.shard_size, use_labels=args.use_labels)
    print(f"done; point data_path at {os.path.join(args.output_dir, 'train')}")


if __name__ == "__main__":
    main()

"""Latent extraction (port of ``vavae_tpu/pipelines/extract_features.py``):
VAE-encode an image folder into safetensors shards.

Two passes, the images and their horizontal flips, are encoded with a
posterior draw and written as shards ``{latents, latents_flip, labels}`` of
at most ``shard_size`` images, CHW fp32 latents and int32 labels, named
``latents_rank{r:02d}_shard{k:03d}.safetensors`` as the JAX package names
them; then ``ImgLatentDataset`` builds the channel-stats cache. The draws
come from one ``torch.Generator`` seeded with ``seed + rank`` (the JAX key
stream cannot be replayed). Under a launcher (``parallel/mesh.py``)
process r encodes items r, r + world, …; once every process has written its
shards, process 0 builds the statistics over all of them. A prefetch thread decodes and crops, and batch
i+1's encode is queued on the card before batch i is copied back.

    python -m vavae_tpu_torch.pipelines.extract_features --data_path IMAGES \\
        --output_path LATENTS [--vae_ckpt CKPT] [--dtype fp32|bf16] [--device cuda]

Images are PNG, JPEG, WebP, BMP, GIF, TIFF, PNM, ICO or CUR, read by the
port (``utils/png.py:read_image_rgb``), or, with PIL installed, any other
type PIL reads. Before anything is encoded, every file is checked on its
headers (``utils/png.py:refused_images``), and the files the port's
decoders refuse, and without PIL the files that would need it, are listed
in one error.
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Iterator, List, Tuple

import numpy as np
import torch

from vavae_tpu_torch.data.image_folder import IMG_EXTS, SplitFileDataset
from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
from vavae_tpu_torch.data.prefetch import prefetch
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.tokenizer import VA_VAE, preprocess_images
from vavae_tpu_torch.utils.png import read_image_rgb, refused_images
from vavae_tpu_torch.utils.safetensors_io import write_safetensors

def list_image_folder(root: str) -> List[Tuple[str, int]]:
    """ImageFolder semantics: class-per-subdir, sorted class names → ids."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    items: List[Tuple[str, int]] = []
    for ci, cname in enumerate(classes):
        for path in sorted(glob(os.path.join(root, cname, "*"))):
            if path.endswith(IMG_EXTS):
                items.append((path, ci))
    return items


def iter_batches(
    items: List[Tuple[str, int]], batch_size: int, image_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(images, flipped images, labels): (B, S, S, 3) float32 in [-1, 1]
    twice and (B,) int32."""
    for s in range(0, len(items), batch_size):
        chunk = items[s : s + batch_size]
        x = preprocess_images([read_image_rgb(p) for p, _ in chunk], image_size, hflip=False)
        x_flip = x[:, :, ::-1, :].copy()
        labels = np.array([l for _, l in chunk], np.int32)
        yield x, x_flip, labels


def _to_card(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device`` without waiting for the card: staged in
    pinned memory, copied asynchronously."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _Fetch:
    """A device result's copy back to the host, queued now and waited for
    (only it, not later work) when ``get`` is called."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = t, None

    def get(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


def extract(
    data_path: str,
    output_path: str,
    vae: VA_VAE,
    batch_size: int = 64,
    image_size: int = 256,
    shard_size: int = 10000,
    seed: int = 0,
    split_file: str | None = None,
    split: str = "train",
) -> None:
    os.makedirs(output_path, exist_ok=True)
    if split_file:
        # split-file driven extraction: user ids become labels
        items = SplitFileDataset(split_file, split, image_size=image_size, root=data_path).items
    else:
        items = list_image_folder(data_path)
    # every process checks every file, so all of them stop together
    refused = refused_images([p for p, _ in items])
    if refused:
        raise ValueError(f"{len(refused)} of {len(items)} images are JPEGs, WebP or BMP files "
                         "(or GIF, TIFF, PNM, ICO or other images) that neither the port's "
                         "decoders nor PIL decode here; nothing was encoded:\n"
                         + "\n".join(f"  {p}: {why}" for p, why in refused))
    rank = mesh_lib.process_index()
    items = items[rank::mesh_lib.process_count()]

    gen = torch.Generator(device=vae.device).manual_seed(seed + rank)
    lat_acc: list[np.ndarray] = []
    flip_acc: list[np.ndarray] = []
    lab_acc: list[np.ndarray] = []
    shard_idx = 0
    count = 0

    def flush():
        nonlocal shard_idx, lat_acc, flip_acc, lab_acc
        if not lab_acc:
            return
        fname = mesh_lib.process_fname("latents", ".safetensors", shard_idx)
        write_safetensors(os.path.join(output_path, fname), {
            # CHW, the reference shard format
            "latents": np.transpose(np.concatenate(lat_acc), (0, 3, 1, 2)),
            "latents_flip": np.transpose(np.concatenate(flip_acc), (0, 3, 1, 2)),
            "labels": np.concatenate(lab_acc),
        })
        print(f"saved {fname} ({sum(len(a) for a in lab_acc)} items)")
        shard_idx += 1
        lat_acc, flip_acc, lab_acc = [], [], []

    def collect(pending):
        nonlocal count
        z, zf, labels = pending
        lat_acc.append(z.get())
        flip_acc.append(zf.get())
        lab_acc.append(labels)
        count += len(labels)
        if sum(len(a) for a in lab_acc) >= shard_size:
            flush()

    pending = None
    for x, x_flip, labels in prefetch(iter_batches(items, batch_size, image_size)):
        z = _Fetch(vae.encode_images(_to_card(x, vae.device), generator=gen))
        zf = _Fetch(vae.encode_images(_to_card(x_flip, vae.device), generator=gen))
        if pending is not None:
            collect(pending)
        pending = (z, zf, labels)
    if pending is not None:
        collect(pending)
    flush()
    print(f"process {rank}: encoded {count} images")
    mesh_lib.barrier()  # every process's shards are on disk
    if rank == 0:
        ImgLatentDataset(output_path, latent_norm=True)  # builds the stats cache
        print("latent stats cached")
    mesh_lib.barrier()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="VAE-encode an image folder into latent shards")
    ap.add_argument("--config", default=None, help="tokenizer config yaml")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--vae_ckpt", default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--split_file", default=None,
                    help="split JSON (any reference layout); labels = user ids")
    ap.add_argument("--split", default="train")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="the encoder's compute dtype (stored latents stay fp32); fp32 "
                    "runs with TF32 off")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    vae = VA_VAE(args.config, ckpt_path=args.vae_ckpt, img_size=args.image_size,
                 dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
                 device=mesh_lib.multihost_init(args.device))
    extract(args.data_path, args.output_path, vae, batch_size=args.batch_size,
            image_size=args.image_size, split_file=args.split_file,
            split=args.split)


if __name__ == "__main__":
    main()

"""Fréchet Inception Distance (port of ``vavae_tpu/eval/fid.py``):
activation statistics, the Fréchet distance (scipy's ``sqrtm`` on the
host, with the usual eps fallback), PNG folders and ADM ``arr_0`` npz files
as image sources, precomputed ``mu``/``sigma`` npz files, and the ADM npz
packer. The Inception pass runs on the card unless ``device="cpu"``.

    python -m vavae_tpu_torch.eval.fid PATH1 PATH2 [--weights W.pth]
"""
from __future__ import annotations

import os
from glob import glob
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.png import read_image_rgb

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||μ1−μ2||² + Tr(Σ1 + Σ2 − 2√(Σ1Σ2)) with the standard eps fallback.
    (``sqrtm`` is called without ``disp``, which newer scipy no longer
    takes; the square root is the same.)"""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


class FIDExtractor:
    """InceptionV3-FID activations of uint8 or float [0, 1] image batches,
    every batch padded to ``batch_size`` (one shape on the card) and the
    padding dropped from the result."""

    def __init__(self, weights_path: Optional[str] = None, batch_size: int = 50,
                 device: str | torch.device = "cuda"):
        from vavae_tpu_torch.eval.inception import load_inception

        self.device = resolve_device(device)
        self.model = load_inception(weights_path, device=self.device)
        self.batch_size = batch_size

    @torch.inference_mode()
    def activations(self, images: Iterable[np.ndarray]) -> np.ndarray:
        """images: iterable of (B, H, W, 3) uint8 or float [0, 1] arrays."""
        out: list = []
        for batch in images:
            x = np.asarray(batch)
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0
            n = x.shape[0]
            if n < self.batch_size:
                x = np.concatenate([x, np.zeros((self.batch_size - n, *x.shape[1:]), x.dtype)])
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            out.append(self.model(x)[:n].cpu().numpy())
        if not out:
            raise ValueError("no images to extract activations from — empty folder/npz "
                             "or a wrong path")
        return np.concatenate(out)


def _iter_folder(path: str, batch_size: int, max_images: Optional[int]):
    files = sorted(f for f in glob(os.path.join(path, "*"))
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    if max_images:
        files = files[:max_images]
    for s in range(0, len(files), batch_size):
        yield np.stack([read_image_rgb(f) for f in files[s:s + batch_size]])


def _iter_npz(path: str, batch_size: int, max_images: Optional[int]):
    data = np.load(path)["arr_0"]  # ADM format (N, H, W, 3) uint8
    if max_images:
        data = data[:max_images]
    for s in range(0, len(data), batch_size):
        yield data[s:s + batch_size]


def _precomputed_stats(path: str):
    """(mu, sigma) when ``path`` is a precomputed stats npz, else None."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            if "mu" in f and "sigma" in f:
                return f["mu"], f["sigma"]
    return None


def compute_statistics_of_path(path: str, extractor: FIDExtractor,
                               max_images: Optional[int] = None):
    stats = _precomputed_stats(path)
    if stats is not None:
        return stats
    if path.endswith(".npz"):
        it = _iter_npz(path, extractor.batch_size, max_images)
    else:
        it = _iter_folder(path, extractor.batch_size, max_images)
    try:
        acts = extractor.activations(it)
    except ValueError as e:
        raise ValueError(f"{e}: {path!r}") from None
    return activation_statistics(acts)


def fid_given_paths(path1: str, path2: str, weights_path: Optional[str] = None,
                    batch_size: int = 50, max_images: Optional[int] = None,
                    device: str | torch.device = "cuda") -> float:
    """FID between two image folders / npz files. The extractor (and its
    weights) loads only when a path is not a precomputed stats npz."""
    stats = [_precomputed_stats(path1), _precomputed_stats(path2)]
    if not all(s is not None for s in stats):
        ex = FIDExtractor(weights_path, batch_size, device=device)
        for i, (s, p) in enumerate(zip(stats, (path1, path2))):
            if s is None:
                stats[i] = compute_statistics_of_path(p, ex, max_images)
    (mu1, s1), (mu2, s2) = stats
    return frechet_distance(mu1, s1, mu2, s2)


def fid_folder_vs_npz(folder: str, npz_path: str, **kw) -> float:
    return fid_given_paths(folder, npz_path, **kw)


def create_npz_from_sample_folder(folder: str, num: int = 50000,
                                  out: Optional[str] = None) -> str:
    """Pack the ``%06d.png`` samples 0..num-1 into an ADM ``arr_0`` npz,
    written to ``out`` (default ``{folder}.npz``)."""
    arr = np.stack([read_image_rgb(os.path.join(folder, f"{i:06d}.png")) for i in range(num)])
    out = out or f"{folder}.npz"
    np.savez(out, arr_0=arr)
    return out


def main(argv=None) -> None:
    """FID between two folders / npz files; ``--save_npz`` packs a sample
    folder into an ADM npz, ``--save_stats`` writes one path's mu/sigma."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("paths", nargs="*", help="two image folders / npz files (arr_0 or mu+sigma)")
    ap.add_argument("--batch_size", type=int, default=50)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--weights", default=None,
                    help="FID InceptionV3 torch weights (default: $VAVAE_FID_WEIGHTS)")
    ap.add_argument("--save_stats", default=None,
                    help="compute mu/sigma of paths[0] and write them to this npz instead of "
                         "computing a FID")
    ap.add_argument("--save_npz", default=None,
                    help="pack the %%06d.png folder paths[0] into an ADM arr_0 npz instead "
                         "of a FID")
    ap.add_argument("--num", type=int, default=50000, help="image count for --save_npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.save_npz:
        if len(args.paths) != 1:
            ap.error("--save_npz takes exactly one sample folder")
        create_npz_from_sample_folder(args.paths[0], num=args.num, out=args.save_npz)
        print(f"saved {args.num} samples to {args.save_npz}")
        return
    if args.save_stats:
        if len(args.paths) != 1:
            ap.error("--save_stats takes exactly one image folder / npz")
        ex = FIDExtractor(args.weights, args.batch_size, device=args.device)
        mu, sigma = compute_statistics_of_path(args.paths[0], ex, args.max_images)
        np.savez(args.save_stats, mu=mu, sigma=sigma)
        print(f"saved statistics of {args.paths[0]} to {args.save_stats}")
        return
    if len(args.paths) != 2:
        ap.error("need exactly two paths to compute a FID")
    score = fid_given_paths(args.paths[0], args.paths[1], weights_path=args.weights,
                            batch_size=args.batch_size, max_images=args.max_images,
                            device=args.device)
    print(f"FID: {score:.6f}")


if __name__ == "__main__":
    main()

"""Tokenizer reconstruction evaluation: PSNR, SSIM, LPIPS and rFID (port of
``vavae_tpu/pipelines/evaluate_tokenizer.py``).

Encodes and decodes an image folder, computes PSNR, SSIM and LPIPS on the
card on the [0, 1] pairs, writes the reference and decoded PNGs
(``ref/{rank:02d}_{i:06d}.png``, ``dec/…``) and the rFID between the two
folders. LPIPS is skipped without its weights, rFID without Inception
weights, as in the JAX package. Under a launcher (``parallel/mesh.py``)
process r takes items r, r + world, …; the metrics are the ranks' summed
(value, count) pairs, all-gathered, and process 0 computes the rFID once
every process's PNGs are on disk.

    python -m vavae_tpu_torch.pipelines.evaluate_tokenizer --data_path IMAGES \\
        [--output_path OUT] [--vae_ckpt CKPT] [--metrics_json M.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.eval.metrics import psnr, ssim
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.pipelines.extract_features import iter_batches, list_image_folder
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.utils.png import write_pngs

def evaluate_tokenizer(
    vae: VA_VAE,
    data_path: str,
    output_path: Optional[str] = None,
    max_images: Optional[int] = None,
    batch_size: int = 16,
    image_size: int = 256,
    lpips_weights: Optional[str] = None,
    fid_weights: Optional[str] = None,
    sample_posterior: bool = True,
    seed: int = 0,
) -> dict:
    items = list_image_folder(data_path)
    if max_images:
        items = items[:max_images]
    rank = mesh_lib.process_index()
    items = items[rank::mesh_lib.process_count()]
    if not items:
        raise ValueError(f"no images for process {rank} — empty or wrong --data_path "
                         f"{data_path!r}, or max_images below the process count")

    lpips_fn = None
    try:
        from vavae_tpu_torch.models.lpips import load_lpips

        lpips_fn = load_lpips(lpips_weights, device=vae.device)
    except FileNotFoundError:
        pass

    if output_path:
        os.makedirs(os.path.join(output_path, "ref"), exist_ok=True)
        os.makedirs(os.path.join(output_path, "dec"), exist_ok=True)

    gen = torch.Generator(device=vae.device).manual_seed(seed)
    psnrs, ssims, lpips_vals = [], [], []
    n_done = 0
    for x, _, _ in iter_batches(items, batch_size, image_size):
        if sample_posterior:
            z = vae.encode_images(x, generator=gen)
        else:
            z = vae.encode_moments(x).mode()
        dec = vae.decode(z).float().cpu().numpy()  # [-1, 1]

        a01 = np.clip((x + 1.0) / 2.0, 0, 1)
        b01 = np.clip((dec + 1.0) / 2.0, 0, 1)
        a, b = (torch.from_numpy(v).to(vae.device) for v in (a01, b01))
        psnrs.append(psnr(a, b, data_range=1.0).cpu().numpy())
        ssims.append(ssim(a, b, data_range=1.0).cpu().numpy())
        if lpips_fn is not None:
            with torch.no_grad():
                lp = lpips_fn(torch.from_numpy(x).to(vae.device), torch.from_numpy(dec).to(vae.device))
            lpips_vals.append(lp.cpu().numpy())

        if output_path:
            names = [f"{rank:02d}_{n_done + i:06d}.png" for i in range(len(x))]
            for folder, img01 in (("ref", a01), ("dec", b01)):
                write_pngs((img01 * 255).astype(np.uint8),
                           [os.path.join(output_path, folder, n) for n in names])
        n_done += len(x)

    # the ranks' (value, count) sums, all-gathered: a size-weighted mean
    sums = np.asarray([
        np.concatenate(psnrs).sum(), np.concatenate(ssims).sum(),
        np.concatenate(lpips_vals).sum() if lpips_vals else 0.0,
        float(n_done), float(sum(len(v) for v in lpips_vals)),
    ], np.float64)
    sums = mesh_lib.process_allgather(sums).sum(axis=0)
    results = {
        "psnr": float(sums[0] / sums[3]),
        "ssim": float(sums[1] / sums[3]),
        "num_images": int(sums[3]),
    }
    if sums[4] > 0:
        results["lpips"] = float(sums[2] / sums[4])
    if output_path:
        mesh_lib.barrier()  # every process's PNGs are on disk
    if output_path and rank == 0:
        try:
            from vavae_tpu_torch.eval.fid import fid_given_paths

            results["rfid"] = fid_given_paths(
                os.path.join(output_path, "ref"),
                os.path.join(output_path, "dec"),
                weights_path=fid_weights,
                device=vae.device,
            )
        except FileNotFoundError:
            pass
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Reconstruction metrics of a VA-VAE")
    ap.add_argument("--config", default=None)
    ap.add_argument("--vae_ckpt", default=None)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--metrics_json", default=None,
                    help="also write the results as JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    vae = VA_VAE(args.config, ckpt_path=args.vae_ckpt, img_size=args.image_size,
                 device=mesh_lib.multihost_init(args.device))
    results = evaluate_tokenizer(vae, args.data_path, output_path=args.output_path,
                                 max_images=args.max_images, image_size=args.image_size)
    print(results)
    if args.metrics_json and mesh_lib.process_index() == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.metrics_json)), exist_ok=True)
        with open(args.metrics_json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()

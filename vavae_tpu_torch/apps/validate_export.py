"""VA-VAE validation and export tools (port of
``vavae_tpu/apps/validate_export.py``).

  - ``per_user_reconstruction``: PSNR and SSIM per user over a split;
  - ``vf_alignment_check``: cosine between the projected latents (the VF
    projector ``gen_params|proj|kernel`` of a training checkpoint) and the
    frozen foundation model's features, the feature grid resized to the
    latent grid where they differ (JAX's ``jax.image.resize`` "linear",
    antialiased when it shrinks: ``linear_resize``);
  - ``latent_user_discrimination``: between/within distance ratio and a
    nearest-centroid accuracy of the per-user latents;
  - ``latent_statistics``: channel mean and std (reference layout);
  - ``load_trained_vae``: the generator of a ``train_vavae`` checkpoint,
    rebuilt from its training config;
  - ``export_encoder``: ``{encoder, quant_conv}`` in the JAX layout as
    flax's msgpack (``utils/msgpack_io.py``), for DiT latent extraction.

Runs on the card unless ``--device cpu``.

    python -m vavae_tpu_torch.apps.validate_export --split_file S.json [--vae_config CFG]
        [--vae_ckpt CKPT] [--train_ckpt T --train_config TC --vf_kind K]
        [--export_encoder enc.msgpack] [--out report.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vavae_tpu_torch.eval.metrics import psnr, ssim
from vavae_tpu_torch.utils.device import full_fp32, resolve_device
from vavae_tpu_torch.utils.msgpack_io import write_msgpack
from vavae_tpu_torch.utils.weights import vae_state_to_jax


@torch.no_grad()
def per_user_reconstruction(vae, dataset, num_users: int, batch_size: int = 16,
                            max_per_user: int = 32) -> Dict[int, Dict[str, float]]:
    """PSNR and SSIM of the posterior mode's reconstruction, per user, over
    at most ``max_per_user`` images of each."""
    by_user: Dict[int, list] = {u: [] for u in range(num_users)}
    for img, label in (dataset[i] for i in range(len(dataset))):
        if len(by_user.setdefault(int(label), [])) < max_per_user:
            by_user[int(label)].append(img)
    results = {}
    for uid, imgs in by_user.items():
        if not imgs:
            continue
        x = torch.as_tensor(np.stack(imgs), device=vae.device)
        dec = vae.decode(vae.encode_moments(x).mode()).float()
        a = torch.clamp((x + 1) / 2, 0, 1)
        b = torch.clamp((dec + 1) / 2, 0, 1)
        results[uid] = {"psnr": psnr(a, b, 1.0).mean().item(),
                        "ssim": ssim(a, b, 1.0).mean().item(), "n": len(imgs)}
    return results


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.scale_and_translate``'s triangle
    kernel (scale n_out / n_in, no translation), widened by the inverse
    scale when shrinking (the antialias), columns normalised."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def linear_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) → (B, h, w, C): ``jax.image.resize(method="linear")``,
    antialiased when it shrinks."""
    wh = torch.as_tensor(_linear_weights(x.shape[1], size[0]), device=x.device)
    ww = torch.as_tensor(_linear_weights(x.shape[2], size[1]), device=x.device)
    with full_fp32():
        return torch.einsum("bhwc,hH,wW->bHWc", x.float(), wh, ww)


@torch.no_grad()
def vf_alignment_check(vae, proj_kernel, aux_feature_fn: Callable, images) -> Dict[str, float]:
    """Channel cosine between the projected latents and the foundation
    features: mean, min and the share above 0.5."""
    x = torch.as_tensor(images, device=vae.device)
    z = vae.encode_moments(x).mode()
    kernel = torch.as_tensor(np.array(proj_kernel, np.float32)[0, 0], device=z.device)
    with full_fp32():
        z_proj = torch.einsum("bhwc,cd->bhwd", z.float(), kernel)
    aux = aux_feature_fn(x).float()
    if aux.shape[1:3] != z_proj.shape[1:3]:
        # the latent grid (image/16) and the foundation grid (224/14 = 16)
        # agree at the production 256 px
        aux = linear_resize(aux, tuple(z_proj.shape[1:3]))
    zf = z_proj / torch.clamp(z_proj.norm(dim=-1, keepdim=True), min=1e-12)
    af = aux / torch.clamp(aux.norm(dim=-1, keepdim=True), min=1e-12)
    cos = (zf * af).sum(dim=-1)
    return {"mean_cosine": cos.mean().item(), "min_cosine": cos.min().item(),
            "frac_above_0.5": (cos > 0.5).float().mean().item()}


class TrainedEncoder:
    """``encode_moments`` over the generator of a training checkpoint."""

    def __init__(self, model, device: torch.device):
        self.model, self.device = model, device

    @torch.no_grad()
    def encode_moments(self, images):
        with full_fp32():
            return self.model.encode(torch.as_tensor(images, device=self.device))


def load_trained_vae(train_config: str, train_ckpt: str,
                     device: str | torch.device = "cuda") -> TrainedEncoder:
    """The generator of a ``train_vavae`` checkpoint, rebuilt from the full
    ``ddconfig`` of its training config (so any architecture validates, not
    only the f16d32 facade's)."""
    from vavae_tpu_torch.models.vae import vae_from_ddconfig
    from vavae_tpu_torch.train.checkpoint import read_state_file
    from vavae_tpu_torch.utils.config import load_config
    from vavae_tpu_torch.utils.safetensors_io import unflatten
    from vavae_tpu_torch.utils.weights import vae_state_from_jax

    dev = resolve_device(device)
    p = load_config(train_config).model.params
    model = vae_from_ddconfig(p.embed_dim, p.ddconfig)
    prefix = "gen_params|vae|"
    flat = {k[len(prefix):]: v for k, v in read_state_file(train_ckpt).items()
            if k.startswith(prefix)}
    if not flat:
        raise ValueError(f"{train_ckpt} carries no gen_params/vae leaves")
    model.load_state_dict(vae_state_from_jax(unflatten(flat)), strict=True)
    return TrainedEncoder(model.to(dev).eval(), dev)


def load_vf_projector(train_ckpt: str) -> Optional[np.ndarray]:
    """The VF projector kernel (1, 1, E, D) of a training checkpoint, or
    None when the run trained without VF."""
    from vavae_tpu_torch.train.checkpoint import read_state_file

    return read_state_file(train_ckpt).get("gen_params|proj|kernel")


def latent_user_discrimination(latents: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Between/within distance ratio of the per-user latent clusters and a
    nearest-centroid accuracy."""
    flat = latents.reshape(len(latents), -1)
    users = np.unique(labels)
    centroids = np.stack([flat[labels == u].mean(axis=0) for u in users])
    within = np.mean([np.linalg.norm(flat[labels == u] - c, axis=-1).mean()
                      for u, c in zip(users, centroids)])
    d_cc = np.linalg.norm(centroids[:, None] - centroids[None], axis=-1)
    between = d_cc[np.triu_indices(len(users), 1)].mean() if len(users) > 1 else 0.0
    d = np.linalg.norm(flat[:, None] - centroids[None], axis=-1)
    pred = users[d.argmin(axis=-1)]
    return {"between_within_ratio": float(between / max(within, 1e-12)),
            "nearest_centroid_acc": float((pred == labels).mean())}


def latent_statistics(latents_nhwc: np.ndarray) -> Dict[str, np.ndarray]:
    """Channel stats over (batch, h, w), in the reference's (1, C, 1, 1)
    layout, and the global mean and std."""
    mean = latents_nhwc.mean(axis=(0, 1, 2))
    std = latents_nhwc.std(axis=(0, 1, 2), ddof=1)
    return {"mean": mean.astype(np.float32).reshape(1, -1, 1, 1),
            "std": std.astype(np.float32).reshape(1, -1, 1, 1),
            "global_mean": np.float32(latents_nhwc.mean()),
            "global_std": np.float32(latents_nhwc.std())}


def export_encoder(vae, out_path: str) -> str:
    """``{encoder, quant_conv}`` of ``vae.model`` in the JAX layout, as the
    bytes ``flax.serialization.to_bytes`` writes."""
    tree = vae_state_to_jax(vae.model.state_dict())
    write_msgpack(out_path, {"encoder": tree["encoder"], "quant_conv": tree["quant_conv"]})
    return out_path


def main(argv=None) -> dict:
    from vavae_tpu_torch.data.image_folder import SplitFileDataset
    from vavae_tpu_torch.pipelines.train_vavae import make_aux_feature_fn
    from vavae_tpu_torch.tokenizer import VA_VAE

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split_file", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--vae_config", default=None)
    ap.add_argument("--vae_ckpt", default=None)
    ap.add_argument("--num_users", type=int, default=31)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--max_per_user", type=int, default=32)
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--export_encoder", default=None,
                    help="write a standalone encoder+quant_conv msgpack here")
    ap.add_argument("--train_ckpt", default=None,
                    help="train_vavae checkpoint carrying the VF projector (gen_params/proj): "
                         "enables the VF alignment check")
    ap.add_argument("--vf_kind", default="dinov2",
                    choices=["dinov2", "mae", "dinov2-tiny", "mae-tiny"],
                    help="foundation net; -tiny = the weight-free smoke testbed")
    ap.add_argument("--train_config", default=None,
                    help="training config of --train_ckpt: rebuilds the trained generator "
                         "for the VF check")
    ap.add_argument("--allow_random_foundation", action="store_true",
                    help="seeded random foundation weights when VAVAE_*_WEIGHTS is unset "
                         "(plumbing runs only: the scores mean nothing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.train_config and not args.train_ckpt:
        ap.error("--train_config only applies to the VF check and requires --train_ckpt "
                 "(the projector lives in the training checkpoint)")
    dev = resolve_device(args.device)
    vae = VA_VAE(args.vae_config, ckpt_path=args.vae_ckpt, img_size=args.image_size, device=dev)
    ds = SplitFileDataset(args.split_file, args.split, image_size=args.image_size)

    recon = per_user_reconstruction(vae, ds, args.num_users, max_per_user=args.max_per_user)
    imgs, labels = zip(*(ds[i] for i in range(len(ds))))
    x = np.stack(imgs)
    lab = np.asarray(labels, np.int64)
    latents = np.concatenate([vae.encode_moments(x[s:s + 32]).mode().float().cpu().numpy()
                              for s in range(0, len(x), 32)])
    disc = latent_user_discrimination(latents, lab)
    stats = latent_statistics(latents)
    report = {
        "per_user_reconstruction": recon,
        "latent_user_discrimination": disc,
        "latent_stats": {"global_mean": float(stats["global_mean"]),
                         "global_std": float(stats["global_std"]),
                         "channel_mean_first8": stats["mean"].reshape(-1)[:8].tolist()},
    }
    if args.train_ckpt:
        proj = load_vf_projector(args.train_ckpt)
        if proj is None:
            print("no VF projector in the training checkpoint (trained without VF) — "
                  "skipping VF alignment"
                  + (" (and the --train_config generator rebuild)" if args.train_config else ""))
        else:
            foundation, _ = make_aux_feature_fn(args.vf_kind,
                                                allow_random=args.allow_random_foundation,
                                                device=dev)
            enc = (load_trained_vae(args.train_config, args.train_ckpt, dev)
                   if args.train_config else vae)
            vf = vf_alignment_check(enc, proj, foundation, x[:32])
            report["vf_alignment"] = vf
            print(f"VF alignment: mean cosine {vf['mean_cosine']:.3f}, "
                  f"frac>0.5 {vf['frac_above_0.5']:.2f}")
    mean_psnr = np.mean([r["psnr"] for r in recon.values()]) if recon else float("nan")
    print(f"users {len(recon)}: mean psnr {mean_psnr:.2f}, between/within "
          f"{disc['between_within_ratio']:.3f}, centroid acc {disc['nearest_centroid_acc']:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.out}")
    if args.export_encoder:
        print(f"encoder exported to {export_encoder(vae, args.export_encoder)}")
    return report


if __name__ == "__main__":
    main()

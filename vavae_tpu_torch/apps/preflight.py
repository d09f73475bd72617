"""Preflight doctor: check a training or sampling config before spending
card time on it (port of ``vavae_tpu/apps/preflight.py``).

Checks, each a line ``[status] name  detail`` with status ok, warn or FAIL:
the latent-size arithmetic and patch divisibility, the class count, the
DiT's build and one forward on the configured latent shape (on the card
unless ``--device cpu``), the latent dataset's sample shape and first label,
the weight files the config names (safetensors headers read by
``utils/safetensors_io.py``), and with ``--verify_outputs`` that the images
under a directory decode and are not blank. Exits 1 when a check FAILed;
warnings name the step that makes a missing artifact.

    python -m vavae_tpu_torch.apps.preflight --config CFG [--verify_outputs DIR]
        [--skip_forward] [--device cpu] [key.path=value ...]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.safetensors_io import read_header

Check = Tuple[str, str, str]  # (status, name, detail); status: ok | warn | FAIL


def check_config_consistency(cfg) -> List[Check]:
    """Latent size, patch divisibility and the class count."""
    out: List[Check] = []
    image_size = cfg.data.image_size
    downsample = cfg.get("vae", {}).get("downsample_ratio", 16)
    if image_size % downsample:
        out.append(("FAIL", "latent-size",
                    f"image_size {image_size} not divisible by downsample_ratio {downsample}"))
        return out
    latent = image_size // downsample
    out.append(("ok", "latent-size", f"{image_size}/{downsample} -> {latent}x{latent} latents"))
    model_type = cfg.model.get("model_type", "")
    patch = None
    if "/" in model_type:
        try:
            patch = int(model_type.rsplit("/", 1)[1])
        except ValueError:
            pass
    if patch is None:
        out.append(("warn", "patch-size", f"cannot parse patch size from model_type {model_type!r}"))
    elif latent % patch:
        out.append(("FAIL", "patch-size", f"latent {latent} not divisible by patch {patch}"))
    else:
        out.append(("ok", "patch-size", f"patch {patch} -> {(latent // patch) ** 2} tokens"))
    num_classes = cfg.data.get("num_classes", 0)
    if num_classes and num_classes > 0:
        out.append(("ok", "num-classes", f"{num_classes}"))
    else:
        out.append(("FAIL", "num-classes", f"invalid: {num_classes!r}"))
    return out


@torch.no_grad()
def check_model_forward(cfg, skip_forward: bool = False,
                        device: str | torch.device = "cuda") -> List[Check]:
    """Build the configured DiT on ``device`` and run one forward at batch 2
    on the configured latent shape: the velocity must come back in the
    input's shape."""
    from vavae_tpu_torch.models.dit import create_dit

    dev = resolve_device(device)
    out: List[Check] = []
    latent = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    try:
        model = create_dit(cfg.model, latent, cfg.data.num_classes, device=dev).eval()
    except Exception as e:  # noqa: BLE001 - reported, the doctor goes on
        out.append(("FAIL", "model-build", f"{type(e).__name__}: {e}"))
        return out
    out.append(("ok", "model-build", f"{cfg.model.get('model_type')} input_size={latent} "
                                     f"in_channels={model.in_channels}"))
    if skip_forward:
        out.append(("warn", "model-forward", "skipped (--skip_forward)"))
        return out
    try:
        x = torch.zeros((2, latent, latent, model.in_channels), device=dev)
        v = model(x, torch.zeros((2,), device=dev), torch.zeros((2,), dtype=torch.long, device=dev))
        n_params = sum(p.numel() for p in model.parameters())
        if v.shape != x.shape:
            out.append(("FAIL", "model-forward", f"output {tuple(v.shape)} != input {tuple(x.shape)}"))
        else:
            out.append(("ok", "model-forward",
                        f"{tuple(v.shape)} velocity field, {n_params:,} params on {dev}"))
    except Exception as e:  # noqa: BLE001
        out.append(("FAIL", "model-forward", f"{type(e).__name__}: {e}"))
    return out


def check_dataset(cfg) -> List[Check]:
    """The latent dataset loads, its samples have the model's input shape
    and its first label is in range."""
    out: List[Check] = []
    data_path = cfg.data.get("data_path")
    if not data_path or not os.path.exists(str(data_path)):
        out.append(("warn", "dataset",
                    f"data_path not found: {data_path!r} — run pipelines.extract_features first"))
        return out
    try:
        from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset

        ds = ImgLatentDataset(str(data_path), latent_norm=cfg.data.get("latent_norm", False),
                              latent_multiplier=cfg.data.get("latent_multiplier", 1.0))
        feats, labels = next(ds.batches(1, shuffle=False, epochs=1))
        latent = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
        # create_dit's default, so this check cannot contradict model-forward
        expected = (latent, latent, cfg.model.get("in_chans", 4))
        if tuple(feats.shape[1:]) != expected:
            out.append(("FAIL", "dataset-shape",
                        f"sample {tuple(feats.shape[1:])} != expected {expected}"))
        else:
            out.append(("ok", "dataset", f"{len(ds)} samples of {expected}"))
        num_classes, lab = cfg.data.num_classes, int(labels[0])
        if not 0 <= lab < num_classes:
            out.append(("FAIL", "dataset-labels", f"label {lab} outside [0, {num_classes})"))
        else:
            out.append(("ok", "dataset-labels", f"first label {lab}"))
    except Exception as e:  # noqa: BLE001
        out.append(("FAIL", "dataset", f"{type(e).__name__}: {e}"))
    return out


def check_weights(cfg) -> List[Check]:
    """The checkpoint and weight files the config names exist, and a
    ``.safetensors`` one has a readable header."""
    out: List[Check] = []
    candidates = {
        "train.weight_init": cfg.get("train", {}).get("weight_init"),
        "train.ckpt": cfg.get("train", {}).get("ckpt"),
        "ckpt_path": cfg.get("ckpt_path"),
        "vae.ckpt_path": cfg.get("vae", {}).get("ckpt_path"),
        "$VAVAE_VAE_WEIGHTS": os.environ.get("VAVAE_VAE_WEIGHTS"),
    }
    seen = False
    for key, path in candidates.items():
        if not path:
            continue
        seen = True
        path = str(path)
        if not os.path.exists(path):
            out.append(("warn", f"weights[{key}]", f"not found: {path}"))
            continue
        detail = f"{path} ({os.path.getsize(path) / 1e6:.1f} MB)"
        if path.endswith(".safetensors"):
            try:
                header, _ = read_header(path)
                detail += f", {len([k for k in header if k != '__metadata__'])} tensors"
            except Exception as e:  # noqa: BLE001
                out.append(("FAIL", f"weights[{key}]", f"unreadable safetensors {path}: {e}"))
                continue
        out.append(("ok", f"weights[{key}]", detail))
    if not seen:
        out.append(("warn", "weights", "no checkpoint keys in config (fresh init)"))
    return out


def check_outputs(out_dir: str) -> List[Check]:
    """The images under ``out_dir`` decode (PNG by the port's decoder) and
    are not blank."""
    from vavae_tpu_torch.utils.png import read_image_rgb

    out: List[Check] = []
    if not os.path.isdir(out_dir):
        out.append(("FAIL", "outputs", f"not a directory: {out_dir}"))
        return out
    images = sorted(os.path.join(r, f) for r, _, fs in os.walk(out_dir) for f in fs
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not images:
        out.append(("FAIL", "outputs", f"no images under {out_dir}"))
        return out
    bad, blank = [], []
    for p in images:
        try:
            if np.asarray(read_image_rgb(p)).std() < 1e-3:
                blank.append(p)
        except Exception:  # noqa: BLE001 - any decode failure counts the image as bad
            bad.append(p)
    if bad:
        out.append(("FAIL", "outputs", f"{len(bad)} undecodable: {bad[:3]}"))
    elif blank:
        out.append(("warn", "outputs",
                    f"{len(images)} images but {len(blank)} look blank (std≈0): {blank[:3]}"))
    else:
        out.append(("ok", "outputs", f"{len(images)} images decode"))
    return out


def run_preflight(cfg, verify_outputs: str | None = None, skip_forward: bool = False,
                  device: str | torch.device = "cuda") -> List[Check]:
    checks = check_config_consistency(cfg)
    if not any(s == "FAIL" for s, _, _ in checks):
        checks += check_model_forward(cfg, skip_forward=skip_forward, device=device)
    checks += check_dataset(cfg)
    checks += check_weights(cfg)
    if verify_outputs:
        checks += check_outputs(verify_outputs)
    return checks


def main(argv=None) -> None:
    from vavae_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--verify_outputs", default=None,
                    help="also verify generated images under this dir")
    ap.add_argument("--skip_forward", action="store_true", help="skip the model forward")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, overrides=args.overrides)
    checks = run_preflight(cfg, args.verify_outputs, args.skip_forward, device=args.device)
    width = max(len(n) for _, n, _ in checks)
    for status, name, detail in checks:
        print(f"[{status:>4}] {name:<{width}}  {detail}")
    fails = [n for s, n, _ in checks if s == "FAIL"]
    if fails:
        print(f"preflight FAILED: {', '.join(fails)}")
        sys.exit(1)
    print("preflight passed")


if __name__ == "__main__":
    main()

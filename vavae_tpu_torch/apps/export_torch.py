"""Export a checkpoint trained with the port (or the JAX package) to the
reference's torch formats (port of ``vavae_tpu/apps/export_torch.py``).

  - ``--kind dit``: a DiT train state (``.safetensors`` or legacy
    ``.msgpack``) → ``{"model", "ema", "steps"}`` ``.pt``, which the
    reference's inference (EMA preferred) and the port's
    ``load_dit_params`` read; RoPE q/k rows go back to the interleaved
    layout and the frozen ``pos_embed`` is added (``utils/torch_export.py``).
  - ``--kind vae``: a VA-VAE train state → ``{"state_dict"}`` ``.ckpt``
    with the reference AutoencoderKL names: the generator only, as the
    reference's inference loads no loss or discriminator.

A host-side file conversion: it needs no card.

    python -m vavae_tpu_torch.apps.export_torch --kind dit --config CFG --ckpt CKPT --out dit.pt
    python -m vavae_tpu_torch.apps.export_torch --kind vae --ckpt CKPT --out vae.ckpt
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.train.checkpoint import read_state_file
from vavae_tpu_torch.utils.config import load_config
from vavae_tpu_torch.utils.msgpack_io import load_state_tree
from vavae_tpu_torch.utils.safetensors_io import unflatten
from vavae_tpu_torch.utils.torch_export import dit_state_to_reference, vae_state_to_reference
from vavae_tpu_torch.utils.weights import dit_state_from_jax, vae_state_from_jax


def export_dit(config_path: str, ckpt_path: str, out: str, overrides=()) -> str:
    cfg = load_config(config_path, overrides=overrides)
    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device="meta")  # shapes only
    tree = load_state_tree(ckpt_path)
    if tree.get("params") is None or tree.get("ema_params") is None:
        raise SystemExit(f"{ckpt_path} holds no params/ema_params: expected a DiT train state")

    def to_reference(params) -> dict[str, torch.Tensor]:
        return dit_state_to_reference(dit_state_from_jax(params), model.patch_size,
                                      model.num_heads, model.use_rope, model.input_size)

    payload = {"model": to_reference(tree["params"]), "ema": to_reference(tree["ema_params"]),
               "steps": int(np.asarray(tree["step"]))}
    torch.save(payload, out)
    print(f"exported DiT (model+ema, step {payload['steps']}) to {out}")
    return out


def export_vae(ckpt_path: str, out: str) -> str:
    prefix = "gen_params|vae|"
    flat = {k[len(prefix):]: v for k, v in read_state_file(ckpt_path).items()
            if k.startswith(prefix)}
    if not flat:
        raise SystemExit(f"{ckpt_path} holds no gen_params|vae| leaves: expected a VA-VAE "
                         "train state from pipelines.train_vavae")
    sd = vae_state_to_reference(vae_state_from_jax(unflatten(flat)))
    torch.save({"state_dict": sd}, out)
    print(f"exported VAE ({len(sd)} tensors) to {out}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True, choices=["dit", "vae"])
    ap.add_argument("--ckpt", required=True, help="a train-state .safetensors (or .msgpack)")
    ap.add_argument("--out", required=True, help="torch .pt/.ckpt output path")
    ap.add_argument("--config", default=None, help="model config (required for --kind dit)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if not os.path.exists(args.ckpt):
        raise SystemExit(f"checkpoint not found: {args.ckpt}")
    if args.kind == "dit":
        if not args.config:
            raise SystemExit("--kind dit requires --config")
        export_dit(args.config, args.ckpt, args.out, args.overrides)
    else:
        export_vae(args.ckpt, args.out)


if __name__ == "__main__":
    main()

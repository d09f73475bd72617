"""Sampling pipeline: CFG sampling → VAE decode → PNG folder (+ FID).

Port of ``vavae_tpu/pipelines/sample.py``: EMA weights preferred, the ODE
samplers (euler, heun, ab2/ab3, dopri5; on the split-CFG program when the
interval gate is set, with euler's velocity caches and multistep there) or
the SDE sampler, latent un-normalisation (x·σ/multiplier + μ),
rank-interleaved PNG names, the demo grid, and the FID of the folder
against ``data.fid_reference_file``. Runs on the card unless
``device="cpu"``.

    python -m vavae_tpu_torch.pipelines.sample --config CFG.yaml --demo ckpt_path=CKPT
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
from vavae_tpu_torch.models.dit import LightningDiT, create_dit
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.parallel.mesh import process_index
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.transport import Sampler, build_transport
from vavae_tpu_torch.utils.config import Config, load_config
from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.png import encode_png, write_pngs
from vavae_tpu_torch.utils.msgpack_io import load_state_tree
from vavae_tpu_torch.utils.weights import dit_state_from_jax, dit_state_from_reference


def create_logger() -> logging.Logger:
    """The port's stdout logger; INFO on process 0, warnings only on the
    others (the JAX package logs on process 0)."""
    logger = logging.getLogger("vavae_tpu_torch")
    logger.setLevel(logging.INFO if process_index() == 0 else logging.WARNING)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
    return logger


def load_dit_params(model: LightningDiT, ckpt_path: str, prefer_ema: bool = True) -> None:
    """Load DiT weights into ``model``, EMA preferred: a JAX-package or port
    train state (``.safetensors``, or the JAX package's legacy ``.msgpack``
    with its RoPE-layout warning) through the weight bridge, or a reference
    torch ``.pt`` (``{"ema"|"model": state_dict}``) with the RoPE q/k rows
    moved to split-half order."""
    path = str(ckpt_path)
    if path.endswith((".safetensors", ".msgpack")):
        tree = load_state_tree(path)
        key = "ema_params" if prefer_ema and tree.get("ema_params") is not None else "params"
        sd = dit_state_from_jax(tree[key])
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        key = "ema" if prefer_ema and isinstance(ckpt, dict) and "ema" in ckpt else "model"
        raw = ckpt[key] if isinstance(ckpt, dict) and key in ckpt else ckpt
        sd = dit_state_from_reference(raw, model.num_heads, model.use_rope)
    model.load_state_dict(sd, strict=True)


def build_sample_fn(cfg: Config, model: LightningDiT, latent_stats=None, *,
                    device: str | torch.device = "cuda") -> Callable:
    """Returns generate(labels, generator=None, z=None, noise=None) ->
    un-normalised latents (B, h, w, C). ``z`` replaces the initial noise
    and, in SDE mode, ``noise`` the Wiener draws (``(num_sampling_steps -
    1, *x.shape)``, x the sampler's state: with CFG the concatenated
    [z | z]), so tests hand both packages the same draws; otherwise both
    are drawn from ``generator``."""
    dev = resolve_device(device)
    sc = cfg.sample
    sampler = Sampler(build_transport(cfg))
    cfg_scale = sc.get("cfg_scale", 1.0)
    use_cfg = cfg_scale > 1.0
    # CFG null label: num_classes, the row class dropout trains;
    # sample.null_class reproduces the reference micro-Doppler quirk
    null_class = sc.get("null_class", cfg.data.num_classes)
    mode = sc.get("mode", "ODE")
    method = sc.get("sampling_method", "euler").lower()
    interval_start = sc.get("cfg_interval_start", 0.0)
    use_split_cfg = (use_cfg and mode.upper() == "ODE" and method in ("euler", "heun", "dopri5")
                     and interval_start > 0.0)
    is_split_euler = use_split_cfg and method == "euler"
    # the euler-only acceleration knobs, which any other program ignores:
    # warned by name, as the JAX pipeline does
    euler_only = {
        "velocity_cache_interval": sc.get("velocity_cache_interval", 1) > 1,
        "velocity_cache_adaptive": bool(sc.get("velocity_cache_adaptive", False)),
        "multistep_order": sc.get("multistep_order", 1) > 1,
    }
    if any(euler_only.values()) and not is_split_euler:
        warnings.warn(
            f"sample.{'/'.join(k for k, v in euler_only.items() if v)} only applies on the "
            "split-CFG euler path (cfg_scale > 1, mode ODE, sampling_method euler, "
            f"cfg_interval_start > 0) — sampling will run plain {method} with no acceleration.",
            stacklevel=2,
        )
    is_sde = mode.upper() != "ODE"
    num_steps = sc.get("num_sampling_steps", 250)
    shift = sc.get("timestep_shift", 0.0)
    reverse = sc.get("reverse", False)
    if is_sde:
        sample_fn = sampler.sample_sde(
            sampling_method=sc.get("sampling_method", "Euler"),
            diffusion_form=sc.get("diffusion_form", "sigma"),
            diffusion_norm=sc.get("diffusion_norm", 1.0),
            last_step=sc.get("last_step", "Mean"),
            last_step_size=sc.get("last_step_size", 0.04),
            num_steps=num_steps,
        )
    elif use_split_cfg:
        # the JAX pipeline's knobs, names and defaults; the euler ones only on
        # the split-euler path
        euler_knobs = dict(
            cache_interval=sc.get("velocity_cache_interval", 1),
            cache_order=sc.get("velocity_cache_order", 1),
            multistep_order=sc.get("multistep_order", 1),
            cache_adaptive=bool(sc.get("velocity_cache_adaptive", False)),
            cache_tol=sc.get("velocity_cache_tol", 0.02),
            cache_max_interval=sc.get("velocity_cache_max_interval", 8),
        ) if is_split_euler else {}
        cfg_sample_fn = sampler.sample_ode_cfg(
            num_steps=num_steps, timestep_shift=shift, cfg_interval_start=interval_start,
            reverse=reverse, sampling_method=method, rtol=sc.get("rtol", 1e-3),
            atol=sc.get("atol", 1e-6), max_steps=sc.get("dopri5_max_steps", 1000),
            **euler_knobs,
        )
    else:
        sample_fn = sampler.sample_ode(
            sampling_method=method, num_steps=num_steps, atol=sc.get("atol", 1e-6),
            rtol=sc.get("rtol", 1e-3), max_steps=sc.get("dopri5_max_steps", 1000),
            reverse=reverse, timestep_shift=shift,
        )

    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    C = model.in_channels
    if latent_stats is not None:
        mean = torch.as_tensor(np.asarray(latent_stats[0]).reshape(1, 1, 1, -1), device=dev)
        std = torch.as_tensor(np.asarray(latent_stats[1]).reshape(1, 1, 1, -1), device=dev)
    else:
        mean = torch.zeros((1, 1, 1, C), device=dev)
        std = torch.ones((1, 1, 1, C), device=dev)
    multiplier = cfg.data.get("latent_multiplier", 1.0)

    def run(fn, x, model_fn, generator, noise):
        if is_sde:
            noise = None if noise is None else torch.as_tensor(noise, device=dev)
            return fn(x, model_fn, generator=generator, noise=noise)
        return fn(x, model_fn)

    @torch.inference_mode()
    def generate(labels, generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        labels = torch.as_tensor(labels, dtype=torch.long, device=dev)
        B = labels.shape[0]
        if z is None:
            z = torch.randn((B, latent_size, latent_size, C), generator=generator,
                            dtype=torch.float32, device=dev)
        else:
            z = torch.as_tensor(z, dtype=torch.float32, device=dev)
        if use_cfg:
            y_in = torch.cat([labels, torch.full_like(labels, null_class)])

            def model_fn(x, t):
                return model.forward_with_cfg(
                    x, t, y_in, cfg_scale,
                    cfg_interval=not use_split_cfg,
                    cfg_interval_start=interval_start,
                    cfg_channels=sc.get("cfg_channels"),
                )

            if use_split_cfg:
                samples = cfg_sample_fn(z, lambda x, t: model(x, t, labels), model_fn)
            else:
                samples = run(sample_fn, torch.cat([z, z], dim=0), model_fn, generator, noise)[:B]
        else:
            samples = run(sample_fn, z, lambda x, t: model(x, t, labels), generator, noise)
        return samples * std / multiplier + mean

    return generate


def load_latent_stats(cfg: Config):
    """(mean, std), each (1, C, 1, 1), when ``data.latent_norm`` is set, else
    None: ``ImgLatentDataset(data_path, latent_norm=True).latent_stats``, as
    the JAX function returns them. The dataset reads the cache beside the
    shards (``latents_stats.safetensors``, or a reference
    ``latents_stats.pt``) or computes the stats from the shards and writes
    the cache."""
    if not cfg.data.get("latent_norm", False):
        return None
    data_path = cfg.data.get("data_path")
    if not data_path or not os.path.isdir(data_path):
        raise FileNotFoundError(
            f"latent_norm: true but data.data_path is not a directory: {data_path!r} — "
            "point it at the extracted-latents dump that holds the stats cache, "
            "or set data.latent_norm: false"
        )
    return ImgLatentDataset(data_path, latent_norm=True).latent_stats


def demo_grid(imgs: np.ndarray, cols: int = 4) -> np.ndarray:
    n = len(imgs)
    cols = min(cols, n)
    rows = math.ceil(n / cols)
    S = imgs.shape[1]
    grid = np.zeros((rows * S, cols * S, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * S:(r + 1) * S, c * S:(c + 1) * S] = im
    return grid


def do_sample(cfg: Config, demo: bool = False, device: str | torch.device = "cuda") -> str:
    """Sample into ``sample_folder``. Under a launcher every process draws
    its own images from ``global_seed + rank`` and names them
    rank-interleaved, as the JAX package's ``:345-350``: batch i of rank r
    holds ``(i·world + r)·per_batch + j``. Returns once every process's
    images are on disk."""
    dev = mesh_lib.multihost_init(device)
    logger = create_logger()
    latent_stats = load_latent_stats(cfg)
    if not cfg.get("ckpt_path"):
        raise ValueError("ckpt_path is not set: sampling needs DiT weights")

    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev)
    load_dit_params(model, cfg.ckpt_path)
    model.eval()
    vae = VA_VAE(cfg.get("vae", {}).get("config"),
                 ckpt_path=cfg.get("vae", {}).get("ckpt_path"),
                 img_size=cfg.data.image_size, device=dev)
    generate = build_sample_fn(cfg, model, latent_stats, device=dev)

    sc = cfg.sample
    exp_name = cfg.train.get("exp_name", "samples")
    folder = cfg.get("sample_folder",
                     os.path.join(cfg.train.get("output_dir", "output"), f"{exp_name}_samples"))
    os.makedirs(folder, exist_ok=True)
    n_proc, rank = mesh_lib.process_count(), process_index()
    gen = torch.Generator(device=dev).manual_seed(cfg.train.get("global_seed", 0) + rank)

    if demo:
        labels = list(cfg.get("demo_labels", list(range(8))))
        imgs = vae.decode_to_images(generate(labels, generator=gen))
        out = os.path.join(folder, "demo_grid.png")
        if rank == 0:
            with open(out, "wb") as f:
                f.write(encode_png(demo_grid(imgs)))
            logger.info(f"saved demo grid to {out}")
        return folder

    per_batch = sc.get("per_proc_batch_size", 4)
    fid_num = sc.get("fid_num", 50000)
    total = int(math.ceil(fid_num / (per_batch * n_proc))) * per_batch * n_proc
    iters = total // (per_batch * n_proc)
    logger.info(f"sampling {total} images ({iters} iters × {per_batch}/proc)")
    for i in range(iters):
        labels = torch.randint(0, cfg.data.num_classes, (per_batch,), generator=gen, device=dev)
        imgs = vae.decode_to_images(generate(labels, generator=gen))
        base = (i * n_proc + rank) * per_batch
        write_pngs(imgs, [os.path.join(folder, f"{base + j:06d}.png") for j in range(len(imgs))])
        if (i + 1) % 50 == 0:
            logger.info(f"{(i + 1) * per_batch} images done on proc {rank}")
    mesh_lib.barrier()  # the folder is complete on return, every process's PNGs on disk
    return folder


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, overrides=args.overrides)
    folder = do_sample(cfg, demo=args.demo, device=args.device)
    if not args.demo and cfg.data.get("fid_reference_file"):
        if process_index() == 0:
            from vavae_tpu_torch.eval.fid import fid_folder_vs_npz

            score = fid_folder_vs_npz(folder, cfg.data.fid_reference_file,
                                      device=mesh_lib.multihost_init(args.device))
            print(f"FID: {score:.4f}")


if __name__ == "__main__":
    main()

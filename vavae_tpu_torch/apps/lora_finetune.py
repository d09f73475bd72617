"""LoRA finetuning CLI for a pretrained DiT (port of
``vavae_tpu/apps/lora_finetune.py``).

Loads a base checkpoint (EMA weights preferred; ``.safetensors``, the JAX
package's legacy ``.msgpack`` or a reference ``.pt``), puts rank-r adapters
on qkv/proj/w12/w3, trains only the adapters on the latent shards, and saves
the EMA adapters as a LoRA-only file ``lora_{steps:06d}.msgpack`` (the JAX
package's format). ``--export_merged`` also writes the merged weights as a
DiT train state ``{steps:07d}.safetensors`` (``params`` = ``ema_params`` =
the merge, no optimizer state), which both packages' samplers load. Runs on
the card unless ``--device cpu`` is passed; under torchrun (or the JAX
package's ``JAX_*`` variables) the processes train data-parallel, each
reading its rows of the global batch, and process 0 writes the files.

    python -m vavae_tpu_torch.apps.lora_finetune \\
        --config vavae_tpu_torch/configs/dit_s_microdoppler.yaml \\
        --base_ckpt dit.safetensors --rank 8 --alpha 16 --steps 2000
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.pipelines.sample import create_logger, load_dit_params
from vavae_tpu_torch.train.lora import lora_size, save_lora
from vavae_tpu_torch.train.lora_trainer import LoRATrainer
from vavae_tpu_torch.transport import build_transport
from vavae_tpu_torch.utils.config import load_config
from vavae_tpu_torch.utils.safetensors_io import flatten, tree_metadata, write_safetensors
from vavae_tpu_torch.utils.weights import dit_state_to_jax


def export_merged(out_dir: str, step: int, merged: dict[str, torch.Tensor]) -> str:
    """``{out_dir}/{step:07d}.safetensors``: the JAX ``TrainState(step,
    params=merged, ema_params=merged, opt_state=None)``, as the JAX
    package's ``save_checkpoint`` writes it."""
    tree = dit_state_to_jax({k: v for k, v in merged.items()})
    tensors = {"step": np.asarray(step)}
    tensors.update(flatten(tree, "params"))
    tensors.update(flatten(tree, "ema_params"))
    path = os.path.join(out_dir, f"{step:07d}.safetensors")
    write_safetensors(path, tensors, tree_metadata(none_keys=["opt_state"]))
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--base_ckpt", required=True,
                    help="pretrained DiT (.pt/.msgpack/.safetensors)")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--batch_size", type=int, default=None, help="global batch")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--export_merged", action="store_true",
                    help="also save base+LoRA merged weights for sampling")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = mesh_lib.multihost_init(args.device)
    mesh = mesh_lib.make_mesh()
    cfg = load_config(args.config, overrides=args.overrides)
    out_dir = args.out_dir or os.path.join(
        cfg.train.get("output_dir", "output"),
        f"{cfg.train.get('exp_name', 'exp')}_lora_r{args.rank}")
    logger = create_logger()

    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev)
    load_dit_params(model, args.base_ckpt, prefer_ema=True)
    seed = cfg.train.get("global_seed", 0)
    trainer = LoRATrainer(model, build_transport(cfg), rank=args.rank, alpha=args.alpha,
                          lr=args.lr, max_grad_norm=cfg.get("optimizer", {}).get("max_grad_norm"),
                          global_seed=seed, mesh=mesh)
    state = trainer.init_state()
    logger.info(f"LoRA r={args.rank}: {lora_size(state.lora) / 1e6:.2f}M trainable")

    dataset = ImgLatentDataset(cfg.data.data_path, latent_norm=cfg.data.get("latent_norm", False),
                               latent_multiplier=cfg.data.get("latent_multiplier", 1.0))
    batch_size = args.batch_size or cfg.train.get("global_batch_size", 16)
    world = mesh_lib.process_count()
    if batch_size % world:
        raise SystemExit(f"global batch {batch_size} must divide the process count ({world})")
    # each process's rows of the global batches one process would read
    it = dataset.batches(batch_size, seed=seed, rows=(mesh_lib.process_index(), world))
    log_every = cfg.train.get("log_every", 100)
    losses = []
    t0, running = time.time(), []
    for step in range(1, args.steps + 1):
        m = trainer.train_step(state, next(it))
        running.append(m["loss"])
        if step % log_every == 0:
            mean = torch.stack(running).mean().item()
            losses.append(mean)
            logger.info(f"(step={step:06d}) loss {mean:.4f}, "
                        f"{log_every / (time.time() - t0):.2f} it/s")
            t0, running = time.time(), []

    rank0 = mesh_lib.process_index() == 0
    os.makedirs(out_dir, exist_ok=True)
    lora_path = os.path.join(out_dir, f"lora_{args.steps:06d}.msgpack")
    if rank0:
        save_lora(lora_path, state.ema_lora)
        logger.info(f"saved LoRA-only checkpoint to {lora_path}")
    result = {"trainer": trainer, "state": state, "lora_path": lora_path, "losses": losses}
    if args.export_merged:
        merged = os.path.join(out_dir, f"{args.steps:07d}.safetensors")
        if rank0:
            merged = export_merged(out_dir, args.steps, trainer.merged_params(state))
            logger.info("saved merged weights for the sampling pipeline")
        result["merged_path"] = merged
    mesh_lib.barrier()  # the files are on disk for every process
    return result


if __name__ == "__main__":
    main()

"""Where the time of a training step goes, on the card.

    python -m vavae_tpu_torch.pipelines.profile_train [--batch 32] [--qknorm] [--out FILE.json]
    python -m vavae_tpu_torch.pipelines.profile_train --big_variant LightningDiT-1p6B/1 --batch 8

Profiles (torch.profiler, CUDA activity) ``DiTTrainer.train_step`` of
LightningDiT-XL/1 from the JAX init, with the production config's
``model:`` (bf16, remat "dots"), ``optimizer:``, ``transport:`` and EMA
settings, on seeded random latents. Prints the device time per step by
kernel class (the attention forward and backward kernels, matrix products,
the foreach list updates of AdamW and the EMA, everything else), the wall
time per step and the device's busy share. ``--qknorm`` profiles the model
with ``use_qknorm: true`` instead; ``--big_variant NAME`` the step of
``python -m vavae_tpu_torch big_variant NAME`` (its model and trainer,
``apps/big_variant.py``).
"""
from __future__ import annotations

import argparse
import json

import torch

from vavae_tpu_torch.apps import big_variant
from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.pipelines.profile_sample import XL1, profile
from vavae_tpu_torch.pipelines.train_dit import build_trainer
from vavae_tpu_torch.utils.config import Config
from vavae_tpu_torch.utils.device import resolve_device

TRAIN_CFG = {
    "model": dict(XL1, use_checkpoint=True, checkpoint_policy="dots"),
    "optimizer": {"lr": 0.0002, "beta2": 0.95},
    "transport": {"path_type": "Linear", "prediction": "velocity", "use_cosine_loss": True,
                  "use_lognorm": True},
    "train": {"max_steps": 80000, "global_seed": 0, "ema_decay": 0.9999},
    "data": {"num_classes": 1000},
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    model_arg = ap.add_mutually_exclusive_group()
    model_arg.add_argument("--qknorm", action="store_true",
                           help="the model with use_qknorm: true")
    model_arg.add_argument("--big_variant", metavar="NAME",
                           help="profile the big_variant command's step of this registry model "
                                "instead")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = Config(TRAIN_CFG).merged_with({"model": {"use_qknorm": args.qknorm}})
    if args.big_variant:
        model = big_variant.build_model(args.big_variant, dev)
        trainer = big_variant.build_trainer(model)
    else:
        model = create_dit(cfg.model, 16, cfg.data.num_classes, device=dev)
        trainer = build_trainer(cfg, model, steps_per_epoch=1, max_steps=cfg.train.max_steps)
    state = trainer.init_state()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.batch, 16, 16, 32), generator=gen, device=dev)
    y = torch.randint(0, cfg.data.num_classes, (args.batch,), generator=gen, device=dev)
    result = {"device": torch.cuda.get_device_name(0), "batch": args.batch, "qknorm": args.qknorm,
              "model": args.big_variant or cfg.model.model_type,
              "train_step": profile(lambda: trainer.train_step(state, (x, y)), reps=3)}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()

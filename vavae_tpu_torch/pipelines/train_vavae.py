"""VA-VAE training pipeline (port of ``vavae_tpu/pipelines/train_vavae.py``):
the epoch loop and the staged VF-alignment recipe.

``run_stages`` trains the stages in turn, each in ``{output_dir}/stage{k}``
with its own loss settings and learning rate and fresh optimizers, each
starting from the best-validation checkpoint of the one before. An
interrupted run resumes: a stage whose ``epoch.json`` (or, without it, its
count of checkpoints) says it is complete is skipped, a partial one restarts
at its next epoch from its newest checkpoint; ``resume=False`` refuses to
start over a stage directory that already holds checkpoints. The epoch loop
prefetches batches, logs ``epoch e step s: rec …, … it/s`` and
``metrics.jsonl``, writes input/reconstruction grids every
``train.log_images_every`` steps, validates at each epoch's end (the best
``val/rec_loss`` goes to ``best/`` with ``best/metric.json``), checkpoints
every epoch with ``epoch.json``, logs each epoch's duration and peak
device memory, and on SIGTERM checkpoints mid-epoch and stops. Checkpoints
are written in line. The stage-1 ``weight_init`` (or ``ckpt_path``) is a
train-state ``.safetensors`` (weights only, shape-checked) or a reference
``.ckpt``/``.pt``.

    python -m vavae_tpu_torch.pipelines.train_vavae --base VAE.yaml --data_path DIR
        [--val_path DIR] [--output_dir OUT] [--batch_size 8] [--stages official|single]
        [--no_resume] [--allow_random_foundation] [--device cuda] [key.path=value ...]

Runs on the card unless ``--device cpu`` is passed. The frozen nets load
from ``VAVAE_DINOV2_WEIGHTS`` / ``VAVAE_MAE_WEIGHTS`` (or seeded random
weights with ``--allow_random_foundation``) and ``VAVAE_LPIPS_WEIGHTS`` /
``VAVAE_VGG16_WEIGHTS`` (no perceptual loss without them).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from vavae_tpu_torch.data.image_folder import ImageFolderDataset
from vavae_tpu_torch.data.prefetch import prefetch
from vavae_tpu_torch.models.lpips import LPIPS, load_lpips
from vavae_tpu_torch.models.vae import vae_from_ddconfig
from vavae_tpu_torch.models.vit import FoundationModel
from vavae_tpu_torch.pipelines.sample import create_logger
from vavae_tpu_torch.tokenizer import reference_vae_state
from vavae_tpu_torch.train import checkpoint as ckpt_lib
from vavae_tpu_torch.train.vae_loss import VAELossConfig
from vavae_tpu_torch.train.vae_trainer import VAETrainer, VAETrainState
from vavae_tpu_torch.utils.config import Config, load_config
from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.image_grid import log_reconstructions
from vavae_tpu_torch.utils.metrics_logger import MetricsLogger
from vavae_tpu_torch.utils.preemption import PreemptionGuard

# the official 3-stage recipe (f16d32_vfdinov2_long.yaml)
OFFICIAL_STAGES = [
    dict(epochs=100, vf_weight=0.5, distmat_margin=0.0, cos_margin=0.0),
    dict(epochs=15, vf_weight=0.1, distmat_margin=0.0, cos_margin=0.0),
    dict(epochs=15, vf_weight=0.1, distmat_margin=0.25, cos_margin=0.5),
]
COMPUTE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                  "fp32": torch.float32, "float32": torch.float32}


def build_vae_trainer(cfg: Config, stage_overrides: Optional[dict] = None,
                      foundation: Optional[FoundationModel] = None,
                      lpips: Optional[LPIPS] = None, vf_dim: int = 1024,
                      device: str | torch.device = "cuda") -> VAETrainer:
    """A trainer over a fresh VAE built from the full ``ddconfig``, with the
    config's loss settings and a stage's overrides (``lr`` and ``epochs``
    are the stage's own)."""
    p = cfg.model.params
    lc = dict(p.lossconfig.params)
    if stage_overrides:
        lc.update({k: v for k, v in stage_overrides.items() if k not in ("epochs", "lr")})
    loss_cfg = VAELossConfig(
        disc_start=lc.get("disc_start", 5001),
        kl_weight=lc.get("kl_weight", 1e-6),
        disc_weight=lc.get("disc_weight", 0.5),
        vf_weight=lc.get("vf_weight", 0.1),
        adaptive_vf=lc.get("adaptive_vf", True),
        distmat_margin=lc.get("distmat_margin", 0.0),
        cos_margin=lc.get("cos_margin", 0.0),
        perceptual_weight=lc.get("perceptual_weight", 1.0 if lpips is not None else 0.0),
    )
    dtype_key = str(p.get("compute_dtype", "fp32"))
    if dtype_key not in COMPUTE_DTYPES:
        raise ValueError(f"model.params.compute_dtype={dtype_key!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    vae = vae_from_ddconfig(p.embed_dim, p.ddconfig).to(resolve_device(device))
    lr = (stage_overrides or {}).get("lr") or cfg.model.get("base_learning_rate", 1e-4)
    return VAETrainer(vae, loss_cfg=loss_cfg, lr=lr, use_vf=bool(p.get("use_vf")),
                      vf_dim=vf_dim, foundation=foundation, lpips=lpips,
                      frozen_bf16=p.get("frozen_bf16", True),
                      compute_dtype=COMPUTE_DTYPES[dtype_key])


def make_aux_feature_fn(kind: str, weights_path: Optional[str] = None,
                        allow_random: bool = False,
                        device: str | torch.device = "cuda") -> tuple[FoundationModel, int]:
    """The frozen foundation model of ``kind`` and its feature width (which
    sizes the reverse projector: 1024 for ViT-L, 64 for the "-tiny"
    testbeds); seeded random weights when none are found and
    ``allow_random``."""
    fm = FoundationModel(kind, device=device)
    try:
        fm.load(weights_path)
    except FileNotFoundError:
        if not allow_random:
            raise
        fm.init_random(0)
    return fm, fm.feature_dim


def make_lpips_fn(weights_path: Optional[str] = None,
                  device: str | torch.device = "cuda") -> Optional[LPIPS]:
    """The LPIPS module, or None without its weights."""
    try:
        return load_lpips(weights_path, device=device)
    except FileNotFoundError:
        return None


def _write_json(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f)


def train_epochs(trainer: VAETrainer, state: VAETrainState, dataset, *, epochs: int,
                 batch_size: int, logger: logging.Logger, ckpt_dir: str, log_every: int = 100,
                 seed: int = 0, val_dataset=None, start_epoch: int = 0,
                 log_images_every: int = 750):
    """Returns (state, best_val_path, preempted). ``dataset.batches`` yields
    (B, H, W, 3) images in [-1, 1] (or (images, labels)); ``preempted`` is
    True when SIGTERM ended the run mid-epoch, and the caller must stop.
    ``start_epoch`` keeps the per-epoch shuffles on their schedule when a
    stage resumes."""
    best_dir = os.path.join(ckpt_dir, "best")
    metric_file = os.path.join(best_dir, "metric.json")
    best_val, best_path = float("inf"), None
    if start_epoch > 0 and os.path.exists(metric_file):
        # a resumed run must not overwrite a better pre-interruption best
        with open(metric_file) as f:
            best_val = float(json.load(f).get("val", float("inf")))
        best_path = ckpt_lib.latest_checkpoint(best_dir)
    cuda = trainer.device.type == "cuda"
    mlog = MetricsLogger(os.path.join(ckpt_dir, "tb"))
    guard = PreemptionGuard().__enter__()
    loss_acc, log_steps, run_steps, t0 = [], 0, 0, time.time()
    try:
        for epoch in range(start_epoch, epochs):
            t_epoch = time.time()
            if cuda:
                torch.cuda.reset_peak_memory_stats(trainer.device)
            for batch in prefetch(dataset.batches(batch_size, seed=seed + epoch, epochs=1)):
                images = batch[0] if isinstance(batch, tuple) else batch
                metrics = trainer.train_step(state, images)
                loss_acc.append(metrics["rec_loss"])  # read at the log point only
                log_steps += 1
                run_steps += 1
                if log_images_every and run_steps % log_images_every == 0:
                    dec = trainer.reconstruct(state, images)
                    log_reconstructions(os.path.join(ckpt_dir, "images"), state.step,
                                        np.asarray(images), dec.cpu().numpy())
                if guard.should_stop:
                    # epoch.json counts the completed epochs only: resume
                    # re-runs this one on the saved (newer) weights
                    ckpt_lib.save_checkpoint(ckpt_dir, state.step, state)
                    _write_json(os.path.join(ckpt_dir, "epoch.json"), {"epochs_done": epoch})
                    logger.info(f"preempted at step {state.step}: checkpoint saved")
                    return state, best_path, True
                if log_steps % log_every == 0:
                    dt = time.time() - t0
                    rec = torch.stack(loss_acc).mean().item()
                    logger.info(f"epoch {epoch} step {state.step}: rec {rec:.4f}, "
                                f"{log_steps / dt:.2f} it/s")
                    mlog.log_scalars(state.step, {"train/rec_loss": rec,
                                                  "train/it_per_s": log_steps / dt})
                    loss_acc, log_steps, t0 = [], 0, time.time()

            if val_dataset is not None:
                vals = [trainer.eval_step(state, b[0] if isinstance(b, tuple) else b)
                        ["val/rec_loss"].item()
                        for b in val_dataset.batches(batch_size, shuffle=False, epochs=1)]
                val = float(np.mean(vals)) if vals else float("nan")
                logger.info(f"epoch {epoch}: val/rec_loss {val:.4f}")
                mlog.log_scalars(state.step, {"val/rec_loss": val})
                if val < best_val:
                    best_val = val
                    best_path = ckpt_lib.save_checkpoint(best_dir, state.step, state)
                    _write_json(metric_file, {"val": val, "step": state.step})
            # an explicit count: a zero-step epoch saves under an unchanged
            # step number, which counting checkpoints would miss
            ckpt_lib.save_checkpoint(ckpt_dir, state.step, state)
            _write_json(os.path.join(ckpt_dir, "epoch.json"), {"epochs_done": epoch + 1})
            scalars = {"epoch/duration_s": time.time() - t_epoch}
            if cuda:
                scalars["epoch/peak_mem_mb"] = torch.cuda.max_memory_allocated(trainer.device) / 1e6
            mlog.log_scalars(state.step, scalars)
            logger.info(f"epoch {epoch} done at step {state.step}: "
                        + ", ".join(f"{k} {v:.2f}" for k, v in scalars.items()))
    finally:
        guard.__exit__()
        mlog.close()
    return state, best_path, False


def stage_epochs_done(stage_dir: str) -> int:
    """Completed epochs of a stage: its ``epoch.json``, else its count of
    distinct checkpoints."""
    path = os.path.join(stage_dir, "epoch.json")
    if os.path.exists(path):
        with open(path) as f:
            return int(json.load(f).get("epochs_done", 0))
    return ckpt_lib.checkpoint_count(stage_dir)


@torch.no_grad()
def _load_pretrained(trainer: VAETrainer, state: VAETrainState, path: str,
                     logger: logging.Logger) -> None:
    """Stage-1 init, weights only: a train-state ``.safetensors`` (the
    port's or the JAX package's; shape-checked), or a reference torch
    ``.ckpt``/``.pt``, whose ``linear_proj.weight`` becomes the projector."""
    if path.endswith(".safetensors"):
        ckpt_lib.restore_weights(path, state)
    elif path.endswith(".msgpack"):
        raise ValueError(f"{path}: legacy msgpack checkpoints are not read by the port")
    else:
        sd = reference_vae_state(path)
        trainer.vae.load_state_dict({k: v for k, v in sd.items()
                                     if not k.startswith("linear_proj")}, strict=True)
        if trainer.use_vf and "linear_proj.weight" in sd:  # (out, in, 1, 1) or (out, in)
            w = sd["linear_proj.weight"]
            trainer.gen.proj.weight.copy_(w.reshape(w.shape[0], w.shape[1], 1, 1))
    logger.info(f"loaded pretrained VAE weights from {path}")


@torch.no_grad()
def _chain(dst: VAETrainState, src: VAETrainState) -> VAETrainState:
    """``dst`` (fresh optimizers) takes ``src``'s weights, stats and step."""
    if dst.gen_names != src.gen_names or dst.disc_names != src.disc_names:
        raise ValueError("stages of one run must share the model's architecture")
    for a, b in ((dst.gen_params, src.gen_params), (dst.disc_params, src.disc_params),
                 (dst.disc_stats, src.disc_stats)):
        torch._foreach_copy_(a, b)
    dst.step = src.step
    return dst


def run_stages(cfg: Config, dataset, val_dataset=None, stages: Sequence[dict] = OFFICIAL_STAGES,
               output_dir: str = "output/vavae", batch_size: int = 8,
               allow_random_foundation: bool = False, resume: bool = True,
               device: str | torch.device = "cuda") -> VAETrainState:
    """The staged VF-alignment recipe with best-checkpoint chaining and
    auto-resume (the reference launcher's resume from the newest epoch)."""
    dev = resolve_device(device)
    logger = create_logger()
    use_vf = cfg.model.params.get("use_vf")
    foundation, vf_dim = (make_aux_feature_fn(use_vf, allow_random=allow_random_foundation,
                                              device=dev) if use_vf else (None, 1024))
    lpips = make_lpips_fn(device=dev)
    train_cfg = cfg.get("train", Config())

    state = None
    for si, stage in enumerate(stages):
        trainer = build_vae_trainer(cfg, stage_overrides=stage, foundation=foundation,
                                    lpips=lpips, vf_dim=vf_dim, device=dev)
        stage_dir = os.path.join(output_dir, f"stage{si + 1}")
        if not resume and ckpt_lib.checkpoint_count(stage_dir) > 0:
            raise RuntimeError(
                f"--no_resume requested but {stage_dir} already holds checkpoints from a "
                "previous run: delete the stage directories (or choose a fresh --output_dir) "
                "before starting over")
        epochs_done = stage_epochs_done(stage_dir) if resume else 0
        if epochs_done > 0:
            state = trainer.init_state(si)
            ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(stage_dir), state)
            logger.info(f"stage {si + 1}: resumed {epochs_done}/{stage['epochs']} epochs "
                        f"from {stage_dir} (step {state.step})")
            if epochs_done >= stage["epochs"]:
                best_ck = ckpt_lib.latest_checkpoint(os.path.join(stage_dir, "best"))
                if best_ck:
                    ckpt_lib.restore_checkpoint(best_ck, state)
                    logger.info(f"stage {si + 1}: chaining best-val {best_ck}")
                continue
        elif state is None:
            state = trainer.init_state(0)
            init_path = cfg.get("weight_init") or cfg.get("ckpt_path")
            if init_path and os.path.exists(str(init_path)):
                _load_pretrained(trainer, state, str(init_path), logger)
        else:  # chain: the previous stage's weights, fresh optimizers
            state = _chain(trainer.init_state(si), state)
        logger.info(f"=== stage {si + 1}/{len(stages)}: {stage} ===")
        state, _, preempted = train_epochs(
            trainer, state, dataset, epochs=stage["epochs"], batch_size=batch_size,
            logger=logger, ckpt_dir=stage_dir, val_dataset=val_dataset,
            start_epoch=epochs_done, log_images_every=train_cfg.get("log_images_every", 750))
        if preempted:
            logger.info(f"preempted during stage {si + 1}: exiting for relaunch "
                        "(auto-resume continues this stage)")
            return state
        best_ck = ckpt_lib.latest_checkpoint(os.path.join(stage_dir, "best"))
        if best_ck:
            ckpt_lib.restore_checkpoint(best_ck, state)
            logger.info(f"stage {si + 1}: chaining best-val {best_ck}")
    return state


def main(argv=None) -> VAETrainState:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="VAE config (YAML, or JSON)")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--val_path", default=None)
    ap.add_argument("--output_dir", default="output/vavae")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--stages", default="official", choices=["official", "single"])
    ap.add_argument("--no_resume", action="store_true",
                    help="start from scratch even if stage checkpoints exist")
    ap.add_argument("--allow_random_foundation", action="store_true",
                    help="seeded random foundation weights when VAVAE_*_WEIGHTS is unset "
                         "(plumbing runs only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.base, overrides=args.overrides)
    size = cfg.model.params.ddconfig.resolution
    dataset = ImageFolderDataset(args.data_path, image_size=size)
    val_dataset = ImageFolderDataset(args.val_path, image_size=size) if args.val_path else None
    if "stages" in cfg:  # the config's staged recipe
        stages = [dict(s) for s in cfg.stages]
    elif args.stages == "official":
        stages = OFFICIAL_STAGES
    else:
        stages = [dict(epochs=cfg.get("train", {}).get("max_epochs", 50))]
    return run_stages(cfg, dataset, val_dataset, stages=stages, output_dir=args.output_dir,
                      batch_size=args.batch_size,
                      allow_random_foundation=args.allow_random_foundation,
                      resume=not args.no_resume, device=device)


if __name__ == "__main__":
    main()

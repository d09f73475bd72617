"""DiT training pipeline (port of ``vavae_tpu/pipelines/train_dit.py``).

Builds the model, transport, dataset and ``DiTTrainer`` from a
reference-format config, resumes from the newest step-numbered checkpoint,
and runs the step loop: ``(step=…) Train Loss …, Train Steps/Sec …`` log
lines every ``log_every`` steps (and ``metrics.jsonl``), a checkpoint every
``ckpt_every`` steps with validation and early stopping when
``data.valid_path`` is set, EMA sample grids every ``sample_every`` steps, a
checkpoint on SIGTERM, and a final checkpoint. Checkpoints are written from
a background thread unless ``train.async_checkpoint`` is false;
``VAVAE_PROFILE=/dir`` traces a window of steps (``utils/profiling.py``);
the config goes to TensorBoard as text. Runs on the card unless
``--device cpu`` is passed.

One process drives one card. Under a launcher (torchrun, or the JAX
package's ``JAX_*`` variables; ``parallel/mesh.py``) the processes form
the config's ``parallel:`` mesh (``data: -1`` takes the rest, ``fsdp``,
``tensor``); ``train.global_batch_size`` is split over data × fsdp, each
data rank reading its rows of the global batches a single process reads.
Process 0 logs, writes TensorBoard, the sample grids (from the EMA
gathered from every rank's shards) and the checkpoints (gathered
likewise). The ranks agree on a preemption signal before acting on it.

    torchrun --nproc_per_node=N -m vavae_tpu_torch.pipelines.train_dit --config CFG.yaml [key.path=value ...]
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
from vavae_tpu_torch.parallel.mesh import DP
from vavae_tpu_torch.pipelines.sample import build_sample_fn, create_logger, demo_grid
from vavae_tpu_torch.train import checkpoint as ckpt_lib
from vavae_tpu_torch.train.dit_trainer import DiTTrainer, TrainState
from vavae_tpu_torch.transport import build_transport
from vavae_tpu_torch.utils.config import Config, load_config
from vavae_tpu_torch.utils.metrics_logger import MetricsLogger
from vavae_tpu_torch.utils.png import encode_png
from vavae_tpu_torch.utils.preemption import PreemptionGuard
from vavae_tpu_torch.utils.profiling import WindowTracer
from vavae_tpu_torch.utils.msgpack_io import load_state_tree
from vavae_tpu_torch.utils.weights import dit_state_from_jax, dit_state_from_reference


@torch.no_grad()
def load_weight_init(init_path: str, state: TrainState, model, logger) -> TrainState:
    """Pretrained weights only, for a finetune run: the ``params`` of a
    train state (the port's or the JAX package's, ``.safetensors`` or legacy
    ``.msgpack``), or a reference ``.pt`` (EMA preferred). Leaves whose
    shape differs from the model's (a label table of another class count)
    keep the fresh init.
    Step and optimizer restart; the EMA restarts from the loaded weights."""
    if init_path.endswith((".safetensors", ".msgpack")):
        sd = dit_state_from_jax(load_state_tree(init_path)["params"])
    else:
        ckpt = torch.load(init_path, map_location="cpu", weights_only=False)
        key = "ema" if isinstance(ckpt, dict) and "ema" in ckpt else "model"
        raw = ckpt[key] if isinstance(ckpt, dict) and key in ckpt else ckpt
        sd = dit_state_from_reference(raw, model.num_heads, model.use_rope)
    loaded = 0
    for name, p in zip(state.names, state.params):
        if name in sd and sd[name].shape == p.shape:
            p.copy_(sd[name])
            loaded += 1
        else:
            logger.info(f"weight init: keeping the fresh init of {name}")
    for e, p in zip(state.ema_params, state.params):
        e.copy_(p)
    logger.info(f"weight init from {init_path}: {loaded} of {len(state.params)} tensors")
    return state


def build_trainer(cfg: Config, model, steps_per_epoch: int, max_steps: int,
                  mesh: mesh_lib.Mesh | None = None) -> DiTTrainer:
    opt_cfg = cfg.get("optimizer", Config())
    sched = cfg.get("scheduler", Config())
    return DiTTrainer(
        model,
        build_transport(cfg),
        lr=opt_cfg.get("lr", 2e-4),
        beta2=opt_cfg.get("beta2", 0.95),
        weight_decay=opt_cfg.get("weight_decay", 0.0),
        max_grad_norm=opt_cfg.get("max_grad_norm"),
        ema_decay=cfg.train.get("ema_decay", 0.9999),
        ema_every=cfg.train.get("ema_every", 1),
        lr_schedule="cosine" if sched.get("type", "constant") in ("cosine", "warmup_cosine") else None,
        total_steps=(int(sched.get("T_max", 0)) * steps_per_epoch
                     if sched.get("T_max") and cfg.train.get("max_epochs") else max_steps),
        min_lr=sched.get("eta_min", 0.0),
        warmup_steps=sched.get("warmup_steps", 0),
        adam_mu_dtype=opt_cfg.get("adam_mu_dtype"),
        grad_accum=cfg.train.get("grad_accum", 1),
        global_seed=cfg.train.get("global_seed", 0),
        mesh=mesh,
    )


def _dataset(cfg: Config, path: str) -> ImgLatentDataset:
    return ImgLatentDataset(path, latent_norm=cfg.data.get("latent_norm", False),
                            latent_multiplier=cfg.data.get("latent_multiplier", 0.18215))


def do_train(cfg: Config, device: str | torch.device = "cuda") -> TrainState:
    dev = mesh_lib.multihost_init(device)
    mesh = mesh_lib.mesh_from_config(cfg.get("parallel"))
    rank0 = mesh_lib.process_index() == 0
    exp_dir = os.path.join(cfg.train.output_dir, cfg.train.get("exp_name") or "exp")
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    logger = create_logger()

    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    # the fresh weights draw from torch's global stream: seeded here, so two
    # runs of one config start alike, as the JAX package's PRNGKey(global_seed)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(cfg.train.get("global_seed", 0))
        model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev)

    def sample_model():
        """An unsharded model for the EMA sample grids, built without moving
        the global random stream."""
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            return create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev).eval()

    dataset = _dataset(cfg, cfg.data.data_path)
    valid_dataset = _dataset(cfg, cfg.data.valid_path) if cfg.data.get("valid_path") else None

    global_bs = cfg.train.global_batch_size
    n_dp = mesh.size(DP)
    if global_bs % n_dp:
        raise ValueError(f"train.global_batch_size {global_bs} does not split over "
                         f"{n_dp} data ranks")
    per_proc_bs = global_bs // n_dp
    steps_per_epoch = max(len(dataset) // global_bs, 1)
    if cfg.train.get("max_epochs"):
        max_steps = int(cfg.train.max_epochs) * steps_per_epoch
    else:
        max_steps = cfg.train.max_steps
    trainer = build_trainer(cfg, model, steps_per_epoch, max_steps, mesh)
    state = trainer.init_state()

    init_path = cfg.train.get("weight_init") or cfg.train.get("ckpt")
    if init_path:
        if not os.path.exists(str(init_path)):
            raise FileNotFoundError(f"train.weight_init/ckpt points at a missing file: {init_path!r}")
        load_weight_init(str(init_path), state, model, logger)
    if cfg.train.get("resume", True):
        latest = ckpt_lib.latest_checkpoint(ckpt_dir)
        if latest:
            ckpt_lib.restore_checkpoint(latest, state)
            logger.info(f"resumed from {latest} at step {state.step}")

    n_params = sum(p.numel() for p in state.params)
    state = trainer.distribute(state)
    logger.info(f"LightningDiT parameters: {n_params / 1e6:.2f}M on {dev}; mesh {mesh.shape}")
    logger.info(f"dataset: {len(dataset):,} latents; global batch {global_bs}, "
                f"{per_proc_bs} a data rank")
    metrics_log = MetricsLogger(os.path.join(exp_dir, "tb"), enabled=rank0)
    metrics_log.log_text("config", str(dict(cfg)))
    # train.async_checkpoint (default on): the snapshot is taken here, the
    # write overlaps the next steps
    writer = ckpt_lib.AsyncCheckpointer() if cfg.train.get("async_checkpoint", True) else None

    def save(dir_: str, at_step: int, with_cfg: bool = True, sync: bool = False) -> None:
        config = dict(cfg) if with_cfg else None
        if writer is None:
            ckpt_lib.save_checkpoint(dir_, at_step, state, config)
        else:
            writer.save(dir_, at_step, state, config)
            if sync:
                writer.wait()

    log_every = cfg.train.get("log_every", 100)
    if cfg.train.get("ckpt_every_epoch"):
        ckpt_every = int(cfg.train.ckpt_every_epoch) * steps_per_epoch
    else:
        ckpt_every = cfg.train.get("ckpt_every", 20000)
    patience = cfg.train.get("early_stopping_patience") or cfg.train.get("patience")
    min_delta = cfg.train.get("min_delta", 1e-6)
    best_val, bad_evals = float("inf"), 0
    latent_stats = dataset.latent_stats if cfg.data.get("latent_norm") else None

    # each data rank reads its rows of the global batches one process would
    # read, so a world of N takes a world of 1's steps
    it = dataset.batches(global_bs, seed=cfg.train.get("global_seed", 0),
                         rows=(mesh.index(DP), n_dp))
    tracer = WindowTracer()  # VAVAE_PROFILE=/dir traces a window of steps
    loss_acc, log_steps, t_start = [], 0, time.time()
    step = state.step
    guard = PreemptionGuard().__enter__()
    completed = False
    try:
        while step < max_steps:
            # the ranks agree on the step to stop at: one that stopped alone
            # would wait in the checkpoint's collectives while the others
            # wait in the step's
            if mesh_lib.any_process(guard.should_stop):
                save(ckpt_dir, step, sync=True)
                logger.info(f"preempted: checkpointed at step {step}, exiting")
                break
            metrics = trainer.train_step(state, next(it))
            step = state.step
            tracer.step(step, sync_on=metrics["loss"])
            loss_acc.append(metrics["loss"])  # stays on the device until a log point
            log_steps += 1

            if step % log_every == 0:
                avg_loss = torch.stack(loss_acc).mean().item()
                sps = log_steps / (time.time() - t_start)
                logger.info(f"(step={step:07d}) Train Loss: {avg_loss:.4f}, "
                            f"Train Steps/Sec: {sps:.2f}, Img/Sec: {sps * global_bs:.1f}")
                metrics_log.log_scalars(step, {"train/loss": avg_loss, "train/steps_per_sec": sps,
                                               "train/grad_norm": metrics["grad_norm"].item()})
                loss_acc, log_steps, t_start = [], 0, time.time()

            sample_every = cfg.train.get("sample_every")
            if sample_every and step % sample_every == 0:
                ema = state.full(state.ema_params)  # collective when sharded
                if rank0:
                    _sample_grid(cfg, trainer, ema, exp_dir, step, logger, sample_model,
                                 latent_stats=latent_stats)

            if step % ckpt_every == 0 and step > 0:
                save(ckpt_dir, step)
                logger.info(f"saved checkpoint at step {step}")
                if valid_dataset is not None:
                    val = evaluate(trainer, state, valid_dataset, global_bs)
                    logger.info(f"(step={step:07d}) Validation Loss: {val:.4f}")
                    metrics_log.log_scalars(step, {"val/loss": val})
                    if patience:
                        if val < best_val - min_delta:
                            best_val, bad_evals = val, 0
                            save(os.path.join(exp_dir, "best"), step, with_cfg=False)
                        else:
                            bad_evals += 1
                            if bad_evals >= patience:
                                logger.info(f"early stopping at step {step}")
                                break
        completed = True
    finally:
        guard.__exit__()
        tracer.close()
        if not completed:  # best effort, without masking the original error
            if mesh_lib.process_count() > 1:
                # the other ranks may never reach the checkpoint's collectives
                logger.error("a failed step in a world of several processes: no final "
                             "checkpoint (the last periodic one stands)")
            else:
                try:
                    save(ckpt_dir, step, sync=True)
                except Exception as e:  # noqa: BLE001
                    logger.error(f"final checkpoint after failure also failed: {e}")
            metrics_log.close()
    save(ckpt_dir, step, sync=True)
    metrics_log.close()
    logger.info("training done")
    return state


@torch.no_grad()
def _sample_grid(cfg: Config, trainer: DiTTrainer, ema_params: list, exp_dir: str, step: int,
                 logger, make_model, n: int = 8, latent_stats=None) -> None:
    """Sample a small grid with the EMA weights (full tensors) mid-training:
    a PNG through the VAE when ``vae.ckpt_path`` exists, else the raw
    latents (.npy). The model to load them into (``make_model()``,
    unsharded) and the VAE are built once per trainer and kept."""
    try:
        cache = trainer.__dict__.setdefault("_sample_cache", {})
        if "model" not in cache:
            cache["model"] = make_model()
            cache["vae"] = None
            vae_ckpt = cfg.get("vae", {}).get("ckpt_path")
            if vae_ckpt and os.path.exists(str(vae_ckpt)):
                from vavae_tpu_torch.tokenizer import VA_VAE

                cache["vae"] = VA_VAE(cfg.get("vae", {}).get("config"), ckpt_path=vae_ckpt,
                                      img_size=cfg.data.image_size, device=trainer.device)
        ema_model = cache["model"]
        torch._foreach_copy_(list(ema_model.parameters()), ema_params)
        generate = build_sample_fn(cfg, ema_model, latent_stats, device=trainer.device)
        labels = torch.arange(n) % cfg.data.num_classes
        gen = torch.Generator(device=trainer.device).manual_seed(step)
        lat = generate(labels, generator=gen)
        out_dir = os.path.join(exp_dir, "train_samples")
        os.makedirs(out_dir, exist_ok=True)
        if cache["vae"] is not None:
            with open(os.path.join(out_dir, f"step{step:07d}.png"), "wb") as f:
                f.write(encode_png(demo_grid(cache["vae"].decode_to_images(lat))))
        else:
            np.save(os.path.join(out_dir, f"step{step:07d}_latents.npy"), lat.float().cpu().numpy())
        logger.info(f"(step={step:07d}) wrote training samples")
    except Exception as e:  # sampling must never kill a training run
        logger.info(f"in-training sampling failed: {e}")


def evaluate(trainer: DiTTrainer, state: TrainState, dataset: ImgLatentDataset, batch_size: int,
             max_batches: int = 50) -> float:
    """Mean validation loss over up to ``max_batches`` batches, in order;
    every batch draws t and the noise from the same seed, as the JAX
    pipeline passes every batch the same key."""
    losses = []
    for i, batch in enumerate(dataset.batches(batch_size, shuffle=False, epochs=1)):
        if i >= max_batches:
            break
        gen = torch.Generator(device=trainer.device).manual_seed(trainer.global_seed)
        losses.append(trainer.eval_step(state, batch, gen)["val_loss"].item())
    return float(np.mean(losses)) if losses else float("nan")


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = ap.parse_args(argv)
    return do_train(load_config(args.config, overrides=args.overrides), device=args.device)


if __name__ == "__main__":
    main()

"""The learning check (port of ``tests/test_learning_tpu.py``): train
DiT-S/2 on per-class synthetic latents, then CFG-sample from the EMA
weights and check that each sample lands nearest its own class mean.

It runs the whole DiT stack numerically: the model (the #1 and #2
attention kernels on the card), the transport loss, the trainer (AdamW,
EMA) and the split-CFG sampler. The data: 4 classes, each a mean of
2·N(0, 1) on 16×16×32 latents, plus 0.05 noise, batches of 64 drawn
from ``default_rng(0)``; DiT-S/2 (depth 12, width 384, 6 heads of 64)
in bf16 with SwiGLU, RoPE and RMSNorm; 1,200 steps at lr 3e-4, β2 0.95,
EMA 0.99; euler-50 split-CFG at scale 2.0, shift 0.3, interval 0.11, 4
samples a class. It passes when the last loss is below half the first
and at least 0.75 of the samples are nearest their class's mean.

``run`` returns the losses, the accuracy, ms/step and the attention
kernels' launches in training and in sampling; ``chip_smoke.py`` (phase
38) and ``tests/test_torch_cuda.py`` hold those to exact counts.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from vavae_tpu_torch.data.prefetch import prefetch
from vavae_tpu_torch.models.dit import LightningDiT
from vavae_tpu_torch.ops.flash_attention import fused_qkv_attention
from vavae_tpu_torch.train.dit_trainer import DiTTrainer
from vavae_tpu_torch.transport import Sampler, create_transport
from vavae_tpu_torch.utils.device import resolve_device

N_CLASSES, BATCH, LATENT, CHANNELS = 4, 64, 16, 32
STEPS, SAMPLE_STEPS, CFG_SCALE, PER_CLASS = 1200, 50, 2.0, 4
WARMUP = 10  # steps left out of ms/step


def _launches() -> tuple[int, int]:
    return fused_qkv_attention.launches, fused_qkv_attention.bwd_launches


def run(device: str | torch.device = "cuda", steps: int = STEPS, depth: int = 12,
        hidden: int = 384, heads: int = 6, dtype: torch.dtype = torch.bfloat16,
        seed: int = 0) -> dict:
    """Train, sample and score (module docstring). The narrower arguments
    are for a tiny CPU run of the same code."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    shape = (LATENT, LATENT, CHANNELS)
    class_means = 2.0 * rng.normal(size=(N_CLASSES, *shape)).astype(np.float32)

    def batches():
        for _ in range(steps):
            y = rng.integers(0, N_CLASSES, size=(BATCH,)).astype(np.int32)
            x = class_means[y] + 0.05 * rng.normal(size=(BATCH, *shape)).astype(np.float32)
            if dev.type == "cuda":  # page-locked, so the step's copy does not wait for the card
                yield torch.from_numpy(x).pin_memory(), torch.from_numpy(y).pin_memory()
            else:
                yield x, y

    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = LightningDiT(input_size=LATENT, patch_size=2, in_channels=CHANNELS,
                             hidden_size=hidden, depth=depth, num_heads=heads,
                             num_classes=N_CLASSES, use_swiglu=True, use_rope=True,
                             use_rmsnorm=True, class_dropout_prob=0.1, dtype=dtype).to(dev)
    transport = create_transport("Linear", "velocity", use_cosine_loss=True, use_lognorm=True)
    # a short run: a fast EMA, so the averaged weights track
    trainer = DiTTrainer(model, transport, lr=3e-4, beta2=0.95, ema_decay=0.99,
                         global_seed=seed)
    state = trainer.init_state()

    fwd0, bwd0 = _launches()
    losses = []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_start = time.perf_counter()
    for i, (x, y) in enumerate(prefetch(batches())):  # the next batch drawn meanwhile
        if i == WARMUP:
            sync()
            t_timed = time.perf_counter()
        batch = (torch.as_tensor(x).to(dev, non_blocking=True),
                 torch.as_tensor(y).to(dev, non_blocking=True))
        losses.append(trainer.train_step(state, batch)["loss"])
    sync()
    t_end = time.perf_counter()
    fwd1, bwd1 = _launches()
    losses = torch.stack(losses).float().cpu()

    # split-CFG sampling with the EMA weights: PER_CLASS samples a class
    with torch.no_grad():
        torch._foreach_copy_(state.params, state.ema_params)
    model.eval()
    sample_fn = Sampler(transport).sample_ode_cfg(num_steps=SAMPLE_STEPS, timestep_shift=0.3,
                                                  cfg_interval_start=0.11)
    labels = torch.arange(N_CLASSES, device=dev).repeat_interleave(PER_CLASS)
    y_cfg = torch.cat([labels, torch.full_like(labels, N_CLASSES)])
    z = torch.randn((len(labels), *shape), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 7))
    t0 = time.perf_counter()
    with torch.inference_mode():
        samples = sample_fn(z, lambda x, t: model(x, t, labels),
                            lambda x, t: model.forward_with_cfg(x, t, y_cfg, CFG_SCALE))
        samples = samples.float().cpu().numpy()
    sample_s = time.perf_counter() - t0
    fwd2, bwd2 = _launches()

    # each sample must be nearest (L2) to its class's mean
    d = np.linalg.norm(samples.reshape(len(samples), 1, -1)
                       - class_means.reshape(1, N_CLASSES, -1), axis=-1)
    accuracy = float((d.argmin(axis=-1) == labels.cpu().numpy()).mean())
    timed = steps - WARMUP
    return {
        "steps": steps, "batch": BATCH, "depth": depth, "first_loss": float(losses[0]),
        "last_loss": float(losses[-1]), "losses_finite": bool(torch.isfinite(losses).all()),
        "samples_finite": bool(np.isfinite(samples).all()), "accuracy": accuracy,
        "train_s": t_end - t_start,
        "ms_per_step": (t_end - t_timed) / timed * 1e3 if timed > 0 else None,
        "sample_s": sample_s,
        # model calls of an euler split-CFG run: one an interval of the grid
        "sample_model_calls": SAMPLE_STEPS - 1,
        "train_launches": [fwd1 - fwd0, bwd1 - bwd0],
        "sample_launches": [fwd2 - fwd1, bwd2 - bwd1],
    }


def passed(result: dict) -> bool:
    """The JAX test's two assertions, and finite losses and samples."""
    return (result["losses_finite"] and result["samples_finite"]
            and result["last_loss"] < 0.5 * result["first_loss"] and result["accuracy"] >= 0.75)

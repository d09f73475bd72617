"""On-card smoke run of the PyTorch/CUDA port (``vavae_tpu_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, each fatal on failure:
  1. device: name and power limit (nvidia-smi), torch's device name;
  2. build: every CUDA kernel of the sampling path, from ``ops/csrc``;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main-path shapes, bf16, tolerance 2e-2 max-abs; times (CUDA events,
     median of 30 after warm-up) of the kernel, the plain version and one
     PyTorch library call computing the same function, beside the card's
     bound for the same work;
  4. main path: LightningDiT-XL/1 (depth 28, width 1152, bf16, random
     non-zero weights from the seed) → 250-step euler split-CFG sampling
     (cfg 10, interval 0.11, shift 0.3) at batch 8 → f16d32 VA-VAE decode to
     uint8 images, through ``build_sample_fn`` and ``VA_VAE``; checks shapes,
     finiteness and that every launch of the attention kernel came from it;
  5. the same XL/1 forward at batch 16 with the kernel and with attention
     forced through the plain version: relative error of the velocity.
The line before the last holds the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from vavae_tpu_torch.models import layers
from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops import build
from vavae_tpu_torch.ops.flash_attention import (
    fold_sin,
    fused_qkv_attention,
    fused_qkv_attention_reference,
)
from vavae_tpu_torch.pipelines.sample import build_sample_fn
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.utils.config import Config
from vavae_tpu_torch.utils.weights import randomize_

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the production config (vavae_tpu/configs/lightningdit_xl_vavae_f16d32.yaml),
# written out so no YAML parser is needed on the card
PRODUCTION = {
    "data": {"image_size": 256, "num_classes": 1000, "latent_norm": True,
             "latent_multiplier": 1.0},
    "vae": {"downsample_ratio": 16},
    "model": {"model_type": "LightningDiT-XL/1", "use_qknorm": False, "use_swiglu": True,
              "use_rope": True, "use_rmsnorm": True, "wo_shift": False, "in_chans": 32,
              "bf16": True},
    "transport": {"path_type": "Linear", "prediction": "velocity", "use_cosine_loss": True,
                  "use_lognorm": True},
    "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 250,
               "cfg_scale": 10.0, "cfg_interval_start": 0.11, "timestep_shift": 0.3,
               "per_proc_batch_size": 8, "cfg_channels": None},
    "train": {"global_seed": 0},
}
BATCH = 8
SEED = 0  # weights, noise and labels are all drawn from generators seeded with it
ATTN_TOL = 2e-2   # bf16 max-abs, the TPU kernel's own tolerance (tests/test_ops.py:99)
PATH_TOL = 3e-2   # bf16 relative (Frobenius) error of a 28-layer XL/1 forward


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] torch: {name}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": smi, "name": name}


def phase_build() -> dict:
    t0 = time.perf_counter()
    path = build.build("nat_attention_fwd")
    build.load_library("nat_attention_fwd")
    seconds = time.perf_counter() - t0
    log(f"[build] {path.name}: {seconds:.1f} s")
    return {"nat_attention_fwd": seconds}


def _attention_case(B: int, H: int, N: int, D: int, rope: bool, gen: torch.Generator):
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    grid = int(np.ceil(N ** 0.5))
    tables = None
    if rope:
        cos, sin = rope_2d_freqs(D, grid)
        tables = (torch.as_tensor(cos[:N], device="cuda"), torch.as_tensor(sin[:N], device="cuda"))
    return qkv, tables


def _attention_bound(B: int, H: int, N: int, D: int, rope: bool) -> tuple[float, str]:
    """Least time on an H100 for one call: operations at the bf16 tensor-core
    peak vs each input byte read once and the output written once."""
    flops = 4.0 * B * H * N * N * D
    nbytes = 2.0 * (3 + 1) * B * N * H * D + (2 * N * D * 4 if rope else 0)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(16, 16, 256, 72, True), (16, 16, 256, 72, False),
             (8, 16, 256, 72, True), (8, 16, 256, 72, False),
             (4, 16, 200, 64, True), (4, 16, 200, 64, False)]
    worst, rows = 0.0, []
    for B, H, N, D, rope in cases:
        qkv, tables = _attention_case(B, H, N, D, rope, gen)
        out = fused_qkv_attention(qkv, rope=tables)
        torch.cuda.synchronize()
        ref = fused_qkv_attention_reference(qkv, rope=tables)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= ATTN_TOL):
            fail(f"attention kernel vs plain at {(B, H, N, D, rope)}: max-abs {err} > {ATTN_TOL}")
        worst = max(worst, err)

        # the library yardstick: SDPA on q, k, v rotated beforehand, (B, H, N, D)
        if tables is not None:
            cos, sinf = fold_sin(tables, device="cuda")
            c, s = cos[None, :, None].to(qkv.dtype), sinf[None, :, None].to(qkv.dtype)
            rot = lambda x: x * c + torch.roll(x, D // 2, dims=-1) * s  # noqa: E731
        else:
            rot = lambda x: x  # noqa: E731
        q, k, v = (t.transpose(1, 2).contiguous()
                   for t in (rot(qkv[:, :, 0]), rot(qkv[:, :, 1]), qkv[:, :, 2]))
        row = {
            "shape": [B, H, N, D], "rope": rope, "max_abs_err": err,
            "ms": time_ms(lambda: fused_qkv_attention(qkv, rope=tables)),
            "plain_ms": time_ms(lambda: fused_qkv_attention_reference(qkv, rope=tables)),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
        }
        row["bound_ms"], row["bound_by"] = _attention_bound(B, H, N, D, rope)
        rows.append(row)
        log(f"[kernels] nat_attention_fwd B={B} H={H} N={N} D={D} rope={rope}: "
            f"max-abs {err:.3e}, kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"SDPA {row['library_ms']:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bound_by']})")
    return {"nat_attention_fwd": {"worst_err": worst, "rows": rows}}


def build_xl(seed: int):
    cfg = Config(PRODUCTION)
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda").eval()
    randomize_(model, seed)  # the JAX init's zero adaLN would make sampling integrate 0
    return cfg, model


def phase_main_path(cfg: Config, model, seed: int, device_info: dict) -> dict:
    C = model.in_channels
    stats = (np.zeros((1, C, 1, 1), np.float32), np.ones((1, C, 1, 1), np.float32))
    vae = VA_VAE(embed_dim=32, img_size=cfg.data.image_size, seed=seed, device="cuda")
    generate = build_sample_fn(cfg, model, stats, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.train.global_seed)
    labels = torch.randint(0, cfg.data.num_classes, (BATCH,), generator=gen, device="cuda")

    # warm-up: cuBLAS/cuDNN handles and the decoder's algorithms, 3 steps
    warm = build_sample_fn(Config(cfg).merged_with({"sample": {"num_sampling_steps": 3}}),
                           model, stats, device="cuda")
    vae.decode_to_images(warm(labels, generator=gen))
    torch.cuda.synchronize()

    fused_qkv_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latents = generate(labels, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    imgs = vae.decode_to_images(latents)
    t2 = time.perf_counter()
    launches = fused_qkv_attention.launches
    peak = torch.cuda.max_memory_allocated()

    want = model.depth * (cfg.sample.num_sampling_steps - 1)  # one forward per step
    if launches != want:
        fail(f"attention kernel launched {launches} times on the main path, expected {want}")
    S = cfg.data.image_size
    if imgs.shape != (BATCH, S, S, 3) or imgs.dtype != np.uint8:
        fail(f"images {imgs.shape} {imgs.dtype}, expected ({BATCH}, {S}, {S}, 3) uint8")
    s = model.input_size
    if latents.shape != (BATCH, s, s, C) or not torch.isfinite(latents).all():
        fail(f"latents {tuple(latents.shape)} not finite or of the wrong shape")
    if latents.float().std().item() == 0.0 or len(np.unique(imgs)) < 16:
        fail("constant latents or images")
    result = {
        "launches": launches, "sample_s": t1 - t0, "decode_s": t2 - t1,
        "samples_per_s": BATCH / (t2 - t0), "peak_bytes": peak,
        "latent_std": latents.float().std().item(), "image_mean": float(imgs.mean()),
    }
    log(f"[main] XL/1 euler-250 split-CFG batch {BATCH}: sampling {result['sample_s']:.3f} s, "
        f"decode {result['decode_s']:.3f} s, {result['samples_per_s']:.4f} samples/s, "
        f"peak {peak / 2**30:.2f} GiB, attention launches {launches} "
        f"[{device_info['smi']}]")
    return result


@torch.no_grad()
def phase_kernel_on_path(model, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    B = 2 * BATCH
    s = model.input_size
    x = torch.randn((B, s, s, model.in_channels), generator=gen, device="cuda")
    t = torch.rand((B,), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    with_kernel = model(x, t, y).float()
    original = layers.fused_qkv_attention
    layers.fused_qkv_attention = fused_qkv_attention_reference  # smoke-only switch
    try:
        plain = model(x, t, y).float()
    finally:
        layers.fused_qkv_attention = original
    rel = ((with_kernel - plain).norm() / plain.norm()).item()
    rel_max = ((with_kernel - plain).abs().max() / plain.abs().max()).item()
    if not (rel <= PATH_TOL):
        fail(f"XL/1 forward with the kernel vs plain attention: relative error {rel} > {PATH_TOL}")
    log(f"[path] XL/1 forward B={B}, kernel vs plain attention: relative error {rel:.3e} "
        f"(max {rel_max:.3e})")
    return {"rel_err": rel, "rel_max_err": rel_max}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every measured number to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = phase_device()
    builds = phase_build()
    kernels = phase_kernels(SEED)
    cfg, model = build_xl(SEED)
    main_path = phase_main_path(cfg, model, SEED, device)
    on_path = phase_kernel_on_path(model, SEED)

    nat = kernels["nat_attention_fwd"]
    main_row = nat["rows"][0]  # (16, 16, 256, 72) with RoPE: the CFG-phase shape
    line = {"kernels": [{
        "name": "nat_attention_fwd",
        "route": "cuda",
        "source": "vavae_tpu_torch/ops/csrc/nat_attention_fwd.cu",
        "replaces": "vavae_tpu/ops/pallas/flash_attention.py:215",
        "launches": main_path["launches"],
        "max_abs_err": nat["worst_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "build_s": builds, "kernels": kernels,
                       "main_path": main_path, "kernel_on_path": on_path}, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

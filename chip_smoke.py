"""On-card smoke run of the PyTorch/CUDA port (``vavae_tpu_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, each fatal on failure:
  1. device: name and power limit (nvidia-smi), torch's device name;
  2. build: every CUDA kernel (the fused-qkv attention forward and backward,
     the separate-q/k/v attention forward and backward, the long-route
     forward), from ``ops/csrc``, one nvcc per source, all started together;
     each kernel instance's registers and spills from the compiler's report
     (``-Xptxas -v``), where an instance of the forward's wgmma body at a
     head dim of at most 80 must not spill;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes, bf16 (forward 2e-2 max-abs, backward 3e-2 of
     max|ref|); times (CUDA events, median of 30 after warm-up) of the
     kernel, the plain version and one PyTorch library call computing the
     same function, beside the card's bound for the same work, and the
     device time alone (torch.profiler) of the kernel and of the library
     call; the forward and backward kernels also at N = 1,024 (the longest
     sequence of the in-kernel-RoPE route), with the device time of each
     launch of their body; each forward wrapper call must run one kernel,
     its wgmma body, and each backward wrapper must give bit-identical
     gradients on a second call;
  4. sampling path: LightningDiT-XL/1 (depth 28, width 1152, bf16, random
     non-zero weights from the seed) → 250-step euler split-CFG sampling
     (cfg 10, interval 0.11, shift 0.3) at batch 8 → f16d32 VA-VAE decode to
     uint8 images, through ``build_sample_fn`` and ``VA_VAE``; checks shapes,
     finiteness and the forward kernel's launches (and none of the others);
  5. the same XL/1 forward at batch 16 with the kernel and with attention
     forced through the plain version: relative error of the velocity;
  6. train path: one forward and backward of the XL/1 training loss
     (velocity MSE + cosine, remat "dots") at batch 16 with both kernels and
     with plain attention: relative error of all gradients and of the
     ``attn.qkv`` gradients;
  7. training path: XL/1 from the JAX init with the production config's
     model, optimizer, transport and train blocks, 10 steps of
     ``DiTTrainer.train_step`` (the function ``do_train`` calls) at batch 32:
     ms/step and img/s of the last 8, peak memory, the backward kernel's 28
     and the forward kernel's 56 launches in every step (remat runs the
     forward again), finite losses, moved params and EMA;
  8. entry point: ``do_train`` on seeded synthetic f16d32 latent shards (an
     XL/1-width DiT cut to depth 2): 4 steps with a checkpoint every 2, then
     a resumed run to step 6, with both kernels' launches counted;
  9-13. phases 4-8 again with ``model.use_qknorm: true`` (RMSNorm q/k norms,
     RoPE): attention then runs through ``flash_attention``, whose forward
     kernel with RoPE and backward kernel take the places of the fused-qkv
     ones; phase 11 also reports the ``attn.q_norm``/``attn.k_norm``
     gradients on their own;
  14. the forward kernel without RoPE: an XL/1-width qk-norm model with
     ``use_rope: false`` and ``use_rmsnorm: false`` (LayerNorm q/k norms) at
     depth 4, its forward and its loss gradients against plain attention;
  15. the long route at 1024² (``data.image_size: 1024``, 64×64×32 latents,
     N = 4,096 tokens), where attention runs ``flash_fwd`` (``_flash_kernel``)
     on q, k rotated beforehand with the fp32 tables: XL/1 euler-250
     split-CFG sampling at per-batch 2 + f16d32 decode to 1024² uint8
     images (6,972 ``flash_fwd`` launches and none of any other kernel), the
     XL/1 forward at batch 4 of the production and the qk-norm model against
     plain attention, and the loss gradients of XL/1-width models cut to
     depth 2 at batch 2 against plain attention (the backward is autograd of
     the exact op; remat "dots" runs the kernel again).
Phase 3 also holds ``flash_fwd`` against its plain version at the 1024²
shapes (B = 4 and 2, H = 16, N = 4,096, D = 72) in its three dtype pairs
(fp32 q̃, k̃ with bf16 v; all bf16; all fp32) and at N = 4,033 (the last key
tile holds one key and 63 masked ones), within 2e-2 max-abs and, tighter,
within ``LONG_TOL`` relative (Frobenius) error; at N = 4,033 it also shows
that two planted faults, emulated in plain PyTorch on the same inputs (the
tail mask dropped, the running sums not rescaled), exceed that limit.
Every path phase sets the launch counts to 0 before it and holds
them to the exact expected counts after it. The line before the last holds the
kernels' JSON; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vavae_tpu_torch.models import dit, layers
from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops import build
from vavae_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_long,
    flash_attention_long_reference,
    flash_attention_reference,
    fold_sin,
    fused_qkv_attention,
    fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
    long_attention_reference,
    rope_uncast,
    rotate_half,
)
from vavae_tpu_torch.pipelines.sample import build_sample_fn
from vavae_tpu_torch.pipelines.train_dit import build_trainer, do_train
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.transport import build_transport
from vavae_tpu_torch.utils.config import Config
from vavae_tpu_torch.utils.device_timing import device_kernels, device_ms, time_ms
from vavae_tpu_torch.utils.safetensors_io import write_safetensors
from vavae_tpu_torch.utils.weights import randomize_

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# the production config (vavae_tpu/configs/lightningdit_xl_vavae_f16d32.yaml),
# written out so no YAML parser is needed on the card
PRODUCTION = {
    "data": {"image_size": 256, "num_classes": 1000, "latent_norm": True,
             "latent_multiplier": 1.0},
    "vae": {"downsample_ratio": 16},
    "model": {"model_type": "LightningDiT-XL/1", "use_qknorm": False, "use_swiglu": True,
              "use_rope": True, "use_rmsnorm": True, "wo_shift": False, "in_chans": 32,
              "use_checkpoint": True, "checkpoint_policy": "dots", "bf16": True},
    "transport": {"path_type": "Linear", "prediction": "velocity", "use_cosine_loss": True,
                  "use_lognorm": True},
    "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 250,
               "cfg_scale": 10.0, "cfg_interval_start": 0.11, "timestep_shift": 0.3,
               "per_proc_batch_size": 8, "cfg_channels": None},
    "optimizer": {"lr": 0.0002, "beta2": 0.95},
    "train": {"max_steps": 80000, "global_batch_size": 1024, "global_seed": 0,
              "output_dir": "output", "exp_name": "lightningdit_xl_vavae_f16d32",
              "log_every": 100, "ckpt_every": 20000, "ema_decay": 0.9999},
}
BATCH = 8
HIRES = 1024        # data.image_size of the long-route phase: 64×64 latents, N = 4,096
HIRES_BATCH = 2     # its per-batch size
HIRES_GRAD_DEPTH = 2
TRAIN_BATCH = 32
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
SEED = 0  # weights, noise and labels are all drawn from generators seeded with it
ATTN_TOL = 2e-2   # bf16 max-abs, the TPU kernel's own tolerance (tests/test_ops.py:99)
BWD_TOL = 3e-2    # bf16 max|err| / max|ref|, the TPU backward's tolerance (tests/test_ops.py:190)
PATH_TOL = 3e-2   # bf16 relative (Frobenius) error of a 28-layer XL/1 forward or gradient
# ``flash_fwd`` against its plain version, relative (Frobenius) error. With
# bf16 v both round P to bf16, against a running and a final row max: about
# 2e-3 apart. A dropped tail mask (zero keys at logit 0 in the softmax) gives
# about 9e-3 at N = 4,033, which the 2e-2 max-abs limit cannot see.
LONG_TOL = 5e-3
LONG_TOL_F32 = 1e-5  # all fp32: summation order only


# each kernel's launch count: (wrapper, attribute)
COUNTERS = {
    "nat_attention_fwd": (fused_qkv_attention, "launches"),
    "nat_attention_bwd": (fused_qkv_attention, "bwd_launches"),
    "attn_small_fwd_rope": (flash_attention, "rope_launches"),
    "attn_small_fwd": (flash_attention, "launches"),
    "attn_small_bwd": (flash_attention, "bwd_launches"),
    "flash_fwd": (flash_attention, "long_launches"),
}

# the attention branches the paths run: the model options that select one,
# its forward and backward kernels, the ``layers`` attribute that calls them
# and the plain version to swap in for it, and the gradients reported apart
BRANCHES = {
    "production": {
        "model": {}, "fwd": "nat_attention_fwd", "bwd": "nat_attention_bwd",
        "op": "fused_qkv_attention", "plain": fused_qkv_attention_reference,
        "groups": {"attn.qkv": (".attn.qkv.",)},
    },
    "qknorm": {
        "model": {"use_qknorm": True}, "fwd": "attn_small_fwd_rope", "bwd": "attn_small_bwd",
        "op": "dot_product_attention", "plain": flash_attention_reference,
        "groups": {"attn.qkv": (".attn.qkv.",),
                   "attn.q_norm/k_norm": (".attn.q_norm.", ".attn.k_norm.")},
    },
    "qknorm_no_rope": {
        "model": {"use_qknorm": True, "use_rope": False, "use_rmsnorm": False},
        "fwd": "attn_small_fwd", "bwd": "attn_small_bwd",
        "op": "dot_product_attention", "plain": flash_attention_reference,
        "groups": {"attn.q_norm/k_norm": (".attn.q_norm.", ".attn.k_norm.")},
    },
    # 1024²: both branches take the long route; its backward is autograd of
    # the exact op, so there is no backward kernel
    "hires": {
        "model": {}, "data": {"image_size": HIRES}, "fwd": "flash_fwd", "bwd": None,
        "op": "fused_qkv_attention",
        "plain": lambda qkv5, rope=None: long_attention_reference(*qkv5.unbind(dim=2), rope),
        "groups": {"attn.qkv": (".attn.qkv.",)},
    },
    "hires_qknorm": {
        "model": {"use_qknorm": True}, "data": {"image_size": HIRES}, "fwd": "flash_fwd",
        "bwd": None, "op": "dot_product_attention", "plain": long_attention_reference,
        "groups": {"attn.qkv": (".attn.qkv.",),
                   "attn.q_norm/k_norm": (".attn.q_norm.", ".attn.k_norm.")},
    },
}
NO_ROPE_DEPTH = 4


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def expect_counts(got: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly as ``want`` says (absent: never)."""
    full = {name: want.get(name, 0) for name in COUNTERS}
    if got != full:
        fail(f"{what}: kernel launches {got}, expected {full}")


@contextlib.contextmanager
def plain_attention(branch: str):
    """Attention of ``branch`` forced through its plain version (smoke-only switch)."""
    op = BRANCHES[branch]["op"]
    original = getattr(layers, op)
    setattr(layers, op, BRANCHES[branch]["plain"])
    try:
        yield
    finally:
        setattr(layers, op, original)


@contextlib.contextmanager
def xl_depth(depth: int):
    """Smoke-only: the XL registry entries at XL width, cut to ``depth``."""
    saved = dict(dit._VARIANTS["XL"])
    dit._VARIANTS["XL"] = dict(saved, depth=depth)
    try:
        yield
    finally:
        dit._VARIANTS["XL"] = saved


def branch_config(branch: str) -> Config:
    spec = BRANCHES[branch]
    return Config(PRODUCTION).merged_with({"model": spec["model"], "data": spec.get("data", {})})


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def _short_kernel_name(key: str) -> str:
    """``void (anonymous namespace)::attn_bwd_main_kernel<80, 8>(...)`` ->
    ``attn_bwd_main_kernel<80, 8>``."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name[len("void "):] if name.startswith("void ") else name


def backward_times(fn) -> dict:
    """A backward wrapper call's device time, in all and by kernel: the
    launches of its body (``attention_bwd.cuh``) and anything else the call
    runs, such as the wrapper's folding of the RoPE tables."""
    by_kernel = {_short_kernel_name(k): v for k, v in device_kernels(fn).items()}
    return {"device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel}


def check_deterministic(fn, what: str) -> None:
    """Two calls of a backward wrapper on the same inputs give bit-identical
    gradients."""
    first = fn()
    first = [first] if isinstance(first, torch.Tensor) else list(first)
    second = fn()
    second = [second] if isinstance(second, torch.Tensor) else list(second)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{what}: two calls on the same inputs differ")


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


KERNELS = ("nat_attention_fwd", "nat_attention_bwd", "attn_small_fwd", "attn_small_bwd", "flash_fwd")


WGMMA_FWD = "attn_fwd_wgmma_kernel"  # the forward body of the small route's bf16 calls
LONG_FWD = "flash_fwd_wgmma_kernel"  # the long route's body for aligned calls with bf16 v


def phase_build() -> dict:
    def timed_build(name):
        t0 = time.perf_counter()
        path = build.build(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        built = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    for name in KERNELS:
        build.load_library(name)
    resources = {}
    for name, (path, seconds) in built.items():
        log(f"[build] {path.name}: {seconds:.1f} s")
        resources[name] = build.kernel_resources(name)
        for kernel, r in sorted(resources[name].items()):
            log(f"[build] {name}.cu {kernel}: {r.get('registers')} registers, spills "
                f"{r.get('spill_stores')} bytes stored / {r.get('spill_loads')} loaded")
            dp = int(kernel.split("<")[1].split(">")[0]) if kernel.startswith(WGMMA_FWD) else 0
            wgmma = 0 < dp <= 80 or kernel.startswith(LONG_FWD)
            if wgmma and (r.get("spill_stores") or r.get("spill_loads")):
                fail(f"{name}.cu {kernel} spills: {r}")
    log(f"[build] all kernels: {time.perf_counter() - t0:.1f} s")
    return {"seconds": {name: seconds for name, (_, seconds) in built.items()},
            "resources": resources}


def forward_times(fn) -> dict:
    """A forward wrapper call's device time, and the kernels it runs: the
    small route's bf16 calls must run the wgmma body and nothing else."""
    by_kernel = {_short_kernel_name(k): v for k, v in device_kernels(fn).items()}
    if len(by_kernel) != 1 or not next(iter(by_kernel)).startswith(WGMMA_FWD):
        fail(f"a forward wrapper call ran {sorted(by_kernel)}, expected {WGMMA_FWD} alone")
    return {"device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel}


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
             (4, 16, 200, 64, True), (4, 16, 200, 64, False),
             (4, 16, 1024, 72, True), (4, 16, 1024, 72, False)]
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
            **forward_times(lambda: fused_qkv_attention(qkv, rope=tables)),
            "plain_ms": time_ms(lambda: fused_qkv_attention_reference(qkv, rope=tables),
                                reps=10 if N > 256 else 30),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            "library_device_ms": device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
        }
        row["bound_ms"], row["bound_by"] = _attention_bound(B, H, N, D, rope)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
        log(f"[kernels] nat_attention_fwd B={B} H={H} N={N} D={D} rope={rope}: "
            f"max-abs {err:.3e}, kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), "
            f"plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms (device "
            f"{row['library_device_ms']:.4f}), bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bound_by']})")
    return {"nat_attention_fwd": {"worst_err": worst, "rows": rows}}


def _bwd_bound(B: int, H: int, N: int, D: int, rope: bool) -> tuple[float, str]:
    """Least time on an H100 for one backward call: 10·B·H·N²·D operations
    (S, dP, dV, dQ, dK) at the bf16 peak vs qkv, g and dqkv (3 + 1 + 3 of
    B·N·H·D bf16) and the tables moved once."""
    flops = 10.0 * B * H * N * N * D
    nbytes = 2.0 * (3 + 1 + 3) * B * N * H * D + (2 * N * D * 4 if rope else 0)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# backward cases: the training shape (B = 32), half of it, the microdoppler
# DiT head dim at a ragged N, and N = 1,024, the longest sequence of the
# in-kernel-RoPE route (512² latents)
BWD_CASES = [(32, 16, 256, 72, True), (32, 16, 256, 72, False),
             (16, 16, 256, 72, True), (16, 16, 256, 72, False),
             (4, 16, 200, 64, True), (4, 16, 200, 64, False),
             (4, 16, 1024, 72, True)]


def phase_bwd_kernel(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    worst, rows = 0.0, []
    for B, H, N, D, rope in BWD_CASES:
        qkv, tables = _attention_case(B, H, N, D, rope, gen)
        g = torch.randn((B, N, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        got = fused_qkv_attention_bwd(qkv, g, rope=tables)
        torch.cuda.synchronize()
        check_deterministic(lambda: fused_qkv_attention_bwd(qkv, g, rope=tables),
                            f"nat_attention_bwd at {(B, H, N, D, rope)}")
        ref = fused_qkv_attention_bwd_reference(qkv, g, rope=tables)
        abs_err = (got.float() - ref.float()).abs().max().item()
        err = abs_err / ref.float().abs().max().item()
        if not (err <= BWD_TOL):
            fail(f"backward kernel vs plain at {(B, H, N, D, rope)}: max-rel {err} > {BWD_TOL}")
        worst = max(worst, abs_err)

        # the library yardstick: SDPA's backward on q, k, v rotated beforehand
        if tables is not None:
            cos, sinf = fold_sin(tables, device="cuda")
            c, s = cos[None, :, None].to(qkv.dtype), sinf[None, :, None].to(qkv.dtype)
            rot = lambda x: x * c + torch.roll(x, D // 2, dims=-1) * s  # noqa: E731
        else:
            rot = lambda x: x  # noqa: E731
        q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
                   for t in (rot(qkv[:, :, 0]), rot(qkv[:, :, 1]), qkv[:, :, 2]))
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        gt = g.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(out, (q, k, v), gt, retain_graph=True)  # noqa: E731
        row = {
            "shape": [B, H, N, D], "rope": rope, "max_rel_err": err, "max_abs_err": abs_err,
            "ms": time_ms(lambda: fused_qkv_attention_bwd(qkv, g, rope=tables)),
            **backward_times(lambda: fused_qkv_attention_bwd(qkv, g, rope=tables)),
            "plain_ms": time_ms(lambda: fused_qkv_attention_bwd_reference(qkv, g, rope=tables),
                                reps=10 if N > 256 else 30),
            "library_ms": time_ms(sdpa_bwd),
            "library_device_ms": device_ms(sdpa_bwd),
        }
        row["bound_ms"], row["bound_by"] = _bwd_bound(B, H, N, D, rope)
        rows.append(row)
        _log_bwd_row("nat_attention_bwd", row)
        del out, q, k, v, got, ref
        torch.cuda.empty_cache()
    return {"nat_attention_bwd": {"worst_err": worst, "rows": rows}}


def _log_bwd_row(name: str, row: dict, note: str = "") -> None:
    B, H, N, D = row["shape"]
    log(f"[kernels] {name} B={B} H={H} N={N} D={D} rope={row['rope']}{note}: max-rel "
        f"{row['max_rel_err']:.3e} (max-abs {row['max_abs_err']:.3e}), bit-identical on a second "
        f"call, kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f} ms, SDPA backward {row['library_ms']:.4f} ms (device "
        f"{row['library_device_ms']:.4f}), bound {row['bound_ms'] * 1e3:.2f} us "
        f"({row['bound_by']})")
    log(f"[kernels] {name} B={B} N={N} rope={row['rope']} device ms by launch: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(row["device_ms_by_kernel"].items())))


def _small_case(B: int, H: int, N: int, D: int, rope: bool, gen: torch.Generator):
    """q, k fresh (B, N, H, D) tensors (the q/k norms' outputs) and v the
    strided view qkv[:, :, 2] of a (B, N, 3, H, D) projection, bf16."""
    q, k = (torch.randn((B, N, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    qkv, tables = _attention_case(B, H, N, D, rope, gen)
    return q, k, qkv[:, :, 2], tables


def _rotated_bhnd(q, k, v, tables):
    """SDPA's inputs: q, k rotated as the kernels rotate them, all (B, H, N, D)."""
    if tables is not None:
        cos, sin = (t[None, :, None].to(q.dtype) for t in tables)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
    return [t.transpose(1, 2).contiguous() for t in (q, k, v)]


def phase_small_kernels(seed: int) -> dict:
    """The separate-q/k/v kernels (the qk-norm branch) at the sampling (B=16)
    and training (B=32) shapes and at N = 1,024, with v a strided view of the
    projection."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    result = {}
    for rope in (True, False):
        name = "attn_small_fwd_rope" if rope else "attn_small_fwd"
        worst, rows = 0.0, []
        for B, H, N, D in [(16, 16, 256, 72), (4, 16, 1024, 72)]:
            q, k, v, tables = _small_case(B, H, N, D, rope, gen)
            out = flash_attention(q, k, v, rope=tables)
            torch.cuda.synchronize()
            ref = flash_attention_reference(q, k, v, rope=tables)
            err = (out.float() - ref.float()).abs().max().item()
            if not (err <= ATTN_TOL):
                fail(f"{name} vs plain at {(B, H, N, D)}: max-abs {err} > {ATTN_TOL}")
            worst = max(worst, err)
            qt, kt, vt = _rotated_bhnd(q, k, v, tables)
            row = {
                "shape": [B, H, N, D], "rope": rope, "max_abs_err": err,
                "ms": time_ms(lambda: flash_attention(q, k, v, rope=tables)),
                **forward_times(lambda: flash_attention(q, k, v, rope=tables)),
                "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, rope=tables),
                                    reps=10 if N > 256 else 30),
                "library_ms": time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)),
                "library_device_ms": device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)),
            }
            row["bound_ms"], row["bound_by"] = _attention_bound(B, H, N, D, rope)
            rows.append(row)
            log(f"[kernels] {name} B={B} H={H} N={N} D={D} (v strided): max-abs {err:.3e}, "
                f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms (device "
                f"{row['library_device_ms']:.4f}), bound {row['bound_ms'] * 1e3:.2f} us "
                f"({row['bound_by']})")
            del out, ref, qt, kt, vt
            torch.cuda.empty_cache()
        result[name] = {"worst_err": worst, "rows": rows}

    worst, rows = 0.0, []
    for B, H, N, D, rope in [(32, 16, 256, 72, True), (32, 16, 256, 72, False),
                             (4, 16, 1024, 72, True)]:
        q, k, v, tables = _small_case(B, H, N, D, rope, gen)
        g = torch.randn((B, N, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attention_bwd(q, k, v, g, rope=tables)
        torch.cuda.synchronize()
        check_deterministic(lambda: flash_attention_bwd(q, k, v, g, rope=tables),
                            f"attn_small_bwd at {(B, H, N, D, rope)}")
        ref = flash_attention_bwd_reference(q, k, v, g, rope=tables)
        abs_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(got, ref))
        if not (err <= BWD_TOL):
            fail(f"attn_small_bwd vs plain at {(B, H, N, D, rope)}: max-rel {err} > {BWD_TOL}")
        worst = max(worst, abs_err)
        qt, kt, vt = (t.requires_grad_(True) for t in _rotated_bhnd(q, k, v, tables))
        sdpa = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        gt = g.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
        row = {
            "shape": [B, H, N, D], "rope": rope, "max_rel_err": err, "max_abs_err": abs_err,
            "ms": time_ms(lambda: flash_attention_bwd(q, k, v, g, rope=tables)),
            **backward_times(lambda: flash_attention_bwd(q, k, v, g, rope=tables)),
            "plain_ms": time_ms(lambda: flash_attention_bwd_reference(q, k, v, g, rope=tables),
                                reps=10 if N > 256 else 30),
            "library_ms": time_ms(sdpa_bwd),
            "library_device_ms": device_ms(sdpa_bwd),
        }
        row["bound_ms"], row["bound_by"] = _bwd_bound(B, H, N, D, rope)
        rows.append(row)
        _log_bwd_row("attn_small_bwd", row, " (v strided)")
        del sdpa, qt, kt, vt, got, ref
        torch.cuda.empty_cache()
    result["attn_small_bwd"] = {"worst_err": worst, "rows": rows}
    return result


F32, BF16 = torch.float32, torch.bfloat16


def _long_case(B: int, H: int, N: int, D: int, qk_dtype, v_dtype, gen: torch.Generator):
    """q̃, k̃, v as the long route hands them to ``flash_fwd``: v the strided
    view qkv[:, :, 2] of a (B, N, 3, H, D) projection; fp32 q̃, k̃ its q and k
    rotated with the fp32 tables (the RoPE models), bf16 q̃, k̃ its unrotated
    strided views (``use_rope: false``)."""
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").to(v_dtype)
    if qk_dtype == BF16:
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    tables = (torch.as_tensor(cos[:N], device="cuda"), torch.as_tensor(sin[:N], device="cuda"))
    return rope_uncast(qkv[:, :, 0], tables), rope_uncast(qkv[:, :, 1], tables), qkv[:, :, 2]


def _long_bound(B: int, H: int, N: int, D: int, qk_dtype, v_dtype) -> tuple[float, str]:
    """Least time on an H100 for one ``flash_fwd`` call: q̃·k̃ᵀ (2·B·H·N²·D)
    at the peak of q̃'s type (TF32 tensor cores for fp32 q̃, k̃ with bf16 v,
    bf16 tensor cores for bf16, fp32 FMAs for the all-fp32 pair) and P·V (as
    much again) at the peak of v's type, vs q̃, k̃, v read once and the
    output (in q̃'s type) written once."""
    half = 2.0 * B * H * N * N * D
    qk_peak = {(F32, BF16): PEAK_TF32_FLOPS, (BF16, BF16): PEAK_BF16_FLOPS,
               (F32, F32): PEAK_FP32_FLOPS}[(qk_dtype, v_dtype)]
    pv_peak = PEAK_BF16_FLOPS if v_dtype == BF16 else PEAK_FP32_FLOPS
    t_ops = half / qk_peak + half / pv_peak
    qk_bytes, v_bytes = torch.finfo(qk_dtype).bits / 8, torch.finfo(v_dtype).bits / 8
    t_bytes = (3 * qk_bytes + v_bytes) * B * N * H * D / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


LONG_TILE = 64  # flash_fwd's key tile (kLongTile of flash_fwd_wgmma.cuh, kBlockN of the first bodies)


def _planted_unmasked_tail(q, k, v):
    """``flash_fwd`` with the tail mask dropped: the zero-filled keys past N
    in the last key tile enter the softmax with logit 0 (and v = 0)."""
    pad = -k.shape[1] % LONG_TILE
    zeros = lambda t: torch.cat([t, t.new_zeros(t.shape[0], pad, *t.shape[2:])], dim=1)
    return flash_attention_long_reference(q, zeros(k), zeros(v))


def _planted_no_rescale(q, k, v):
    """``flash_fwd`` with alpha dropped: the running sum and the accumulator
    are not rescaled when a later key tile raises the row max."""
    m = l = acc = None
    for k0 in range(0, k.shape[1], LONG_TILE):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, k0:k0 + LONG_TILE].float())
        s = s * q.shape[-1] ** -0.5
        m = s.amax(-1, keepdim=True) if m is None else torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          v[:, k0:k0 + LONG_TILE].float())
        l = p.sum(-1, keepdim=True) + (0 if l is None else l)
        acc = pv + (0 if acc is None else acc)
    return (acc / l).to(q.dtype).transpose(1, 2)


def phase_long_kernel(seed: int) -> dict:
    """``flash_fwd`` against its plain version at the 1024² path's shapes
    (B = 4 in the CFG phase, 2 in the cond-only phase), in its three dtype
    pairs, and at N = 4,033 (the last key tile holds one key), where the
    planted faults must exceed the limit. The SDPA yardstick takes q̃, k̃
    cast to v's dtype (SDPA takes one dtype: with bf16 v its logits inputs
    are bf16, where the kernel's are TF32) and v."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    N, H, D = (HIRES // 16) ** 2, 16, 72
    cases = [(4, H, N, D, F32, BF16), (2, H, N, D, F32, BF16), (4, H, N, D, BF16, BF16),
             (4, H, N, D, F32, F32), (2, H, 4033, D, F32, BF16)]
    worst, worst_rel, rows = 0.0, 0.0, []
    for B, H, N, D, qk_dtype, v_dtype in cases:
        q, k, v = _long_case(B, H, N, D, qk_dtype, v_dtype, gen)
        out = flash_attention_long(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_long_reference(q, k, v)
        torch.cuda.synchronize()
        if out.dtype != qk_dtype or ref.dtype != qk_dtype:
            fail(f"flash_fwd output {out.dtype}, plain {ref.dtype}, expected {qk_dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_err(out, ref)
        tol = LONG_TOL_F32 if v_dtype == F32 else LONG_TOL
        if not (err <= ATTN_TOL and rel <= tol):
            fail(f"flash_fwd vs plain at {(B, H, N, D, qk_dtype, v_dtype)}: max-abs {err} "
                 f"(limit {ATTN_TOL}), relative {rel} (limit {tol})")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        planted = {}
        if N % LONG_TILE:
            planted = {"unmasked_tail": rel_err(_planted_unmasked_tail(q, k, v), ref),
                       "no_rescale": rel_err(_planted_no_rescale(q, k, v), ref)}
            if not all(r > tol for r in planted.values()):
                fail(f"flash_fwd's limit {tol} does not catch the planted faults {planted}")
            log(f"[kernels] flash_fwd planted faults at N={N}, relative error against the "
                f"plain version: tail mask dropped {planted['unmasked_tail']:.3e}, no rescale "
                f"{planted['no_rescale']:.3e} (limit {tol}; kernel {rel:.3e})")
        qt, kt, vt = (t.to(v_dtype).transpose(1, 2).contiguous() for t in (q, k, v))
        del out, ref
        # with bf16 v every call here takes the wgmma body, the fp32 pair the FMA body
        by_kernel = {_short_kernel_name(name): ms for name, ms
                     in device_kernels(lambda: flash_attention_long(q, k, v)).items()}
        body = LONG_FWD if v_dtype == BF16 else "attn_fwd_kernel"
        if len(by_kernel) != 1 or not next(iter(by_kernel)).startswith(body):
            fail(f"flash_fwd at {(B, H, N, D, qk_dtype, v_dtype)} ran {sorted(by_kernel)}, "
                 f"expected {body} alone")
        row = {
            "shape": [B, H, N, D], "qk_dtype": str(qk_dtype), "v_dtype": str(v_dtype),
            "max_abs_err": err, "rel_err": rel, "planted_rel_err": planted,
            "ms": time_ms(lambda: flash_attention_long(q, k, v)),
            "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
            "plain_ms": time_ms(lambda: flash_attention_long_reference(q, k, v), reps=10),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)),
            "library_device_ms": device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)),
        }
        row["bound_ms"], row["bound_by"] = _long_bound(B, H, N, D, qk_dtype, v_dtype)
        rows.append(row)
        log(f"[kernels] flash_fwd B={B} H={H} N={N} D={D} q/k {qk_dtype} v {v_dtype}: max-abs "
            f"{err:.3e}, relative {rel:.3e}, kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, SDPA (q, k in v's dtype) {row['library_ms']:.4f} ms "
            f"(device {row['library_device_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return {"flash_fwd": {"worst_err": worst, "worst_rel_err": worst_rel, "rows": rows}}


def build_xl(seed: int, branch: str = "production"):
    cfg = branch_config(branch)
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda").eval()
    randomize_(model, seed)  # the JAX init's zero adaLN would make sampling integrate 0
    return cfg, model


def phase_main_path(cfg: Config, model, seed: int, device_info: dict,
                    branch: str = "production", batch: int = BATCH) -> dict:
    C = model.in_channels
    stats = (np.zeros((1, C, 1, 1), np.float32), np.ones((1, C, 1, 1), np.float32))
    vae = VA_VAE(embed_dim=32, img_size=cfg.data.image_size, seed=seed, device="cuda")
    generate = build_sample_fn(cfg, model, stats, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.train.global_seed)
    labels = torch.randint(0, cfg.data.num_classes, (batch,), generator=gen, device="cuda")

    # warm-up: cuBLAS/cuDNN handles and the decoder's algorithms, 3 steps
    warm = build_sample_fn(Config(cfg).merged_with({"sample": {"num_sampling_steps": 3}}),
                           model, stats, device="cuda")
    vae.decode_to_images(warm(labels, generator=gen))
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latents = generate(labels, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    imgs = vae.decode_to_images(latents)
    t2 = time.perf_counter()
    got = counts()
    peak = torch.cuda.max_memory_allocated()

    fwd = BRANCHES[branch]["fwd"]
    want = model.depth * (cfg.sample.num_sampling_steps - 1)  # one forward per step
    expect_counts(got, {fwd: want}, f"{branch} sampling path")
    S = cfg.data.image_size
    if imgs.shape != (batch, S, S, 3) or imgs.dtype != np.uint8:
        fail(f"images {imgs.shape} {imgs.dtype}, expected ({batch}, {S}, {S}, 3) uint8")
    s = model.input_size
    if latents.shape != (batch, s, s, C) or not torch.isfinite(latents).all():
        fail(f"latents {tuple(latents.shape)} not finite or of the wrong shape")
    if latents.float().std().item() == 0.0 or len(np.unique(imgs)) < 16:
        fail("constant latents or images")
    result = {
        "launches": got[fwd], "sample_s": t1 - t0, "decode_s": t2 - t1,
        "samples_per_s": batch / (t2 - t0), "peak_bytes": peak,
        "latent_std": latents.float().std().item(), "image_mean": float(imgs.mean()),
    }
    log(f"[main] {branch} XL/1 {S}² euler-{cfg.sample.num_sampling_steps} split-CFG batch "
        f"{batch}: sampling "
        f"{result['sample_s']:.3f} s, decode {result['decode_s']:.3f} s, "
        f"{result['samples_per_s']:.4f} samples/s, peak {peak / 2**30:.2f} GiB, "
        f"{fwd} launches {got[fwd]} [{device_info['smi']}]")
    return result


@torch.no_grad()
def phase_kernel_on_path(model, seed: int, branch: str = "production",
                         batch: int = 2 * BATCH) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    B = batch
    s = model.input_size
    x = torch.randn((B, s, s, model.in_channels), generator=gen, device="cuda")
    t = torch.rand((B,), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    reset_counts()
    with_kernel = model(x, t, y).float()
    torch.cuda.synchronize()
    expect_counts(counts(), {BRANCHES[branch]["fwd"]: model.depth}, f"{branch} XL/1 forward")
    with plain_attention(branch):
        plain = model(x, t, y).float()
    rel = ((with_kernel - plain).norm() / plain.norm()).item()
    rel_max = ((with_kernel - plain).abs().max() / plain.abs().max()).item()
    if not (rel <= PATH_TOL):
        fail(f"{branch} XL/1 forward with the kernel vs plain attention: relative error {rel} "
             f"> {PATH_TOL}")
    log(f"[path] {branch} XL/1 forward B={B} N={s * s} depth {model.depth}, kernel vs plain "
        f"attention: "
        f"relative error {rel:.3e} (max {rel_max:.3e})")
    return {"rel_err": rel, "rel_max_err": rel_max}


def _training_loss(model, transport, x, y, t, x0, drop):
    """The trainer's loss (velocity MSE + cosine) at fixed draws."""
    terms = transport.losses_at(
        lambda xt, tt: model(xt, tt, y, train=True, force_drop_ids=drop), t, x0, x)
    return terms["loss"].mean() + terms["cos_loss"].mean()


def phase_train_path(cfg: Config, model, seed: int, branch: str = "production",
                     batch: int = 2 * BATCH) -> dict:
    """XL/1 gradients of the training loss with both kernels against those
    with attention forced through the plain version (autograd of it)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    B, s, C = batch, model.input_size, model.in_channels
    transport = build_transport(cfg)
    x = torch.randn((B, s, s, C), generator=gen, device="cuda")
    y = torch.randint(0, cfg.data.num_classes, (B,), generator=gen, device="cuda")
    t = transport.sample_t(B, gen)
    x0 = torch.randn((B, s, s, C), generator=gen, device="cuda")
    drop = (torch.rand((B,), generator=gen, device="cuda") < 0.1).long()
    names, params = zip(*model.named_parameters())
    groups = BRANCHES[branch]["groups"]

    def grads():
        g = torch.autograd.grad(_training_loss(model, transport, x, y, t, x0, drop), params)
        flat = torch.cat([v.float().flatten() for v in g])
        parts = {key: torch.cat([v.float().flatten() for n, v in zip(names, g)
                                 if any(m in n for m in marks)])
                 for key, marks in groups.items()}
        return flat, parts

    fwd, bwd = BRANCHES[branch]["fwd"], BRANCHES[branch]["bwd"]
    reset_counts()
    with_kernel, parts_kernel = grads()
    torch.cuda.synchronize()
    launches = counts()
    # remat "dots" runs the forward kernel again in the backward; the long
    # route has no backward kernel
    want = {fwd: 2 * model.depth} if bwd is None else {fwd: 2 * model.depth, bwd: model.depth}
    expect_counts(launches, want, f"{branch} XL/1 training backward")
    with plain_attention(branch):
        plain, parts_plain = grads()
    rel = ((with_kernel - plain).norm() / plain.norm()).item()
    rel_parts = {key: ((parts_kernel[key] - parts_plain[key]).norm()
                       / parts_plain[key].norm()).item() for key in groups}
    if not (rel <= PATH_TOL and all(r <= PATH_TOL for r in rel_parts.values())):
        fail(f"{branch} XL/1 gradients with the kernels vs plain attention: relative error "
             f"{rel}, {rel_parts} (limit {PATH_TOL})")
    qkv_part = f", attn.qkv {rel_parts['attn.qkv']:.3e}" if "attn.qkv" in rel_parts else ""
    log(f"[train-path] {branch} XL/1 loss gradients B={B} N={s * s} depth {model.depth}, kernels vs "
        f"plain attention: relative error {rel:.3e}{qkv_part}")
    for key, r in rel_parts.items():
        if key != "attn.qkv":
            log(f"[train-path] {branch} XL/1 {key} gradients, kernels vs plain attention: "
                f"relative error {r:.3e}")
    return {"rel_err": rel, **{f"rel_err_{key}": r for key, r in rel_parts.items()},
            "launches": [launches[fwd], launches[bwd] if bwd else 0]}


def phase_train_steps(seed: int, device_info: dict, branch: str = "production") -> dict:
    """The training path: XL/1 from the JAX init through DiTTrainer.train_step."""
    cfg = branch_config(branch)
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda")
    trainer = build_trainer(cfg, model, steps_per_epoch=1, max_steps=cfg.train.max_steps)
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    s, C, steps = model.input_size, model.in_channels, TRAIN_WARMUP + TRAIN_TIMED
    batches = [(torch.randn((TRAIN_BATCH, s, s, C), generator=gen, device="cuda"),
                torch.randint(0, cfg.data.num_classes, (TRAIN_BATCH,), generator=gen,
                              device="cuda")) for _ in range(steps)]
    watch = [i for i, n in enumerate(state.names) if "adaLN" in n or "final_layer" in n]
    before = [state.params[i].detach().clone() for i in watch]
    ema_before = [state.ema_params[i].clone() for i in watch]
    fwd, bwd = BRANCHES[branch]["fwd"], BRANCHES[branch]["bwd"]

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    per_step, losses = [], []
    for i, batch in enumerate(batches):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        c0 = counts()
        losses.append(trainer.train_step(state, batch)["loss"])
        c1 = counts()
        per_step.append({k: c1[k] - c0[k] for k in c1})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()

    want = {fwd: 2 * model.depth, bwd: model.depth}  # remat "dots" runs the forward again
    for i, got in enumerate(per_step):
        expect_counts(got, want, f"{branch} train step {i}")
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite training loss {losses.tolist()}")
    if all(torch.equal(a, b) for a, b in zip(before, (state.params[i] for i in watch))):
        fail("the train steps left the parameters unchanged")
    if all(torch.equal(a, b) for a, b in zip(ema_before, (state.ema_params[i] for i in watch))):
        fail("the train steps left the EMA unchanged")
    result = {
        "batch": TRAIN_BATCH, "timed_steps": TRAIN_TIMED,
        "ms_per_step": seconds / TRAIN_TIMED * 1e3, "img_per_s": TRAIN_BATCH * TRAIN_TIMED / seconds,
        "peak_bytes": peak, "fwd_launches": launches[fwd], "bwd_launches": launches[bwd],
        "launches_per_step": [want[fwd], want[bwd]], "losses": losses.tolist(),
    }
    log(f"[train] {branch} XL/1 train_step batch {TRAIN_BATCH} (remat dots, AdamW, fp32 EMA): "
        f"{result['ms_per_step']:.2f} ms/step, {result['img_per_s']:.2f} img/s, "
        f"peak {peak / 2**30:.2f} GiB, launches per step {want[fwd]} {fwd} / {want[bwd]} "
        f"{bwd}, loss {losses[0]:.4f} → {losses[-1]:.4f} [{device_info['smi']}]")
    return result


def phase_entry_point(seed: int, branch: str = "production") -> dict:
    """do_train on synthetic f16d32 latent shards, then a resumed run."""
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    fwd, bwd = BRANCHES[branch]["fwd"], BRANCHES[branch]["bwd"]
    depth = 2
    try:
        rs = np.random.default_rng(seed)
        data = os.path.join(work, "latents")
        for i in range(2):
            lat = rs.standard_normal((24, 32, 16, 16)).astype(np.float32)
            write_safetensors(os.path.join(data, f"shard_{i:03d}.safetensors"), {
                "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
                "labels": rs.integers(0, 1000, (24,)).astype(np.int32)})
        cfg = branch_config(branch).merged_with({
            "data": {"data_path": data},
            "train": {"max_steps": 4, "global_batch_size": 8, "ckpt_every": 2, "log_every": 2,
                      "output_dir": os.path.join(work, "out"), "exp_name": "smoke"}})
        with xl_depth(depth):  # an XL/1-width DiT, depth 2
            reset_counts()
            t0 = time.perf_counter()
            first = do_train(cfg, device="cuda")
            resumed = do_train(cfg.merged_with({"train": {"max_steps": 6}}), device="cuda")
            seconds = time.perf_counter() - t0
        got = counts()
        ckpts = sorted(os.listdir(os.path.join(work, "out", "smoke", "checkpoints")))
        want = ["0000002.safetensors", "0000004.safetensors", "0000006.safetensors", "config.json"]
        if first.step != 4 or resumed.step != 6 or ckpts != want:
            fail(f"do_train reached steps {first.step}, {resumed.step} with checkpoints {ckpts}")
        # 6 steps, remat "dots"
        expect_counts(got, {fwd: 6 * 2 * depth, bwd: 6 * depth}, f"{branch} do_train")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[entry] {branch} do_train XL/1-width depth 2: 4 steps, resumed to 6, checkpoints "
        f"{ckpts[:-1]}, kernel launches {got[fwd]} {fwd} / {got[bwd]} {bwd}, {seconds:.1f} s")
    return {"steps": [first.step, resumed.step], "checkpoints": ckpts, "seconds": seconds,
            "launches": [got[fwd], got[bwd]]}


def run_paths(branch: str, device: dict) -> dict:
    """Phases 4-8 (or 9-13) on one attention branch."""
    cfg, model = build_xl(SEED, branch)
    out = {"main_path": phase_main_path(cfg, model, SEED, device, branch),
           "kernel_on_path": phase_kernel_on_path(model, SEED, branch),
           "train_path": phase_train_path(cfg, model, SEED, branch)}
    del model
    torch.cuda.empty_cache()
    out["train_steps"] = phase_train_steps(SEED, device, branch)
    out["entry_point"] = phase_entry_point(SEED, branch)
    return out


def phase_no_rope(seed: int) -> dict:
    """Phase 14: the forward kernel without RoPE, on an XL/1-width qk-norm
    model at depth NO_ROPE_DEPTH, forward and loss gradients."""
    branch = "qknorm_no_rope"
    with xl_depth(NO_ROPE_DEPTH):
        cfg, model = build_xl(seed, branch)
    on_path = phase_kernel_on_path(model, seed, branch)
    train_path = phase_train_path(cfg, model, seed, branch)
    del model
    torch.cuda.empty_cache()
    return {"kernel_on_path": on_path, "train_path": train_path}


def phase_hires(seed: int, device: dict) -> dict:
    """Phase 15: the long route at 1024²: XL/1 sampling + decode at per-batch
    2 and the XL/1 forward at batch 4 against plain attention (production),
    the same forward with qk-norm, and the loss gradients of both branches
    at depth HIRES_GRAD_DEPTH, batch 2."""
    cfg, model = build_xl(seed, "hires")
    out = {"main_path": phase_main_path(cfg, model, seed, device, "hires", HIRES_BATCH),
           "kernel_on_path": phase_kernel_on_path(model, seed, "hires", 2 * HIRES_BATCH)}
    del model
    torch.cuda.empty_cache()
    _, model = build_xl(seed, "hires_qknorm")
    out["qknorm_kernel_on_path"] = phase_kernel_on_path(model, seed, "hires_qknorm",
                                                        2 * HIRES_BATCH)
    del model
    torch.cuda.empty_cache()
    for branch in ("hires", "hires_qknorm"):
        with xl_depth(HIRES_GRAD_DEPTH):
            cfg, model = build_xl(seed, branch)
        out[f"{branch}_train_path"] = phase_train_path(cfg, model, seed, branch, HIRES_BATCH)
        del model
        torch.cuda.empty_cache()
    return out


def _kernel_entry(name: str, source: str, replaces: str, launches: int, summary: dict) -> dict:
    row = summary["rows"][0]  # the main path's shape (B=16 forward, B=32 backward, B=4 long)
    return {"name": name, "route": "cuda", "source": f"vavae_tpu_torch/ops/csrc/{source}",
            "replaces": f"vavae_tpu/ops/pallas/flash_attention.py:{replaces}",
            "launches": launches, "max_abs_err": summary["worst_err"], "ms": row["ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"]}


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
    kernels.update(phase_bwd_kernel(SEED))
    kernels.update(phase_small_kernels(SEED))
    kernels.update(phase_long_kernel(SEED))
    production = run_paths("production", device)
    qknorm = run_paths("qknorm", device)
    no_rope = phase_no_rope(SEED)
    hires = phase_hires(SEED, device)

    line = {"kernels": [
        _kernel_entry("nat_attention_fwd", "nat_attention_fwd.cu", "215",
                      production["main_path"]["launches"], kernels["nat_attention_fwd"]),
        _kernel_entry("nat_attention_bwd", "nat_attention_bwd.cu", "240",
                      production["train_steps"]["bwd_launches"], kernels["nat_attention_bwd"]),
        _kernel_entry("attn_small_fwd_rope", "attn_small_fwd.cu", "68",
                      qknorm["main_path"]["launches"], kernels["attn_small_fwd_rope"]),
        _kernel_entry("attn_small_fwd", "attn_small_fwd.cu", "49",
                      no_rope["train_path"]["launches"][0], kernels["attn_small_fwd"]),
        _kernel_entry("attn_small_bwd", "attn_small_bwd.cu", "94",
                      qknorm["train_steps"]["bwd_launches"], kernels["attn_small_bwd"]),
        _kernel_entry("flash_fwd", "flash_fwd.cu", "163",
                      hires["main_path"]["launches"], kernels["flash_fwd"]),
    ]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "build": builds, "kernels": kernels,
                       "production": production, "qknorm": qknorm, "no_rope": no_rope,
                       "hires": hires},
                      f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

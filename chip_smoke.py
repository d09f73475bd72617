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
     the exact op; remat "dots" runs the kernel again);
  16. the fixed-grid samplers on XL/1 at the production ``sample:`` settings
     cut to ``SAMPLER_STEPS`` steps, batch 8, each decoded: heun, Adams–
     Bashforth 2 and 3, the velocity cache (k = 3, orders 1 and 2) through
     ``build_sample_fn``, the adaptive cache through the split-CFG sampler
     with its stats; model calls from the sampler's evaluation rule (and
     the stats), held in the launch counts, beside the cost functions;
  17. SDE sampling (Euler and Heun, ``diffusion_form: sigma``, ``last_step:
     Mean``) with CFG 10 on the concatenated batch, through
     ``build_sample_fn``;
  18. dopri5 split-CFG sampling of the micro-Doppler DiT-S/2
     (``vavae_tpu/configs/dit_s_microdoppler.yaml``, bf16, N = 64 tokens)
     with the controller's stats (accepted, rejected, exhausted per phase),
     decoded;
  19. ``sample_ode_likelihood``: XL/1 euler at batch 2 with the kernels and
     with plain attention (relative error), and dopri5 on the DiT-S/2; the
     Hutchinson term's vector-Jacobian product runs the backward kernel;
  20. FID: ``do_sample`` on XL/1 (a checkpoint of seeded weights) into two
     folders of ``FID_NUM`` images from two seeds, one packed into an npz,
     ``fid_folder_vs_npz`` with random Inception weights on the card:
     FID(a, b) finite and positive, FID(a, a) below 1% of it;
  21. extraction: a seeded folder of 96 PNGs (48 RGB 384×320, BICUBIC only;
     48 RGBA 640×560, one BOX halving first) through ``extract`` with the
     f16d32 VA-VAE at batch 32 and shard size 64, at fp32 (TF32 off) and
     bf16: the shards' names, keys, CHW shapes, labels and stats cache; the
     fp32 posterior mode against the CPU (1e-4 relative), the stored draw
     standardised by its posterior (mean 0, std 1 within 0.05), bf16
     against fp32 (mean rel-L2 < 2%, deviation < 0.1× the posterior std);
     images/s of each run beside its host decode + crop and its encodes'
     device time; then ``do_train`` (XL/1 width, depth 2) for 2 steps on the
     fp32 shards with both kernels' launches counted;
  22. tokenizer evaluation: ``evaluate_tokenizer`` on 32 of those images at
     batch 16, posterior sampled, LPIPS with seeded random VGG16 weights
     and rFID with random Inception weights: PSNR finite, SSIM in [-1, 1],
     LPIPS and rFID finite and ≥ 0; SSIM(a, a) = 1 within 1e-5, LPIPS(a, a)
     = 0 within 1e-6, and SSIM and LPIPS on the card within 1e-4 of the CPU
     with TF32 left on around the calls; images/s and each metric's seconds;
  23. VA-VAE training at full width: the f16d32 VAE of
     ``vavae_tpu/configs/vavae_f16d32.yaml`` (its blocks written into the
     script, ``adaptive_vf: true``, ``disc_start: 4``) with ViT-L DINOv2,
     VGG16 LPIPS and the 3-layer PatchGAN, seeded random weights: one fp32
     step (frozen nets fp32 too) at batch 2 with the discriminator's gate
     open, its last conv scaled by 3e4 (so d_weight is below its clip), and
     explicit noise on the card and on the CPU: every loss part and both
     adaptive weights within 1e-3 relative; after the step each module's
     weights and the BN stats within 1e-3 and its Adam moments within 1e-2
     (relative Frobenius); then 8 ``train_step``s at batch 8 on phase 21's folder
     (frozen nets bf16): finite losses, positive adaptive weights, the
     discriminator unchanged while its gate is closed and moved after, its
     batch-norm stats moved; ms/step of each regime, img/s, peak memory,
     the device's split by class (conv, matmul, norm, elementwise) and busy
     share of a profiled window, and no attention kernel launched;
  24. ``train_vavae.main`` on phase 21's folder (16 of its images the
     validation folder) with the micro-Doppler config's model and three
     stages cut to one epoch each, random ViT-L and LPIPS weights, image
     grids every 4 steps: each stage's ``epoch.json``, ``best/metric.json``,
     grids and chained steps (12, 24, 36); then a relaunch with stage 3 at
     two epochs skips stages 1-2 and resumes stage 3 at epoch 1 (step 48).
Phase 3 also holds the forward kernel at the micro-Doppler DiT-S/2's shapes
(N = 64, 6 heads of 64, with and without RoPE) and the backward at its
likelihood's, and holds ``flash_fwd`` against its plain version at the 1024²
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
from vavae_tpu_torch.eval import fid as fid_mod
from vavae_tpu_torch.eval.fid import (
    FIDExtractor,
    create_npz_from_sample_folder,
    fid_folder_vs_npz,
)
from vavae_tpu_torch.data.image_folder import ImageFolderDataset
from vavae_tpu_torch.eval.metrics import ssim
from vavae_tpu_torch.models import lpips as lpips_mod
from vavae_tpu_torch.models.lpips import LPIPS, init_lpips_weights, load_lpips
from vavae_tpu_torch.models.vit import FoundationModel
from vavae_tpu_torch.pipelines import evaluate_tokenizer as teval
from vavae_tpu_torch.pipelines import train_vavae
from vavae_tpu_torch.pipelines.evaluate_tokenizer import evaluate_tokenizer
from vavae_tpu_torch.pipelines.extract_features import extract, iter_batches, list_image_folder
from vavae_tpu_torch.pipelines.sample import build_sample_fn, do_sample
from vavae_tpu_torch.pipelines.train_dit import build_trainer, do_train
from vavae_tpu_torch.pipelines.train_vavae import build_vae_trainer, make_aux_feature_fn
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.train import checkpoint as ckpt_lib
from vavae_tpu_torch.transport import Sampler, build_transport, create_transport
from vavae_tpu_torch.transport.cost import (
    adaptive_cache_cost,
    dopri5_cost,
    fixed_grid_cost,
    split_idx,
)
from vavae_tpu_torch.utils.config import Config
from vavae_tpu_torch.utils.device_timing import device_kernels, device_ms, time_ms
from vavae_tpu_torch.utils.png import read_png, write_pngs
from vavae_tpu_torch.utils.safetensors_io import flatten, read_safetensors, write_safetensors
from vavae_tpu_torch.utils.weights import dit_state_to_jax, randomize_

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


# the micro-Doppler DiT-S/2's forward shapes (N = 64 tokens, 6 heads of 64):
# its dopri5 CFG phase and a batch of 16, half of one 128-query wgmma block
MICRO_FWD_CASES = [(16, 6, 64, 64, True), (16, 6, 64, 64, False),
                   (8, 6, 64, 64, True), (8, 6, 64, 64, False)]


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(16, 16, 256, 72, True), (16, 16, 256, 72, False),
             (8, 16, 256, 72, True), (8, 16, 256, 72, False),
             (4, 16, 200, 64, True), (4, 16, 200, 64, False),
             (4, 16, 1024, 72, True), (4, 16, 1024, 72, False),
             *MICRO_FWD_CASES]
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
             (4, 16, 1024, 72, True),
             (4, 6, 64, 64, True)]  # the micro-Doppler DiT-S/2 likelihood's


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


# -- phases 16-20: every sampler, the likelihood and FID -----------------------

SAMPLER_STEPS = 50  # num_sampling_steps of phases 16, 17 and 20 (the production 250, cut)
# phase 16: the fixed-grid samplers, each a ``sample:`` block over the production one
SAMPLERS = {
    "heun": {"sampling_method": "heun"},
    "ab2": {"multistep_order": 2},
    "ab3": {"multistep_order": 3},
    "cache_k3_o1": {"velocity_cache_interval": 3, "velocity_cache_order": 1},
    "cache_k3_o2": {"velocity_cache_interval": 3, "velocity_cache_order": 2},
}
ADAPTIVE = {"cache_adaptive": True, "cache_tol": 0.02, "cache_max_interval": 8}
SDE_METHODS = ("Euler", "Heun")
LIKELIHOOD_BATCH, LIKELIHOOD_STEPS = 2, 10
FID_NUM = 16
# the micro-Doppler DiT-S/2 (vavae_tpu/configs/dit_s_microdoppler.yaml), its
# model:, transport: and sample: blocks written out, with ``bf16: true``
MICRODOPPLER = {
    "data": {"image_size": 256, "num_classes": 32, "latent_norm": True,
             "latent_multiplier": 1.0},
    "vae": {"downsample_ratio": 16},
    "model": {"model_type": "LightningDiT-S/2", "use_qknorm": False, "use_swiglu": True,
              "use_rope": True, "use_rmsnorm": True, "wo_shift": False, "in_chans": 32,
              "use_checkpoint": False, "class_dropout_prob": 0.05, "bf16": True},
    "transport": {"path_type": "Linear", "prediction": "velocity", "use_lognorm": True,
                  "use_cosine_loss": True},
    "sample": {"mode": "ODE", "sampling_method": "dopri5", "atol": 1e-6, "rtol": 1e-3,
               "reverse": False, "num_sampling_steps": 300, "cfg_scale": 10.0,
               "per_proc_batch_size": 4, "cfg_interval_start": 0.11, "timestep_shift": 0.1},
    "train": {"global_seed": 0},
}


def _fixed_grid_calls(name: str, s: int, steps: int) -> tuple[int, int]:
    """Model calls of the cond-only and the CFG phase of a fixed-grid split
    sampler over ``steps`` steps, ``s`` of them below the interval: heun
    evaluates twice a step, Adams–Bashforth once (order 3 adds a Heun first
    step in a phase of at least two steps), the cache every k-th step."""
    if name == "heun":
        return 2 * s, 2 * (steps - s)
    if name.startswith("ab"):
        extra = lambda n: int(name == "ab3" and n >= 2)  # noqa: E731
        return s + extra(s), steps - s + extra(steps - s)
    k = int(name.split("_k")[1].split("_")[0])
    return s, -(-(steps - s) // k)


def _split_cfg_fns(cfg: Config, model, labels):
    """The split-CFG program's two model functions, as ``build_sample_fn``
    makes them: cond-only at batch B, [cond | uncond] guided at 2B."""
    y_in = torch.cat([labels, torch.full_like(labels, cfg.data.num_classes)])
    scale = cfg.sample.cfg_scale
    return (lambda x, t: model(x, t, labels),
            lambda x, t: model.forward_with_cfg(x, t, y_in, scale))


@torch.inference_mode()
def _sync_ms(fn, n: int = 20, rounds: int = 7) -> float:
    """Wall ms that one host read of a device value (``.item()``, the
    adaptive samplers' one sync per step or evaluation) adds between two
    calls of ``fn``: n calls with a read after each against n calls back
    to back, the median over ``rounds`` such pairs (the host's own spread
    between runs of n calls is of the order of the sync)."""
    def run(sync: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
            if sync:
                out.flatten()[0].item()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(False), run(True)  # warm-up
    return float(np.median([(run(True) - run(False)) / n * 1e3 for _ in range(rounds)]))


def _sampling_run(what: str, run, vae, batch: int, S: int, want, device_info: dict):
    """``run() -> (latents, extra)`` timed with the decode after it; the
    launch counts held to ``want(extra)``; the images checked. Returns the
    row and ``extra``."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents, extra = run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    imgs = vae.decode_to_images(latents)
    t2 = time.perf_counter()
    got = counts()
    expect_counts(got, want(extra), what)
    if not torch.isfinite(latents).all():
        fail(f"{what}: non-finite latents")
    if imgs.shape != (batch, S, S, 3) or imgs.dtype != np.uint8 or len(np.unique(imgs)) < 16:
        fail(f"{what}: images {imgs.shape} {imgs.dtype} constant or of the wrong shape")
    result = {"sample_s": t1 - t0, "decode_s": t2 - t1, "samples_per_s": batch / (t2 - t0),
              "launches": got, "latent_std": latents.float().std().item()}
    log(f"[samplers] {what}: sampling {result['sample_s']:.3f} s, decode "
        f"{result['decode_s']:.3f} s, {result['samples_per_s']:.4f} samples/s "
        f"[{device_info['smi']}]")
    return result, extra


def phase_fixed_grid_samplers(cfg0: Config, model, vae, seed: int, device_info: dict) -> dict:
    """Phase 16: heun, Adams–Bashforth 2 and 3 and the fixed velocity cache
    (k = 3, orders 1 and 2) through ``build_sample_fn``, and the adaptive
    cache through the split-CFG sampler with its stats, on XL/1 at the
    production settings with ``SAMPLER_STEPS`` steps; each decoded."""
    sc, depth, S = cfg0.sample, model.depth, cfg0.data.image_size
    transport = build_transport(cfg0)
    shift, start = sc.timestep_shift, sc.cfg_interval_start
    s = split_idx(transport, SAMPLER_STEPS, shift, start)
    steps = SAMPLER_STEPS - 1
    C = model.in_channels
    stats = (np.zeros((1, C, 1, 1), np.float32), np.ones((1, C, 1, 1), np.float32))
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    labels = torch.randint(0, cfg0.data.num_classes, (BATCH,), generator=gen, device="cuda")
    out = {"split_idx": s}
    for name, knobs in SAMPLERS.items():
        cfg = Config(cfg0).merged_with({"sample": {"num_sampling_steps": SAMPLER_STEPS, **knobs}})
        generate = build_sample_fn(cfg, model, stats, device="cuda")
        n_cond, n_cfg = _fixed_grid_calls(name, s, steps)
        row, _ = _sampling_run(
            f"XL/1 {name}-{SAMPLER_STEPS} split-CFG batch {BATCH}",
            lambda: (generate(labels, generator=gen), None), vae, BATCH, S,
            lambda _: {"nat_attention_fwd": depth * (n_cond + n_cfg)}, device_info)
        method = "heun" if name == "heun" else "euler"
        k = knobs.get("velocity_cache_interval", 1)
        row.update(model_calls=n_cond + n_cfg, cond_calls=n_cond, cfg_calls=n_cfg,
                   run_cost=0.5 * n_cond + n_cfg,
                   fixed_grid_cost=fixed_grid_cost(transport, SAMPLER_STEPS, shift, start,
                                                   method, k))
        # the JAX cost counts num_steps - s CFG-phase steps, one more than run
        if name != "ab3" and not 0 <= row["fixed_grid_cost"] - row["run_cost"] <= (
                2.0 if name == "heun" else 1.0):
            fail(f"{name}: {row['model_calls']} model calls cost {row['run_cost']}, "
                 f"fixed_grid_cost {row['fixed_grid_cost']}")
        out[name] = row
        log(f"[samplers] XL/1 {name}: {row['model_calls']} model calls ({n_cond} cond-only, "
            f"{n_cfg} CFG), cost {row['run_cost']} (fixed_grid_cost {row['fixed_grid_cost']})")

    fn = Sampler(transport).sample_ode_cfg(
        num_steps=SAMPLER_STEPS, timestep_shift=shift, cfg_interval_start=start,
        return_stats=True, **ADAPTIVE)
    cond, guided = _split_cfg_fns(cfg0, model, labels)
    z = torch.randn((BATCH, model.input_size, model.input_size, C), generator=gen, device="cuda")

    def adaptive():
        with torch.inference_mode():
            return fn(z, cond, guided)

    row, st = _sampling_run(f"XL/1 adaptive-cache-{SAMPLER_STEPS} split-CFG batch {BATCH}",
                            adaptive, vae, BATCH, S,
                            lambda st: {"nat_attention_fwd": depth * (s + st["cfg_evals"])},
                            device_info)
    cost = adaptive_cache_cost(transport, SAMPLER_STEPS, shift, start, st["cfg_evals"])
    z2 = torch.cat([z, z])
    t2 = torch.full((2 * BATCH,), 0.5, device="cuda")
    row.update(model_calls=s + st["cfg_evals"], cfg_evals=st["cfg_evals"],
               noise_floor=float(st["noise_floor"]), run_cost=0.5 * s + st["cfg_evals"],
               adaptive_cache_cost=cost, sync_ms=_sync_ms(lambda: guided(z2, t2)))
    if cost != row["run_cost"]:
        fail(f"adaptive cache: cost {row['run_cost']} of the run, adaptive_cache_cost {cost}")
    out["adaptive"] = row
    log(f"[samplers] XL/1 adaptive cache (tol {ADAPTIVE['cache_tol']}, max "
        f"{ADAPTIVE['cache_max_interval']}): {row['model_calls']} model calls ({s} cond-only, "
        f"{st['cfg_evals']} CFG), noise floor {row['noise_floor']:.4e}, cost {cost}; one host "
        f"sync between two CFG calls adds {row['sync_ms']:.3f} ms")
    return out


def phase_sde(cfg0: Config, model, vae, seed: int, device_info: dict) -> dict:
    """Phase 17: SDE sampling (Euler and Heun, ``diffusion_form: sigma``,
    ``last_step: Mean``) with CFG on the concatenated batch, through
    ``build_sample_fn``."""
    depth, S, C = model.depth, cfg0.data.image_size, model.in_channels
    stats = (np.zeros((1, C, 1, 1), np.float32), np.ones((1, C, 1, 1), np.float32))
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    labels = torch.randint(0, cfg0.data.num_classes, (BATCH,), generator=gen, device="cuda")
    out = {}
    for method in SDE_METHODS:
        cfg = Config(cfg0).merged_with({"sample": {
            "mode": "SDE", "sampling_method": method, "diffusion_form": "sigma",
            "last_step": "Mean", "last_step_size": 0.04, "num_sampling_steps": SAMPLER_STEPS}})
        generate = build_sample_fn(cfg, model, stats, device="cuda")
        calls = (SAMPLER_STEPS - 1) * (2 if method == "Heun" else 1) + 1  # + the last step
        row, _ = _sampling_run(f"XL/1 SDE {method}-{SAMPLER_STEPS} CFG batch {BATCH} (model "
                               f"batch {2 * BATCH})",
                               lambda: (generate(labels, generator=gen), None), vae, BATCH, S,
                               lambda _: {"nat_attention_fwd": depth * calls}, device_info)
        row["model_calls"] = calls
        out[method] = row
    return out


def phase_dopri5(seed: int, device_info: dict, vae) -> dict:
    """Phase 18: the micro-Doppler DiT-S/2's dopri5 split-CFG sampling with
    the controller's stats, decoded."""
    cfg = Config(MICRODOPPLER)
    sc = cfg.sample
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda").eval()
    randomize_(model, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    B = sc.per_proc_batch_size
    labels = torch.randint(0, cfg.data.num_classes, (B,), generator=gen, device="cuda")
    z = torch.randn((B, latent, latent, model.in_channels), generator=gen, device="cuda")
    fn = Sampler(build_transport(cfg)).sample_ode_cfg(
        num_steps=sc.num_sampling_steps, timestep_shift=sc.timestep_shift,
        cfg_interval_start=sc.cfg_interval_start, sampling_method="dopri5", rtol=sc.rtol,
        atol=sc.atol, return_stats=True)
    cond, guided = _split_cfg_fns(cfg, model, labels)
    n_calls = {"cond": 0, "cfg": 0}

    def counted(phase, f):
        def call(x, t):
            n_calls[phase] += 1
            return f(x, t)
        return call

    def run():
        with torch.inference_mode():
            return fn(z, counted("cond", cond), counted("cfg", guided))

    def phase_calls(p):  # 2 evaluations seed a phase, 6 each attempted step
        return 2 + 6 * (p["naccept"] + p["nreject"]) if p else 0

    def calls(st):
        return phase_calls(st["cond"]) + phase_calls(st["cfg"])

    row, st = _sampling_run(f"micro-Doppler DiT-S/2 dopri5 split-CFG batch {B}", run, vae, B,
                            cfg.data.image_size,
                            lambda st: {"nat_attention_fwd": model.depth * calls(st)},
                            device_info)
    z2, t2 = torch.cat([z, z]), torch.full((2 * B,), 0.5, device="cuda")
    row.update(stats=st, model_calls=calls(st), dopri5_cost=dopri5_cost(st),
               exhausted=any(p["exhausted"] for p in st.values() if p),
               sync_ms=_sync_ms(lambda: guided(z2, t2)))
    if (n_calls["cond"], n_calls["cfg"]) != (phase_calls(st["cond"]), phase_calls(st["cfg"])) \
            or row["dopri5_cost"] != 0.5 * n_calls["cond"] + n_calls["cfg"]:
        fail(f"dopri5: model calls {n_calls}, stats {st}, dopri5_cost {row['dopri5_cost']}")
    log(f"[samplers] DiT-S/2 dopri5 (atol {sc.atol}, rtol {sc.rtol}): cond phase "
        f"{st['cond']}, CFG phase {st['cfg']}, {row['model_calls']} model calls, dopri5_cost "
        f"{row['dopri5_cost']}, exhausted {row['exhausted']}; one host sync a step adds "
        f"{row['sync_ms']:.3f} ms")
    return row, model


def phase_likelihood(model, micro, seed: int) -> dict:
    """Phase 19: ``sample_ode_likelihood`` on XL/1 (euler) with the kernels
    and with attention forced through the plain version, and with dopri5
    on the micro-Doppler DiT-S/2; the Hutchinson term runs the backward
    kernel (the model's remat runs the forward again)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 70)
    out = {}
    for name, m, classes, method, B in (
            ("XL/1", model, PRODUCTION["data"]["num_classes"], "euler", LIKELIHOOD_BATCH),
            ("DiT-S/2", micro, MICRODOPPLER["data"]["num_classes"], "dopri5", 4)):
        s = m.input_size
        x = torch.randn((B, s, s, m.in_channels), generator=gen, device="cuda")
        y = torch.randint(0, classes, (B,), generator=gen, device="cuda")
        eps = torch.randint(0, 2, x.shape, generator=gen, device="cuda").float() * 2 - 1
        fn = Sampler(create_transport()).sample_ode_likelihood(
            sampling_method=method, num_steps=LIKELIHOOD_STEPS)
        n_calls = [0]

        def model_fn(xv, t):
            n_calls[0] += 1
            return m(xv, t, y)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp, zt = fn(x, model_fn, eps=eps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        calls = n_calls[0]
        remat = 2 if m.use_checkpoint else 1
        expect_counts(counts(), {"nat_attention_fwd": remat * m.depth * calls,
                                 "nat_attention_bwd": m.depth * calls}, f"{name} likelihood")
        if not (torch.isfinite(logp).all() and torch.isfinite(zt).all()):
            fail(f"{name} likelihood: non-finite result")
        row = {"method": method, "batch": B, "model_calls": calls, "seconds": seconds,
               "logp": logp.tolist(), "launches": counts()}
        if method == "euler":
            if calls != LIKELIHOOD_STEPS - 1:
                fail(f"{name} likelihood: {calls} model calls, expected {LIKELIHOOD_STEPS - 1}")
            with plain_attention("production"):
                logp_plain, z_plain = fn(x, model_fn, eps=eps)
            row["rel_err"] = rel_err(logp, logp_plain)
            row["rel_err_z"] = rel_err(zt, z_plain)
            if not (row["rel_err"] <= PATH_TOL and row["rel_err_z"] <= PATH_TOL):
                fail(f"{name} likelihood with the kernels vs plain attention: relative error "
                     f"{row['rel_err']} (z {row['rel_err_z']}), limit {PATH_TOL}")
        elif (calls - 2) % 6:
            fail(f"{name} dopri5 likelihood: {calls} model calls, not 2 + 6 a step")
        out[name] = row
        errs = (f", kernels vs plain attention: relative error {row['rel_err']:.3e} (z "
                f"{row['rel_err_z']:.3e})" if "rel_err" in row else "")
        log(f"[likelihood] {name} {method} batch {B}: {calls} model calls, {seconds:.3f} s, "
            f"launches {row['launches']}{errs}")
    return out


def phase_fid(seed: int, work: str) -> dict:
    """Phase 20: ``do_sample`` on XL/1 (euler-``SAMPLER_STEPS``, random
    weights from a checkpoint written here) into two folders of
    ``FID_NUM`` images from two seeds, one packed into an npz, and
    ``fid_folder_vs_npz`` with random Inception weights on the card."""
    cfg, model = build_xl(seed)
    ckpt = os.path.join(work, "xl.safetensors")
    write_safetensors(ckpt, flatten(dit_state_to_jax(model.state_dict()), "params"))
    del model
    torch.cuda.empty_cache()
    folders = {}
    t0 = time.perf_counter()
    for name, global_seed in (("a", seed), ("b", seed + 1)):
        folders[name] = os.path.join(work, f"samples_{name}")
        run = cfg.merged_with({
            "ckpt_path": ckpt, "sample_folder": folders[name],
            "data": {"latent_norm": False},
            "sample": {"num_sampling_steps": SAMPLER_STEPS, "fid_num": FID_NUM},
            "train": {"global_seed": global_seed}})
        reset_counts()
        do_sample(run, device="cuda")
        torch.cuda.empty_cache()
    sample_s = time.perf_counter() - t0
    npz = create_npz_from_sample_folder(folders["a"], num=FID_NUM)

    os.environ["VAVAE_FID_ALLOW_RANDOM"] = "1"  # no Inception weights on the card's machine
    extractor = FIDExtractor(batch_size=FID_NUM, device="cuda")
    imgs = np.stack([read_png(os.path.join(folders["a"], f"{i:06d}.png"))
                     for i in range(FID_NUM)])
    extractor.activations([imgs])  # warm-up: cuDNN's algorithms
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acts = extractor.activations([imgs])
    inception_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    fid_ab = fid_folder_vs_npz(folders["b"], npz, batch_size=FID_NUM, device="cuda")
    fid_aa = fid_folder_vs_npz(folders["a"], npz, batch_size=FID_NUM, device="cuda")
    fid_s = (time.perf_counter() - t2) / 2
    if not (np.isfinite(fid_ab) and fid_ab > 0 and np.isfinite(acts).all()):
        fail(f"FID(a, b) = {fid_ab}, not finite and positive")
    if not abs(fid_aa) < 0.01 * fid_ab:
        fail(f"FID(a, a) = {fid_aa} is not below 1% of FID(a, b) = {fid_ab}")
    result = {"fid_ab": fid_ab, "fid_aa": fid_aa, "images": FID_NUM, "sample_s": sample_s,
              "inception_images_per_s": FID_NUM / inception_s, "fid_s": fid_s}
    log(f"[fid] do_sample XL/1 euler-{SAMPLER_STEPS} x2 ({FID_NUM} images each): "
        f"{sample_s:.1f} s; Inception (random weights) {result['inception_images_per_s']:.1f} "
        f"images/s at batch {FID_NUM}; FID(a, b) {fid_ab:.4f}, FID(a, a) {fid_aa:.3e}, "
        f"{fid_s:.1f} s per FID (host sqrtm included)")
    return result


def run_samplers(seed: int, device_info: dict) -> dict:
    """Phases 16-20."""
    t0 = time.perf_counter()
    cfg, model = build_xl(seed)
    vae = VA_VAE(embed_dim=32, img_size=cfg.data.image_size, seed=seed, device="cuda")
    out = {"fixed_grid": phase_fixed_grid_samplers(cfg, model, vae, seed, device_info),
           "sde": phase_sde(cfg, model, vae, seed, device_info)}
    out["dopri5"], micro = phase_dopri5(seed, device_info, vae)
    out["likelihood"] = phase_likelihood(model, micro, seed)
    del model, micro, vae
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_fid_")
    try:
        out["fid"] = phase_fid(seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[samplers] phases 16-20: {out['seconds']:.1f} s")
    return out


# -- phases 21-22: the tokenizer side ---------------------------------------------

# phase 21's image folder: (class, colour, width, height); 48 PNGs a class.
# 384×320 takes BICUBIC only; 640×560 one BOX halving (short side ≥ 512),
# then BICUBIC to 293×256
EXTRACT_CLASSES = (("class_0", 3, 384, 320), ("class_1", 4, 640, 560))
EXTRACT_PER_CLASS = 48
EXTRACT_BATCH, EXTRACT_SHARD = 32, 64  # 96 images: shards of 64 and 32
EVAL_BATCH, EVAL_IMAGES = 16, 32
METRIC_TOL = 1e-4  # SSIM and LPIPS on the card against the CPU, relative


def write_image_folder(root: str, seed: int) -> None:
    """Seeded PNGs: a coarse random layout (16-px cells) plus noise, so the
    files are neither constant nor pure noise."""
    rs = np.random.default_rng(seed)
    for name, c, w, h in EXTRACT_CLASSES:
        os.makedirs(os.path.join(root, name))
        for i in range(EXTRACT_PER_CLASS):
            cells = rs.integers(0, 256, (h // 16 + 1, w // 16 + 1, c)).astype(np.int16)
            img = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:h, :w]
            img = np.clip(img + rs.integers(-12, 13, img.shape), 0, 255).astype(np.uint8)
            write_pngs(img[None], [os.path.join(root, name, f"{i:03d}.png")])


def _extraction_run(folder: str, out: str, vae, seed: int) -> tuple[dict, np.ndarray]:
    """``extract`` timed as a user runs it; then its host side (decode +
    crop) and its device side (the encodes, CUDA events) apart. Returns the
    row and the first batch of images."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    extract(folder, out, vae, batch_size=EXTRACT_BATCH, image_size=256,
            shard_size=EXTRACT_SHARD, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    batches = list(iter_batches(list_image_folder(folder), EXTRACT_BATCH, 256))
    host_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [(torch.from_numpy(x).cuda(), torch.from_numpy(xf).cuda()) for x, xf, _ in batches]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x, xf in xs:
        vae.encode_images(x, generator=gen)
        vae.encode_images(xf, generator=gen)
    end.record()
    torch.cuda.synchronize()
    n = sum(len(b[2]) for b in batches)
    return {"wall_s": wall, "images_per_s": n / wall, "host_decode_crop_s": host_s,
            "encode_device_s": start.elapsed_time(end) / 1e3, "peak_bytes": peak}, batches[0][0]


def _check_shards(out: str) -> None:
    names = sorted(os.listdir(out))
    want = ["latents_rank00_shard000.safetensors", "latents_rank00_shard001.safetensors",
            "latents_stats.safetensors"]
    if names != want:
        fail(f"extraction wrote {names}, expected {want}")
    labels = []
    for name, n in zip(names[:2], (EXTRACT_SHARD, 2 * EXTRACT_PER_CLASS - EXTRACT_SHARD)):
        t = read_safetensors(os.path.join(out, name))[0]
        if sorted(t) != ["labels", "latents", "latents_flip"]:
            fail(f"{name}: keys {sorted(t)}")
        for k in ("latents", "latents_flip"):
            if t[k].shape != (n, 32, 16, 16) or t[k].dtype != np.float32 \
                    or not np.isfinite(t[k]).all():
                fail(f"{name}: {k} {t[k].shape} {t[k].dtype}, not finite (n, 32, 16, 16) fp32")
        labels.append(t["labels"])
    labels = np.concatenate(labels)
    if labels.dtype != np.int32 or (labels != np.repeat([0, 1], EXTRACT_PER_CLASS)).any():
        fail(f"extraction labels {labels}")
    stats = read_safetensors(os.path.join(out, names[2]))[0]
    if stats["mean"].shape != (1, 32, 1, 1) or not (stats["std"] > 0).all():
        fail(f"stats cache {stats['mean'].shape}, std {stats['std'].ravel()[:4]}")


def phase_extraction(seed: int, device_info: dict, work: str) -> tuple[dict, VA_VAE]:
    """Phase 21: ``extract`` on a seeded folder of 96 PNGs with the f16d32
    VA-VAE at fp32 (TF32 off) and bf16, then ``do_train`` on its shards."""
    folder = os.path.join(work, "images")
    t0 = time.perf_counter()
    write_image_folder(folder, seed)
    write_s = time.perf_counter() - t0
    vaes = {"fp32": VA_VAE(embed_dim=32, img_size=256, seed=seed, device="cuda"),
            "bf16": VA_VAE(embed_dim=32, img_size=256, dtype=torch.bfloat16, seed=seed,
                           device="cuda")}
    warm = np.zeros((EXTRACT_BATCH, 256, 256, 3), np.float32)
    for vae in vaes.values():  # cuDNN's handles and algorithms
        vae.encode_moments(warm)
    out, runs = {}, {}
    reset_counts()
    for name, vae in vaes.items():
        out[name] = os.path.join(work, f"latents_{name}")
        runs[name], x = _extraction_run(folder, out[name], vae, seed)
        _check_shards(out[name])
    expect_counts(counts(), {}, "extraction")  # the VAE runs no attention kernel

    # fp32 on the card against the CPU, on one image of each class
    last, _, _ = next(iter_batches(list_image_folder(folder)[-1:], 1, 256))
    pair = np.concatenate([x[:1], last])
    host = VA_VAE(embed_dim=32, img_size=256, seed=seed, device="cpu")
    card_mean = vaes["fp32"].encode_moments(pair).mean
    cpu_mean = host.encode_moments(pair).mean
    cpu_err = rel_err(card_mean.cpu(), cpu_mean)
    del host
    if not cpu_err <= 1e-4:
        fail(f"fp32 encode on the card vs the CPU: relative error {cpu_err:.3e} > 1e-4")
    # the stored draw of the first batch, standardised by its posterior
    post = vaes["fp32"].encode_moments(x)
    stored = read_safetensors(os.path.join(out["fp32"], "latents_rank00_shard000.safetensors"))[0]
    z = torch.from_numpy(stored["latents"][:EXTRACT_BATCH]).cuda().permute(0, 2, 3, 1)
    res = ((z - post.mean) / post.std).float()
    res_mean, res_std = res.mean().item(), res.std().item()
    if not (abs(res_mean) < 0.05 and abs(res_std - 1) < 0.05):
        fail(f"standardised posterior draw: mean {res_mean:.4f}, std {res_std:.4f}")
    # bf16 against fp32: the JAX package's bounds (tests/test_vae.py)
    p16 = vaes["bf16"].encode_moments(x)
    dev = p16.mean - post.mean
    bf16_rel = (dev.norm() / post.mean.norm()).item()
    bf16_ratio = (dev.square().mean().sqrt() / post.std.square().mean().sqrt()).item()
    if not (bf16_rel < 0.02 and bf16_ratio < 0.1):
        fail(f"bf16 encode: mean rel-L2 {bf16_rel:.4f}, deviation {bf16_ratio:.4f}x the std")
    del vaes["bf16"]
    torch.cuda.empty_cache()

    # the DiT trainer reads the fp32 shards: 2 steps at XL/1 width, depth 2
    depth, steps = 2, 2
    cfg = branch_config("production").merged_with({
        "data": {"data_path": out["fp32"]},
        "train": {"max_steps": steps, "global_batch_size": 8, "ckpt_every": steps,
                  "log_every": 1, "output_dir": os.path.join(work, "train"), "exp_name": "smoke"}})
    with xl_depth(depth):
        reset_counts()
        t0 = time.perf_counter()
        state = do_train(cfg, device="cuda")
        train_s = time.perf_counter() - t0
    got = counts()
    fwd, bwd = BRANCHES["production"]["fwd"], BRANCHES["production"]["bwd"]
    if state.step != steps:
        fail(f"do_train on the extracted shards reached step {state.step}")
    expect_counts(got, {fwd: steps * 2 * depth, bwd: steps * depth}, "do_train on extracted shards")

    result = {"images": 2 * EXTRACT_PER_CLASS, "write_pngs_s": write_s, "runs": runs,
              "cpu_rel_err": cpu_err, "residual_mean": res_mean, "residual_std": res_std,
              "bf16_mean_rel": bf16_rel, "bf16_dev_over_std": bf16_ratio,
              "train_s": train_s, "train_launches": [got[fwd], got[bwd]]}
    for name, r in runs.items():
        log(f"[extract] {name}: {result['images']} images (x2 with flips) in {r['wall_s']:.2f} s, "
            f"{r['images_per_s']:.2f} images/s; host decode + crop {r['host_decode_crop_s']:.2f} s, "
            f"encode device {r['encode_device_s']:.3f} s "
            f"({result['images'] / r['encode_device_s']:.1f} images/s); peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB [{device_info['smi']}]")
    log(f"[extract] fp32 card vs CPU {cpu_err:.3e}; draw residual mean {res_mean:.4f} std "
        f"{res_std:.4f}; bf16 mean rel-L2 {bf16_rel:.4f}, deviation {bf16_ratio:.4f}x std; "
        f"do_train {steps} steps on the shards {train_s:.1f} s, launches {got[fwd]} {fwd} / "
        f"{got[bwd]} {bwd}")
    return result, vaes["fp32"]


def _timed(fn, seconds: dict, key: str):
    """Smoke-only: ``fn`` with each call's synchronised wall time added to
    ``seconds[key]``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return out

    return wrapper


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


def phase_tokenizer_eval(seed: int, device_info: dict, work: str, vae: VA_VAE) -> dict:
    """Phase 22: ``evaluate_tokenizer`` on phase 21's folder with seeded
    random LPIPS (VGG16 at full width) and Inception weights, the posterior
    sampled; SSIM and LPIPS on the card against the CPU with TF32 on."""
    folder = os.path.join(work, "images")
    lpips = LPIPS()
    init_lpips_weights(lpips, torch.Generator().manual_seed(seed))
    weights = os.path.join(work, "lpips.pth")
    torch.save(lpips.state_dict(), weights)
    os.environ["VAVAE_FID_ALLOW_RANDOM"] = "1"  # no Inception weights on the card's machine
    out = os.path.join(work, "eval")
    seconds: dict = {}
    load = lpips_mod.load_lpips
    with _patched(teval, "psnr", _timed(teval.psnr, seconds, "psnr")), \
            _patched(teval, "ssim", _timed(teval.ssim, seconds, "ssim")), \
            _patched(lpips_mod, "load_lpips",
                     lambda *a, **k: _timed(load(*a, **k), seconds, "lpips")), \
            _patched(fid_mod, "fid_given_paths", _timed(fid_mod.fid_given_paths, seconds, "rfid")):
        t0 = time.perf_counter()
        res = evaluate_tokenizer(vae, folder, output_path=out, max_images=EVAL_IMAGES,
                                 batch_size=EVAL_BATCH, image_size=256, lpips_weights=weights,
                                 sample_posterior=True, seed=seed)
        total = time.perf_counter() - t0
    if res.get("num_images") != EVAL_IMAGES or not np.isfinite(res["psnr"]) \
            or not -1 <= res["ssim"] <= 1 or not (np.isfinite(res.get("lpips", np.nan))
                                                 and res["lpips"] >= 0) \
            or not (np.isfinite(res.get("rfid", np.nan)) and res["rfid"] >= 0):
        fail(f"evaluate_tokenizer gave {res}")

    # identities, and the card against the CPU with TF32 left on
    ref = np.stack([read_png(os.path.join(out, "ref", f"00_{i:06d}.png")) for i in range(4)])
    dec = np.stack([read_png(os.path.join(out, "dec", f"00_{i:06d}.png")) for i in range(4)])
    a = torch.from_numpy(ref).float() / 255
    b = torch.from_numpy(dec).float() / 255
    lp_cuda = load_lpips(weights, device="cuda")
    lp_cpu = load_lpips(weights, device="cpu")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            ssim_aa = ssim(a.cuda(), a.cuda())
            lpips_aa = lp_cuda(2 * a.cuda() - 1, 2 * a.cuda() - 1)
            ssim_card = ssim(a.cuda(), b.cuda())
            lpips_card = lp_cuda(2 * a[:2].cuda() - 1, 2 * b[:2].cuda() - 1)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    with torch.no_grad():
        ssim_err = rel_err(ssim_card.cpu(), ssim(a, b))
        lpips_err = rel_err(lpips_card.cpu(), lp_cpu(2 * a[:2] - 1, 2 * b[:2] - 1))
    aa_ssim = float((ssim_aa - 1).abs().max())
    aa_lpips = float(lpips_aa.abs().max())
    if not (aa_ssim <= 1e-5 and aa_lpips <= 1e-6):
        fail(f"SSIM(a, a) off 1 by {aa_ssim:.3e}, LPIPS(a, a) {aa_lpips:.3e}")
    if not (ssim_err <= METRIC_TOL and lpips_err <= METRIC_TOL):
        fail(f"card vs CPU with TF32 on: SSIM {ssim_err:.3e}, LPIPS {lpips_err:.3e} > {METRIC_TOL}")
    result = {**res, "images_per_s": EVAL_IMAGES / total, "seconds": total,
              "metric_seconds": seconds, "ssim_aa_err": aa_ssim, "lpips_aa": aa_lpips,
              "ssim_cpu_rel": ssim_err, "lpips_cpu_rel": lpips_err}
    log(f"[tokenizer-eval] {EVAL_IMAGES} images at batch {EVAL_BATCH}, posterior sampled: "
        f"PSNR {res['psnr']:.4f} dB, SSIM {res['ssim']:.5f}, LPIPS {res['lpips']:.5f}, rFID "
        f"{res['rfid']:.4f}; {total:.2f} s, {result['images_per_s']:.2f} images/s; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; card vs CPU (TF32 on) SSIM {ssim_err:.2e}, LPIPS {lpips_err:.2e}; SSIM(a, a)-1 "
        f"{aa_ssim:.1e}, LPIPS(a, a) {aa_lpips:.1e} [{device_info['smi']}]")
    return result


def run_tokenizer(seed: int, device_info: dict) -> dict:
    """Phases 21-22."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tokenizer_")
    try:
        extraction, vae = phase_extraction(seed, device_info, work)
        evaluation = phase_tokenizer_eval(seed, device_info, work, vae)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"extraction": extraction, "evaluation": evaluation,
           "seconds": time.perf_counter() - t0}
    log(f"[tokenizer] phases 21-22: {out['seconds']:.1f} s")
    return out


# -- phases 23-24: VA-VAE training ---------------------------------------------------

# vavae_tpu/configs/vavae_f16d32.yaml's blocks, written out (no YAML parser
# on the card), with the discriminator's gate at step 4 of phase 23's 8
VAVAE_F16D32 = {
    "ckpt_path": None,
    "model": {"base_learning_rate": 1.0e-4, "params": {
        "monitor": "val/rec_loss", "embed_dim": 32, "use_vf": "dinov2", "reverse_proj": True,
        "lossconfig": {"params": {"disc_start": 5001, "kl_weight": 1.0e-6, "disc_weight": 0.5,
                                  "vf_weight": 0.1, "adaptive_vf": True, "distmat_margin": 0.25,
                                  "cos_margin": 0.5}},
        "ddconfig": {"double_z": True, "z_channels": 32, "resolution": 256, "in_channels": 3,
                     "out_ch": 3, "ch": 128, "ch_mult": [1, 1, 2, 2, 4], "num_res_blocks": 2,
                     "attn_resolutions": [16], "dropout": 0.0}}},
}
# vavae_tpu/configs/vavae_microdoppler_finetune.yaml: its model differs from
# the above in its loss block only; its three stages cut to one epoch each
MICRODOPPLER_LOSS = {"kl_weight": 1.0e-6, "disc_weight": 0.5, "adaptive_vf": False,
                     "perceptual_weight": 1.0}
MICRODOPPLER_STAGES = [
    {"epochs": 1, "vf_weight": 0.5, "distmat_margin": 0.0, "cos_margin": 0.0, "disc_start": 5001,
     "lr": 1.0e-4},
    {"epochs": 1, "vf_weight": 0.1, "distmat_margin": 0.0, "cos_margin": 0.0, "disc_start": 1,
     "lr": 5.0e-5},
    {"epochs": 1, "vf_weight": 0.1, "distmat_margin": 0.25, "cos_margin": 0.5, "disc_start": 1,
     "lr": 2.0e-5},
]
VAE_BATCH, VAE_STEPS, VAE_DISC_START = 8, 8, 4  # train.batch_size of the micro-Doppler config
VAE_CPU_BATCH = 2   # the card-vs-CPU step
VAE_CPU_TOL = 1e-3  # relative: each loss part, adaptive weight, module's weights and BN stats
# relative Frobenius, each module's Adam moments after the gate-open step: the
# GAN term's gradient is a small residual of cancelling terms scaled by
# d_weight (tests/test_torch_vae_train.py's GAN_TOL, on the CPU)
VAE_MOMENT_TOL = 1e-2
# the discriminator's last conv scaled up for the card-vs-CPU step: at taming's
# init ‖∇g‖ at the decoder's last layer is about 6e5 times smaller than ‖∇nll‖
# (2 · d_weight · this scale, from the phase's log line), so d_weight would sit
# at its clip (1e4 × disc_weight) on both sides and its value would not be
# compared; ‖∇g‖ is linear in this scale, which brings d_weight near 10
VAE_DISC_OUT_SCALE = 3e4
VAE_VAL_IMAGES, VAE_LOG_IMAGES_EVERY = 16, 4
VAE_METRICS = ("rec_loss", "kl_loss", "g_loss", "vf_loss", "vf_distmat", "vf_cos", "nll_loss",
               "total_loss", "d_weight", "vf_weight", "logits_real", "logits_fake")


def vae_kernel_class(name: str) -> str:
    """conv: cuDNN's convolutions, their FFT algorithm's transforms and
    complex products (``fft``, ``cf32`` gemm, ``complex``) included;
    matmul: the real GEMMs (the bf16 ViT-L, the VAE's attention, 1×1
    convolutions cuDNN runs as GEMMs); norm: the group and layer norms'
    kernels; the rest elementwise (the discriminator's batch norm is
    elementwise ops)."""
    low = name.lower()
    if "norm" in low or "moments" in low or "welford" in low:
        return "norm"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft",
                              "cf32", "complex")):
        return "conv"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")):
        return "matmul"
    return "elementwise"


def _first_batch(folder: str, batch: int) -> np.ndarray:
    return next(ImageFolderDataset(folder, image_size=256).batches(batch, seed=0, epochs=1))[0]


def _vae_trainer(cfg: Config, foundation, lpips, device: str):
    return build_vae_trainer(cfg, foundation=foundation, lpips=lpips,
                             vf_dim=foundation.feature_dim, device=device)


def _vae_module(key: str) -> str:
    """The module of a train-state file key: ``gen_params|vae|encoder``,
    ``gen_opt|0|mu|proj``, ``disc_params|bn2``, ..."""
    parts = key.split("|")
    head = 3 if parts[0].endswith("_opt") else 1
    return "|".join(parts[:head + (2 if parts[head] == "vae" else 1)])


def phase_vae_cpu_check(seed: int, folder: str, cfg: Config, foundation, lpips) -> dict:
    """One fp32 step with the discriminator's gate open (frozen nets fp32
    too) at VAE_CPU_BATCH with explicit noise on the card and on the CPU
    from the same seeded weights, the discriminator's last conv scaled by
    VAE_DISC_OUT_SCALE: every loss part and both adaptive weights (d_weight
    below its clip) within VAE_CPU_TOL; after the step each module's
    weights and the BN stats within VAE_CPU_TOL and its Adam moments within
    VAE_MOMENT_TOL (relative Frobenius)."""
    cfg = cfg.merged_with({"model": {"params": {
        "frozen_bf16": False, "lossconfig": {"params": {"disc_start": 0}}}}})
    x = _first_batch(folder, VAE_CPU_BATCH)
    p = cfg.model.params
    side = p.ddconfig.resolution // 2 ** (len(p.ddconfig.ch_mult) - 1)
    noise = np.random.default_rng(seed).standard_normal(
        (VAE_CPU_BATCH, side, side, p.embed_dim)).astype(np.float32)

    def step(trainer):
        state = trainer.init_state(seed)
        with torch.no_grad():
            trainer.disc.conv_out.weight.mul_(VAE_DISC_OUT_SCALE)
        t0 = time.perf_counter()
        m = {k: v.item() for k, v in trainer.train_step(state, x, noise=noise).items()}
        return m, ckpt_lib.vae_state_tensors(state)[0], time.perf_counter() - t0

    card = _vae_trainer(cfg, foundation, lpips, "cuda")  # the trainer pins fp32 itself
    m_card, s_card, _ = step(card)
    del card
    torch.cuda.empty_cache()
    cpu_fm = FoundationModel("dinov2", device="cpu").init_random(0)
    cpu_lpips = LPIPS()
    init_lpips_weights(cpu_lpips, torch.Generator().manual_seed(seed))
    m_cpu, s_cpu, cpu_s = step(_vae_trainer(cfg, cpu_fm, cpu_lpips.eval(), "cpu"))
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6) for k in VAE_METRICS}
    worst = max(rel, key=rel.get)
    clip = 1e4 * cfg.model.params.lossconfig.params.disc_weight
    groups: dict = {}
    for key in s_cpu:
        if key != "step" and not key.endswith("count"):
            groups.setdefault(_vae_module(key), []).append(key)
    fro = {}
    for g, keys in groups.items():
        err = sum(float(np.square(s_card[k].astype(np.float64) - s_cpu[k]).sum()) for k in keys)
        ref = sum(float(np.square(s_cpu[k].astype(np.float64)).sum()) for k in keys)
        fro[g] = (err / max(ref, 1e-30)) ** 0.5
    worst_w = max((g for g in fro if "_opt" not in g), key=fro.get)
    worst_m = max((g for g in fro if "_opt" in g), key=fro.get)
    log(f"[vae-train] card vs CPU, one fp32 gate-open step at batch {VAE_CPU_BATCH} "
        f"({cpu_s:.1f} s on the CPU): worst loss part {worst} {rel[worst]:.2e}; d_weight "
        f"{m_card['d_weight']:.4f} / {m_cpu['d_weight']:.4f}, vf_weight {m_card['vf_weight']:.4f} / "
        f"{m_cpu['vf_weight']:.4f}; after the step, worst module {worst_w} {fro[worst_w]:.2e}, "
        f"worst moments {worst_m} {fro[worst_m]:.2e}")
    if not rel[worst] <= VAE_CPU_TOL:
        fail(f"VA-VAE step, card vs CPU: {worst} relative error {rel[worst]:.3e} > {VAE_CPU_TOL}: "
             f"{rel}")
    if not (m_cpu["disc_factor"] == 1.0 and 0 < m_card["d_weight"] < 0.99 * clip):
        fail(f"VA-VAE step, card vs CPU: gate {m_cpu['disc_factor']}, d_weight {m_card['d_weight']} "
             f"(clip {clip}): the GAN term's weight is not compared")
    if not fro[worst_w] <= VAE_CPU_TOL or not fro[worst_m] <= VAE_MOMENT_TOL:
        fail(f"VA-VAE step, card vs CPU, the state after the step: {fro}")
    return {"rel_err": rel, "card": m_card, "cpu": m_cpu, "cpu_s": cpu_s, "state_rel_err": fro}


def phase_vae_train(seed: int, device_info: dict, folder: str) -> dict:
    """Phase 23: the f16d32 VA-VAE trainer at full width with ViT-L DINOv2,
    VGG16 LPIPS and the 3-layer PatchGAN (seeded random weights), VAE_STEPS
    steps at batch VAE_BATCH, the discriminator gated until step
    VAE_DISC_START; then one step against the CPU."""
    cfg = Config(VAVAE_F16D32).merged_with(
        {"model": {"params": {"lossconfig": {"params": {"disc_start": VAE_DISC_START}}}}})
    foundation, _ = make_aux_feature_fn("dinov2", allow_random=True, device="cuda")
    lpips = LPIPS()
    init_lpips_weights(lpips, torch.Generator().manual_seed(seed))
    lpips = lpips.cuda().eval()
    out = {"cpu_check": phase_vae_cpu_check(seed, folder, cfg, foundation, lpips)}

    trainer = _vae_trainer(cfg, foundation, lpips, "cuda")  # frozen nets cast to bf16
    state = trainer.init_state(seed)
    x = torch.from_numpy(_first_batch(folder, VAE_BATCH)).cuda()
    disc0 = [p.clone() for p in state.disc_params]
    stats0 = [t.clone() for t in state.disc_stats]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, metrics, disc_at_gate = [], [], None
    for step in range(VAE_STEPS):
        if step == VAE_DISC_START:
            disc_at_gate = [p.clone() for p in state.disc_params]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(state, x)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: v.item() for k, v in m.items()})
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    expect_counts(got, {}, "VA-VAE training")  # its attentions are plain einsums
    for i, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"VA-VAE step {i}: non-finite metrics {m}")
        if not (m["d_weight"] > 0 and m["vf_weight"] > 0):
            fail(f"VA-VAE step {i}: adaptive weights d {m['d_weight']}, vf {m['vf_weight']}")
        if m["disc_factor"] != float(i >= VAE_DISC_START):
            fail(f"VA-VAE step {i}: disc_factor {m['disc_factor']}")
    if not all(torch.equal(a, b) for a, b in zip(disc0, disc_at_gate)):
        fail("the discriminator moved while its gate was closed")
    if all(torch.equal(a, b) for a, b in zip(disc_at_gate, state.disc_params)):
        fail("the discriminator did not move after its gate opened")
    if any(torch.equal(a, b) for a, b in zip(stats0, state.disc_stats)):
        fail("the discriminator's batch-norm running stats did not move")

    # the device's split of a gate-open step, and its busy share over the
    # same window's wall time
    reps = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(state, x)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0) / reps
    by_kernel = {ev.key: ev.self_device_time_total / 1e3 / reps for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                 and ev.self_device_time_total > 0}
    split: dict = {}
    for name, t in by_kernel.items():
        split[vae_kernel_class(name)] = split.get(vae_kernel_class(name), 0.0) + t
    device_step = sum(split.values())
    gated, opened = ms[1:VAE_DISC_START], ms[VAE_DISC_START + 1:]
    res = {"ms": ms, "ms_gated": float(np.median(gated)), "ms_open": float(np.median(opened)),
           "peak_bytes": peak, "device_ms_by_class": split, "device_ms": device_step,
           "window_ms": window_ms, "busy": device_step / window_ms, "metrics": metrics,
           "top_kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])}
    res["img_per_s_gated"] = VAE_BATCH / res["ms_gated"] * 1e3
    res["img_per_s_open"] = VAE_BATCH / res["ms_open"] * 1e3
    out.update(res)
    log(f"[vae-train] f16d32 + ViT-L DINOv2 + VGG16 LPIPS + PatchGAN, batch {VAE_BATCH}: "
        f"ms/step {', '.join(f'{t:.1f}' for t in ms)}; gate closed {res['ms_gated']:.2f} ms "
        f"({res['img_per_s_gated']:.2f} img/s), open {res['ms_open']:.2f} ms "
        f"({res['img_per_s_open']:.2f} img/s); peak {peak / 2**30:.2f} GiB; device "
        f"{device_step:.2f} ms a gate-open step (traced window {window_ms:.2f} ms a step, busy "
        f"{res['busy']:.3f}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(split.items()))
        + f" [{device_info['smi']}]")
    for name, t in res["top_kernels"].items():
        log(f"[vae-train]   {t:8.3f} ms  {vae_kernel_class(name):11s} {name[:110]}")
    del trainer, state, foundation, lpips
    torch.cuda.empty_cache()
    return out


def _stage_check(out_dir: str, k: int, step: int, epochs: int) -> None:
    d = os.path.join(out_dir, f"stage{k}")
    with open(os.path.join(d, "epoch.json")) as f:
        done = json.load(f)["epochs_done"]
    latest = ckpt_lib.latest_checkpoint(d)
    with open(os.path.join(d, "best", "metric.json")) as f:
        best = json.load(f)
    if done != epochs or not latest.endswith(f"{step:07d}.safetensors") \
            or ckpt_lib.latest_checkpoint(os.path.join(d, "best")) is None \
            or not np.isfinite(best["val"]):
        fail(f"stage {k}: epochs_done {done}, latest {latest}, best {best}; expected {epochs} "
             f"epochs at step {step}")
    for kind in ("inputs", "recon"):
        grid = read_png(os.path.join(d, "images", f"{kind}_{step:07d}.png"))
        if grid.shape != (768, 768, 3):  # 8 images, 3 × 3
            fail(f"stage {k}: {kind} grid {grid.shape}")


def phase_vae_entry_point(seed: int, device_info: dict, work: str, folder: str) -> dict:
    """Phase 24: ``train_vavae.main`` on the seeded folder (16 of its images
    the validation folder), the micro-Doppler config's three stages at one
    epoch each, random ViT-L (``--allow_random_foundation``) and LPIPS
    weights; then a relaunch with stage 3 at two epochs."""
    val = os.path.join(work, "val")
    for name, *_ in EXTRACT_CLASSES:
        os.makedirs(os.path.join(val, name))
        for i in range(VAE_VAL_IMAGES // len(EXTRACT_CLASSES)):
            shutil.copy(os.path.join(folder, name, f"{i:03d}.png"), os.path.join(val, name))
    lpips = LPIPS()
    init_lpips_weights(lpips, torch.Generator().manual_seed(seed))
    os.environ["VAVAE_LPIPS_WEIGHTS"] = os.path.join(work, "lpips.pth")
    torch.save(lpips.state_dict(), os.environ["VAVAE_LPIPS_WEIGHTS"])
    cfg = Config(VAVAE_F16D32).merged_with({"model": {"params": {
        "use_vf": "dinov2", "lossconfig": {"params": MICRODOPPLER_LOSS}}}})
    out_dir = os.path.join(work, "vavae")
    steps_per_epoch = 2 * EXTRACT_PER_CLASS // VAE_BATCH

    def run(stages, name):
        cfg_path = os.path.join(work, f"{name}.json")
        with open(cfg_path, "w") as f:
            json.dump({**cfg, "stages": stages,
                       "train": {"batch_size": VAE_BATCH,
                                 "log_images_every": VAE_LOG_IMAGES_EVERY}}, f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_vavae.main(["--base", cfg_path, "--data_path", folder, "--val_path", val,
                                  "--output_dir", out_dir, "--batch_size", str(VAE_BATCH),
                                  "--allow_random_foundation"])
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    reset_counts()
    try:
        state, first_s = run(MICRODOPPLER_STAGES, "stages")
        for k in (1, 2, 3):
            _stage_check(out_dir, k, k * steps_per_epoch, 1)
        if state.step != 3 * steps_per_epoch:
            fail(f"train_vavae.main ended at step {state.step}")
        files = {k: sorted(os.listdir(os.path.join(out_dir, f"stage{k}"))) for k in (1, 2)}
        longer = [dict(s) for s in MICRODOPPLER_STAGES]
        longer[2]["epochs"] = 2
        state, second_s = run(longer, "stages_longer")
    finally:
        del os.environ["VAVAE_LPIPS_WEIGHTS"]
    expect_counts(counts(), {}, "train_vavae.main")
    if state.step != 4 * steps_per_epoch:
        fail(f"the relaunch ended at step {state.step}, expected {4 * steps_per_epoch}")
    _stage_check(out_dir, 3, 4 * steps_per_epoch, 2)
    for k in (1, 2):  # skipped: nothing new written
        if sorted(os.listdir(os.path.join(out_dir, f"stage{k}"))) != files[k]:
            fail(f"the relaunch wrote into stage {k}")
    res = {"first_s": first_s, "relaunch_s": second_s, "steps": state.step,
           "images_per_s": 3 * 2 * EXTRACT_PER_CLASS / first_s}
    log(f"[vae-train] train_vavae.main: 3 stages x 1 epoch x {steps_per_epoch} steps at batch "
        f"{VAE_BATCH} (validation, best/ and grids every {VAE_LOG_IMAGES_EVERY} steps) in "
        f"{first_s:.1f} s ({res['images_per_s']:.2f} images/s with checkpoints); relaunch with "
        f"stage 3 at 2 epochs: stages 1-2 skipped, stage 3 resumed at epoch 1, step "
        f"{state.step}, {second_s:.1f} s [{device_info['smi']}]")
    return res


def run_vae_training(seed: int, device_info: dict) -> dict:
    """Phases 23-24, on phase 21's seeded image folder."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_vavae_")
    try:
        folder = os.path.join(work, "images")
        write_image_folder(folder, seed)
        out = {"train": phase_vae_train(seed, device_info, folder),
               "entry_point": phase_vae_entry_point(seed, device_info, work, folder)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[vae-train] phases 23-24: {out['seconds']:.1f} s")
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

    t0 = time.perf_counter()
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
    samplers = run_samplers(SEED, device)
    tokenizer = run_tokenizer(SEED, device)
    vae_training = run_vae_training(SEED, device)

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
                       "hires": hires, "samplers": samplers, "tokenizer": tokenizer,
                       "vae_training": vae_training, "seconds": time.perf_counter() - t0},
                      f, indent=1)
    log(f"[run] phases 1-24: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-card smoke run of the PyTorch/CUDA port (``vavae_tpu_torch``).

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --phase36 [--out results.json]   # phases 1 and 36 alone
    python3 chip_smoke.py --phase37 [--out results.json]   # phases 1 and 37 alone
    python3 chip_smoke.py --phase38 [--out results.json]   # phases 1, 2 and 38 alone
    python3 chip_smoke.py --phase39 [--out results.json]   # phases 1, 2, 39 and its phase-3 rows

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, each fatal on failure:
  1. device: name and power limit (nvidia-smi), torch's device name;
  2. build: every CUDA kernel (the fused-qkv attention forward and backward,
     the separate-q/k/v attention forward and backward, the long-route
     forward), from ``ops/csrc``, one nvcc per source, all started together;
     each kernel instance's registers and spills from the compiler's report
     (``-Xptxas -v``), where an instance of the forward's wgmma body or of
     the fp32 3xTF32 bodies at a head dim of at most 80 must not spill;
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
     gradients on a second call; then the fp32 calls of all five
     small-route kernels at the micro-Doppler DiTs' shapes and a ragged one
     (forward 1e-5 max-abs, backward 1e-4 of max|ref|, bit-identical twice),
     each of which must run the 3xTF32 body, beside SDPA's fp32 time and the
     bound of three TF32 products;
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
     on q, k rotated beforehand with the fp32 tables, XL/1 at full width cut
     to depth ``CUT_DEPTH``: euler-250 split-CFG sampling at per-batch 2 +
     f16d32 decode to 1024² uint8 images (249 · depth ``flash_fwd``
     launches and none of any other kernel), the forward at batch 4 of the
     production and the qk-norm model against plain attention, and the
     loss gradients of XL/1-width models cut to
     depth 2 at batch 2 against plain attention (the backward is autograd of
     the exact op; remat "dots" runs the kernel again);
  16. the fixed-grid samplers on XL/1 (depth ``CUT_DEPTH``, as in 17, 19
     and 20) at the production ``sample:`` settings
     cut to ``SAMPLER_STEPS`` steps, batch 8, each decoded: heun, Adams–
     Bashforth 2 and 3, the velocity cache (k = 3, orders 1 and 2) through
     ``build_sample_fn``, the adaptive cache through the split-CFG sampler
     with its stats; model calls from the sampler's evaluation rule (and
     the stats), held in the launch counts, beside the cost functions;
  17. SDE sampling (Euler and Heun, ``diffusion_form: sigma``, ``last_step:
     Mean``) with CFG 10 on the concatenated batch, through
     ``build_sample_fn``;
  18. dopri5 split-CFG sampling of the micro-Doppler DiT-S/2
     (``vavae_tpu_torch/configs/dit_s_microdoppler.yaml``, bf16, N = 64 tokens)
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
     ``vavae_tpu_torch/configs/vavae_f16d32.yaml`` (its blocks written into the
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
     stages cut to one epoch each (the stage config written as YAML by
     ``utils/yaml_io.py``), random ViT-L and LPIPS weights, image grids
     every 4 steps: each stage's ``epoch.json``, ``best/metric.json``,
     grids and chained steps (12, 24, 36); then a relaunch with stage 3 at
     two epochs skips stages 1-2 and resumes stage 3 at epoch 1 (step 48);
  25. LoRA finetune: ``lora_finetune.main`` on the micro-Doppler DiT-S/2
     (``vavae_tpu_torch/configs/dit_s_microdoppler.yaml`` written into the script
     with ``log_every`` 1: hidden 384, depth 12, 6 heads, 32 classes, 64
     tokens, fp32) from seeded random base weights given as a JAX-layout
     ``.msgpack`` (the legacy reader, with its RoPE-layout warning), rank
     8, alpha 16, batch 16, 6 steps on seeded latent shards in the JAX
     format, ``--export_merged``: finite losses, 12 launches of #1 and of #2
     a step, the base weights bit-identical, alpha unchanged, A and B
     moved, the LoRA file read back bit for bit, the export loaded by
     ``pipelines.sample.load_dit_params`` equal to the merge; ms/step of 10
     more steps and peak memory; #1 and #2 at the step's shape (16, 6, 64,
     64) in fp32 against their plain versions, timed beside SDPA and the
     bound; then one LoRA step on the production XL/1 at full width cut to
     depth 4 (bf16, remat "dots"): adapter gradients with the kernels
     against plain attention, within 3e-2;
  26. classifier: ``ClassifierTrainer`` at 256², batch 64, on a seeded
     folder of 31 ``ID_*`` users, in the baseline (32 classes, as
     ``generate_and_filter.run`` builds it), improved + global and
     domain-adaptive modes (fp32, TF32 off, no autocast): 4 timed steps
     after one, finite losses, frozen stages bit-identical, the saved file
     read back; one step from the same state (carried through the file) and
     dropout masks on the card and the CPU at batch 16: loss, weights and
     BN stats within 1e-3 relative; no attention kernel launched;
  27. ``generate_and_filter.run`` with phase 25's merged export, phase 26's
     baseline classifier and the f16d32 VA-VAE decode (seeded random
     weights), two users (the classes the classifier predicts most often
     on a probe batch: random weights predict a few classes whatever the
     label), 2 batches of 8, confidence 0 (random weights accept almost
     nothing at the app's 0.95), euler-50 split-CFG in place of the
     config's dopri5 (an exact launch count): 12 × 49 #1 launches a
     batch, as many PNGs as accepted (at least one), each decoding to its
     image, the stats consistent; samples/s and the seconds of sampling,
     decode and classifier;
  28. ``quantize_dit.main`` on the production XL/1 (depth ``CUT_DEPTH``,
     seeded random weights, a DiT train-state file) at batch 8 with ``--sample_check 4`` (euler-50
     split-CFG from the same noise with the fp and the dequantized weights)
     and ``--out``: sizes, compression, fp and dequantized forward ms, the
     output and sample deviations, #1's exact launches; ``int8_matmul`` at
     an XL/1 ``qkv`` shape, ``torch._int_mm`` on the card against the CPU's
     int32 path (accumulators equal); the int8 file read back equal;
  29. ``iterative_finetune.main`` on LightningDiT-B/2
     (``vavae_tpu_torch/configs/dit_b_microdoppler.yaml`` written into the script,
     fp32, N = 64) with seeded random DiT, VA-VAE and classifier files (the
     classifier's head a nearest-centroid rule between users 0 and 1, the
     two users the run iterates, fitted on one probe batch of each) and a
     latent shard tree written here: 2 rounds × 4 steps at batch 8, 4
     samples a user (euler-50 split-CFG), confidence 0;
     each round's seconds of generate, decode, classify, encode and train,
     the accepted counts, final losses, #1 and #2 launches a sampling call
     and a train step (exact), the saved state restored equal; then one B/2
     train step's gradients with the kernels against plain attention
     (1e-3, fp32);
  30. ``select_users``, ``analyze_metrics`` and ``generation_evaluator``
     (feature, then LPIPS diversity with seeded random VGG16 weights) at
     their defaults (224², so the 256² PNGs go through the port's BICUBIC)
     on phase 26's users (a split file) and baseline classifier and phase
     27's filtered tree; ``domain_adaptation.main`` on a seeded random
     classifier and 31 users × 10 target images (support 5 a class,
     reference grid limited to 8, NCC, confidence-weighted ensemble); the
     target BN statistics and adapted probabilities on the card against
     the CPU (1e-5 relative and 1e-5 max-abs, TF32 off); ``select_support``
     with each strategy; each entry point's seconds;
  31. ``autotune_sampler.main`` on the production XL/1 (full width, depth
     ``CUT_DEPTH``, bf16, seeded random weights in a DiT train-state file, the
     production ``sample:`` block, config given as JSON) with ``--n 8
     --batch 8 --ref_steps 250``, the full ladder: the exact euler-250
     reference, the noise-floor probe, euler 125/100/50, AB3 100/62, heun
     83/62, the fixed cache k = 3, 6 and the adaptive cache at its three
     tolerances; #1's launches exactly depth × the model calls of all those
     runs by the samplers' evaluation rules (the adaptive runs' from their
     ``cfg_evals``), no other kernel; the JSON evidence, the overlay, and
     the recommended block equal to ``_method_config`` of the winner with the
     production keys carried through; each method's seconds and cost;
  32. the tools: ``python -m vavae_tpu_torch --help`` (exit 0) and an
     unknown command (exit 2) as subprocesses; ``preflight.main`` on the
     XL/1 config and checkpoint of phase 31 (depth ``CUT_DEPTH``, as all of
     phase 32's XL/1: ``CUT_DEPTH`` #1 launches); ``export_torch --kind
     dit`` reloaded by ``load_dit_params`` (the XL/1 forward at batch 16
     bit-equal) and ``--kind vae`` of phase 24's last state loaded by
     ``VA_VAE`` (decode bit-equal); ``prepare_dataset_split`` on phase 26's
     seeded users and ``validate_export.main`` on that split with the
     exported VAE, the VF check from phase 24's checkpoint and config (random
     ViT-L) and ``--export_encoder`` (read back equal); ``convert_latents``
     of a seeded legacy dump read back by ``ImgLatentDataset``; phase 8's
     ``do_train`` with ``train.async_checkpoint`` on and ``VAVAE_PROFILE``
     set (each save also written in line at the same moment), then off: the
     checkpoints byte-equal, one trace a run, the events files' CRCs; the
     production XL/1 under ``VAVAE_ATTN_NATURAL=0`` (forward at batch 16 and
     loss gradients as phases 5-6, #3 and #6 in place of #1 and #2) against
     plain attention and against the natural route, within 3e-2;
  33. the multi-device paths (``run_multidevice``): a world of every card
     over NCCL (``do_train`` and rank-striped sampling at XL/1 width, depth
     2), two ranks sharing the card over gloo (DP, FSDP and TP steps
     against one process), and four gloo ranks on it under tensor = 4 at
     LightningDiT-1p6B/1's full width (28 heads cut 7 a rank, MLP rows
     1,195, 1,195, 1,194, 1,194 of 4,778) with and without QK-norm;
  34. the data and I/O modules: the committed JPEG fixtures of
     ``tests/data/jpeg`` (Huffman, arithmetic-coded, lossless and
     block-smoothed files) through the port's decoder, and the PNG
     fixtures of ``tests/data/png`` (every colour type and bit depth,
     plain and Adam7-interlaced) through its PNG reader, bit-equal to PIL's
     committed decodes; the shard reader on shards of every other kind the
     JAX package reads (F16, F64, I32 and BOOL latents, no flips, F32, I16
     and U8 labels), bit-equal to ``reference_batch`` at batch 1,024; an
     ImageNet-layout tree of the Huffman fixtures (66 files, with
     CMYK, YCCK, grayscale, progressive and a PNG under a ``.JPEG`` name),
     whose ``ImageNetValidation`` filelist, items and labels equal the JAX
     package's committed ones; ``extract`` over the tree at 256² with the
     f16d32 VA-VAE at fp32 (its images/s a smoke reading: 66 small files,
     first calls included); the native shard reader's batches of its
     shards bit-equal to the Python reference's (``reference_batch``), and
     ``do_train`` (XL/1 width, depth 2) 2 steps on them with #1 and #2
     counted exactly; ``do_train``'s steps/s at the global batch of 1,024
     with the native reader and with the Python reference (native, Python,
     native, Python); two ``train_epochs`` steps of the VA-VAE at batch 8
     over ``ImageNetTrain`` on phase 23's trainer (run at the end of phase
     23: one ViT-L); a ``pipelines.sample`` FID folder of 16 images (XL/1
     width, depth 2, euler-50) through the threaded PNG writer, each file
     decoding to its image, #1 counted; the host rates: decode images/s of
     the 500×375 4:2:0 fixture alone and on 8 threads, as Huffman, SOF9
     and SOF3 files, ``extract``'s image check (``refused_images``) of
     the tree's files, the reader's batches of 1,024 against the Python
     reference and the writer's 256² PNGs on a pool against one thread;
  35. the documented commands from the port's shipped configs
     (``vavae_tpu_torch/configs``), each through ``vavae_tpu_torch.__main__``
     as ``python -m vavae_tpu_torch`` dispatches it, with PyYAML made
     unimportable: (a) ``train_dit --config dit_s_microdoppler.yaml`` (the
     config's DiT-S/2 at full width and depth, fp32, batch 16) for 4 steps
     on seeded f16d32 shards with a checkpoint every 2, 48 #1 and 48 #2
     launches; (b) ``sample`` from that config and (a)'s last checkpoint:
     its dopri5 split-CFG, #1 exactly 12 × the model calls (2 + 6 k in each
     phase), the PNGs read back; (c) ``sample --config
     lightningdit_xl_vavae_f16d32.yaml`` with a params file of the seeded
     XL/1 (full width and depth) written by the port's safetensors writer,
     ``sample.per_proc_batch_size=8 sample.fid_num=8``: 6,972 #1 launches,
     8 PNGs read back; (d) ``extract_features --config vavae_f16d32.yaml`` on
     phase 21's seeded folder: its shards bit-equal to phase 21's fp32
     ones (the same seeded weights and draws).
  36. with PIL, scikit-learn and matplotlib made unimportable: (a) every
     committed WebP and BMP fixture (``tests/data/webp``, ``tests/data/bmp``)
     through ``read_image_rgb`` (the WebP ones with alpha also as RGBA)
     bit-equal to PIL's committed decodes, and the WebP decode rate of the
     256×341 lossy fixture (LSUN's shape) and of a 160×96 lossless one,
     alone and on 8 threads; (b) an LSUN tree of 256 WebP files with its txt
     filelist through ``LSUNBase`` and its ``batches`` at 256², then
     ``extract`` over it with the f16d32 VA-VAE, once to warm the path and
     once timed: images/s, and the seconds its loader thread spent in
     ``read_image_rgb`` over its wall time (a small tree: a smoke reading,
     not a workload's rate); (c) ``plot_tsne_visualization`` of 10,000 seeded latent
     pixels of 32 channels, the t-SNE on the card: seconds, final KL,
     normalised entropy and Gini, the PNG read back by the port's reader
     (its size, the drawing of the embedding, ink at every point); and the
     t-SNE of 1,000 of them on the card against the host: tightly, the
     gradient and KL at the same P and positions (at the init and at the
     host's final layout) within ``TSNE_GRAD_TOL`` and the first
     ``TSNE_TIGHT_ITERS`` iterations from the same init within
     ``TSNE_ITER_TOL``; of the whole run, where the iterations are chaotic
     and the layouts part, the final KL, normalised entropy, Gini and
     10-neighbour agreement within ``TSNE_TOL``.
  37. with PIL made unimportable: (a) every committed GIF, TIFF, PNM and
     ICO/CUR fixture (``tests/data/{gif,tiff,pnm,ico}``) through
     ``read_image_rgb`` bit-equal to PIL's committed decodes, each file PIL
     refuses raising, naming it, and each TIFF left to PIL (JPEG and CCITT)
     raising ``ImportError`` naming it; a seeded 256×256 GIF, LZW TIFF
     (predictor 2) and PPM, each read back equal to what was written, and
     the decode rate of each (bytes to pixels), alone and on 8 threads; (b) ``extract`` with the
     f16d32 VA-VAE over a tree of 128 such files named ``.jpg`` and
     ``.png``, once to warm the path and once timed: images/s, and the
     seconds its loader thread spent in ``read_image_rgb`` over its wall;
     (c) ``refused_images`` over a tree holding one TGA file names that
     file as needing PIL, and nothing else.
  38. the workflow trained on the card: (a) the learning check
     (``apps/learning_check.py``, the port of ``tests/test_learning_tpu.py``):
     DiT-S/2 (depth 12, width 384, 6 heads of 64, bf16, SwiGLU, RoPE,
     RMSNorm) through ``DiTTrainer`` for 1,200 steps at batch 64 on 4
     classes of seeded 16×16×32 latents (lr 3e-4, β2 0.95, EMA 0.99), then
     euler-50 split-CFG at scale 2 from the EMA weights, 4 samples a class:
     the last loss below half the first, at least 0.75 of the samples
     nearest their class's mean, #1 and #2 launched exactly 12 × 1,200 in
     training and #1 12 × 49 in sampling; ms/step; (b), in its own
     processes beside (a): ``python -m vavae_tpu_torch e2e_onchip --smoke
     --device cuda``: every stage of the whole workflow (dataset, VA-VAE
     training, export, extraction, DiT training, sampling, tokenizer
     evaluation, gauge FID) exits 0 on the card, and the record holds them
     all with finite metrics; then #1 and #2 in fp32 at the full e2e run's
     DiT-S/2 train step (32, 6, 64, 64) against their plain versions, timed
     beside SDPA and the bound.
  39. the big registry variant at full size: ``python -m vavae_tpu_torch
     big_variant``'s body (``apps/big_variant.py:run``) on
     LightningDiT-1p6B/1 (depth 28, width 1792, 28 heads of 64, N = 256,
     1.63 B parameters, bf16 over fp32 weights, bf16 Adam μ, remat "dots")
     at batch 8 on one card, 2 steps: its own checks (finite losses, the
     step count, moved parameters and EMA, #1 and #2 launched [56, 28] a
     step, each part of the state at its arithmetic), those bytes held to
     14 bytes an element of state and 4 of gradients, ms/step, img/s and
     peak memory; then the loss gradients of a 1p6B-width model cut to
     depth 4 (batch 16) with both kernels against plain attention, within
     ``PATH_TOL``.
Phase 3 also holds the forward kernel at the micro-Doppler DiT-S/2's shapes
(N = 64, 6 heads of 64, with and without RoPE) and the backward at its
likelihood's, both also at the learning check's train step (B = 64) and at
the big variants' (8, 28, 256, 64) and (8, 24, 256, 64) with RoPE, and
holds ``flash_fwd`` against its plain version at the 1024²
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
import hashlib
import json
import logging
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import vavae_tpu_torch.__main__ as port_cli
from vavae_tpu_torch.models import dit, layers
from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops import build, quant
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
from vavae_tpu_torch.apps import analyze_metrics, domain_adaptation, generation_evaluator
from vavae_tpu_torch.apps import generate_and_filter as gen_filter
from vavae_tpu_torch.apps import iterative_finetune, lora_finetune, quantize_dit, select_users
from vavae_tpu_torch.apps import autotune_sampler, convert_latents, export_torch, preflight
from vavae_tpu_torch.apps import big_variant, e2e_onchip, learning_check
from vavae_tpu_torch.apps import prepare_dataset_split, validate_export
from vavae_tpu_torch.apps.train_classifier import (
    ClassifierTrainer,
    restore_classifier,
    save_classifier,
)
from vavae_tpu_torch.data.image_folder import (
    ImageFolderDataset,
    MixedDomainDataset,
    SplitFileDataset,
)
from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
from vavae_tpu_torch.data.ldm_datasets import ImageNetTrain, ImageNetValidation, LSUNBase
from vavae_tpu_torch.eval import latent_vis
from vavae_tpu_torch.eval.latent_vis import (
    calculate_uniformity_metrics,
    plot_tsne_visualization,
    render_scatter,
    sample_latent_pixels,
)
from vavae_tpu_torch.eval.metrics import ssim
from vavae_tpu_torch.models import lpips as lpips_mod
from vavae_tpu_torch.models.lpips import LPIPS, init_lpips_weights, load_lpips
from vavae_tpu_torch.models.vit import FoundationModel
from vavae_tpu_torch.pipelines import evaluate_tokenizer as teval
from vavae_tpu_torch.pipelines import train_vavae
from vavae_tpu_torch.pipelines.evaluate_tokenizer import evaluate_tokenizer
from vavae_tpu_torch.pipelines import extract_features
from vavae_tpu_torch.pipelines.extract_features import extract, iter_batches, list_image_folder
from vavae_tpu_torch.pipelines import sample as sample_mod
from vavae_tpu_torch.pipelines.sample import build_sample_fn, do_sample, load_dit_params
from vavae_tpu_torch.pipelines.train_dit import build_trainer, do_train
from vavae_tpu_torch.pipelines.train_vavae import build_vae_trainer, make_aux_feature_fn
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.train import checkpoint as ckpt_lib
from vavae_tpu_torch.train.dit_trainer import DiTTrainer
from vavae_tpu_torch.train.lora import load_lora, lora_size
from vavae_tpu_torch.train.lora_trainer import LoRATrainer
from vavae_tpu_torch.transport import Sampler, build_transport, create_transport
from vavae_tpu_torch.transport.cost import (
    adaptive_cache_cost,
    dopri5_cost,
    fixed_grid_cost,
    split_idx,
)
from vavae_tpu_torch.utils import yaml_io
from vavae_tpu_torch.utils.config import Config, load_config
from vavae_tpu_torch.utils.device_timing import device_kernels, device_ms, time_ms
from vavae_tpu_torch.utils.metrics_logger import read_events
from vavae_tpu_torch.utils.msgpack_io import read_msgpack, write_msgpack
from vavae_tpu_torch.utils.jpeg import decode_jpeg
from vavae_tpu_torch.utils.png import read_image_rgb, read_png, refused_images, write_pngs
from vavae_tpu_torch.utils.gif import decode_gif
from vavae_tpu_torch.utils.pnm import decode_pnm
from vavae_tpu_torch.utils.tiff import decode_tiff
from vavae_tpu_torch.utils.webp import decode_webp
from vavae_tpu_torch.utils.safetensors_io import (
    flatten,
    read_safetensors,
    unflatten,
    write_safetensors,
)
from vavae_tpu_torch.utils.weights import (
    dit_state_to_jax,
    randomize_,
    vae_state_from_jax,
    vae_state_to_jax,
)

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# the production config (vavae_tpu_torch/configs/lightningdit_xl_vavae_f16d32.yaml),
# written out with the sampling batch cut to 8 (phase 35 runs from the file)
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
# XL/1 at full width cut to this depth in the paths past the main ones that
# time and count (phase 15's 1024² sampling and forwards, 16-17, 19-20, 28,
# 31-32): their launches stay exact at any depth, and the script keeps
# inside its time limit
CUT_DEPTH = 4
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
    # a model without qk-norm under VAVAE_ATTN_NATURAL=0: the separate q, k, v
    # route of the qk-norm branch, without the norms
    "ab_route": {
        "model": {}, "fwd": "attn_small_fwd_rope", "bwd": "attn_small_bwd",
        "op": "dot_product_attention", "plain": flash_attention_reference,
        "groups": {"attn.qkv": (".attn.qkv.",)},
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
def variant_depth(size: str, depth: int):
    """Smoke-only: the ``size`` registry entries at their width, cut to ``depth``."""
    saved = dict(dit._VARIANTS[size])
    dit._VARIANTS[size] = dict(saved, depth=depth)
    try:
        yield
    finally:
        dit._VARIANTS[size] = saved


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
TF32_FWD = "attn_fwd_tf32_kernel"  # the body of every fp32 small-route forward call with D <= 128
TF32_BWD = "attn_bwd_tf32_kernel"  # the body of every fp32 backward call


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
            dp = (int(kernel.split("<")[1].split(">")[0].split(",")[0])
                  if kernel.startswith((WGMMA_FWD, TF32_FWD, TF32_BWD)) else 0)
            no_spill = 0 < dp <= 80 or kernel.startswith(LONG_FWD)
            if no_spill and (r.get("spill_stores") or r.get("spill_loads")):
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
# its dopri5 CFG phase and a batch of 16, half of one 128-query wgmma block;
# and the learning check's train step (phase 38), batch 64
MICRO_FWD_CASES = [(16, 6, 64, 64, True), (16, 6, 64, 64, False),
                   (8, 6, 64, 64, True), (8, 6, 64, 64, False), (64, 6, 64, 64, True)]
# the big variants' train step at batch 8 (phase 39): 1p6B/1 and 1p0B/1, 28
# and 24 heads of 64 at N = 256, the forward and the backward
BIG_CASES = [(8, 28, 256, 64, True), (8, 24, 256, 64, True)]
# a rank's call of 1p6B/1 under tensor = 4 (phase 33 (c)): 7 of its 28 heads
TP4_CASES = [(8, 7, 256, 64, True)]
FWD_CASES = [(16, 16, 256, 72, True), (16, 16, 256, 72, False),
             (8, 16, 256, 72, True), (8, 16, 256, 72, False),
             (4, 16, 200, 64, True), (4, 16, 200, 64, False),
             (4, 16, 1024, 72, True), (4, 16, 1024, 72, False),
             *MICRO_FWD_CASES, *BIG_CASES, *TP4_CASES]


def phase_kernels(seed: int, cases=FWD_CASES) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
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
             (4, 6, 64, 64, True),  # the micro-Doppler DiT-S/2 likelihood's
             (64, 6, 64, 64, True),  # the learning check's train step (phase 38)
             *BIG_CASES, *TP4_CASES]


def phase_bwd_kernel(seed: int, cases=BWD_CASES) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    worst, rows = 0.0, []
    for B, H, N, D, rope in cases:
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
    and training (B=32) shapes, at N = 1,024 and at a rank's 7 heads of 64
    under tensor = 4 (phase 33 (c)), with v a strided view of the
    projection."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    result = {}
    for rope in (True, False):
        name = "attn_small_fwd_rope" if rope else "attn_small_fwd"
        worst, rows = 0.0, []
        for B, H, N, D in [(16, 16, 256, 72), (4, 16, 1024, 72),
                           *(c[:4] for c in TP4_CASES)]:
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
                             (4, 16, 1024, 72, True), *TP4_CASES]:
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


ATTN_TOL_F32 = 1e-5   # fp32 forward max-abs: summation order only
BWD_TOL_F32 = 1e-4    # fp32 backward max|err| / max|ref|
# fp32 calls of the micro-Doppler DiTs (N = 64, heads of 64, RoPE): the LoRA
# step (16, 6), the B/2 train step and CFG sampling (8, 12), the e2e DiT-S/2
# train step (32, 6), and a ragged three-tile head; B/2's cond-only sampling
# (4, 12) runs the forward alone
FP32_CASES = [(16, 6, 64, 64), (8, 12, 64, 64), (32, 6, 64, 64), (2, 6, 130, 64)]
FP32_FWD_ONLY = [(4, 12, 64, 64)]


def _fp32_body_times(fn, body: str, what: str) -> dict:
    """A wrapper call's device time by kernel, which must include ``body``
    and no other attention kernel (the backward's table folding runs beside it)."""
    by_kernel = {_short_kernel_name(k): v for k, v in device_kernels(fn).items()}
    attention = [k for k in by_kernel if k.startswith("attn_")]
    if len(attention) != 1 or not attention[0].startswith(body):
        fail(f"{what} ran {sorted(by_kernel)}, expected {body} as its only attention kernel")
    return {"device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel}


def phase_fp32_kernels(seed: int) -> dict:
    """The fp32 calls of #1, #2, #3, #4 and #6 (the 3xTF32 bodies of
    ``attention_tf32.cuh``) at the micro-Doppler DiTs' shapes and a ragged
    one, each against its plain version (forward 1e-5 max-abs, backward 1e-4
    of max|ref|), with the kernel's ms and device ms (the profiler's kernel
    names show the body), SDPA's fp32 time on q, k rotated beforehand
    (forward, backward) and the bound (three TF32 products at the TF32 peak
    vs the bytes). v is the strided view of the projection on the separate
    entries."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    rows = {name: [] for name in ("nat_attention_fwd", "nat_attention_bwd", "attn_small_fwd_rope",
                                  "attn_small_fwd", "attn_small_bwd")}
    for B, H, N, D in FP32_CASES + FP32_FWD_ONLY:
        with_bwd = (B, H, N, D) in FP32_CASES
        qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda")
        q, k, g = (torch.randn((B, N, H, D), generator=gen, device="cuda") for _ in range(3))
        v = qkv[:, :, 2]
        cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
        tables = (torch.as_tensor(cos[:N], device="cuda"), torch.as_tensor(sin[:N], device="cuda"))
        # the library yardstick: SDPA's forward and backward on q, k rotated
        # beforehand and v, fp32 (B, H, N, D)
        qt, kt, vt = (t.requires_grad_(True) for t in _rotated_bhnd(qkv[:, :, 0], qkv[:, :, 1], v,
                                                                    tables))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
        out = sdpa()
        gt = g.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
        library = {"fwd": (time_ms(sdpa), device_ms(sdpa))}
        if with_bwd:
            library["bwd"] = (time_ms(sdpa_bwd), device_ms(sdpa_bwd))
        calls = [("nat_attention_fwd", lambda: fused_qkv_attention(qkv, rope=tables),
                  lambda: fused_qkv_attention_reference(qkv, rope=tables), "fwd"),
                 ("attn_small_fwd_rope", lambda: flash_attention(q, k, v, rope=tables),
                  lambda: flash_attention_reference(q, k, v, rope=tables), "fwd"),
                 ("attn_small_fwd", lambda: flash_attention(q, k, v),
                  lambda: flash_attention_reference(q, k, v), "fwd")]
        if with_bwd:
            calls += [("nat_attention_bwd", lambda: fused_qkv_attention_bwd(qkv, g, rope=tables),
                       lambda: fused_qkv_attention_bwd_reference(qkv, g, rope=tables), "bwd"),
                      ("attn_small_bwd", lambda: flash_attention_bwd(q, k, v, g, rope=tables),
                       lambda: flash_attention_bwd_reference(q, k, v, g, rope=tables), "bwd")]
        for name, fn, ref, kind in calls:
            got, want = fn(), ref()
            torch.cuda.synchronize()
            got = [got] if isinstance(got, torch.Tensor) else list(got)
            want = [want] if isinstance(want, torch.Tensor) else list(want)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
            if kind == "fwd" and not err <= ATTN_TOL_F32:
                fail(f"{name} fp32 at {(B, H, N, D)}: max-abs {err} > {ATTN_TOL_F32}")
            if kind == "bwd":
                if not rel <= BWD_TOL_F32:
                    fail(f"{name} fp32 at {(B, H, N, D)}: max-rel {rel} > {BWD_TOL_F32}")
                check_deterministic(fn, f"{name} fp32 at {(B, H, N, D)}")
            rope = name != "attn_small_fwd"
            row = {"shape": [B, H, N, D], "dtype": "fp32", "rope": rope, "max_abs_err": err,
                   "max_rel_err": rel, "ms": time_ms(fn),
                   **_fp32_body_times(fn, TF32_FWD if kind == "fwd" else TF32_BWD,
                                      f"{name} fp32 at {(B, H, N, D)}"),
                   "library_ms": library[kind][0], "library_device_ms": library[kind][1]}
            row["bound_ms"], row["bound_by"] = _fp32_attention_bound(
                B, H, N, D, 4.0 if kind == "fwd" else 10.0, 4 if kind == "fwd" else 7, rope)
            rows[name].append(row)
            log(f"[kernels] {name} fp32 B={B} H={H} N={N} D={D} rope={rope}: max-abs {err:.3e} "
                f"(max-rel {rel:.3e}), kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}: "
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(row["device_ms_by_kernel"].items()))
                + f"), SDPA{' backward' if kind == 'bwd' else ''} {row['library_ms']:.4f} ms "
                f"(device {row['library_device_ms']:.4f}), bound {row['bound_ms'] * 1e3:.2f} us "
                f"({row['bound_by']})")
        del qkv, q, k, g, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    return {f"{name}_fp32": {"worst_err": max(r["max_abs_err"] for r in rs), "rows": rs}
            for name, rs in rows.items()}


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
                     batch: int = 2 * BATCH, tol: float = PATH_TOL, what: str = "XL/1") -> dict:
    """XL/1 gradients of the training loss with both kernels against those
    with attention forced through the plain version (autograd of it); any
    DiT of ``cfg`` with ``model``, within ``tol``."""
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
    fwd_n = (2 if model.use_checkpoint else 1) * model.depth
    want = {fwd: fwd_n} if bwd is None else {fwd: fwd_n, bwd: model.depth}
    expect_counts(launches, want, f"{branch} {what} training backward")
    with plain_attention(branch):
        plain, parts_plain = grads()
    rel = ((with_kernel - plain).norm() / plain.norm()).item()
    rel_parts = {key: ((parts_kernel[key] - parts_plain[key]).norm()
                       / parts_plain[key].norm()).item() for key in groups}
    if not (rel <= tol and all(r <= tol for r in rel_parts.values())):
        fail(f"{branch} {what} gradients with the kernels vs plain attention: relative error "
             f"{rel}, {rel_parts} (limit {tol})")
    qkv_part = f", attn.qkv {rel_parts['attn.qkv']:.3e}" if "attn.qkv" in rel_parts else ""
    log(f"[train-path] {branch} {what} loss gradients B={B} N={s * s} depth {model.depth}, kernels "
        f"vs plain attention: relative error {rel:.3e}{qkv_part}")
    for key, r in rel_parts.items():
        if key != "attn.qkv":
            log(f"[train-path] {branch} {what} {key} gradients, kernels vs plain attention: "
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
        with variant_depth("XL", depth):  # an XL/1-width DiT, depth 2
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
    with variant_depth("XL", NO_ROPE_DEPTH):
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
    at depth HIRES_GRAD_DEPTH, batch 2. The models are cut to CUT_DEPTH."""
    with variant_depth("XL", CUT_DEPTH):
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
        with variant_depth("XL", HIRES_GRAD_DEPTH):
            cfg, model = build_xl(seed, branch)
        out[f"{branch}_train_path"] = phase_train_path(cfg, model, seed, branch, HIRES_BATCH)
        del model
        torch.cuda.empty_cache()
    return out


# -- phases 16-20: every sampler, the likelihood and FID -----------------------

SAMPLER_STEPS = 50  # num_sampling_steps of phases 16, 17, 20, 28 and 29 (the production 250, cut)
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
FID_NUM = 8
# the micro-Doppler DiT-S/2 (vavae_tpu_torch/configs/dit_s_microdoppler.yaml), its
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
    """Phases 16-20, XL/1 cut to CUT_DEPTH."""
    with variant_depth("XL", CUT_DEPTH):
        return _run_samplers(seed, device_info)


def _run_samplers(seed: int, device_info: dict) -> dict:
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
        imgs = []
        for i in range(EXTRACT_PER_CLASS):
            cells = rs.integers(0, 256, (h // 16 + 1, w // 16 + 1, c)).astype(np.int16)
            img = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:h, :w]
            imgs.append(np.clip(img + rs.integers(-12, 13, img.shape), 0, 255).astype(np.uint8))
        paths = [os.path.join(root, name, f"{i:03d}.png") for i in range(EXTRACT_PER_CLASS)]
        write_pngs(np.stack(imgs), paths)


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
    with variant_depth("XL", depth):
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


def run_tokenizer(seed: int, device_info: dict, keep: str | None = None) -> dict:
    """Phases 21-22. With ``keep``, phase 21's fp32 shards are copied to
    ``keep/extract_fp32`` (for phase 35)."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tokenizer_")
    try:
        extraction, vae = phase_extraction(seed, device_info, work)
        if keep is not None:
            shutil.copytree(os.path.join(work, "latents_fp32"), os.path.join(keep, "extract_fp32"))
        evaluation = phase_tokenizer_eval(seed, device_info, work, vae)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"extraction": extraction, "evaluation": evaluation,
           "seconds": time.perf_counter() - t0}
    log(f"[tokenizer] phases 21-22: {out['seconds']:.1f} s")
    return out


# -- phases 23-24: VA-VAE training ---------------------------------------------------

# vavae_tpu_torch/configs/vavae_f16d32.yaml's blocks, written out, with the
# discriminator's gate at step 4 of phase 23's 8
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
# vavae_tpu_torch/configs/vavae_microdoppler_finetune.yaml: its model differs from
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


def phase_vae_train(seed: int, device_info: dict, folder: str,
                    imagenet: str | None = None) -> dict:
    """Phase 23: the f16d32 VA-VAE trainer at full width with ViT-L DINOv2,
    VGG16 LPIPS and the 3-layer PatchGAN (seeded random weights), VAE_STEPS
    steps at batch VAE_BATCH, the discriminator gated until step
    VAE_DISC_START; then one step against the CPU. With ``imagenet`` (a
    tree), phase 34's ``train_epochs`` steps over ``ImageNetTrain`` run on
    the same trainer after them (one ViT-L for both)."""
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
    if imagenet is not None:
        out["imagenet"] = phase_imagenet_vae(trainer, state, imagenet, device_info)
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
        cfg_path = os.path.join(work, f"{name}.yaml")
        with open(cfg_path, "w") as f:
            yaml_io.safe_dump(Config({**cfg, "stages": stages, "train": {
                "batch_size": VAE_BATCH, "log_images_every": VAE_LOG_IMAGES_EVERY}}).to_dict(), f)
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


def run_vae_training(seed: int, device_info: dict, keep: str | None = None,
                     imagenet: str | None = None) -> dict:
    """Phases 23-24, on phase 21's seeded image folder. With ``keep``, phase
    24's last stage-3 checkpoint and its config are copied there (for
    phase 32); with ``imagenet``, phase 34's VA-VAE steps run on phase 23's
    trainer."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_vavae_")
    try:
        folder = os.path.join(work, "images")
        write_image_folder(folder, seed)
        out = {"train": phase_vae_train(seed, device_info, folder, imagenet),
               "entry_point": phase_vae_entry_point(seed, device_info, work, folder)}
        if keep is not None:
            shutil.copy(ckpt_lib.latest_checkpoint(os.path.join(work, "vavae", "stage3")),
                        os.path.join(keep, "vae_state.safetensors"))
            shutil.copy(os.path.join(work, "stages_longer.yaml"),
                        os.path.join(keep, "vae_config.yaml"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[vae-train] phases 23-24: {out['seconds']:.1f} s")
    return out


# -- phases 25-27: the micro-Doppler application path -----------------------------

# vavae_tpu_torch/configs/dit_s_microdoppler.yaml written out with ``log_every`` 1:
# DiT-S/2 at full width and depth (hidden 384, depth 12, 6 heads), 32 classes
# (31 users + the CFG null), fp32 compute as the file sets no ``bf16``
MICRODOPPLER_APP = {
    "data": {"image_size": 256, "num_classes": 32, "num_users": 31, "latent_norm": True,
             "latent_multiplier": 1.0},
    "vae": {"model_name": "vavae_f16d32", "downsample_ratio": 16},
    "model": {"model_type": "LightningDiT-S/2", "use_qknorm": False, "use_swiglu": True,
              "use_rope": True, "use_rmsnorm": True, "wo_shift": False, "in_chans": 32,
              "use_checkpoint": False, "class_dropout_prob": 0.05},
    "train": {"max_steps": 8000, "global_batch_size": 16, "global_seed": 0,
              "output_dir": "output", "exp_name": "dit_s_microdoppler", "log_every": 1},
    "optimizer": {"lr": 0.00005, "beta2": 0.99, "max_grad_norm": 1.0, "weight_decay": 0.01},
    "transport": {"path_type": "Linear", "prediction": "velocity", "use_lognorm": True,
                  "use_cosine_loss": True},
    "sample": {"mode": "ODE", "sampling_method": "dopri5", "atol": 1e-6, "rtol": 1e-3,
               "reverse": False, "num_sampling_steps": 300, "cfg_scale": 10.0,
               "per_proc_batch_size": 4, "cfg_interval_start": 0.11, "timestep_shift": 0.1},
}
LORA_RANK, LORA_ALPHA, LORA_BATCH, LORA_STEPS = 8, 16.0, 16, 6
LORA_TIMED = 10          # further steps timed after the entry point's run
LORA_XL_DEPTH = 4        # the XL/1 LoRA step: full width, depth cut to 4
LATENT_SHARDS, LATENT_PER_SHARD = 2, 48
CLF_SIZE, CLF_BATCH, CLF_USERS, CLF_PER_USER = 256, 64, 31, 5
CLF_CPU_BATCH = 16       # the card-vs-CPU step
CLF_TOL = 1e-3           # card vs CPU, relative: losses, weights, BN stats (Frobenius)
CLF_STEPS = 4            # timed steps a mode, after one warm-up step
CLF_MODES = {            # the baseline has data.num_classes classes, as run() builds it
    "baseline": dict(mode="baseline", num_classes=32),
    "improved_global": dict(mode="improved", contrastive_type="global", num_classes=31),
    "domain_adaptive": dict(mode="domain_adaptive", num_classes=31),
}
FILTER_BATCH, FILTER_BATCHES = 8, 2
FILTER_STEPS = 50        # euler split-CFG (the production sampler, cut): an exact launch count


def write_latent_shards(root: str, seed: int) -> None:
    """Seeded f16d32 latent shards in the JAX package's format (N, 32, 16, 16),
    labels over the 31 users."""
    rs = np.random.default_rng(seed)
    for i in range(LATENT_SHARDS):
        lat = (rs.standard_normal((LATENT_PER_SHARD, 32, 16, 16))
               * rs.uniform(0.5, 2.0, (1, 32, 1, 1))).astype(np.float32)
        write_safetensors(os.path.join(root, f"latents_rank00_shard{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 31, (LATENT_PER_SHARD,)).astype(np.int32)})


def _fp32_attention_bound(B: int, H: int, N: int, D: int, flops_per: float,
                          tensors: int, rope: bool = True) -> tuple[float, str]:
    """Least time on an H100 of an fp32 attention call with D <= 128, the
    same work at fp32 accuracy on the tensor cores: ``flops_per``·B·H·N²·D
    operations taken three times (3xTF32: hi·hi, hi·lo, lo·hi) at the TF32
    peak, vs ``tensors`` fp32 (B, N, H, D) tensors and, with RoPE, the two
    (N, D) tables moved once. At (16, 6, 64, 64): forward 0.61 us of
    operations against 1.89 us of bytes, backward 1.53 against 3.30."""
    flops = 3 * flops_per * B * H * N * N * D
    nbytes = 4.0 * tensors * B * N * H * D + (2 * N * D * 4 if rope else 0)
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def lora_kernel_rows(seed: int, B: int = LORA_BATCH, H: int = 6, tag: str = "lora") -> dict:
    """Kernels #1 and #2 at the LoRA step's attention shape (B 16, 6 heads,
    N 64, D 64, RoPE, fp32 as the config computes; other B and H for other
    micro-Doppler DiTs): each against its plain version, its time, the
    plain version's, SDPA's (forward; backward of q, k, v rotated
    beforehand), the bound, and the kernel's and SDPA's device time."""
    N, D = 64, 64
    gen = torch.Generator(device="cuda").manual_seed(seed + 250)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda")
    g = torch.randn((B, N, H, D), generator=gen, device="cuda")
    cos, sin = rope_2d_freqs(D, 8)
    tables = (torch.as_tensor(cos, device="cuda"), torch.as_tensor(sin, device="cuda"))
    cosf, sinf = fold_sin(tables, device="cuda")
    c, s_ = cosf[None, :, None], sinf[None, :, None]
    rot = lambda x: x * c + torch.roll(x, D // 2, dims=-1) * s_  # noqa: E731
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in (rot(qkv[:, :, 0]), rot(qkv[:, :, 1]), qkv[:, :, 2]))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    out = sdpa()
    gt = g.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(out, (q, k, v), gt, retain_graph=True)  # noqa: E731
    rows = {}
    for name, fn, ref, library, flops_per, tensors in (
            ("nat_attention_fwd", lambda: fused_qkv_attention(qkv, rope=tables),
             lambda: fused_qkv_attention_reference(qkv, rope=tables), sdpa, 4.0, 4),
            ("nat_attention_bwd", lambda: fused_qkv_attention_bwd(qkv, g, rope=tables),
             lambda: fused_qkv_attention_bwd_reference(qkv, g, rope=tables), sdpa_bwd, 10.0, 7)):
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not (rel <= 1e-4):
            fail(f"{name} fp32 at {(B, H, N, D)}: max-rel {rel} against its plain version")
        row = {"shape": [B, H, N, D], "dtype": "fp32", "rope": True, "max_abs_err": err,
               "max_rel_err": rel, "ms": time_ms(fn),
               "device_ms": sum(device_kernels(fn).values()),
               "plain_ms": time_ms(ref), "library_ms": time_ms(library),
               "library_device_ms": device_ms(library)}
        row["bound_ms"], row["bound_by"] = _fp32_attention_bound(B, H, N, D, flops_per, tensors)
        rows[name] = row
        dev, lib_dev = f"{row['device_ms']:.4f}", f"{row['library_device_ms']:.4f}"
        log(f"[{tag}-kernels] {name} fp32 B={B} H={H} N={N} D={D} rope: max-abs {err:.3e} "
            f"(max-rel {rel:.3e}), kernel {row['ms']:.4f} ms (device {dev}), "
            f"plain {row['plain_ms']:.4f} ms, SDPA{' backward' if 'bwd' in name else ''} "
            f"{row['library_ms']:.4f} ms (device {lib_dev}), bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return rows


def _jax_dit_msgpack(path: str, model) -> dict:
    """``model``'s weights as a JAX-layout DiT train state in flax msgpack (the
    JAX package's legacy checkpoint format): step, params, ema_params and a
    None optimizer state. Returns the port state dict it holds."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    tree = dit_state_to_jax(sd)
    write_msgpack(path, {"step": np.asarray(0, np.int32), "params": tree, "ema_params": tree,
                         "opt_state": None})
    return sd


def phase_lora(seed: int, device_info: dict, work: str) -> dict:
    """Phase 25: ``lora_finetune.main`` on the micro-Doppler DiT-S/2 from a
    JAX-layout msgpack base; then one XL/1 LoRA step, kernels vs plain."""
    cfg = Config(MICRODOPPLER_APP).merged_with({"data": {"data_path": os.path.join(work, "latents")}})
    write_latent_shards(cfg.data.data_path, seed)
    cfg_path = os.path.join(work, "dit_s_microdoppler.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    base_model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda")
    randomize_(base_model, seed)
    base_path = os.path.join(work, "base.msgpack")
    base_sd = _jax_dit_msgpack(base_path, base_model)
    del base_model
    out = os.path.join(work, "lora")
    argv = ["--config", cfg_path, "--base_ckpt", base_path, "--rank", str(LORA_RANK),
            "--alpha", str(LORA_ALPHA), "--steps", str(LORA_STEPS), "--batch_size",
            str(LORA_BATCH), "--out_dir", out, "--export_merged"]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = lora_finetune.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    trainer, state = res["trainer"], res["state"]
    depth = trainer.model.depth
    expect_counts(got, {"nat_attention_fwd": depth * LORA_STEPS,
                        "nat_attention_bwd": depth * LORA_STEPS}, "LoRA finetune")
    if not any("split-half RoPE" in str(w.message) for w in caught):
        fail("the msgpack base loaded without the JAX package's RoPE-layout warning")
    losses = np.asarray(res["losses"])
    if len(losses) != LORA_STEPS or not np.isfinite(losses).all():
        fail(f"LoRA losses {losses}")
    for k, v in trainer.model.state_dict().items():
        if not torch.equal(v.cpu(), base_sd[k]):
            fail(f"LoRA training changed the base weight {k}")
    init = trainer.init_state()  # the same seeded draw of A, B = 0
    for n, ad in state.lora.items():
        if ad["alpha"].item() != LORA_ALPHA:
            fail(f"alpha of {n} moved to {ad['alpha'].item()}")
    if not all(not torch.equal(state.lora[n]["a"], init.lora[n]["a"])
               and state.lora[n]["b"].abs().max() > 0 for n in state.lora):
        fail("an adapter's A or B did not move")
    back = load_lora(res["lora_path"], device="cuda")
    if sorted(back) != sorted(state.ema_lora) or not all(
            torch.equal(back[n][k], state.ema_lora[n][k]) for n in back for k in back[n]):
        fail("the LoRA file does not read back equal to the EMA adapters")
    merged = trainer.merged_params(state)
    check = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda")
    load_dit_params(check, res["merged_path"])
    if not all(torch.equal(v, merged[k]) for k, v in check.state_dict().items()):
        fail("the merged export does not load into pipelines.sample equal to the merge")
    del check
    peak_main = torch.cuda.max_memory_allocated()

    # ms/step of further steps on the same batch stream (not counted)
    ds = ImgLatentDataset(cfg.data.data_path, latent_norm=True)
    it = ds.batches(LORA_BATCH, seed=1)
    batches = [tuple(torch.as_tensor(a, device="cuda") for a in next(it)) for _ in range(4)]
    trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LORA_TIMED):
        trainer.train_step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / LORA_TIMED * 1e3
    kernels = lora_kernel_rows(seed)
    xl = phase_lora_xl(seed)
    res_out = {"wall_s": wall, "losses": losses.tolist(), "launches": [got["nat_attention_fwd"],
               got["nat_attention_bwd"]], "ms_per_step": ms_step,
               "img_per_s": LORA_BATCH / ms_step * 1e3, "peak_bytes": peak_main,
               "lora_params": lora_size(state.lora), "merged_path": res["merged_path"],
               "kernels": kernels, "xl": xl}
    log(f"[lora] lora_finetune.main DiT-S/2 (depth {depth}, fp32) r={LORA_RANK} "
        f"alpha={LORA_ALPHA:g} batch {LORA_BATCH}: {LORA_STEPS} steps in {wall:.1f} s "
        f"(load, train, save, export), loss {losses[0]:.4f} → {losses[-1]:.4f}, "
        f"{res_out['lora_params'] / 1e6:.3f}M adapter parameters, launches "
        f"{got['nat_attention_fwd']} nat_attention_fwd / {got['nat_attention_bwd']} "
        f"nat_attention_bwd ({depth} each a step); {ms_step:.2f} ms/step "
        f"({res_out['img_per_s']:.1f} img/s), peak {peak_main / 2**30:.2f} GiB; base bit-identical, "
        f"alpha unchanged, A and B moved, LoRA file and merged export read back "
        f"[{device_info['smi']}]")
    return res_out


def phase_lora_xl(seed: int) -> dict:
    """One LoRA step's adapter gradients on the production XL/1 (full width,
    depth cut to ``LORA_XL_DEPTH``, bf16, remat "dots") with both kernels
    against plain attention."""
    cfg = branch_config("production")
    with variant_depth("XL", LORA_XL_DEPTH):
        model = create_dit(cfg.model, 16, cfg.data.num_classes, device="cuda")
    randomize_(model, seed)
    trainer = LoRATrainer(model, build_transport(cfg), rank=LORA_RANK, alpha=LORA_ALPHA)
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(seed + 251)
    with torch.no_grad():  # B away from 0, so A receives a gradient too
        for ad in state.lora.values():
            ad["b"].normal_(0.0, 0.01, generator=gen)
    B = BATCH
    x = torch.randn((B, 16, 16, 32), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    t = trainer.transport.sample_t(B, gen)
    x0 = torch.randn((B, 16, 16, 32), generator=gen, device="cuda")
    drop = torch.zeros((B,), dtype=torch.long, device="cuda")

    def grads():
        out = trainer.loss_and_grads(state.lora, x, y, t, x0, drop)[2]
        return torch.cat([g.float().flatten() for g in out])

    reset_counts()
    with_kernel = grads()
    torch.cuda.synchronize()
    expect_counts(counts(), {"nat_attention_fwd": 2 * LORA_XL_DEPTH,
                             "nat_attention_bwd": LORA_XL_DEPTH}, "XL/1 LoRA step")
    with plain_attention("production"):
        plain = grads()
    rel = ((with_kernel - plain).norm() / plain.norm()).item()
    if not (rel <= PATH_TOL):
        fail(f"XL/1 LoRA adapter gradients, kernels vs plain attention: {rel} > {PATH_TOL}")
    log(f"[lora] XL/1 (width 1152, depth {LORA_XL_DEPTH}, bf16, remat dots) LoRA r={LORA_RANK} "
        f"adapter gradients B={B}, kernels vs plain attention: relative error {rel:.3e}")
    del model, trainer, state
    torch.cuda.empty_cache()
    return {"rel_err": rel, "depth": LORA_XL_DEPTH}


def write_user_folder(root: str, seed: int, per_user: int = CLF_PER_USER) -> None:
    """Seeded 256² PNGs in ``ID_{u}`` folders, 31 users: a coarse random
    layout per user (16-px cells) plus per-image noise."""
    rs = np.random.default_rng(seed)
    for u in range(CLF_USERS):
        d = os.path.join(root, f"ID_{u + 1}")
        os.makedirs(d)
        base = np.repeat(np.repeat(rs.integers(0, 256, (16, 16, 3)), 16, 0), 16, 1)
        for i in range(per_user):
            img = np.clip(base + rs.integers(-40, 41, base.shape), 0, 255).astype(np.uint8)
            write_pngs(img[None], [os.path.join(d, f"{i:03d}.png")])


def _clf_groups(state) -> dict:
    return {"params": [t.detach().float().cpu() for t in state.params],
            "stats": [t.detach().float().cpu() for t in state.stats]}


def _frob(a: list, b: list) -> float:
    a = torch.cat([t.flatten().double() for t in a])
    b = torch.cat([t.flatten().double() for t in b])
    return ((a - b).norm() / b.norm()).item()


def _clf_cpu_check(name: str, spec: dict, state, trainer, batch, work: str) -> dict:
    """One fp32 step from the same state and draws on the card and on the
    CPU (the state carried through the classifier file)."""
    path = save_classifier(os.path.join(work, f"{name}_check.safetensors"), trainer, state,
                           extras=True)
    cpu = ClassifierTrainer(device="cpu", seed=SEED, **spec)
    cpu_state = restore_classifier(path, cpu, cpu.init_state(0))
    card_state = restore_classifier(path, trainer, trainer.init_state(0))
    x, y = (a[:CLF_CPU_BATCH] for a in batch)
    draws = {}
    if spec["mode"] == "domain_adaptive":
        g = torch.Generator().manual_seed(SEED + 260)
        keep = 1.0 - trainer.dropout_rate
        draws["dropout"] = [torch.rand((CLF_CPU_BATCH, n), generator=g) < keep for n in (512, 256)]
    m_card = trainer.train_step(card_state, (x, y),
                                {k: [t.cuda() for t in v] for k, v in draws.items()})
    m_cpu = cpu.train_step(cpu_state, (x, y), draws)
    loss_rel = abs(m_card["loss"].item() - m_cpu["loss"].item()) / abs(m_cpu["loss"].item())
    a, b = _clf_groups(card_state), _clf_groups(cpu_state)
    rels = {"loss": loss_rel, "params": _frob(a["params"], b["params"]),
            "stats": _frob(a["stats"], b["stats"])}
    if not all(r <= CLF_TOL for r in rels.values()):
        fail(f"classifier {name}: card vs CPU {rels} (limit {CLF_TOL})")
    return rels


def phase_classifier(seed: int, device_info: dict, work: str) -> dict:
    """Phase 26: ``ClassifierTrainer`` at 256², batch 64, three modes."""
    folder = os.path.join(work, "users")
    write_user_folder(folder, seed)
    ds = MixedDomainDataset(real_dir=folder, split="train", image_size=CLF_SIZE, verbose=False)
    it = ds.batches(CLF_BATCH, seed=seed)
    batches = [next(it) for _ in range(CLF_STEPS + 1)]
    out = {}
    reset_counts()
    for name, spec in CLF_MODES.items():
        trainer = ClassifierTrainer(device="cuda", seed=seed, **spec)
        state = trainer.init_state(seed)
        frozen = {n: t.detach().clone() for n, t, tr in
                  zip(state.names, state.params, state.trainable) if not tr}
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(state, batches[0])  # warm-up (cuDNN's algorithm choice)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [trainer.train_step(state, b)["loss"] for b in batches[1:]]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / CLF_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            fail(f"classifier {name}: losses {losses}")
        if any(not torch.equal(t, frozen[n]) for n, t in zip(state.names, state.params)
               if n in frozen):
            fail(f"classifier {name}: a frozen stage moved")
        path = save_classifier(os.path.join(work, f"{name}.safetensors"), trainer, state)
        back = restore_classifier(path, trainer, trainer.init_state(seed + 1))
        if not all(torch.equal(a, b) for a, b in zip(back.params + back.stats,
                                                     state.params + state.stats)):
            fail(f"classifier {name}: the saved file does not read back equal")
        rels = _clf_cpu_check(name, spec, state, trainer, batches[0], work)
        out[name] = {"ms_per_step": ms, "img_per_s": CLF_BATCH / ms * 1e3, "peak_bytes": peak,
                     "losses": losses.tolist(), "frozen_tensors": len(frozen), "cpu_check": rels,
                     "path": path}
        log(f"[classifier] {name} ResNet-18 {CLF_SIZE}² batch {CLF_BATCH} (fp32, TF32 off, no "
            f"autocast): {ms:.2f} ms/step, {out[name]['img_per_s']:.1f} img/s, peak "
            f"{peak / 2**30:.2f} GiB, loss {losses[0]:.4f} → {losses[-1]:.4f}, {len(frozen)} "
            f"frozen tensors bit-identical, file read back; one step card vs CPU (batch "
            f"{CLF_CPU_BATCH}): loss {rels['loss']:.2e}, weights {rels['params']:.2e}, BN stats "
            f"{rels['stats']:.2e} [{device_info['smi']}]")
        del trainer, state
        torch.cuda.empty_cache()
    expect_counts(counts(), {}, "classifier phase")  # no attention kernel
    return out


def phase_generate_filter(seed: int, device_info: dict, work: str, lora: dict,
                          classifier: dict) -> dict:
    """Phase 27: ``generate_and_filter.run`` with phase 25's merged export,
    phase 26's baseline classifier and the f16d32 VA-VAE decode (seeded
    random weights), two users at confidence 0 (random weights accept almost
    nothing at the app's 0.95)."""
    cfg = Config(MICRODOPPLER_APP).merged_with({
        "ckpt_path": lora["merged_path"],
        "data": {"data_path": os.path.join(work, "latents")},
        "sample": {"sampling_method": "euler", "num_sampling_steps": FILTER_STEPS}})
    cfg_path = os.path.join(work, "generate_and_filter.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    save_dir = os.path.join(work, "filtered")
    seconds, decoded, probs = {}, [], []
    users = _probe_users(cfg, classifier["baseline"]["path"], seed)
    build = sample_mod.build_sample_fn

    def timed_build(*args, **kwargs):
        return _timed(build(*args, **kwargs), seconds, "sampling")

    predict = ClassifierTrainer.predict_fn
    fcfg = gen_filter.FilterConfig(confidence_threshold=0.0, target_per_user=10**6,
                                   batch_size=FILTER_BATCH, max_batches=FILTER_BATCHES)
    reset_counts()
    t0 = time.perf_counter()
    with _patched(sample_mod, "build_sample_fn", timed_build), \
            _patched(VA_VAE, "decode_to_images",
                     _timed(_recorded(decoded, VA_VAE.decode_to_images), seconds, "decode")), \
            _patched(ClassifierTrainer, "predict_fn",
                     lambda self, st: _timed(_recorded(probs, predict(self, st)), seconds,
                                             "classifier")):
        results = gen_filter.run(cfg_path, user_ids=list(users), filter_cfg=fcfg,
                                 save_dir=save_dir, classifier_ckpt=classifier["baseline"]["path"],
                                 device="cuda")
    wall = time.perf_counter() - t0
    got = counts()
    depth = 12  # DiT-S/2
    calls = len(users) * FILTER_BATCHES
    expect_counts(got, {"nat_attention_fwd": depth * (FILTER_STEPS - 1) * calls},
                  "generate_and_filter")
    n = 0
    for k, uid in enumerate(users):
        st = results[uid]
        imgs = decoded[k * FILTER_BATCHES:(k + 1) * FILTER_BATCHES]
        pr = probs[k * FILTER_BATCHES:(k + 1) * FILTER_BATCHES]
        kept = [im for b_imgs, b_pr in zip(imgs, pr) for im, ok in zip(
            b_imgs, (b_pr.argmax(-1) == uid) & (b_pr.max(-1) > 0.0)
            & gen_filter.pixel_sanity(b_imgs, *fcfg.pixel_range)) if ok]
        if (st["generated"], st["batches"], st["accepted"]) != (
                FILTER_BATCH * FILTER_BATCHES, FILTER_BATCHES, len(kept)) \
                or st["acceptance_rate"] != st["accepted"] / st["generated"]:
            fail(f"user {uid}: stats {st}, {len(kept)} images pass the gates")
        user_dir = os.path.join(save_dir, f"user_{uid:02d}")
        files = sorted(os.listdir(user_dir)) if os.path.isdir(user_dir) else []
        if len(files) != st["accepted"]:
            fail(f"user {uid}: {len(files)} PNGs for {st['accepted']} accepted")
        for f, im in zip(files, kept):
            if not np.array_equal(read_png(os.path.join(user_dir, f)), im):
                fail(f"user {uid}: {f} does not decode to its image")
        n += st["generated"]
    if not sum(results[u]["accepted"] for u in users):
        fail(f"users {users}: nothing accepted, so no PNG was written")
    res = {"wall_s": wall, "samples_per_s": n / wall, "seconds": seconds, "stats": {
        str(u): st for u, st in results.items()}, "launches": got["nat_attention_fwd"]}
    log(f"[filter] generate_and_filter.run: users {list(users)}, {FILTER_BATCHES} batches "
        f"of {FILTER_BATCH}, euler-{FILTER_STEPS} split-CFG (cfg 10, interval 0.11), f16d32 decode, "
        f"baseline classifier, confidence 0: accepted "
        f"{[results[u]['accepted'] for u in users]} of {FILTER_BATCH * FILTER_BATCHES} "
        f"each, PNGs match; {n / wall:.3f} samples/s ({wall:.1f} s: sampling "
        f"{seconds.get('sampling', 0):.2f} s, decode {seconds.get('decode', 0):.2f} s, classifier "
        f"{seconds.get('classifier', 0):.2f} s), {got['nat_attention_fwd']} nat_attention_fwd "
        f"launches [{device_info['smi']}]")
    return res


@torch.no_grad()
def _probe_users(cfg: Config, classifier_path: str, seed: int) -> tuple[int, int]:
    """The two users phase 27 filters for: the classes the baseline
    classifier predicts most often on one batch sampled and decoded as
    ``run`` does (random weights predict a few classes for any label, so
    users chosen blind would accept nothing and write no PNG)."""
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda")
    load_dit_params(model, cfg.ckpt_path)
    generate = build_sample_fn(cfg, model.eval(), sample_mod.load_latent_stats(cfg), device="cuda")
    vae = VA_VAE(img_size=cfg.data.image_size, device="cuda")
    trainer = ClassifierTrainer(num_classes=cfg.data.num_classes, device="cuda")
    state = restore_classifier(classifier_path, trainer, trainer.init_state(0))
    gen = torch.Generator(device="cuda").manual_seed(seed + 270)
    imgs = vae.decode_to_images(generate(torch.zeros(FILTER_BATCH, dtype=torch.long), generator=gen))
    pred = trainer.predict_fn(state)(imgs.astype(np.float32) / 127.5 - 1.0).argmax(-1)
    votes = np.bincount(pred, minlength=cfg.data.num_classes)[:cfg.data.num_users]
    first, second = (int(u) for u in np.argsort(-votes, kind="stable")[:2])
    log(f"[filter] probe batch: the classifier's votes over the users {votes.tolist()}; users "
        f"{first} and {second}")
    return first, second


def _recorded(store: list, fn):
    """Smoke-only: ``fn`` with a copy of each call's output appended to ``store``."""
    def call(*args):
        out = fn(*args)
        store.append(np.array(out))
        return out
    return call


def run_microdoppler_apps(seed: int, device_info: dict) -> dict:
    """Phases 25-30."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    out = {}
    try:
        for key, phase in (("lora", lambda: phase_lora(seed, device_info, work)),
                           ("classifier", lambda: phase_classifier(seed, device_info, work)),
                           ("generate_filter", lambda: phase_generate_filter(
                               seed, device_info, work, out["lora"], out["classifier"])),
                           ("quantize", lambda: phase_quantize(seed, device_info, work)),
                           ("iterative", lambda: phase_iterative(seed, device_info, work)),
                           ("scoring", lambda: phase_scoring(seed, device_info, work,
                                                             out["classifier"]))):
            t1 = time.perf_counter()
            out[key] = phase()
            out[key]["phase_s"] = time.perf_counter() - t1
            log(f"[apps] {key}: {out[key]['phase_s']:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    late = sum(out[k]["phase_s"] for k in ("quantize", "iterative", "scoring"))
    log(f"[apps] phases 25-30: {out['seconds']:.1f} s (28-30: {late:.1f} s)")
    return out


# -- phases 28-30: the rest of the micro-Doppler application layer ---------------------

QUANT_BATCH, QUANT_REPS, QUANT_SAMPLES = 8, 10, 4
# LightningDiT-B/2 on micro-Doppler latents
# (vavae_tpu_torch/configs/dit_b_microdoppler.yaml), written out
DIT_B_MICRODOPPLER = {
    "data": {"image_size": 256, "num_classes": 31, "latent_norm": True, "latent_multiplier": 1.0,
             "augment_training": False},
    "vae": {"model_name": "vavae_f16d32", "downsample_ratio": 16, "config": None},
    "model": {"model_type": "LightningDiT-B/2", "num_classes": 31, "use_qknorm": False,
              "use_swiglu": True, "use_rope": True, "use_rmsnorm": True, "wo_shift": False,
              "in_chans": 32, "use_checkpoint": False},
    "train": {"max_epochs": 150, "global_batch_size": 8, "global_seed": 42,
              "output_dir": "output", "exp_name": "dit_base_microdoppler", "log_every": 100,
              "ema_decay": 0.9999},
    "optimizer": {"lr": 0.00005, "beta1": 0.9, "beta2": 0.999, "max_grad_norm": 0.5,
                  "weight_decay": 0.001, "eps": 1.0e-08},
    "transport": {"path_type": "Linear", "prediction": "velocity", "use_cosine_loss": True,
                  "use_lognorm": True},
    "sample": {"mode": "ODE", "sampling_method": "euler", "atol": 0.000001, "rtol": 0.001,
               "reverse": False, "num_sampling_steps": 250, "cfg_scale": 10.0,
               "per_proc_batch_size": 4, "cfg_interval_start": 0.11, "timestep_shift": 0.1},
}
ITER_ROUNDS, ITER_STEPS, ITER_BATCH, ITER_SAMPLES, ITER_USERS = 2, 4, 8, 4, 2
B2_GRAD_TOL = 1e-3    # fp32 B/2 gradients, kernels (the 3xTF32 bodies) vs plain attention
DA_USERS, DA_PER_USER = 31, 10
DA_STAT_TOL = 1e-5    # card vs CPU: target BN statistics, relative (max-abs / max)
DA_PROB_TOL = 1e-5    # card vs CPU: adapted probabilities, max-abs
DA_CPU_SUPPORT = 2    # support images a class of the card-vs-CPU check
DA_CPU_TEST = 62      # its test images


def _tensor_leaves(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{part}": t for part, t in v.items()})
        else:
            out[k] = v
    return out


def phase_quantize(seed: int, device_info: dict, work: str) -> dict:
    """Phase 28: ``quantize_dit.main`` on the production XL/1 (seeded random
    weights) at batch 8 with ``--sample_check 4`` and ``--out``; the int8
    product on the card against the CPU's at an XL/1 ``qkv`` shape; the
    written file read back. XL/1 cut to CUT_DEPTH."""
    with variant_depth("XL", CUT_DEPTH):
        return _phase_quantize(seed, device_info, work)


def _phase_quantize(seed: int, device_info: dict, work: str) -> dict:
    cfg, model = build_xl(seed)
    cfg = cfg.merged_with({"sample": {"num_sampling_steps": SAMPLER_STEPS}})
    ckpt = os.path.join(work, "xl.safetensors")  # the weights alone: a 2.6 GB file, not 5.2
    write_safetensors(ckpt, flatten(dit_state_to_jax(
        {k: v.detach().float().cpu() for k, v in model.state_dict().items()}), "params"))
    cfg_path = os.path.join(work, "xl.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(work, "xl_int8.safetensors")
    argv = ["--config", cfg_path, "--ckpt", ckpt, "--batch_size", str(QUANT_BATCH),
            "--reps", str(QUANT_REPS), "--sample_check", str(QUANT_SAMPLES), "--out", out]
    reset_counts()
    t0 = time.perf_counter()
    report = quantize_dit.main(argv)
    wall = time.perf_counter() - t0
    got = counts()
    depth, steps = model.depth, cfg.sample.num_sampling_steps
    # the fp and dequantized forwards (a warm-up and the timed reps each), two sampling calls
    want = depth * (2 * (1 + QUANT_REPS) + 2 * (steps - 1))
    expect_counts(got, {"nat_attention_fwd": want}, "quantize_dit")
    for key in ("mean_abs_rel_error", "sample_latent_rel_l2", "fp_latency_ms",
                "dequant_latency_ms"):
        if not (np.isfinite(report[key]) and report[key] > 0):
            fail(f"quantize_dit: {key} = {report[key]}")
    if not 3.5 < report["compression"] < 4.0:
        fail(f"quantize_dit: compression {report['compression']}")
    params = {k: v.detach() for k, v in model.named_parameters()}
    qparams, _ = quant.quantize_params(params)
    back = _tensor_leaves(quantize_dit.load_int8(out))
    mem = _tensor_leaves(qparams)
    if sorted(back) != sorted(mem) or not all(
            torch.equal(back[k], mem[k].detach().cpu()) for k in mem):
        fail("the int8 file does not read back equal to the quantized weights")
    # the int8 product at an XL/1 qkv shape: torch._int_mm on the card, int32 on the CPU
    q = qparams["blocks.0.attn.qkv.weight"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 280)
    tokens = (model.input_size // model.patch_size) ** 2
    x = torch.randn((QUANT_BATCH * tokens, q["values"].shape[1]), generator=gen, device="cuda")
    out_card, acc_card = quant.int8_matmul(x, q, return_acc=True)
    out_cpu, acc_cpu = quant.int8_matmul(x.cpu(), {k: v.cpu() for k, v in q.items()},
                                         return_acc=True)
    if not torch.equal(acc_card.cpu(), acc_cpu):
        fail("int8_matmul: torch._int_mm's int32 accumulators differ from the CPU's")
    out_err = ((out_card.cpu() - out_cpu).abs().max() / out_cpu.abs().max()).item()
    if not out_err <= 1e-6:
        fail(f"int8_matmul: card vs CPU outputs {out_err}")
    xq, _ = quant.quantize_activations(x)
    int_mm_ms = time_ms(lambda: quant.int8_accumulate(xq, q["values"]))
    w_bf16 = quant.dequantize_kernel(q).to(torch.bfloat16)
    x_bf16 = x.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: torch.nn.functional.linear(x_bf16, w_bf16))
    res = {**report, "wall_s": wall, "launches": got["nat_attention_fwd"],
           "int8_shape": [x.shape[0], x.shape[1], q["values"].shape[0]],
           "int8_out_rel_err": out_err, "int_mm_ms": int_mm_ms, "bf16_linear_ms": bf16_ms}
    log(f"[quantize] quantize_dit.main XL/1 (depth {depth}, bf16 compute) batch {QUANT_BATCH}: "
        f"{report['fp_size_mb']:.2f} MiB fp32 → {report['int8_size_mb']:.2f} MiB int8 "
        f"({report['compression']:.4f}×), forward fp {report['fp_latency_ms']:.2f} ms, "
        f"dequantized {report['dequant_latency_ms']:.2f} ms, mean_abs_rel_error "
        f"{report['mean_abs_rel_error']:.4e}; --sample_check {QUANT_SAMPLES} (euler-{steps} "
        f"split-CFG, fp and dequantized, the same noise): sample_latent_rel_l2 "
        f"{report['sample_latent_rel_l2']:.4e}, max-abs {report['sample_latent_max_abs']:.4e}; "
        f"{got['nat_attention_fwd']} nat_attention_fwd launches; {wall:.1f} s; int8 file read "
        f"back equal; int8_matmul {tuple(res['int8_shape'])}: torch._int_mm accumulators equal "
        f"to the CPU's, outputs {out_err:.1e}, _int_mm {int_mm_ms:.4f} ms vs bf16 linear "
        f"{bf16_ms:.4f} ms [{device_info['smi']}]")
    return res


def _random_files(work: str, cfg: Config, seed: int) -> tuple[str, str]:
    """Seeded random B/2 DiT (a DiT train state) and f16d32 VA-VAE weight files."""
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda")
    randomize_(model, seed)
    dit_path = lora_finetune.export_merged(os.path.join(work, "dit_b"), 0, {
        k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    vae = VA_VAE(img_size=cfg.data.image_size, seed=seed, device="cuda")
    vae_path = os.path.join(work, "vae_f16d32.safetensors")
    write_safetensors(vae_path, flatten(vae_state_to_jax(vae.model.state_dict())))
    return dit_path, vae_path


@torch.no_grad()
def _two_user_classifier(path: str, cfg: Config, seed: int, dit_path: str,
                         vae_path: str) -> float:
    """A seeded random classifier of ``data.num_classes`` classes whose head
    is a nearest-centroid rule between users 0 and 1, the two users the run
    iterates: on a probe batch sampled and decoded as the run does (half of
    it each user), its backbone features' means μ0 and μ1 give the logits
    ±(μ0 − μ1)·(f − (μ0 + μ1)/2), every other class −1e4. (A random head,
    as phase 27 picks users with, voted 8 of 8 probe images of this B/2 for
    one class: the other user then accepted nothing in 20 batches a
    round.) Returns the probe batches' accuracy."""
    latent = cfg.data.image_size // cfg.vae.downsample_ratio
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="cuda")
    load_dit_params(model, dit_path)
    generate = build_sample_fn(cfg, model.eval(), sample_mod.load_latent_stats(cfg),
                               device="cuda")
    vae = VA_VAE(ckpt_path=vae_path, img_size=cfg.data.image_size, device="cuda")
    trainer = ClassifierTrainer(num_classes=cfg.data.num_classes, device="cuda")
    state = trainer.init_state(seed + 291)
    gen = torch.Generator(device="cuda").manual_seed(seed + 290)
    labels = torch.arange(ITER_BATCH) * ITER_USERS // ITER_BATCH
    probe = vae.decode_to_images(generate(labels, generator=gen)).astype(np.float32) / 127.5 - 1
    x = [probe[labels.numpy() == u] for u in range(ITER_USERS)]
    feats = [torch.as_tensor(trainer.feature_fn(state)(xu), device="cuda") for xu in x]
    mu0, mu1 = (f.mean(0) for f in feats)
    d, mid = mu0 - mu1, (mu0 + mu1) / 2
    fc = dict(zip(state.names, state.params))
    fc["fc.weight"].zero_()
    fc["fc.bias"].fill_(-1e4)
    fc["fc.weight"][0], fc["fc.weight"][1] = d, -d
    fc["fc.bias"][0], fc["fc.bias"][1] = -(d @ mid), d @ mid
    acc = float(np.mean([(trainer.predict_fn(state)(xu).argmax(-1) == u).mean()
                         for u, xu in enumerate(x)]))
    save_classifier(path, trainer, state)
    log(f"[iterative] probe batch ({ITER_BATCH}, half of it each user): nearest-centroid head "
        f"accuracy {acc:.3f}")
    return acc


def phase_iterative(seed: int, device_info: dict, work: str) -> dict:
    """Phase 29: ``iterative_finetune.main`` on LightningDiT-B/2 (seeded
    random DiT, VA-VAE and classifier files, a latent shard tree written
    here), 2 rounds × 4 steps at batch 8, 4 samples a user, confidence 0,
    users 0 and 1; then one B/2 train step's gradients, kernels vs plain
    attention; the saved state restored."""
    root = os.path.join(work, "iterative")
    os.makedirs(os.path.join(root, "latents"))
    write_latent_shards(os.path.join(root, "latents"), seed + 29)
    cfg = Config(DIT_B_MICRODOPPLER).merged_with({"data": {
        "data_path": os.path.join(root, "latents"), "num_users": ITER_USERS},
        "sample": {"num_sampling_steps": SAMPLER_STEPS}})
    dit_path, vae_path = _random_files(root, cfg, seed)
    cfg = cfg.merged_with({"ckpt_path": dit_path, "vae": {"ckpt_path": vae_path}})
    cfg_path = os.path.join(root, "dit_b_microdoppler.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    clf_path = os.path.join(root, "classifier.safetensors")
    probe_acc = _two_user_classifier(clf_path, cfg, seed, dit_path, vae_path)

    rounds: list = []  # per round: seconds by part
    per_call = {"sample": [], "train": []}

    def mark(fn):
        def wrapper(self, *args, **kwargs):
            rounds.append({})
            return fn(self, *args, **kwargs)
        return wrapper

    def timed(fn, key, launches=None):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rounds[-1][key] = rounds[-1].get(key, 0.0) + time.perf_counter() - t0
            if launches is not None:
                after = counts()
                launches.append([after[k] - before[k] for k in
                                 ("nat_attention_fwd", "nat_attention_bwd")])
            return out
        return wrapper

    build = sample_mod.build_sample_fn
    predict = ClassifierTrainer.predict_fn
    out_dir = os.path.join(root, "out")
    argv = ["--config", cfg_path, "--classifier_ckpt", clf_path, "--iterations", str(ITER_ROUNDS),
            "--steps_per_iteration", str(ITER_STEPS), "--samples_per_user", str(ITER_SAMPLES),
            "--confidence", "0", "--batch_size", str(ITER_BATCH), "--out_dir", out_dir]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched(iterative_finetune.IterativeTraining, "_generate_synthetic",
                  mark(iterative_finetune.IterativeTraining._generate_synthetic)), \
            _patched(sample_mod, "build_sample_fn",
                     lambda *a, **k: timed(build(*a, **k), "generate", per_call["sample"])), \
            _patched(VA_VAE, "decode_to_images", timed(VA_VAE.decode_to_images, "decode")), \
            _patched(VA_VAE, "encode_images", timed(VA_VAE.encode_images, "encode")), \
            _patched(ClassifierTrainer, "predict_fn",
                     lambda self, st: timed(predict(self, st), "classify")), \
            _patched(DiTTrainer, "train_step",
                     timed(DiTTrainer.train_step, "train", per_call["train"])):
        state, history, path = iterative_finetune.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    depth, steps = 12, cfg.sample.num_sampling_steps
    n_sample, n_train = len(per_call["sample"]), len(per_call["train"])
    if n_train != ITER_ROUNDS * ITER_STEPS or state.step != n_train:
        fail(f"iterative_finetune: {n_train} train steps, state at {state.step}")
    if any(c != [depth * (steps - 1), 0] for c in per_call["sample"]) or any(
            c != [depth, depth] for c in per_call["train"]):
        fail(f"iterative_finetune: launches a sampling call {per_call['sample']}, a train step "
             f"{per_call['train']}")
    expect_counts(got, {"nat_attention_fwd": depth * ((steps - 1) * n_sample + n_train),
                        "nat_attention_bwd": depth * n_train}, "iterative_finetune")
    accepted = [h["accepted"] for h in history]
    losses = [h["final_loss"] for h in history]
    if len(history) != ITER_ROUNDS or not all(np.isfinite(losses)) or not sum(accepted):
        fail(f"iterative_finetune: history {history}")
    trainer = DiTTrainer(create_dit(cfg.model, 16, cfg.data.num_classes, device="cuda"),
                         build_transport(cfg))
    back = ckpt_lib.restore_checkpoint(path, trainer.init_state())
    if back.step != state.step or not all(
            torch.equal(a, b) for a, b in zip(back.params + back.ema_params,
                                              state.params + state.ema_params)):
        fail("iterative_finetune: the saved state does not restore equal")
    grads = phase_train_path(cfg, trainer.model.train(), seed, batch=ITER_BATCH, tol=B2_GRAD_TOL)
    # #1 and #2 at the B/2 train step's shape (B 8 is also sampling's CFG
    # batch, 4 samples twice), and #1 at sampling's cond-only batch of 4
    kernels = lora_kernel_rows(seed + 1, B=ITER_BATCH, H=12, tag="b2")
    kernels["nat_attention_fwd_sampling"] = lora_kernel_rows(
        seed + 2, B=ITER_SAMPLES, H=12, tag="b2-sampling")["nat_attention_fwd"]
    res = {"wall_s": wall, "rounds": rounds, "accepted": accepted, "final_losses": losses,
           "sampling_calls": n_sample, "launches": [got["nat_attention_fwd"],
                                                    got["nat_attention_bwd"]],
           "launches_per_sampling_call": per_call["sample"][0],
           "launches_per_train_step": per_call["train"][0], "peak_bytes": peak,
           "probe_accuracy": probe_acc, "grad_check": grads, "kernels": kernels}
    for k, r in enumerate(rounds):
        log(f"[iterative] round {k}: " + ", ".join(f"{key} {v:.2f} s" for key, v in r.items()))
    log(f"[iterative] iterative_finetune.main LightningDiT-B/2 (depth {depth}, fp32, N = 64) "
        f"{ITER_ROUNDS} rounds × {ITER_STEPS} steps at batch {ITER_BATCH}, {ITER_USERS} users × "
        f"{ITER_SAMPLES} samples, confidence 0, euler-{steps} split-CFG: {wall:.1f} s, accepted "
        f"{accepted}, final losses {[round(v, 4) for v in losses]}, {n_sample} sampling calls "
        f"({per_call['sample'][0][0]} nat_attention_fwd each), {per_call['train'][0]} "
        f"nat_attention_fwd/bwd a train step, peak {peak / 2**30:.2f} GiB; the saved state "
        f"restores equal; B/2 gradients kernels vs plain attention {grads['rel_err']:.3e} "
        f"[{device_info['smi']}]")
    return res


def _split_file(root: str, path: str) -> str:
    """A split file whose val side lists every PNG of the ``ID_{u}`` folders."""
    entries = [{"path": os.path.join(root, d, f), "user_id": int(d[3:]) - 1}
               for d in sorted(os.listdir(root)) for f in sorted(os.listdir(os.path.join(root, d)))]
    with open(path, "w") as f:
        json.dump({"train": entries, "val": entries}, f)
    return path


def _da_check(clf_path: str, split: str, seed: int) -> dict:
    """The support pool and test set as ``domain_adaptation.main`` splits
    them; target BN statistics and lccs_pnc_combined's probabilities on the
    card against the CPU (TF32 off); ``select_support`` with each strategy
    on the card's source features."""
    ds = SplitFileDataset(split, "val", image_size=224)
    labels = np.asarray([uid for _, uid in ds.items], np.int64)
    sup_idx, test_idx = domain_adaptation.strategic_split(labels, 5, seed=42)

    def load(idx):
        return np.stack([ds[int(i)][0] for i in idx])

    sup_x, sup_y, test_x = load(sup_idx), labels[sup_idx], load(test_idx[:DA_CPU_TEST])
    # the card-vs-CPU check on the first DA_CPU_SUPPORT support images a class
    sub = np.concatenate([np.where(sup_y == c)[0][:DA_CPU_SUPPORT] for c in np.unique(sup_y)])
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = ClassifierTrainer(num_classes=DA_USERS, device=dev)
        restore_classifier(clf_path, trainer, trainer.init_state(0))
        model = trainer.model.eval()
        params = {k: v.detach() for k, v in model.named_parameters()}
        stats = domain_adaptation.model_stats(model)
        target = domain_adaptation.compute_target_bn_stats(model, params, stats, sup_x[sub])
        _, _, predict = domain_adaptation.lccs_pnc_combined(
            model, params, stats, sup_x[sub], sup_y[sub], DA_USERS, alpha=0.3)
        out[dev] = ({k: v.cpu() for k, v in target.items()}, predict(test_x))
        if dev == "cuda":
            feats = domain_adaptation._features(model, params, stats, sup_x)
            probs = domain_adaptation._softmax_probs(model, params, stats, sup_x)
    stat_err = max(((out["cuda"][0][k] - out["cpu"][0][k]).abs().max()
                    / out["cpu"][0][k].abs().max()).item() for k in out["cpu"][0])
    prob_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    if not (stat_err <= DA_STAT_TOL and prob_err <= DA_PROB_TOL):
        fail(f"domain adaptation card vs CPU: statistics {stat_err} (limit {DA_STAT_TOL}), "
             f"probabilities {prob_err} (limit {DA_PROB_TOL})")
    keep = max(1, len(sup_x) // 2)
    selections = {}
    for strategy in ("random", "confidence", "diversity", "uncertainty", "balanced"):
        t0 = time.perf_counter()
        sel = domain_adaptation.select_support(feats, sup_y, probs, keep, strategy, seed=42)
        if len(sel) != keep or len(np.unique(sel)) != keep:
            fail(f"select_support {strategy}: {sel}")
        selections[strategy] = {"seconds": time.perf_counter() - t0,
                                "classes": int(len(np.unique(sup_y[sel])))}
    return {"stat_rel_err": stat_err, "prob_max_abs_err": prob_err, "support": len(sub),
            "select_support": selections}


def phase_scoring(seed: int, device_info: dict, work: str, classifier: dict) -> dict:
    """Phase 30: ``select_users``, ``analyze_metrics`` and
    ``generation_evaluator`` (feature and LPIPS diversity) at their CLI
    defaults on phase 26's users and baseline classifier and phase 27's
    filtered tree; ``domain_adaptation.main`` on a seeded random classifier
    and a target split of 31 users × 10 images; the card against the CPU."""
    seconds: dict = {}
    real = os.path.join(work, "users")
    split = _split_file(real, os.path.join(work, "users_split.json"))
    generated = os.path.join(work, "filtered")
    base = ["--classifier_ckpt", classifier["baseline"]["path"], "--split_file", split,
            "--num_classes", str(CLF_MODES["baseline"]["num_classes"])]
    lpips = LPIPS()
    init_lpips_weights(lpips, torch.Generator().manual_seed(seed + 300))
    lpips_path = os.path.join(work, "lpips_30.pth")
    torch.save(lpips.state_dict(), lpips_path)
    os.environ["VAVAE_LPIPS_WEIGHTS"] = lpips_path
    try:
        sel = _timed(select_users.main, seconds, "select_users")(base)
        metrics = _timed(analyze_metrics.main, seconds, "analyze_metrics")(
            base + ["--generated_dir", generated])
        ev = _timed(generation_evaluator.main, seconds, "generation_evaluator")(
            base + ["--generated_dir", generated])
        ev_lpips = _timed(generation_evaluator.main, seconds, "generation_evaluator_lpips")(
            base + ["--generated_dir", generated, "--diversity", "lpips"])
    finally:
        del os.environ["VAVAE_LPIPS_WEIGHTS"]
    if len(sel["selected"]) != 10 or len(sel["stats"]) != CLF_USERS:
        fail(f"select_users: {sel['selected']}, {len(sel['stats'])} users")
    if not 0.0 <= metrics["generated_pass_rate"] <= 1.0:
        fail(f"analyze_metrics: {metrics['generated_pass_rate']}")
    for report in (ev, ev_lpips):
        if not report or not all(np.isfinite(r["identity_acc"]) for r in report.values()):
            fail(f"generation_evaluator: {report}")
    lp = [r.get("lpips_diversity") for r in ev_lpips.values() if "lpips_diversity" in r]
    if not lp or not all(np.isfinite(v) and v >= 0 for v in lp):
        fail(f"generation_evaluator --diversity lpips: {lp}")

    da_root = os.path.join(work, "target")
    write_user_folder(da_root, seed + 30, per_user=DA_PER_USER)
    da_split = _split_file(da_root, os.path.join(work, "target_split.json"))
    trainer = ClassifierTrainer(num_classes=DA_USERS, device="cuda")
    da_clf = save_classifier(os.path.join(work, "da_classifier.safetensors"), trainer,
                             trainer.init_state(seed + 301))
    del trainer
    reset_counts()
    da = _timed(domain_adaptation.main, seconds, "domain_adaptation")([
        "--classifier_ckpt", da_clf, "--target_split_file", da_split, "--reference_grid",
        "--limit", "8", "--ncc", "--ensemble", "confidence_weighted"])
    expect_counts(counts(), {}, "domain adaptation")
    if len(da["grid_results"]) != 8 or not 0 <= da["best_accuracy"] <= 1 \
            or not da.get("ncc_results") or "ensemble_accuracy" not in da:
        fail(f"domain_adaptation: {da}")
    t0 = time.perf_counter()
    check = _da_check(da_clf, da_split, seed)
    seconds["da_check"] = time.perf_counter() - t0
    res = {"seconds": seconds, "selected": sel["selected"],
           "generated_pass_rate": metrics["generated_pass_rate"],
           "users_scored": sorted(int(u) for u in ev), "lpips_diversity": lp,
           "da": {k: da[k] for k in ("baseline_accuracy", "best_accuracy", "best_config",
                                     "ncc_results", "ensemble_accuracy")}, "da_check": check}
    log(f"[scoring] select_users {seconds['select_users']:.2f} s (selected {sel['selected']}), "
        f"analyze_metrics {seconds['analyze_metrics']:.2f} s (pass rate "
        f"{metrics['generated_pass_rate']:.3f}), generation_evaluator "
        f"{seconds['generation_evaluator']:.2f} s, with LPIPS diversity "
        f"{seconds['generation_evaluator_lpips']:.2f} s (users {res['users_scored']}, LPIPS "
        f"{[round(v, 4) for v in lp]}) at 224² [{device_info['smi']}]")
    log(f"[scoring] domain_adaptation.main {DA_USERS} users × {DA_PER_USER} at 224², reference "
        f"grid limit 8, NCC, ensemble: {seconds['domain_adaptation']:.2f} s, baseline "
        f"{da['baseline_accuracy']:.4f}, best {da['best_accuracy']:.4f}, ensemble "
        f"{da['ensemble_accuracy']:.4f}; card vs CPU ({check['support']} support images, TF32 "
        f"off): target BN statistics {check['stat_rel_err']:.2e} (limit {DA_STAT_TOL}), "
        f"probabilities {check['prob_max_abs_err']:.2e} (limit {DA_PROB_TOL}); select_support "
        + ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in check["select_support"].items())
        + f" [{device_info['smi']}]")
    return res

# -- phases 31-32: the tools and the CLI ------------------------------------------

AUTOTUNE_N, AUTOTUNE_BATCH, AUTOTUNE_REF = 8, 8, 250  # --n, --batch, --ref_steps
TOOLS_DEPTH = 2  # phase 8's do_train: an XL/1-width DiT at depth 2
LEGACY_LATENTS = 40  # phase 32's legacy latent dump (N, 32, 16, 16), shards of 16


def _write_dit_state(path: str, model) -> None:
    """A DiT train-state file of ``model``'s weights (params = EMA), as the
    JAX package and the port write them."""
    tree = flatten(dit_state_to_jax(model.state_dict()))
    write_safetensors(path, {"step": np.asarray(0, np.int32),
                             **{f"params|{k}": v for k, v in tree.items()},
                             **{f"ema_params|{k}": v for k, v in tree.items()}})


def _autotune_calls(doc: dict, cfg: Config) -> int:
    """Model calls of an autotune run, by the samplers' evaluation rules:
    the reference and the fixed-grid methods per batch (euler N − 1, heun
    2(N − 1), Adams–Bashforth 3 and the fixed cache by ``_fixed_grid_calls``
    over the cond-only and CFG phases), the adaptive cache s + its
    ``cfg_evals`` per batch, the probe s + its ``cfg_evals``."""
    transport = build_transport(cfg)
    shift, start = cfg.sample.timestep_shift, cfg.sample.cfg_interval_start
    n_batches = doc["n_samples"] // AUTOTUNE_BATCH

    def calls(rec: dict) -> int:
        steps = rec["num_steps"] - 1
        s = split_idx(transport, rec["num_steps"], shift, start)
        name = {"euler": None, "heun": "heun", "ab": f"ab{rec.get('order')}",
                "vcache": f"cache_k{rec.get('k')}_o1"}[rec["kind"]]
        return steps if name is None else sum(_fixed_grid_calls(name, s, steps))

    total = n_batches * calls({"kind": "euler", "num_steps": AUTOTUNE_REF})
    total += split_idx(transport, AUTOTUNE_REF, shift, start) + doc["probe_cfg_evals"]
    for row in doc["methods"].values():
        rec = row["rec"]
        if rec["kind"] == "vcacheA":
            s = split_idx(transport, rec["num_steps"], shift, start)
            total += sum(s + e for e in row["cfg_evals"])
        else:
            total += n_batches * calls(rec)
    return total


def phase_autotune(seed: int, device_info: dict, work: str) -> dict:
    """Phase 31: ``autotune_sampler.main`` on XL/1 (full width, depth CUT_DEPTH,
    bf16, seeded random weights in a train-state file, the production
    ``sample:`` block) with the full ladder: the exact euler-250 reference,
    the noise-floor probe, euler 125/100/50, AB3 100/62, heun 83/62, the
    fixed cache k = 3, 6 and the adaptive cache at its three tolerances."""
    cfg, model = build_xl(seed)
    depth = model.depth
    ckpt = os.path.join(work, "xl_state.safetensors")
    _write_dit_state(ckpt, model)
    del model
    torch.cuda.empty_cache()
    cfg_path = os.path.join(work, "xl.json")
    with open(cfg_path, "w") as f:
        json.dump({**cfg, "ckpt_path": ckpt}, f)
    out_json, overlay = os.path.join(work, "autotune.json"), os.path.join(work, "overlay.yaml")
    reset_counts()
    t0 = time.perf_counter()
    rc = autotune_sampler.main(["--config", cfg_path, "--n", str(AUTOTUNE_N), "--batch",
                                str(AUTOTUNE_BATCH), "--ref_steps", str(AUTOTUNE_REF), "--out",
                                out_json, "--emit_yaml", overlay])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    with open(out_json) as f:
        doc = json.load(f)
    calls = _autotune_calls(doc, cfg)
    expect_counts(got, {"nat_attention_fwd": depth * calls}, "autotune_sampler")
    want = [label for label, _ in autotune_sampler.ladder(
        False, True, AUTOTUNE_REF, autotune_sampler.tolerance_candidates(doc["noise_floor"]))]
    if rc != 0 or list(doc["methods"]) != want or len(want) < 10:
        fail(f"autotune_sampler: rc {rc}, methods {list(doc['methods'])}, expected {want}")
    winner = doc["recommendation"]["winner"]
    rec = (doc["methods"][winner]["rec"] if winner in doc["methods"]
           else {"kind": "euler", "num_steps": AUTOTUNE_REF})
    block = {**autotune_sampler._method_config(rec),
             **{k: cfg.sample[k] for k in autotune_sampler.CARRIED if k in cfg.sample}}
    with open(overlay) as f:
        text = f.read()
    if doc["recommendation"]["sample_block"] != block or \
            not text.endswith(yaml_io.safe_dump({"sample": block})):
        fail(f"autotune_sampler: recommended {doc['recommendation']['sample_block']}, "
             f"expected {block}; overlay {text!r}")
    for label, row in doc["methods"].items():
        if not (np.isfinite(row["rel_l2_p99"]) and np.isfinite(row["latent_fid"])):
            fail(f"autotune_sampler: {label} has non-finite evidence {row}")
        log(f"[autotune] {label}: {row['seconds']:.2f} s, cost {row['cost']:.1f} "
            f"({row['cost_pct']:.1f}%), rel-L2 p99 {row['rel_l2_p99']:.5f}, latent FID "
            f"{row['latent_fid']:.4f}")
    log(f"[autotune] XL/1 autotune_sampler --n {AUTOTUNE_N} --batch {AUTOTUNE_BATCH} --ref_steps "
        f"{AUTOTUNE_REF}: {seconds:.1f} s, reference {doc['reference_seconds']:.2f} s, noise floor "
        f"{doc['noise_floor']}, {len(want)} methods, {calls} model calls ({got['nat_attention_fwd']} "
        f"nat_attention_fwd launches), winner {winner} [{device_info['smi']}]")
    return {"seconds": seconds, "model_calls": calls, "launches": got["nat_attention_fwd"],
            "noise_floor": doc["noise_floor"], "winner": winner,
            "reference_seconds": doc["reference_seconds"],
            "methods": {k: {key: v[key] for key in ("seconds", "cost", "cost_pct", "rel_l2_p50",
                                                    "rel_l2_p99", "latent_fid")}
                        for k, v in doc["methods"].items()},
            "ckpt": ckpt, "config": cfg_path}


def _cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "vavae_tpu_torch", *args],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)


def _tools_do_train(seed: int, work: str) -> dict:
    """Phase 8's ``do_train`` with ``train.async_checkpoint`` on and
    ``VAVAE_PROFILE`` set (steps 2-3 traced), every save also written in
    line beside it at the same moment, then a run with it off: the same
    checkpoint files byte for byte, one trace, the events file's CRCs."""
    rs = np.random.default_rng(seed)
    data = os.path.join(work, "latents")
    for i in range(2):
        lat = rs.standard_normal((24, 32, 16, 16)).astype(np.float32)
        write_safetensors(os.path.join(data, f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 1000, (24,)).astype(np.int32)})
    mirror = os.path.join(work, "mirror")
    real_save = ckpt_lib.AsyncCheckpointer.save

    # smoke-only: each async save is also written in line, at the same moment
    def mirrored(self, ckpt_dir, step, state, config=None, on_complete=None):
        ckpt_lib.save_checkpoint(os.path.join(mirror, os.path.basename(ckpt_dir)), step, state)
        return real_save(self, ckpt_dir, step, state, config, on_complete)

    prof = os.path.join(work, "prof")
    trees, seconds = {}, {}
    reset_counts()
    for mode in (True, False):
        out = os.path.join(work, f"out_{mode}")
        cfg = branch_config("production").merged_with({
            "data": {"data_path": data},
            "train": {"max_steps": 4, "global_batch_size": 8, "ckpt_every": 2, "log_every": 2,
                      "output_dir": out, "exp_name": "smoke", "async_checkpoint": mode}})
        os.environ.update(VAVAE_PROFILE=prof, VAVAE_PROFILE_AT="2", VAVAE_PROFILE_STEPS="2")
        ckpt_lib.AsyncCheckpointer.save = mirrored
        try:
            with variant_depth("XL", TOOLS_DEPTH):
                t0 = time.perf_counter()
                do_train(cfg, device="cuda")
                seconds[mode] = time.perf_counter() - t0
        finally:
            ckpt_lib.AsyncCheckpointer.save = real_save
            for k in ("VAVAE_PROFILE", "VAVAE_PROFILE_AT", "VAVAE_PROFILE_STEPS"):
                del os.environ[k]
        ckpts = os.path.join(out, "smoke", "checkpoints")
        trees[mode] = {n: open(os.path.join(ckpts, n), "rb").read()
                       for n in sorted(os.listdir(ckpts)) if n.endswith(".safetensors")}
        events = [os.path.join(out, "smoke", "tb", n)
                  for n in os.listdir(os.path.join(out, "smoke", "tb")) if n.startswith("events")]
        records = [len(read_events(e)) for e in events]  # each record's CRCs checked
        if len(events) != 1 or records[0] < 4:
            fail(f"do_train (async {mode}): events files {events} with {records} records")
    expect_counts(counts(), {"nat_attention_fwd": 2 * 4 * 2 * TOOLS_DEPTH,
                             "nat_attention_bwd": 2 * 4 * TOOLS_DEPTH}, "do_train async/sync")
    names = ["0000002.safetensors", "0000004.safetensors"]
    mirrored_files = {n: open(os.path.join(mirror, "checkpoints", n), "rb").read()
                      for n in names}
    if list(trees[True]) != names or trees[True] != mirrored_files:
        fail(f"do_train with async checkpoints: files {list(trees[True])} differ from the same "
             "states saved in line")
    if trees[True] != trees[False]:
        fail("do_train: the async run's checkpoints differ from the synchronous run's")
    traces = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
    if len(traces) != 2:  # one window a run
        fail(f"VAVAE_PROFILE: traces {traces}, expected one a run")
    size = os.path.getsize(os.path.join(prof, traces[0]))
    return {"async_s": seconds[True], "sync_s": seconds[False], "trace_bytes": size,
            "events_records": records[0], "checkpoint_bytes": sum(map(len, trees[True].values()))}


def _ab_route(seed: int) -> dict:
    """The production XL/1 (no qk-norm) under ``VAVAE_ATTN_NATURAL=0``: its
    forward at batch 16 and loss gradients against plain attention (with
    the launches of #3 and #6 held, phases 5-6's checks), and against the
    natural route."""
    cfg, model = build_xl(seed, "ab_route")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    B, s = 2 * BATCH, model.input_size
    x = torch.randn((B, s, s, model.in_channels), generator=gen, device="cuda")
    t = torch.rand((B,), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    transport = build_transport(cfg)
    g2 = torch.Generator(device="cuda").manual_seed(seed + 2)
    xg = torch.randn((B, s, s, model.in_channels), generator=g2, device="cuda")
    yg = torch.randint(0, cfg.data.num_classes, (B,), generator=g2, device="cuda")
    tg = transport.sample_t(B, g2)
    x0 = torch.randn((B, s, s, model.in_channels), generator=g2, device="cuda")
    drop = (torch.rand((B,), generator=g2, device="cuda") < 0.1).long()
    params = list(model.parameters())

    def run():
        with torch.no_grad():
            out = model(x, t, y).float()
        grads = torch.autograd.grad(_training_loss(model, transport, xg, yg, tg, x0, drop), params)
        return out, torch.cat([g.float().flatten() for g in grads])

    os.environ["VAVAE_ATTN_NATURAL"] = "0"
    try:
        res = {"kernel_on_path": phase_kernel_on_path(model, seed, "ab_route"),
               "train_path": phase_train_path(cfg, model, seed, "ab_route")}
        reset_counts()
        out_ab, grad_ab = run()
        expect_counts(counts(), {"attn_small_fwd_rope": 3 * model.depth,
                                 "attn_small_bwd": model.depth}, "VAVAE_ATTN_NATURAL=0")
    finally:
        del os.environ["VAVAE_ATTN_NATURAL"]
    reset_counts()
    out_nat, grad_nat = run()
    expect_counts(counts(), {"nat_attention_fwd": 3 * model.depth,
                             "nat_attention_bwd": model.depth}, "the natural route")
    rel = ((out_ab - out_nat).norm() / out_nat.norm()).item()
    rel_grad = ((grad_ab - grad_nat).norm() / grad_nat.norm()).item()
    if not (rel <= PATH_TOL and rel_grad <= PATH_TOL):
        fail(f"VAVAE_ATTN_NATURAL=0 vs the natural route: forward {rel}, gradients {rel_grad} "
             f"(limit {PATH_TOL})")
    del model
    torch.cuda.empty_cache()
    res.update(rel_err_vs_natural=rel, grad_rel_err_vs_natural=rel_grad)
    log(f"[tools] VAVAE_ATTN_NATURAL=0 XL/1 B={B}: vs plain attention forward "
        f"{res['kernel_on_path']['rel_err']:.3e}, gradients {res['train_path']['rel_err']:.3e}; "
        f"vs the natural route forward {rel:.3e}, gradients {rel_grad:.3e}; {CUT_DEPTH} "
        f"attn_small_fwd_rope a forward, {CUT_DEPTH} attn_small_bwd a backward")
    return res


def phase_tools(seed: int, device_info: dict, work: str, autotune: dict, keep: str) -> dict:
    """Phase 32: the dispatcher, ``preflight``, both exports, the split,
    ``validate_export``, ``convert_latents``, async checkpoints with a
    profiler window, and the ``VAVAE_ATTN_NATURAL=0`` route."""
    res, t0 = {}, time.perf_counter()
    listed, unknown = _cli("--help"), _cli("no_such_command")
    if listed.returncode != 0 or "autotune_sampler" not in listed.stdout or unknown.returncode != 2:
        fail(f"python -m vavae_tpu_torch: --help rc {listed.returncode}, unknown command rc "
             f"{unknown.returncode}\n{listed.stdout}{listed.stderr}{unknown.stderr}")
    res["cli_s"] = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    try:
        preflight.main(["--config", autotune["config"]])
    except SystemExit as e:
        fail(f"preflight on the XL/1 config exited {e.code}")
    res["preflight_s"] = time.perf_counter() - t0
    expect_counts(counts(), {"nat_attention_fwd": CUT_DEPTH}, "preflight's forward")

    # the DiT's export, reloaded by the port's loader: the same forward bit for bit
    cfg = load_config(autotune["config"])
    pt = os.path.join(work, "xl_export.pt")
    t0 = time.perf_counter()
    export_torch.main(["--kind", "dit", "--config", autotune["config"], "--ckpt",
                       autotune["ckpt"], "--out", pt])
    res["export_dit_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    x = torch.randn((2 * BATCH, 16, 16, 32), generator=gen, device="cuda")
    t = torch.rand((2 * BATCH,), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (2 * BATCH,), generator=gen, device="cuda")
    outs = []
    for path in (autotune["ckpt"], pt):
        model = create_dit(cfg.model, 16, cfg.data.num_classes, device="cuda").eval()
        load_dit_params(model, path)
        with torch.no_grad():
            outs.append(model(x, t, y))
        del model
    torch.cuda.empty_cache()
    if not torch.equal(outs[0], outs[1]):
        fail("the XL/1 forward from the exported .pt differs from the checkpoint's")

    # phase 24's VA-VAE state exported, loaded by VA_VAE: the same decode bit for bit
    vae_state = os.path.join(keep, "vae_state.safetensors")
    vae_ckpt = os.path.join(work, "vae_export.ckpt")
    export_torch.main(["--kind", "vae", "--ckpt", vae_state, "--out", vae_ckpt])
    exported = VA_VAE(embed_dim=32, ckpt_path=vae_ckpt, device="cuda")
    direct = VA_VAE(embed_dim=32, device="cuda")
    prefix = "gen_params|vae|"
    direct.model.load_state_dict(vae_state_from_jax(unflatten(
        {k[len(prefix):]: v for k, v in ckpt_lib.read_state_file(vae_state).items()
         if k.startswith(prefix)})), strict=True)
    z = torch.randn((4, 16, 16, 32), generator=gen, device="cuda")
    if not torch.equal(exported.decode(z), direct.decode(z)):
        fail("the VA-VAE decode from the exported .ckpt differs from the train state's")
    del direct

    # phase 26's users: the split, then validate_export with VF alignment
    users, split = os.path.join(work, "users"), os.path.join(work, "split.json")
    write_user_folder(users, seed)
    prepare_dataset_split.main(["--data_root", users, "--output", split])
    enc, rep = os.path.join(work, "encoder.msgpack"), os.path.join(work, "report.json")
    reset_counts()
    t0 = time.perf_counter()
    report = validate_export.main([
        "--split_file", split, "--vae_ckpt", vae_ckpt, "--num_users", str(CLF_USERS),
        "--train_ckpt", vae_state, "--train_config", os.path.join(keep, "vae_config.yaml"),
        "--vf_kind", "dinov2", "--allow_random_foundation", "--export_encoder", enc,
        "--out", rep])
    res["validate_s"] = time.perf_counter() - t0
    expect_counts(counts(), {}, "validate_export")
    recon, vf = report["per_user_reconstruction"], report["vf_alignment"]
    tree = read_msgpack(enc)
    want_tree = vae_state_to_jax(exported.model.state_dict())
    if (len(recon) != CLF_USERS or not all(np.isfinite(r["psnr"]) for r in recon.values())
            or not -1 <= vf["min_cosine"] <= vf["mean_cosine"] <= 1
            or set(tree) != {"encoder", "quant_conv"}
            or not np.array_equal(tree["encoder"]["conv_in"]["kernel"],
                                  want_tree["encoder"]["conv_in"]["kernel"])):
        fail(f"validate_export: {len(recon)} users, VF {vf}, encoder keys {set(tree)}")
    del exported
    torch.cuda.empty_cache()
    res.update(users=len(recon), mean_psnr=float(np.mean([r["psnr"] for r in recon.values()])),
               vf_mean_cosine=vf["mean_cosine"],
               between_within=report["latent_user_discrimination"]["between_within_ratio"])

    # a seeded legacy latent dump through convert_latents, read back by the dataset
    legacy, conv_out = os.path.join(work, "legacy"), os.path.join(work, "converted")
    os.makedirs(legacy)
    cpu = torch.Generator().manual_seed(seed + 61)
    torch.save({"latents": torch.randn((LEGACY_LATENTS, 32, 16, 16), generator=cpu),
                "user_ids": [i % CLF_USERS for i in range(LEGACY_LATENTS)]},
               os.path.join(legacy, "train_latents.pt"))
    convert_latents.main(["--input_dir", legacy, "--output_dir", conv_out, "--splits", "train",
                          "--shard_size", "16", "--use_labels"])
    ds = ImgLatentDataset(os.path.join(conv_out, "train"), latent_norm=True)
    xb, yb = next(ds.batches(8, shuffle=False, epochs=1))
    if len(ds) != LEGACY_LATENTS or xb.shape != (8, 16, 16, 32) or list(yb) != list(range(8)) \
            or not np.isfinite(xb).all():
        fail(f"convert_latents: {len(ds)} latents, batch {xb.shape}, labels {list(yb)}")

    res["do_train"] = _tools_do_train(seed, work)
    res["ab_route"] = _ab_route(seed)
    d = res["do_train"]
    log(f"[tools] dispatcher {res['cli_s']:.1f} s; preflight {res['preflight_s']:.1f} s ({CUT_DEPTH} "
        f"nat_attention_fwd); export_torch --kind dit {res['export_dit_s']:.1f} s, forward "
        f"bit-equal; --kind vae decode bit-equal; validate_export {res['validate_s']:.1f} s "
        f"({res['users']} users, mean PSNR {res['mean_psnr']:.2f}, VF mean cosine "
        f"{res['vf_mean_cosine']:.4f}); convert_latents {LEGACY_LATENTS} latents; do_train "
        f"async {d['async_s']:.1f} s vs in line {d['sync_s']:.1f} s, files byte-equal, a trace "
        f"of {d['trace_bytes']} bytes, {d['events_records']} event records [{device_info['smi']}]")
    return res


def run_tools(seed: int, device_info: dict, keep: str) -> dict:
    """Phases 31-32, XL/1 cut to CUT_DEPTH (phase 32 reads phase 31's
    checkpoint)."""
    with variant_depth("XL", CUT_DEPTH):
        return _run_tools(seed, device_info, keep)


def _run_tools(seed: int, device_info: dict, keep: str) -> dict:
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        out = {"autotune": phase_autotune(seed, device_info, work)}
        t1 = time.perf_counter()
        out["tools"] = phase_tools(seed, device_info, work, out["autotune"], keep)
        out["tools"]["phase_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[tools] phases 31-32: {out['seconds']:.1f} s (32: {out['tools']['phase_s']:.1f} s)")
    return out


# -- phase 33: the multi-device paths ------------------------------------------------------

DIST_DEPTH = 4          # (b)'s XL/1-width DiT
DIST_BATCH = 32         # (b)'s global batch: 16 a rank at world 2
DIST_STEPS = 2
DIST_WAIT_S = 600       # each launch's limit
# (b): world 2 over gloo against world 1, relative differences (bf16 model):
# the losses of both steps, and the parameters after them (Frobenius over
# all), and the gradient's global norm at both steps (an all-reduce that
# sums where it should average doubles it; Adam would hide that in the
# parameters). Measured on an H100 80GB HBM3 (700 W): losses 5.1e-6 to
# 1.1e-5, parameters 2.4e-5 (DP, FSDP) to 9.7e-5 (TP), gradient norms 2.4e-5
# (TP) to 9.2e-5 (DP, FSDP); the limits are about 5x those
DIST_LOSS_TOL = 5e-5
DIST_PARAM_TOL = 5e-4
DIST_NORM_TOL = 5e-4
DIST_LAYOUTS = {  # name -> ((data, fsdp, tensor), branch)
    "dp": ((2, 1, 1), "production"),
    "fsdp": ((1, 2, 1), "production"),
    "tp": ((1, 1, 2), "production"),
    "tp_qknorm": ((1, 1, 2), "qknorm"),
}
# (c): four gloo ranks on card 0, tensor = 4 at LightningDiT-1p6B/1's full
# width (1,792, 28 heads of 64, MLP 4,778: uneven rows) cut to depth 2, at
# (c)'s global batch, against one process; the limits are (b)'s
TP4_VARIANT, TP4_DEPTH, TP4_BATCH, TP4_TENSOR = "1p6B", 2, 8, 4
TP4_LAYOUTS = {"tp4": "production", "tp4_qknorm": "qknorm"}  # name -> branch
TP4_HEADS, TP4_ROWS = [7, 7, 7, 7], [1195, 1195, 1194, 1194]  # each rank's


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_start(case: str, world: int, work: str, backend: str) -> list:
    """Start ``world`` copies of this script running ``case``
    (``--dist-case``), joined through ``multihost_init``'s environment
    contract (torchrun's variables); ``backend`` gloo puts every rank on
    card 0."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), VAVAE_DIST_TIMEOUT="300",
                   LOCAL_RANK=str(0 if backend == "gloo" else rank),
                   CHIP_SMOKE_DIST_BACKEND=backend)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-case", case, "--dist-work", work],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _dist_wait(procs: list, case: str, work: str) -> list[dict]:
    """Each rank's result once every rank has exited (killed past
    DIST_WAIT_S); fails if one did not exit 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"phase 33 {case}: rank {rank} of {len(procs)} exited {p.returncode}:\n"
                 f"{out[-4000:]}")
    results = []
    for rank in range(len(procs)):
        with open(os.path.join(work, f"{case}_{rank}.json")) as f:
            results.append(json.load(f))
    return results


def _dist_worker(case: str, work: str) -> None:
    """A rank of a phase-33 world: join it, run ``case``, write the result."""
    import datetime

    import torch.distributed as torch_dist

    from vavae_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if os.environ.get("CHIP_SMOKE_DIST_BACKEND") == "gloo":
        # two ranks on one card: NCCL refuses that, gloo takes CUDA tensors
        torch.cuda.set_device(0)
        torch_dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
            world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]),
            timeout=datetime.timedelta(seconds=300))
    mesh_lib.multihost_init("cuda")
    result = {"world": mesh_lib.process_count(), "rank": mesh_lib.process_index(),
              "backend": torch_dist.get_backend()}
    result.update({"entry": _dist_case_entry, "layouts": _dist_case_layouts,
                   "tensor4": _dist_case_tensor4}[case](work))
    with open(os.path.join(work, f"{case}_{mesh_lib.process_index()}.json"), "w") as f:
        json.dump(result, f)
    mesh_lib.barrier()
    mesh_lib.shutdown()


def _entry_config(work: str, out: str, parallel: dict | None = None) -> Config:
    """Phase 8's ``do_train`` setup: 4 steps at batch 8, a checkpoint every 2."""
    cfg = branch_config("production").merged_with({
        "data": {"data_path": os.path.join(work, "latents")},
        "train": {"max_steps": 4, "global_batch_size": 8, "ckpt_every": 2, "log_every": 2,
                  "output_dir": os.path.join(work, out), "exp_name": "smoke"}})
    return cfg.merged_with({"parallel": parallel}) if parallel else cfg


def _entry_layouts(world: int) -> dict:
    """(a)'s ``parallel:`` blocks: the data, fsdp and tensor axes each
    spanning the world; at world 1 every axis has size 1, so the three are
    one mesh and one run."""
    layouts = {"dp": {"data": -1}, "fsdp": {"fsdp": world}, "tp": {"tensor": world}}
    return layouts if world > 1 else {"dp": layouts["dp"]}


def _dist_case_entry(work: str) -> dict:
    """(a), a rank at world = the card count over NCCL: ``do_train`` under
    each of ``_entry_layouts``, then one rank-striped sampling call; XL/1
    width at depth 2 throughout."""
    from vavae_tpu_torch.parallel import mesh as mesh_lib

    world, fwd, bwd, depth = mesh_lib.process_count(), "nat_attention_fwd", "nat_attention_bwd", 2
    out = {}
    for name, par in _entry_layouts(world).items():
        with variant_depth("XL", depth):
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = do_train(_entry_config(work, name, par), device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        got = counts()
        expect_counts(got, {fwd: 4 * 2 * depth, bwd: 4 * depth}, f"do_train {name}")
        out[name] = {"step": state.step, "seconds": seconds, "launches": [got[fwd], got[bwd]],
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del state
        torch.cuda.empty_cache()
    cfg = Config(PRODUCTION).merged_with({
        "ckpt_path": os.path.join(work, "xl.safetensors"),
        "sample_folder": os.path.join(work, "samples"), "data": {"latent_norm": False},
        "sample": {"num_sampling_steps": SAMPLER_STEPS, "fid_num": BATCH * world}})
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with variant_depth("XL", depth):
        folder = do_sample(cfg, device="cuda")
    got = counts()
    expect_counts(got, {fwd: depth * (SAMPLER_STEPS - 1)}, "rank-striped sampling")
    out["sample"] = {"seconds": time.perf_counter() - t0, "launches": got[fwd],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "names": sorted(os.listdir(folder))}
    return out


def _dist_batches(seed: int) -> list:
    rs = np.random.default_rng(seed + 33)
    return [(rs.standard_normal((DIST_BATCH, 16, 16, 32)).astype(np.float32),
             rs.integers(0, 1000, (DIST_BATCH,)).astype(np.int32)) for _ in range(DIST_STEPS)]


def _dist_trainer(branch: str, mesh=None, size: str = "XL", depth: int = DIST_DEPTH):
    """A ``size``/1-width DiT at ``depth`` (seeded random weights) and its
    production trainer, on ``mesh``."""
    cfg = branch_config(branch).merged_with({"model": {"model_type": f"LightningDiT-{size}/1"}})
    with variant_depth(size, depth):
        model = create_dit(cfg.model, 16, cfg.data.num_classes, device="cuda")
    randomize_(model, SEED)
    return build_trainer(cfg, model, steps_per_epoch=1, max_steps=DIST_STEPS, mesh=mesh)


def _tp4_batches(seed: int) -> list:
    rs = np.random.default_rng(seed + 34)
    return [(rs.standard_normal((TP4_BATCH, 16, 16, 32)).astype(np.float32),
             rs.integers(0, 1000, (TP4_BATCH,)).astype(np.int32)) for _ in range(DIST_STEPS)]


def _dist_case_tensor4(work: str) -> dict:
    """(c), a rank of four sharing the card over gloo: DIST_STEPS train steps
    of the 1p6B/1-width DiT under tensor = 4 (both attention branches), the
    launches of each step counted apart; the gathered parameters to a file."""
    from vavae_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for name, branch in TP4_LAYOUTS.items():
        mesh = mesh_lib.make_mesh(1, 1, TP4_TENSOR)
        trainer = _dist_trainer(branch, mesh, TP4_VARIANT, TP4_DEPTH)
        state = trainer.distribute(trainer.init_state())
        fwd, bwd = BRANCHES[branch]["fwd"], BRANCHES[branch]["bwd"]
        losses, norms, ms, launches = [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        for x, y in _tp4_batches(SEED):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.train_step(state, mesh_lib.shard_batch(mesh, (x, y)))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
            got = counts()
            expect_counts(got, {fwd: 2 * TP4_DEPTH, bwd: TP4_DEPTH}, f"(c) {name} step")
            launches.append([got[fwd], got[bwd]])
        full = state.gathered()
        if mesh_lib.process_index() == 0:
            torch.save([p.detach().float().cpu() for p in full.params],
                       os.path.join(work, f"{name}_params.pt"))
        block = trainer.model.blocks[0]
        out[name] = {"losses": losses, "grad_norms": norms, "ms_per_step": ms,
                     "launches_per_step": launches, "local_heads": block.attn.num_heads,
                     "mlp_rows": block.mlp.w3.weight.shape[1],
                     "qkv_rows": block.attn.qkv.weight.shape[0],
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del trainer, state, full
        torch.cuda.empty_cache()
    return out


def _dist_case_layouts(work: str) -> dict:
    """(b), a rank of two sharing the card over gloo: DIST_STEPS train steps
    under DP, FSDP and tensor parallelism (both attention branches) on its
    rows of the global batches; the gathered parameters to a file."""
    from vavae_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for name, (shape, branch) in DIST_LAYOUTS.items():
        mesh = mesh_lib.make_mesh(*shape)
        trainer = _dist_trainer(branch, mesh)
        state = trainer.distribute(trainer.init_state())
        fwd, bwd = BRANCHES[branch]["fwd"], BRANCHES[branch]["bwd"]
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms = [], [], []
        for x, y in _dist_batches(SEED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.train_step(state, mesh_lib.shard_batch(mesh, (x, y)))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        expect_counts(got, {fwd: DIST_STEPS * 2 * DIST_DEPTH, bwd: DIST_STEPS * DIST_DEPTH},
                      f"{name} train steps")
        full = state.gathered()
        if mesh_lib.process_index() == 0:
            torch.save([p.detach().float().cpu() for p in full.params],
                       os.path.join(work, f"{name}_params.pt"))
        out[name] = {"losses": losses, "grad_norms": norms, "ms_per_step": ms,
                     "launches": [got[fwd], got[bwd]], "local_heads":
                     trainer.model.blocks[0].attn.num_heads,
                     "rank_batch": mesh_lib.shard_batch(mesh, _dist_batches(SEED)[0])[0].shape[0],
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del trainer, state, full
        torch.cuda.empty_cache()
    return out


def run_multidevice(seed: int, device_info: dict, with_b: bool = True) -> dict:
    """Phase 33: the multi-device paths. (a) A world of
    ``torch.cuda.device_count()`` processes over NCCL (torchrun's
    variables): ``do_train`` on phase 8's setup with the data, fsdp and
    tensor axes each spanning the world, every checkpoint bit-equal to one
    process's ``do_train`` (at world 1 the three axes have size 1, so one
    run covers them: the data-parallel path, NCCL, the mesh, the
    rank-striped loader and the rank-0 writes), and one rank-striped euler split-CFG sampling call, all
    at XL/1 width cut to depth 2. (b) Two ranks sharing the card over gloo, each on its rows of
    batch-32 global batches: an XL/1-width DiT at depth 4, DIST_STEPS steps
    under DP, FSDP = 2, tensor = 2 and tensor = 2 with QK-norm (#1/#2 and
    #3/#6 on 8 local heads of 72), against one process at batch 32 (the
    losses, the gradient norms and the parameters). (c) Four ranks sharing
    the card over gloo: a LightningDiT-1p6B/1-width DiT (1,792, 28 heads,
    MLP 4,778) at depth 2, DIST_STEPS steps at batch 8 under tensor = 4 and
    tensor = 4 with QK-norm (#1/#2 and #3/#6 on 7 local heads of 64, MLP
    rows 1,195, 1,195, 1,194, 1,194; every step's launches exact), against
    one process, to (b)'s limits. (a)'s, (b)'s and (c)'s ranks and this
    process's references run side by side, so their times include each
    other's load. On a machine of several cards (a) runs a world of each
    card; its checkpoints are then held to DIST_PARAM_TOL, and
    ``with_b=False`` leaves (b) and (c) out."""
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    procs, procs_b, procs_c = [], [], []
    try:
        rs = np.random.default_rng(seed)
        for i in range(2):
            lat = rs.standard_normal((24, 32, 16, 16)).astype(np.float32)
            write_safetensors(os.path.join(work, "latents", f"shard_{i:03d}.safetensors"), {
                "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
                "labels": rs.integers(0, 1000, (24,)).astype(np.int32)})
        with variant_depth("XL", 2):
            _, model = build_xl(seed)
        write_safetensors(os.path.join(work, "xl.safetensors"),
                          flatten(dit_state_to_jax(model.state_dict()), "params"))
        del model
        # (a)'s and (b)'s ranks start together (importing this script takes
        # seconds, and (b)'s collective-bound steps need little of the card)
        # while this process runs the world-1 references of both
        t0 = time.perf_counter()
        procs = _dist_start("entry", world, work, "nccl")
        procs_b = _dist_start("layouts", 2, work, "gloo") if with_b else []
        procs_c = _dist_start("tensor4", TP4_TENSOR, work, "gloo") if with_b else []
        with variant_depth("XL", 2):
            do_train(_entry_config(work, "single"), device="cuda")
        ref, ref_c = {}, {}
        for branch in ("production", "qknorm"):
            for refs, args, batches in ((ref, (), _dist_batches(seed)),
                                        (ref_c, (None, TP4_VARIANT, TP4_DEPTH),
                                         _tp4_batches(seed))):
                trainer = _dist_trainer(branch, *args)
                state = trainer.init_state()
                metrics = [trainer.train_step(state, b) for b in batches]
                refs[branch] = ([m["loss"].item() for m in metrics],
                                [m["grad_norm"].item() for m in metrics],
                                [p.detach().float().cpu() for p in state.params])
                del trainer, state
        torch.cuda.empty_cache()
        entry = _dist_wait(procs, "entry", work)
        entry_s = time.perf_counter() - t0
        single = os.path.join(work, "single", "smoke", "checkpoints")
        rel_a = {}
        for name in _entry_layouts(world):
            ckpts = os.path.join(work, name, "smoke", "checkpoints")
            for f in ("0000002.safetensors", "0000004.safetensors"):
                a, b = os.path.join(single, f), os.path.join(ckpts, f)
                if world == 1:  # one rank's all-reduce is a copy: bit-equal
                    with open(a, "rb") as fa, open(b, "rb") as fb:
                        if fa.read() != fb.read():
                            fail(f"phase 33 (a): {name} do_train's {f} differs from one "
                                 "process's")
                    continue
                want, got = read_safetensors(a)[0], read_safetensors(b)[0]
                keys = [k for k in want if k.startswith(("params|", "ema_params|"))]
                rel_a[f"{name} {f}"] = _frob([torch.from_numpy(got[k]) for k in keys],
                                             [torch.from_numpy(want[k]) for k in keys])
                if not rel_a[f"{name} {f}"] <= DIST_PARAM_TOL:
                    fail(f"phase 33 (a): {name} do_train's {f} is {rel_a[f'{name} {f}']:.3e} "
                         f"from one process's (limit {DIST_PARAM_TOL})")
        names = entry[0]["sample"]["names"]
        if names != [f"{i:06d}.png" for i in range(BATCH * world)]:
            fail(f"phase 33 (a): sample names {names}")
        for r in entry:
            log(f"[dist] (a) rank {r['rank']}/{r['world']} {r['backend']}: do_train "
                + ", ".join(f"{n} {r[n]['seconds']:.1f} s launches {r[n]['launches']} peak "
                            f"{r[n]['peak_bytes'] / 2**30:.2f} GiB" for n in _entry_layouts(world))
                + f"; sampling XL/1 width depth 2 euler-{SAMPLER_STEPS} batch {BATCH}: "
                f"{r['sample']['seconds']:.1f} s, {r['sample']['launches']} launches, peak "
                f"{r['sample']['peak_bytes'] / 2**30:.2f} GiB [{device_info['smi']}]")
        same = ("bit-equal to one process's" if world == 1 else "params and EMA within "
                + ", ".join(f"{k}: {v:.3e}" for k, v in rel_a.items()) + " of one process's")
        log(f"[dist] (a) world {world}: {'/'.join(_entry_layouts(world))} do_train checkpoints "
            f"{same}; sample names "
            f"{names[0]}..{names[-1]}; {entry_s:.1f} s")
        result = {"world_a": world, "entry": entry, "entry_s": entry_s, "rel_a": rel_a}
        if not with_b:
            result["seconds"] = time.perf_counter() - t_phase
            return result

        ranks = _dist_wait(procs_b, "layouts", work)
        layouts_s = time.perf_counter() - t0
        result.update({"layouts": ranks, "layouts_s": layouts_s, "rel": {}})
        for name, (shape, branch) in DIST_LAYOUTS.items():
            r0, r1 = (r[name] for r in ranks)
            if r0["losses"] != r1["losses"]:
                fail(f"phase 33 (b) {name}: the ranks' losses differ: {r0['losses']} {r1['losses']}")
            want_losses, want_norms, want_params = ref[branch]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want_losses))
            norm_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["grad_norms"], want_norms))
            params = torch.load(os.path.join(work, f"{name}_params.pt"))
            param_rel = _frob(params, want_params)
            result["rel"][name] = {"loss": loss_rel, "grad_norm": norm_rel, "params": param_rel}
            if not (loss_rel <= DIST_LOSS_TOL and norm_rel <= DIST_NORM_TOL
                    and param_rel <= DIST_PARAM_TOL):
                fail(f"phase 33 (b) {name}: loss rel {loss_rel:.3e} (limit {DIST_LOSS_TOL}), "
                     f"grad norm rel {norm_rel:.3e} (limit {DIST_NORM_TOL}), "
                     f"params rel {param_rel:.3e} (limit {DIST_PARAM_TOL})")
            heads = 16 // shape[2]
            if r0["local_heads"] != heads:
                fail(f"phase 33 (b) {name}: {r0['local_heads']} local heads, expected {heads}")
            log(f"[dist] (b) {name} {shape} gloo world 2 ({branch}, {r0['local_heads']} local "
                f"heads of 72, rank batch {r0['rank_batch']}): loss rel {loss_rel:.3e}, grad norm "
                f"rel {norm_rel:.3e}, params rel {param_rel:.3e} against world 1 at batch "
                f"{DIST_BATCH}; ms/step "
                + " | ".join(f"rank {i}: " + ", ".join(f"{t:.0f}" for t in r[name]['ms_per_step'])
                             + f" peak {r[name]['peak_bytes'] / 2**30:.2f} GiB launches "
                             f"{r[name]['launches']}" for i, r in enumerate(ranks))
                + f" [{device_info['smi']}]")

        ranks = _dist_wait(procs_c, "tensor4", work)
        tensor4_s = time.perf_counter() - t0
        result.update({"tensor4": ranks, "tensor4_s": tensor4_s, "rel_c": {}})
        for name, branch in TP4_LAYOUTS.items():
            rs = [r[name] for r in ranks]
            if any(r["losses"] != rs[0]["losses"] for r in rs):
                fail(f"phase 33 (c) {name}: the ranks' losses differ: {[r['losses'] for r in rs]}")
            heads, rows = [r["local_heads"] for r in rs], [r["mlp_rows"] for r in rs]
            if heads != TP4_HEADS or rows != TP4_ROWS or any(
                    r["qkv_rows"] != 3 * 64 * h for r, h in zip(rs, heads)):
                fail(f"phase 33 (c) {name}: local heads {heads}, MLP rows {rows}, qkv rows "
                     f"{[r['qkv_rows'] for r in rs]}; expected {TP4_HEADS}, {TP4_ROWS}")
            want_losses, want_norms, want_params = ref_c[branch]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], want_losses))
            norm_rel = max(abs(a - b) / abs(b) for a, b in zip(rs[0]["grad_norms"], want_norms))
            param_rel = _frob(torch.load(os.path.join(work, f"{name}_params.pt")), want_params)
            result["rel_c"][name] = {"loss": loss_rel, "grad_norm": norm_rel, "params": param_rel}
            if not (loss_rel <= DIST_LOSS_TOL and norm_rel <= DIST_NORM_TOL
                    and param_rel <= DIST_PARAM_TOL):
                fail(f"phase 33 (c) {name}: loss rel {loss_rel:.3e} (limit {DIST_LOSS_TOL}), "
                     f"grad norm rel {norm_rel:.3e} (limit {DIST_NORM_TOL}), "
                     f"params rel {param_rel:.3e} (limit {DIST_PARAM_TOL})")
            fwd, bwd = BRANCHES[branch]["fwd"], BRANCHES[branch]["bwd"]
            log(f"[dist] (c) {name} gloo world {TP4_TENSOR} ({branch}, LightningDiT-{TP4_VARIANT}/1 "
                f"width, depth {TP4_DEPTH}, batch {TP4_BATCH}): local heads of 64 {heads}, MLP "
                f"rows {rows}; loss rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e}, params rel "
                f"{param_rel:.3e} against world 1; {fwd}/{bwd} launches per step "
                + " | ".join(f"rank {i}: {r['launches_per_step']}, ms/step "
                             + ", ".join(f"{t:.0f}" for t in r["ms_per_step"])
                             + f", peak {r['peak_bytes'] / 2**30:.2f} GiB"
                             for i, r in enumerate(rs))
                + f" [{device_info['smi']}]")
    finally:
        for p in procs + procs_b + procs_c:  # a failure leaves no rank running
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(work, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[dist] phase 33: {result['seconds']:.1f} s ((a) done after {entry_s:.1f} s, (b) "
        f"after {layouts_s:.1f} s, (c) after {tensor4_s:.1f} s, side by side)")
    return result


def _kernel_entry(name: str, source: str, replaces: str, launches: int, summary: dict) -> dict:
    row = summary["rows"][0]  # the main path's shape (B=16 forward, B=32 backward, B=4 long)
    return {"name": name, "route": "cuda", "source": f"vavae_tpu_torch/ops/csrc/{source}",
            "replaces": f"vavae_tpu/ops/pallas/flash_attention.py:{replaces}",
            "launches": launches, "max_abs_err": summary["worst_err"], "ms": row["ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"]}


# -- phase 34: the data and I/O modules --------------------------------------------------

JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
RATE_FIXTURE = "photo_420_q90.jpg"   # 500×375 4:2:0, the decode rates' file
# the same photograph arithmetic-coded (SOF9) and lossless (SOF3)
RATE_FORMATS = {"sof9": "arith_photo_420_q90.jpg", "sof3": "lossless_photo.jpg"}
PNG_FIXTURES = os.path.join(os.path.dirname(JPEG_FIXTURES), "png")
# the shard kinds the JAX package reads beside F32 latents with flips and
# integer labels: latent dtype, flips, label dtype
SHARD_KINDS = {"F16": (np.float16, True, np.int64), "F64": (np.float64, True, np.int64),
               "I32": (np.int32, True, np.int64), "BOOL": (np.bool_, True, np.int64),
               "no_flip": (np.float32, False, np.int64),
               "labels_F32": (np.float32, True, np.float32),
               "labels_I16": (np.float32, True, np.int16), "labels_U8": (np.float32, True, np.uint8)}
IMAGENET_VAE_BATCH, IMAGENET_VAE_STEPS = 8, 2
IO_EXTRACT_BATCH, IO_EXTRACT_SHARD = 32, 64
IO_TRAIN_DEPTH, IO_TRAIN_STEPS = 2, 2
IO_SAMPLE_DEPTH, IO_SAMPLE_NUM = 2, 16
IO_READER_ROWS, IO_READER_BATCH = 2048, 1024  # the production global batch
IO_AB_STEPS, IO_AB_WINDOW = 6, 3  # do_train's A/B: steps/s over the last window
IO_WRITER_IMAGES = 64
IO_DECODE_N, IO_POOL = 64, 8


def write_imagenet_tree(root: str) -> dict:
    """The ImageNet-layout tree of ``tests/data/jpeg/manifest.json`` under
    ``root`` (the committed fixtures copied to ``data/<synset>/*.JPEG``);
    returns the manifest."""
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for t in manifest["tree"]:
        dst = os.path.join(root, t["path"])
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy(os.path.join(JPEG_FIXTURES, t["file"]), dst)
    return manifest


def phase_imagenet_vae(trainer, state, root: str, device_info: dict) -> dict:
    """Phase 34's VA-VAE part, on phase 23's trainer (no second ViT-L):
    ``train_epochs`` over the first IMAGENET_VAE_BATCH × IMAGENET_VAE_STEPS
    items of ``ImageNetTrain`` at 256² (the port's JPEG decoder, BILINEAR,
    random crops), one epoch of IMAGENET_VAE_STEPS steps."""
    random.seed(0)
    ds = ImageNetTrain(root, size=256)
    ds.items = ds.items[:IMAGENET_VAE_BATCH * IMAGENET_VAE_STEPS]
    metrics = []

    class Recording:  # smoke-only: the trainer with each step's losses kept
        def __getattr__(self, name):
            return getattr(trainer, name)

        def train_step(self, st, images):
            m = trainer.train_step(st, images)
            metrics.append({k: float(v) for k, v in m.items()})
            return m

    step0 = state.step
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_imagenet_vae_")
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, preempted = train_vavae.train_epochs(
            Recording(), state, ds, epochs=1, batch_size=IMAGENET_VAE_BATCH,
            logger=logging.getLogger("chip_smoke"), ckpt_dir=ckpt, log_every=1, seed=0,
            async_ckpt=False, log_images_every=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    expect_counts(counts(), {}, "VA-VAE train_epochs over ImageNetTrain")
    if preempted or state.step - step0 != IMAGENET_VAE_STEPS or len(metrics) != IMAGENET_VAE_STEPS:
        fail(f"train_epochs over ImageNetTrain: {state.step - step0} steps, {len(metrics)} "
             f"recorded, preempted {preempted}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail(f"train_epochs over ImageNetTrain: non-finite metrics {metrics}")
    losses = ", ".join(f"{m['rec_loss']:.4f}" for m in metrics)
    log(f"[imagenet] VA-VAE train_epochs over ImageNetTrain (256², batch {IMAGENET_VAE_BATCH}): "
        f"{IMAGENET_VAE_STEPS} steps in {seconds:.2f} s (epoch checkpoint included), rec_loss "
        f"{losses} [{device_info['smi']}]")
    return {"steps": IMAGENET_VAE_STEPS, "seconds": seconds, "metrics": metrics}


def _check_fixtures(manifest: dict) -> int:
    """Every committed fixture through ``read_image_rgb`` (the port's JPEG
    decoder; the PNG under a ``.JPEG`` name through ``read_png``) against
    PIL's committed decode: bit-equal, or the decode's SHA-256."""
    for entry in manifest["fixtures"]:
        got = read_image_rgb(os.path.join(JPEG_FIXTURES, entry["file"]))
        if list(got.shape) != entry["shape"]:
            fail(f"{entry['file']}: decoded {got.shape}, PIL's is {entry['shape']}")
        if "decode" in entry:
            want = read_png(os.path.join(JPEG_FIXTURES, entry["decode"]))
            if not np.array_equal(got, want):
                fail(f"{entry['file']}: decode differs from PIL's at "
                     f"{int((got != want).any(axis=2).sum())} pixels")
        elif hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() != \
                entry["decode_sha256"]:
            fail(f"{entry['file']}: decode's SHA-256 differs from PIL's")
    return len(manifest["fixtures"])


def _check_png_fixtures() -> int:
    """Every committed PNG fixture (each colour type and depth, plain and
    Adam7) through ``read_png`` and ``read_image_rgb`` against PIL's
    committed ``convert("RGB")``."""
    want = np.load(os.path.join(PNG_FIXTURES, "expected.npz"))
    for name in want.files:
        path = os.path.join(PNG_FIXTURES, name)
        for got in (read_png(path), read_image_rgb(path)):
            if not np.array_equal(got, want[name]):
                fail(f"{name}: the PNG reader's decode differs from PIL's")
    return len(want.files)


def _check_shard_kinds(work: str, seed: int) -> int:
    """Shards of each SHARD_KINDS kind (the f16d32 latent shape, two shards
    of IO_READER_BATCH + 37 rows in all): ``batches`` at IO_READER_BATCH
    with and without the latent norm, bit-equal to ``reference_batch``."""
    rs = np.random.default_rng(seed)
    for kind, (lat_dtype, flips, label_dtype) in SHARD_KINDS.items():
        folder = os.path.join(work, f"kind_{kind}")
        for i, rows in enumerate((IO_READER_BATCH // 2, IO_READER_BATCH // 2 + 37)):
            lat = 3.0 * rs.standard_normal((rows, 32, 16, 16)) + 1.0
            lat = (lat > 1.0) if lat_dtype is np.bool_ else 8.0 * lat if kind == "I32" else lat
            lat = lat.astype(lat_dtype)
            labels = rs.integers(-100, 1000, rows) + (0.7 if kind == "labels_F32" else 0)
            tensors = {"latents": lat, "labels": labels.astype(label_dtype)}
            if flips:
                tensors["latents_flip"] = np.ascontiguousarray(lat[..., ::-1])
            write_safetensors(os.path.join(folder, f"shard_{i:03d}.safetensors"), tensors)
        # the stats cache extraction writes (F16 stats computed in float16 overflow)
        write_safetensors(os.path.join(folder, "latents_stats.safetensors"), {
            "mean": rs.standard_normal((1, 32, 1, 1)).astype(np.float32),
            "std": rs.uniform(0.5, 4.0, (1, 32, 1, 1)).astype(np.float32)})
        for norm in (True, False):
            ds = ImgLatentDataset(folder, latent_norm=norm, latent_multiplier=0.9)
            idxs, fl = next(ds.index_batches(IO_READER_BATCH, seed=seed))
            gx, gy = next(ds.batches(IO_READER_BATCH, seed=seed))
            wx, wy = ds.reference_batch(idxs, fl)
            if not (np.array_equal(gx, wx) and np.array_equal(gy, wy)):
                fail(f"shards of kind {kind} (latent_norm {norm}): the reader's batch of "
                     f"{IO_READER_BATCH} differs from reference_batch")
        shutil.rmtree(folder)
    return len(SHARD_KINDS)


def _check_validation_crops(root: str, manifest: dict) -> int:
    ds = ImageNetValidation(root, size=manifest["crop_size"])
    with open(os.path.join(root, "filelist.txt")) as f:
        if f.read() != manifest["filelist"]:
            fail("ImageNetValidation's filelist.txt differs from the JAX package's")
    want = np.load(os.path.join(JPEG_FIXTURES, "imagenet_val_crops.npz"))
    if [os.path.relpath(p, root) for p, _ in ds.items] != list(want["paths"]):
        fail("ImageNetValidation's items differ from the JAX package's")
    for i in range(len(ds)):
        x, y = ds[i]
        crop = want["crops"][want["fixture"][i]]
        if not np.array_equal(x, (crop / 127.5 - 1.0).astype(np.float32)) or y != want["labels"][i]:
            fail(f"ImageNetValidation item {i} ({ds.items[i][0]}) differs from the JAX package's")
    return len(ds)


def _rate(fn, n: int, rounds: int = 3) -> float:
    """Calls of ``fn`` a second (``n`` calls a round), the best of
    ``rounds`` rounds after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
    return n / best


def _python_batches(self, batch_size, **kw):  # smoke-only: the reference in do_train
    for idxs, flips in self.index_batches(batch_size, **kw):
        yield self.reference_batch(idxs, flips)


def _rate_shards(work: str) -> str:
    """IO_READER_ROWS seeded latents of the f16d32 shape in two shards."""
    shards = os.path.join(work, "rate_shards")
    rs = np.random.default_rng(0)
    half = IO_READER_ROWS // 2
    for i in range(2):
        lat = rs.standard_normal((half, 32, 16, 16)).astype(np.float32)
        write_safetensors(os.path.join(shards, f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 1000, (half,)).astype(np.int64)})
    return shards


def _host_rates(work: str, shards: str, tree: list, images: np.ndarray) -> dict:
    """The host side: decode images/s of the 500×375 4:2:0 fixture alone and
    on IO_POOL threads; files/s of ``extract``'s image check over ``tree``
    (``refused_images``, on 8 threads); the shard reader's batches of
    IO_READER_BATCH against the Python reference; the writer's PNGs of
    ``images`` on a pool and on one thread."""
    with open(os.path.join(JPEG_FIXTURES, RATE_FIXTURE), "rb") as f:
        data = f.read()
    out = {"decode_images_per_s": _rate(lambda: decode_jpeg(data), IO_DECODE_N)}
    with ThreadPoolExecutor(IO_POOL) as pool:
        out["decode_pool_images_per_s"] = _rate(
            lambda: list(pool.map(decode_jpeg, [data] * IO_DECODE_N)), 1) * IO_DECODE_N
    for key, name in RATE_FORMATS.items():  # the photograph as SOF9 and SOF3
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            coded = f.read()
        out[f"decode_{key}_images_per_s"] = _rate(lambda: decode_jpeg(coded), IO_DECODE_N)
        with ThreadPoolExecutor(IO_POOL) as pool:
            out[f"decode_{key}_pool_images_per_s"] = _rate(
                lambda: list(pool.map(decode_jpeg, [coded] * IO_DECODE_N)), 1) * IO_DECODE_N
    out["check_files_per_s"] = _rate(lambda: refused_images(tree), 1) * len(tree)

    per_epoch = IO_READER_ROWS // IO_READER_BATCH
    ds = ImgLatentDataset(shards)
    native = lambda: list(ds.batches(IO_READER_BATCH, epochs=1))  # noqa: E731
    python = lambda: list(_python_batches(ds, IO_READER_BATCH, epochs=1))  # noqa: E731
    out["reader_native_batches_per_s"] = _rate(native, 1) * per_epoch
    out["reader_python_batches_per_s"] = _rate(python, 1) * per_epoch

    batch = np.concatenate([images] * (IO_WRITER_IMAGES // len(images)))
    paths = [os.path.join(work, f"w{i:03d}.png") for i in range(len(batch))]
    out["writer_pool_images_per_s"] = _rate(lambda: write_pngs(batch, paths), 1) * len(batch)
    out["writer_one_thread_images_per_s"] = _rate(
        lambda: write_pngs(batch, paths, threads=1), 1) * len(batch)
    return out


def _train_reader_ab(shards: str, work: str) -> dict:
    """``do_train``'s steps/s (XL/1 width, depth IO_TRAIN_DEPTH, global batch
    IO_READER_BATCH, logging every IO_AB_WINDOW steps: the last window's
    rate) with the native reader and with the Python reference in its place,
    run native, Python, native, Python; #1 and #2 counted in each."""
    fwd, bwd = BRANCHES["production"]["fwd"], BRANCHES["production"]["bwd"]
    rates = {"native": [], "python": []}
    for i, name in enumerate(("native", "python") * 2):
        out_dir = os.path.join(work, f"ab{i}")
        cfg = branch_config("production").merged_with({
            "data": {"data_path": shards},
            "train": {"max_steps": IO_AB_STEPS, "global_batch_size": IO_READER_BATCH,
                      "ckpt_every": 10 ** 9, "log_every": IO_AB_WINDOW,
                      "output_dir": out_dir, "exp_name": "ab"}})
        with variant_depth("XL", IO_TRAIN_DEPTH), contextlib.ExitStack() as stack:
            if name == "python":
                stack.enter_context(_patched(ImgLatentDataset, "batches", _python_batches))
            reset_counts()
            state = do_train(cfg, device="cuda")
        expect_counts(counts(), {fwd: IO_AB_STEPS * 2 * IO_TRAIN_DEPTH,
                                 bwd: IO_AB_STEPS * IO_TRAIN_DEPTH},
                      f"do_train with the {name} reader")
        with open(os.path.join(out_dir, "ab", "tb", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        rates[name].append([r for r in logged if "train/steps_per_sec" in r][-1]
                           ["train/steps_per_sec"])
        del state
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return rates


def phase_imagenet(seed: int, device_info: dict, work: str, root: str, manifest: dict) -> dict:
    """Phase 34: the committed JPEG and PNG fixtures, the shard reader on
    each shard kind, ``ImageNetValidation``'s items,
    ``extract`` over the ImageNet tree, the native shard reader against the
    Python reference and ``do_train`` on its shards, ``do_train``'s steps/s
    with each reader, a ``pipelines.sample`` FID folder through the threaded
    PNG writer, and the host rates."""
    t_phase = time.perf_counter()
    out = {"fixtures": _check_fixtures(manifest), "png_fixtures": _check_png_fixtures(),
           "shard_kinds": _check_shard_kinds(work, seed),
           "validation_items": _check_validation_crops(root, manifest)}

    # extract over root/data at 256², the f16d32 VA-VAE at fp32
    folder = os.path.join(root, "data")
    items = list_image_folder(folder)
    vae = VA_VAE(embed_dim=32, img_size=256, seed=seed, device="cuda")
    vae.encode_moments(np.zeros((IO_EXTRACT_BATCH, 256, 256, 3), np.float32))  # cuDNN warm-up
    shards = os.path.join(work, "latents")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extract(folder, shards, vae, batch_size=IO_EXTRACT_BATCH, image_size=256,
            shard_size=IO_EXTRACT_SHARD, seed=seed)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    expect_counts(counts(), {}, "extraction over the ImageNet tree")
    del vae
    torch.cuda.empty_cache()
    rows, labels = 0, []
    for name in sorted(os.listdir(shards)):
        if name.startswith("latents_rank"):
            t = read_safetensors(os.path.join(shards, name))[0]
            if not np.isfinite(t["latents"]).all() or t["latents"].shape[1:] != (32, 16, 16):
                fail(f"{name}: latents {t['latents'].shape}, finite {np.isfinite(t['latents']).all()}")
            rows += len(t["labels"])
            labels.append(t["labels"])
    if rows != len(items) or (np.concatenate(labels) != [c for _, c in items]).any():
        fail(f"extraction over the ImageNet tree: {rows} rows for {len(items)} images")
    out["extract"] = {"images": len(items), "seconds": extract_s,
                      "images_per_s": len(items) / extract_s}

    # the native reader against the Python reference, then do_train on the shards
    ds = ImgLatentDataset(shards)
    batches = list(ds.batches(8, seed=seed, epochs=2))
    reference = list(_python_batches(ds, 8, seed=seed, epochs=2))
    if len(batches) != len(reference):
        fail(f"the native reader gave {len(batches)} batches, the reference {len(reference)}")
    for (gx, gy), (wx, wy) in zip(batches, reference):
        if not (np.array_equal(gx, wx) and np.array_equal(gy, wy)):
            fail("the native shard reader's batches differ from the Python reference's")
    cfg = branch_config("production").merged_with({
        "data": {"data_path": shards},
        "train": {"max_steps": IO_TRAIN_STEPS, "global_batch_size": 8,
                  "ckpt_every": IO_TRAIN_STEPS, "log_every": 1,
                  "output_dir": os.path.join(work, "train"), "exp_name": "imagenet"}})
    fwd, bwd = BRANCHES["production"]["fwd"], BRANCHES["production"]["bwd"]
    with variant_depth("XL", IO_TRAIN_DEPTH):
        reset_counts()
        t0 = time.perf_counter()
        state = do_train(cfg, device="cuda")
        train_s = time.perf_counter() - t0
    got = counts()
    if state.step != IO_TRAIN_STEPS:
        fail(f"do_train on the ImageNet shards reached step {state.step}")
    expect_counts(got, {fwd: IO_TRAIN_STEPS * 2 * IO_TRAIN_DEPTH, bwd: IO_TRAIN_STEPS * IO_TRAIN_DEPTH},
                  "do_train on the ImageNet shards")
    del state
    torch.cuda.empty_cache()
    out["reader"] = {"batches": len(batches), "bit_equal": True}
    out["train"] = {"seconds": train_s, "launches": [got[fwd], got[bwd]]}
    rate_shards = _rate_shards(work)
    out["train_reader_ab"] = ab = _train_reader_ab(rate_shards, work)

    # a FID-folder sampling run through the native PNG writer
    with variant_depth("XL", IO_SAMPLE_DEPTH):
        scfg, model = build_xl(seed)
    ckpt = os.path.join(work, "xl_depth2.safetensors")
    write_safetensors(ckpt, flatten(dit_state_to_jax(model.state_dict()), "params"))
    del model
    written = []

    def recording_writer(images, paths, *a, **k):  # smoke-only: keep what was written
        written.append((np.array(images), list(paths)))
        return write_pngs(images, paths, *a, **k)

    run = scfg.merged_with({"ckpt_path": ckpt, "sample_folder": os.path.join(work, "samples"),
                            "data": {"latent_norm": False},
                            "sample": {"num_sampling_steps": SAMPLER_STEPS, "fid_num": IO_SAMPLE_NUM}})
    with variant_depth("XL", IO_SAMPLE_DEPTH), _patched(sample_mod, "write_pngs", recording_writer):
        reset_counts()
        t0 = time.perf_counter()
        sample_folder = do_sample(run, device="cuda")
        sample_s = time.perf_counter() - t0
    calls = IO_SAMPLE_NUM // scfg.sample.per_proc_batch_size
    expect_counts(counts(), {fwd: IO_SAMPLE_DEPTH * (SAMPLER_STEPS - 1) * calls},
                  "sampling into a FID folder")
    n_png = 0
    for images, paths in written:
        for im, p in zip(images, paths):
            if not np.array_equal(read_png(p), im):
                fail(f"{p}: the writer's PNG does not decode to its image")
            n_png += 1
    if n_png != IO_SAMPLE_NUM or len(os.listdir(sample_folder)) != IO_SAMPLE_NUM:
        fail(f"sampling wrote {n_png} PNGs ({len(os.listdir(sample_folder))} in the folder)")
    out["sample"] = {"images": n_png, "seconds": sample_s, "launches": IO_SAMPLE_DEPTH
                     * (SAMPLER_STEPS - 1) * calls}

    out["rates"] = _host_rates(work, rate_shards, [p for p, _ in items],
                               np.concatenate([w[0] for w in written]))
    out["seconds"] = time.perf_counter() - t_phase
    r = out["rates"]
    log(f"[imagenet] {out['fixtures']} JPEG fixtures (Huffman, arithmetic-coded, lossless, "
        f"block-smoothed) and {out['png_fixtures']} PNG fixtures (every colour type and "
        f"depth, plain and Adam7) bit-equal to PIL's decodes; the shard reader bit-equal to "
        f"reference_batch at batch {IO_READER_BATCH} on {out['shard_kinds']} shard kinds "
        f"({', '.join(SHARD_KINDS)}); ImageNetValidation's {out['validation_items']} items "
        f"equal the JAX package's")
    log(f"[imagenet] extract over the ImageNet tree ({len(items)} small JPEG/PNG files, 256², "
        f"fp32): {extract_s:.2f} s, {out['extract']['images_per_s']:.2f} images/s (a smoke "
        f"reading, first calls included); reader bit-equal to the Python reference over "
        f"{len(batches)} batches; do_train {IO_TRAIN_STEPS} steps {train_s:.1f} s, launches "
        f"{got[fwd]} {fwd} / {got[bwd]} {bwd}; FID folder of {n_png} PNGs {sample_s:.1f} s "
        f"[{device_info['smi']}]")
    log(f"[imagenet] do_train steps/s at batch {IO_READER_BATCH}, depth {IO_TRAIN_DEPTH}, "
        f"steps {IO_AB_STEPS - IO_AB_WINDOW + 1}-{IO_AB_STEPS}: native reader "
        f"{', '.join(f'{x:.4f}' for x in ab['native'])}; Python reference "
        f"{', '.join(f'{x:.4f}' for x in ab['python'])} [{device_info['smi']}]")
    log(f"[imagenet] host rates: decode {RATE_FIXTURE} {r['decode_images_per_s']:.1f} images/s "
        f"alone, {r['decode_pool_images_per_s']:.1f} on {IO_POOL} threads; as SOF9 "
        f"{r['decode_sof9_images_per_s']:.1f} alone, {r['decode_sof9_pool_images_per_s']:.1f} "
        f"on {IO_POOL}; as SOF3 {r['decode_sof3_images_per_s']:.1f} alone, "
        f"{r['decode_sof3_pool_images_per_s']:.1f} on {IO_POOL}; image check "
        f"{r['check_files_per_s']:.1f} files/s of the tree; reader "
        f"{r['reader_native_batches_per_s']:.2f} batches/s of {IO_READER_BATCH} (Python "
        f"reference {r['reader_python_batches_per_s']:.2f}); writer "
        f"{r['writer_pool_images_per_s']:.1f} PNGs/s of 256² on a pool "
        f"({r['writer_one_thread_images_per_s']:.1f} on one thread); phase 34 "
        f"{out['seconds']:.1f} s [{device_info['smi']}]")
    return out

# -- phase 35: the commands from the shipped configs ---------------------------------------

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vavae_tpu_torch", "configs")
CMD_STEPS, CMD_CKPT_EVERY = 4, 2  # (a): train_dit steps, a checkpoint every 2
CMD_SAMPLES = 4     # (b): sample.fid_num, one batch of the config's per_proc_batch_size
PROD_SAMPLES = 8    # (c): sample.per_proc_batch_size and sample.fid_num
PROD_LAUNCHES = 6972  # (c): 28 blocks x 249 model calls of euler-250 split-CFG
EXTRACT_KEYS = ("latents", "latents_flip", "labels")


def _command(*args: str) -> float:
    """``python -m vavae_tpu_torch <args>`` in this process (the launch
    counters stay readable), with PyYAML made unimportable as on the card;
    fails unless it exits 0. Returns its seconds."""
    saved_argv, saved_yaml = sys.argv, sys.modules.get("yaml", False)
    sys.argv = ["python -m vavae_tpu_torch", *args]
    sys.modules["yaml"] = None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = port_cli.main()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        sys.argv = saved_argv
        if saved_yaml is False:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = saved_yaml
    if rc != 0:
        fail(f"python -m vavae_tpu_torch {' '.join(args)}: exit {rc}")
    return seconds


@contextlib.contextmanager
def _counted_model_calls(calls: list):
    """Counts LightningDiT forwards (the sampler's model evaluations)."""
    original = dit.LightningDiT.forward

    def forward(self, *a, **kw):
        calls[0] += 1
        return original(self, *a, **kw)

    dit.LightningDiT.forward = forward
    try:
        yield
    finally:
        dit.LightningDiT.forward = original


def _check_samples(folder: str, n: int, size: int, what: str) -> None:
    names = sorted(os.listdir(folder))
    if names != [f"{i:06d}.png" for i in range(n)]:
        fail(f"{what}: wrote {names}, expected {n} PNGs")
    for name in names:
        img = read_png(os.path.join(folder, name))
        if img.shape != (size, size, 3) or img.dtype != np.uint8 or len(np.unique(img)) < 16:
            fail(f"{what}: {name} is {img.shape} {img.dtype} with {len(np.unique(img))} values")


def _shards(folder: str) -> dict:
    files = sorted(f for f in os.listdir(folder) if f.startswith("latents_rank"))
    tensors = [read_safetensors(os.path.join(folder, f))[0] for f in files]
    return {k: np.concatenate([t[k] for t in tensors]) for k in EXTRACT_KEYS}


def phase_commands(seed: int, device_info: dict, phase21_shards: str) -> dict:
    """Phase 35: the documented commands through ``vavae_tpu_torch.__main__``
    from the port's shipped configs, PyYAML blocked: (a) ``train_dit`` on the
    micro-Doppler DiT-S/2, (b) ``sample`` (dopri5 split-CFG) from its
    checkpoint, (c) the production XL/1 ``sample``, (d) ``extract_features``
    with the f16d32 VA-VAE config on phase 21's folder."""
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_commands_")
    out, seconds = {}, {}
    try:
        data = os.path.join(work, "latents")
        write_latent_shards(data, seed)
        micro = os.path.join(CONFIGS, "dit_s_microdoppler.yaml")
        micro_cfg = load_config(micro)
        depth = dit._VARIANTS[micro_cfg.model.model_type.split("-")[1].split("/")[0]]["depth"]
        runs = os.path.join(work, "runs")

        # (a) 4 steps at the config's batch, no remat: one forward and one
        # backward of every block a step
        reset_counts()
        seconds["train_dit"] = _command(
            "train_dit", "--config", micro, f"data.data_path={data}",
            f"train.max_steps={CMD_STEPS}", f"train.ckpt_every={CMD_CKPT_EVERY}",
            "train.log_every=1", f"train.output_dir={runs}")
        expect_counts(counts(), {"nat_attention_fwd": CMD_STEPS * depth,
                                 "nat_attention_bwd": CMD_STEPS * depth}, "train_dit command")
        ckpt_dir = os.path.join(runs, micro_cfg.train.exp_name, "checkpoints")
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors"))
        if ckpts != [f"{s:07d}.safetensors" for s in range(CMD_CKPT_EVERY, CMD_STEPS + 1,
                                                            CMD_CKPT_EVERY)]:
            fail(f"train_dit command: checkpoints {ckpts}")

        # (b) dopri5 split-CFG: 2 evaluations seed each phase, 6 each attempted step
        calls = [0]
        with _counted_model_calls(calls):
            reset_counts()
            seconds["sample_dopri5"] = _command(
                "sample", "--config", micro, f"ckpt_path={os.path.join(ckpt_dir, ckpts[-1])}",
                f"data.data_path={data}", f"train.output_dir={runs}",
                f"sample.fid_num={CMD_SAMPLES}")
        if calls[0] < 4 or (calls[0] - 4) % 6:
            fail(f"sample (dopri5): {calls[0]} model calls, not 2 + 6k in each of two phases")
        expect_counts(counts(), {"nat_attention_fwd": depth * calls[0]}, "sample (dopri5) command")
        _check_samples(os.path.join(runs, f"{micro_cfg.train.exp_name}_samples"), CMD_SAMPLES,
                       micro_cfg.data.image_size, "sample (dopri5)")
        out["dopri5_model_calls"] = calls[0]

        # (c) the production sample: XL/1 at full depth from a params file
        prod = os.path.join(CONFIGS, "lightningdit_xl_vavae_f16d32.yaml")
        prod_cfg = load_config(prod)
        latent = prod_cfg.data.image_size // prod_cfg.vae.downsample_ratio
        model = create_dit(prod_cfg.model, latent, prod_cfg.data.num_classes, device="cuda")
        randomize_(model, seed)
        prod_depth = model.depth
        params = os.path.join(work, "xl_params.safetensors")
        write_safetensors(params, {"step": np.asarray(0, np.int32), **{
            f"params|{k}": v for k, v in flatten(dit_state_to_jax(model.state_dict())).items()}})
        del model
        torch.cuda.empty_cache()
        want = prod_depth * (prod_cfg.sample.num_sampling_steps - 1)
        if want != PROD_LAUNCHES:
            fail(f"the production config gives {want} #1 launches, not {PROD_LAUNCHES}")
        reset_counts()
        seconds["sample_production"] = _command(
            "sample", "--config", prod, f"ckpt_path={params}", f"data.data_path={data}",
            f"sample.per_proc_batch_size={PROD_SAMPLES}", f"sample.fid_num={PROD_SAMPLES}",
            f"train.output_dir={runs}")
        expect_counts(counts(), {"nat_attention_fwd": want}, "production sample command")
        _check_samples(os.path.join(runs, f"{prod_cfg.train.exp_name}_samples"), PROD_SAMPLES,
                       prod_cfg.data.image_size, "production sample")

        # (d) extract_features with the tokenizer config, as phase 21 ran it
        folder = os.path.join(work, "images")
        write_image_folder(folder, seed)
        extracted = os.path.join(work, "extracted")
        reset_counts()
        seconds["extract_features"] = _command(
            "extract_features", "--config", os.path.join(CONFIGS, "vavae_f16d32.yaml"),
            "--data_path", folder, "--output_path", extracted, "--batch_size",
            str(EXTRACT_BATCH), "--image_size", "256")
        expect_counts(counts(), {}, "extract_features command")
        got, want_shards = _shards(extracted), _shards(phase21_shards)
        for k in EXTRACT_KEYS:
            if got[k].shape != want_shards[k].shape or not np.array_equal(got[k], want_shards[k]):
                fail(f"extract_features --config: {k} {got[k].shape} differs from phase 21's "
                     f"{want_shards[k].shape} (the same seeded f16d32 weights)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update(seconds=seconds, phase_seconds=time.perf_counter() - t_phase,
               launches={"train_dit": [CMD_STEPS * depth, CMD_STEPS * depth],
                         "sample_dopri5": [depth * calls[0], 0],
                         "sample_production": [PROD_LAUNCHES, 0]})
    log(f"[commands] python -m vavae_tpu_torch from vavae_tpu_torch/configs, PyYAML blocked: "
        f"(a) train_dit DiT-S/2 {CMD_STEPS} steps {seconds['train_dit']:.1f} s "
        f"({CMD_STEPS * depth} #1 / {CMD_STEPS * depth} #2); (b) sample dopri5 "
        f"{CMD_SAMPLES} images {seconds['sample_dopri5']:.1f} s ({calls[0]} model calls, "
        f"{depth * calls[0]} #1); (c) production XL/1 sample {PROD_SAMPLES} images "
        f"{seconds['sample_production']:.1f} s ({PROD_LAUNCHES} #1); (d) extract_features "
        f"{seconds['extract_features']:.1f} s, shards equal to phase 21's; phase 35 "
        f"{out['phase_seconds']:.1f} s [{device_info['smi']}]")
    return out


# -- phase 36: WebP and BMP images, the latent t-SNE and its plot -------------------------

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
LSUN_FILES, LSUN_BATCH, LSUN_SHARD = 256, 32, 128  # the LSUN tree at 256² (f16d32 VA-VAE)
DECODE_REPS, DECODE_POOL = 64, 8
TSNE_LATENTS = (40, 16, 16, 32)  # 10,240 latent pixels of 32 channels
TSNE_N, TSNE_CHECK_N = 10000, 1000
# The card's and the host's float64 t-SNE differ by rounding only, but the
# 1,000 iterations are chaotic: twelve host runs of 1,000 of these latent
# pixels whose inits differ by 1e-14 to 1e-13 relative end in other layouts
# (10-neighbour agreement 0.37-0.48), their final KL within 2.1% of each
# other, normalised entropy 0.0076, Gini 0.022 (sixteen runs of 400 points:
# 3.2%, 0.0062, 0.0099). The limits are about two and a half times those,
# on what the layout does not change.
TSNE_TOL = {"kl": 0.08, "normalized_entropy": 0.02, "gini": 0.05, "neighbours": 0.25}
# Before chaos sets in the card and the host agree to rounding: one gradient
# (max-abs, relative to its largest entry) and KL at the same P and
# positions, and the positions after the first iterations of the
# exaggerated stage from the same init. On the host, the rounding of
# another row chunking moves the gradient by 3e-16 and the positions by
# 2e-15 after 25 iterations (at N = 400: 1e-11 after 25, 1e-6 after 50);
# the card moved them by 4e-10 after 50.
TSNE_GRAD_TOL, TSNE_TIGHT_ITERS, TSNE_ITER_TOL = 1e-10, 25, 1e-8


@contextlib.contextmanager
def _unimportable(*names: str):
    """``names`` made unimportable, as the card's machine has none of them."""
    saved = {n: sys.modules.get(n, False) for n in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is False:
                del sys.modules[n]
            else:
                sys.modules[n] = m


def _check_webp_bmp_fixtures() -> dict:
    """Every committed WebP and BMP fixture through ``read_image_rgb`` (and
    the WebP ones with alpha as RGBA) against PIL's committed decodes."""
    out = {}
    for kind in ("webp", "bmp"):
        folder = os.path.join(DATA, kind)
        want = np.load(os.path.join(folder, "expected.npz"))
        names = sorted(f for f in os.listdir(folder) if f.endswith("." + kind))
        for name in names:
            stem, path = name[:-len(kind) - 1], os.path.join(folder, name)
            if not np.array_equal(read_image_rgb(path), want[stem]):
                fail(f"{kind} fixture {name}: the decode differs from PIL's")
            if stem + "__rgba" in want.files:
                with open(path, "rb") as f:
                    if not np.array_equal(decode_webp(f.read(), path, alpha=True),
                                          want[stem + "__rgba"]):
                        fail(f"webp fixture {name}: the RGBA decode differs from PIL's")
        out[kind] = len(names)
    return out


def _webp_rates() -> dict:
    """Decodes a second of the LSUN-shaped lossy fixture (256×341) and of a
    lossless one (160×96), alone and on a pool of threads."""
    out = {}
    for key, name in (("lossy_256x341", "lossy_lsun_256x341.webp"),
                      ("lossless_160x96", "lossless_q100_m6.webp")):
        with open(os.path.join(DATA, "webp", name), "rb") as f:
            data = f.read()
        decode_webp(data)
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            decode_webp(data)
        alone = DECODE_REPS / (time.perf_counter() - t0)
        with ThreadPoolExecutor(DECODE_POOL) as pool:
            t0 = time.perf_counter()
            list(pool.map(decode_webp, [data] * (DECODE_REPS * DECODE_POOL)))
            pooled = DECODE_REPS * DECODE_POOL / (time.perf_counter() - t0)
        out[key] = {"alone": alone, f"threads_{DECODE_POOL}": pooled}
    return out


def _lsun_tree(root: str) -> list:
    """An LSUN tree as the LDM layout holds it: ``churches/<key>.webp`` files
    as LSUN's export writes them (the committed lossy, lossless, alpha and
    animated fixtures, the LSUN-shaped one most often) and its txt filelist
    of paths under ``root``, which ``extract`` reads as one class."""
    stems = ["lossy_lsun_256x341"] * 4 + ["lossy_q95_m0", "lossless_photo_q75", "lossy_alpha_pil",
                                          "anim_lossy_offset", "vp8x_icc_exif", "lossy_4_segments"]
    os.makedirs(os.path.join(root, "churches"))
    names = []
    for k in range(LSUN_FILES):
        name = f"churches/{k:040x}.webp"
        shutil.copy(os.path.join(DATA, "webp", stems[k % len(stems)] + ".webp"),
                    os.path.join(root, name))
        names.append(name)
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def _tsne_png_check(emb: np.ndarray, metrics: dict, path: str) -> None:
    """The scatter PNG read back: 900×900, equal to the drawing of ``emb``,
    inked at every marker's centre, white away from the markers."""
    img = read_png(path)
    title = f"entropy={metrics['normalized_entropy']:.3f} gini={metrics['gini']:.3f}"
    if img.shape != (900, 900, 3) or not np.array_equal(img, render_scatter(emb, title)):
        fail(f"t-SNE plot: {img.shape} read back, not the drawing of the embedding")
    (x0, x1), (y0, y1) = latent_vis._limits(emb[:, 0]), latent_vis._limits(emb[:, 1])
    cx = np.floor(112.5 + (emb[:, 0] - x0) / (x1 - x0) * 697.5 + 0.5).astype(int)
    cy = np.floor(801.0 - (emb[:, 1] - y0) / (y1 - y0) * 693.0 + 0.5).astype(int)
    near = np.zeros((900, 900), bool)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            near[np.clip(cy + dy, 0, 899), np.clip(cx + dx, 0, 899)] = True
    inner = np.zeros((900, 900), bool)
    inner[112:797, 117:806] = True
    if not (img[cy, cx, 0] < 255).all() or (img[inner & ~near] != 255).any():
        fail("t-SNE plot: markers missing at the embedding's points, or ink away from them")


def _tsne_tight(pixels: np.ndarray, host_final: np.ndarray, seed: int) -> dict:
    """The t-SNE's steps on the card against the host where rounding alone
    parts them: P; the gradient and KL with the host's P at the init, and
    at ``host_final`` with P exaggerated (there P itself is near balance,
    its gradient the small difference of two large terms); and the
    positions after ``TSNE_TIGHT_ITERS`` exaggerated iterations from the
    init."""
    from vavae_tpu_torch.eval import tsne as T

    n = len(pixels)
    ph = T.joint_probabilities(torch.as_tensor(pixels))
    pc = T.joint_probabilities(torch.as_tensor(pixels, device="cuda"))
    if not (torch.equal(pc[0].cpu(), ph[0]) and torch.equal(pc[1].cpu(), ph[1])):
        fail("t-SNE: the card's P has other entries than the host's")
    out = {"p": float((pc[2].cpu() - ph[2]).abs().max() / ph[2].abs().max())}
    xh = (ph[0], ph[1], ph[2] * T.EARLY_EXAGGERATION)
    pc, xc = tuple(t.cuda() for t in ph), tuple(t.cuda() for t in xh)
    y0 = torch.as_tensor(T.pca_init(pixels, seed).astype(np.float64))
    for key, y, p_host, p_card in (("init", y0, ph, pc),
                                   ("final", torch.as_tensor(host_final), xh, xc)):
        eh, gh = T.kl_gradient(y, p_host)
        ec, gc = T.kl_gradient(y.cuda(), p_card)
        out[f"grad_{key}"] = float((gc.cpu() - gh).abs().max() / gh.abs().max())
        out[f"kl_{key}"] = abs(ec - eh) / abs(eh)
    lr = max(n / T.EARLY_EXAGGERATION / 4, 50.0)
    args = (0, TSNE_TIGHT_ITERS, 0.5, lr, T.EXPLORATION_ITERS)
    yh = T._gradient_descent(y0, xh, *args)[0]
    yc = T._gradient_descent(y0.cuda(), xc, *args)[0]
    out["iterates"] = float((yc.cpu() - yh).abs().max() / yh.abs().max())
    for key, value in out.items():
        if not value <= (TSNE_ITER_TOL if key == "iterates" else TSNE_GRAD_TOL):
            fail(f"t-SNE at N = {n}: the card against the host before chaos, {key} {value:.3g}")
    return out


def _neighbour_agreement(a: np.ndarray, b: np.ndarray, k: int = 10) -> float:
    """The share of each point's k nearest neighbours in ``a`` that are
    among them in ``b``, averaged."""
    def knn(e):
        d = ((e[:, None] - e[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        return np.argsort(d, 1)[:, :k]

    ka, kb = knn(a), knn(b)
    return float(np.mean([len(set(ka[i]) & set(kb[i])) / k for i in range(len(a))]))


def phase_images_tsne(seed: int, device_info: dict, work: str) -> dict:
    """Phase 36, with PIL, scikit-learn and matplotlib unimportable: (a) the
    WebP and BMP fixtures against PIL's committed decodes, and WebP decode
    rates; (b) an LSUN tree of WebP files through ``LSUNBase``, its
    ``batches`` and ``extract`` with the f16d32 VA-VAE; (c)
    ``plot_tsne_visualization`` of 10,000 latent pixels on the card, and the
    t-SNE on the card against the host at N = 1,000."""
    t_phase = time.perf_counter()
    out = {}
    with _unimportable("PIL", "sklearn", "matplotlib"):
        out["fixtures"] = _check_webp_bmp_fixtures()
        out["webp_per_s"] = _webp_rates()

        # (b) LSUN of WebP files: items, batches, extraction
        root = os.path.join(work, "lsun")
        names = _lsun_tree(root)
        ds = LSUNBase(txt_file=os.path.join(root, "list.txt"), data_root=root, size=256,
                      flip_p=0.0)
        if len(ds) != LSUN_FILES or ds.items[0][0] != os.path.join(root, names[0]):
            fail(f"LSUNBase over the WebP filelist: {len(ds)} items")
        seen = 0
        for i, (x, y) in enumerate(ds.batches(LSUN_BATCH, shuffle=False, epochs=1)):
            if x.shape != (LSUN_BATCH, 256, 256, 3) or not np.isfinite(x).all() or abs(x).max() > 1:
                fail(f"LSUN batch {i}: {x.shape}")
            if not np.array_equal(x[0], ds[i * LSUN_BATCH][0]):
                fail(f"LSUN batch {i}: its first item differs from the dataset's")
            seen += len(x)
        if seen != LSUN_FILES:
            fail(f"LSUN batches gave {seen} items for {LSUN_FILES}")
        vae = VA_VAE(embed_dim=32, img_size=256, seed=seed, device="cuda")
        extract(root, os.path.join(work, "lsun_warm"), vae, batch_size=LSUN_BATCH,
                image_size=256, shard_size=LSUN_SHARD, seed=seed)  # the path warmed
        shards = os.path.join(work, "lsun_latents")
        reader, decode_s = extract_features.read_image_rgb, [0.0]

        def timed_reader(path):
            t = time.perf_counter()
            img = reader(path)
            decode_s[0] += time.perf_counter() - t
            return img

        extract_features.read_image_rgb = timed_reader
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract(root, shards, vae, batch_size=LSUN_BATCH, image_size=256,
                    shard_size=LSUN_SHARD, seed=seed)
            torch.cuda.synchronize()
            extract_s = time.perf_counter() - t0
        finally:
            extract_features.read_image_rgb = reader
        expect_counts(counts(), {}, "extraction over the LSUN tree")
        del vae
        torch.cuda.empty_cache()
        got = _shards(shards)
        if got["latents"].shape != (LSUN_FILES, 32, 16, 16) or not np.isfinite(got["latents"]).all():
            fail(f"extraction over the LSUN tree: latents {got['latents'].shape}")
        out["lsun_extract"] = {"images": LSUN_FILES, "seconds": extract_s,
                               "images_per_s": LSUN_FILES / extract_s,
                               "decode_seconds_in_extract": decode_s[0],
                               "decode_share_in_extract": decode_s[0] / extract_s}

        # (c) the t-SNE plot on the card, and the card against the host
        lat = np.random.default_rng(seed).standard_normal(TSNE_LATENTS).astype(np.float32)
        lat[..., :4] *= 2.0  # a few dominant channels
        kls = []
        tsne_fn = latent_vis.tsne

        def recording(*a, **kw):
            emb, kl = tsne_fn(*a, **kw)
            kls.append(kl)
            return emb, kl

        latent_vis.tsne = recording
        png = os.path.join(work, "tsne.png")
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb, metrics = plot_tsne_visualization(lat, png, num_samples=TSNE_N, seed=seed,
                                                   device="cuda")
            torch.cuda.synchronize()
            tsne_s = time.perf_counter() - t0
        finally:
            latent_vis.tsne = tsne_fn
        expect_counts(counts(), {}, "the t-SNE")
        if emb.shape != (TSNE_N, 2) or not np.isfinite(emb).all() or not np.isfinite(kls[0]):
            fail(f"t-SNE: embedding {emb.shape}, KL {kls[0]}")
        _tsne_png_check(emb, metrics, png)
        pixels = sample_latent_pixels(lat, TSNE_CHECK_N, seed)
        t0 = time.perf_counter()
        card, card_kl = tsne_fn(pixels, seed=seed, device="cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host, host_kl = tsne_fn(pixels, seed=seed, device="cpu")
        host_s = time.perf_counter() - t0
        tight = _tsne_tight(pixels, host, seed)
        mc, mh = calculate_uniformity_metrics(card), calculate_uniformity_metrics(host)
        dev = {"kl": abs(card_kl - host_kl) / abs(host_kl),
               "normalized_entropy": abs(mc["normalized_entropy"] - mh["normalized_entropy"]),
               "gini": abs(mc["gini"] - mh["gini"]),
               "neighbours": _neighbour_agreement(card, host),
               "embedding": float(np.abs(card - host).max() / np.abs(host).max())}
        for key, tol in TSNE_TOL.items():
            if not (dev[key] >= tol if key == "neighbours" else dev[key] <= tol):
                fail(f"t-SNE at N = {TSNE_CHECK_N}: the card against the host, {key} "
                     f"{dev[key]:.3g} (limit {tol})")
        out["tsne"] = {"n": TSNE_N, "seconds": tsne_s, "kl": kls[0], **metrics,
                       "check_n": TSNE_CHECK_N, "card_seconds": card_s, "host_seconds": host_s,
                       "card_vs_host": dev, "card_vs_host_tight": tight}
    out["phase_seconds"] = time.perf_counter() - t_phase
    rates, ex, ts = out["webp_per_s"], out["lsun_extract"], out["tsne"]
    log(f"[images+tsne] fixtures: {out['fixtures']['webp']} WebP, {out['fixtures']['bmp']} BMP "
        f"equal to PIL's; WebP decode/s 256x341 lossy {rates['lossy_256x341']['alone']:.0f} "
        f"alone, {rates['lossy_256x341'][f'threads_{DECODE_POOL}']:.0f} on {DECODE_POOL} "
        f"threads, 160x96 lossless {rates['lossless_160x96']['alone']:.0f} / "
        f"{rates['lossless_160x96'][f'threads_{DECODE_POOL}']:.0f}; LSUN WebP tree extract "
        f"{ex['images_per_s']:.1f} images/s warmed, {LSUN_FILES} files (its loader in "
        f"read_image_rgb {ex['decode_share_in_extract']:.2f} of its wall); "
        f"t-SNE N={TSNE_N} {ts['seconds']:.1f} s, KL {ts['kl']:.4f}, entropy "
        f"{ts['normalized_entropy']:.4f}, Gini {ts['gini']:.4f}; N={TSNE_CHECK_N} card "
        f"{card_s:.1f} s vs host {host_s:.1f} s, apart before chaos {tight}, after {dev}; phase 36 "
        f"{out['phase_seconds']:.1f} s [{device_info['smi']}]")
    return out


# phase 37: the readers of GIF, TIFF, PNM and ICO/CUR files
OTHER_EXTS = {"gif": (".gif",), "tiff": (".tif",), "pnm": (".pbm", ".pgm", ".ppm", ".pfm"),
              "ico": (".ico", ".cur")}
OTHER_FILES, OTHER_SIZE = 128, 256  # the misnamed tree that ``extract`` reads


def _kit(kind: str, name: str):
    """``tests/data/<kind>/<name>.py``: the PIL-free GIF and TIFF writers of
    the tests."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(DATA, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_other_fixtures() -> dict:
    """Every committed GIF, TIFF, PNM and ICO/CUR fixture through
    ``read_image_rgb`` against PIL's committed decodes; each file PIL refuses
    raises naming it (``ImportError`` for one its plugin declines, an icon of
    no entries), and each left to PIL (JPEG and CCITT TIFFs) raises
    ``ImportError`` naming it."""
    out = {}
    for kind, exts in OTHER_EXTS.items():
        folder = os.path.join(DATA, kind)
        want = np.load(os.path.join(folder, "expected.npz"))
        tally = {"equal": 0, "refused": 0, "left_to_pil": 0}
        for name in sorted(os.listdir(folder)):
            stem, ext = os.path.splitext(name)
            if ext not in exts:
                continue
            path = os.path.join(folder, name)
            if stem.startswith(("refused_", "pil_only_")):
                key = "refused" if stem.startswith("refused_") else "left_to_pil"
                try:
                    read_image_rgb(path)
                except (ValueError, ImportError) as e:
                    if path not in str(e) or key == "left_to_pil" and not isinstance(e, ImportError):
                        fail(f"{kind} fixture {name}: {type(e).__name__} {e}")
                    tally[key] += 1
                    continue
                fail(f"{kind} fixture {name}: decoded, where PIL refuses it or is needed")
            if not np.array_equal(read_image_rgb(path), want[stem]):
                fail(f"{kind} fixture {name}: the decode differs from PIL's")
            tally["equal"] += 1
        out[kind] = tally
    return out


def _other_images(seed: int) -> dict:
    """A seeded 256×256 picture as a GIF (a 6×6×6 colour cube), an LZW TIFF
    (strips of 16 rows, predictor 2) and a PPM: {kind: (bytes, the RGB it
    holds)}."""
    n = OTHER_SIZE
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    base = np.stack([xx + yy // 2, (xx * yy) // 97, 255 - yy + xx // 3], -1)
    rgb = ((base % 256) + rs.integers(-12, 13, base.shape)).clip(0, 255).astype(np.uint8)
    idx = (rgb // 43).astype(np.int64) @ np.array([36, 6, 1])
    cube = np.stack(np.meshgrid(*[np.arange(6) * 51] * 3, indexing="ij"), -1).reshape(216, 3)
    gif = _kit("gif", "gifkit").gif(n, n, idx.ravel().tolist(), 8,
                                    palette=cube.astype(np.uint8).tobytes())
    tiff = _kit("tiff", "tiffkit").image(rgb, 8, compression=5, predictor=2, rows_per_strip=16)
    ppm = f"P6\n{n} {n}\n255\n".encode() + rgb.tobytes()
    return {"gif": (gif, cube.astype(np.uint8)[idx]), "tiff_lzw": (tiff, rgb), "ppm": (ppm, rgb)}


def _tga(w: int, h: int) -> bytes:
    """An uncompressed 24-bit TGA file (a type only PIL reads; its first
    bytes are a cursor's magic)."""
    header = (bytes([0, 0, 2]) + bytes(9) + w.to_bytes(2, "little") + h.to_bytes(2, "little")
              + bytes([24, 0x20]))
    return header + bytes(i % 251 for i in range(3 * w * h))


def phase_other_images(seed: int, device_info: dict, work: str) -> dict:
    """Phase 37, with PIL unimportable: (a) every GIF, TIFF, PNM and ICO/CUR
    fixture against PIL's committed decodes, and decode rates of a 256×256
    GIF, LZW TIFF and PPM, alone and on 8 threads; (b) ``extract`` with the
    f16d32 VA-VAE over a tree of 128 such files named ``.jpg`` and
    ``.png``, warmed, then timed; (c) ``refused_images`` over a tree holding
    one TGA file names it as needing PIL, and nothing else."""
    t_phase = time.perf_counter()
    out = {}
    with _unimportable("PIL"):
        out["fixtures"] = _check_other_fixtures()
        images = _other_images(seed)
        rates = {}
        decoders = {"gif": decode_gif, "tiff_lzw": decode_tiff, "ppm": decode_pnm}
        for kind, (data, want) in images.items():
            path = os.path.join(work, f"one_{kind}.jpg")
            with open(path, "wb") as f:
                f.write(data)
            if not np.array_equal(read_image_rgb(path), want):
                fail(f"the 256x256 {kind}: read back other than written")
            decode = decoders[kind]
            alone = _rate(lambda: decode(data), DECODE_REPS)
            with ThreadPoolExecutor(DECODE_POOL) as pool:
                t0 = time.perf_counter()
                list(pool.map(decode, [data] * (DECODE_REPS * DECODE_POOL)))
                pooled = DECODE_REPS * DECODE_POOL / (time.perf_counter() - t0)
            rates[kind] = {"alone": alone, f"threads_{DECODE_POOL}": pooled, "bytes": len(data)}
        out["decode_per_s"] = rates

        # (b) extract over the misnamed tree
        root = os.path.join(work, "misnamed")
        kinds = list(images)
        for k in range(OTHER_FILES):
            cls = os.path.join(root, f"class_{k % 2}")
            os.makedirs(cls, exist_ok=True)
            with open(os.path.join(cls, f"{k:04d}{'.jpg' if k % 4 < 2 else '.png'}"), "wb") as f:
                f.write(images[kinds[k % 3]][0])
        vae = VA_VAE(embed_dim=32, img_size=256, seed=seed, device="cuda")
        extract(root, os.path.join(work, "misnamed_warm"), vae, batch_size=LSUN_BATCH,
                image_size=256, shard_size=LSUN_SHARD, seed=seed)  # the path warmed
        reader, decode_s = extract_features.read_image_rgb, [0.0]

        def timed_reader(path):
            t = time.perf_counter()
            img = reader(path)
            decode_s[0] += time.perf_counter() - t
            return img

        shards = os.path.join(work, "misnamed_latents")
        extract_features.read_image_rgb = timed_reader
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract(root, shards, vae, batch_size=LSUN_BATCH, image_size=256,
                    shard_size=LSUN_SHARD, seed=seed)
            torch.cuda.synchronize()
            extract_s = time.perf_counter() - t0
        finally:
            extract_features.read_image_rgb = reader
        expect_counts(counts(), {}, "extraction over the misnamed tree")
        del vae
        torch.cuda.empty_cache()
        got = _shards(shards)
        if got["latents"].shape != (OTHER_FILES, 32, 16, 16) or not np.isfinite(got["latents"]).all():
            fail(f"extraction over the misnamed tree: latents {got['latents'].shape}")
        out["misnamed_extract"] = {"images": OTHER_FILES, "seconds": extract_s,
                                   "images_per_s": OTHER_FILES / extract_s,
                                   "decode_seconds_in_extract": decode_s[0],
                                   "decode_share_in_extract": decode_s[0] / extract_s}

        # (c) without PIL, the check names the file that needs it
        tree = os.path.join(work, "with_tga")
        os.makedirs(os.path.join(tree, "class_0"))
        for k, kind in enumerate(kinds):
            with open(os.path.join(tree, "class_0", f"{k}.png"), "wb") as f:
                f.write(images[kind][0])
        tga = os.path.join(tree, "class_0", "x.jpg")
        with open(tga, "wb") as f:
            f.write(_tga(8, 6))
        paths = [p for p, _ in list_image_folder(tree)]
        refused = refused_images(paths)
        if [p for p, _ in refused] != [tga] or "needs PIL" not in refused[0][1]:
            fail(f"refused_images over a tree with a TGA file: {refused}")
        out["tga_check"] = {"files": len(paths), "named": refused[0][1]}
    out["phase_seconds"] = time.perf_counter() - t_phase
    r, ex = out["decode_per_s"], out["misnamed_extract"]
    fx = out["fixtures"]
    log(f"[other images] fixtures equal to PIL's: GIF {fx['gif']['equal']}, TIFF "
        f"{fx['tiff']['equal']}, PNM {fx['pnm']['equal']}, ICO/CUR {fx['ico']['equal']} "
        f"(refused as PIL: {sum(v['refused'] for v in fx.values())}, left to PIL: "
        f"{sum(v['left_to_pil'] for v in fx.values())}); decode/s of 256x256 "
        + ", ".join(f"{k} {v['alone']:.0f} alone, {v[f'threads_{DECODE_POOL}']:.0f} on "
                    f"{DECODE_POOL} threads" for k, v in r.items())
        + f"; misnamed tree extract {ex['images_per_s']:.1f} images/s warmed, {OTHER_FILES} files "
        f"(its loader in read_image_rgb {ex['decode_share_in_extract']:.2f} of its wall); TGA "
        f"named as needing PIL; phase 37 {out['phase_seconds']:.1f} s [{device_info['smi']}]")
    return out


def phase_learning(device_info: dict) -> dict:
    """Phase 38 (a): the learning check (``apps/learning_check.py``, the
    port of ``tests/test_learning_tpu.py``) on the card: DiT-S/2 bf16 for
    1,200 steps, then euler-50 split-CFG from the EMA weights. The JAX
    test's assertions, and #1 and #2 launched exactly depth × steps in
    training (no remat) and #1 depth × model calls in sampling."""
    reset_counts()
    res = learning_check.run("cuda")
    got = counts()
    depth, steps, calls = res["depth"], res["steps"], res["sample_model_calls"]
    want = {"nat_attention_fwd": depth * (steps + calls), "nat_attention_bwd": depth * steps}
    expect_counts(got, want, "the learning check")
    if res["train_launches"] != [depth * steps] * 2 or res["sample_launches"] != [depth * calls, 0]:
        fail(f"the learning check: launches in training {res['train_launches']}, in sampling "
             f"{res['sample_launches']}")
    log(f"[learning] DiT-S/2 bf16 batch {res['batch']}, {steps} steps: loss "
        f"{res['first_loss']:.4f} → {res['last_loss']:.4f}, {res['ms_per_step']:.2f} ms/step "
        f"({res['train_s']:.1f} s), euler-{learning_check.SAMPLE_STEPS} split-CFG "
        f"{res['sample_s']:.2f} s, nearest-class-mean accuracy {res['accuracy']:.4f}; launches "
        f"#1 {res['train_launches'][0]} + {res['sample_launches'][0]}, #2 "
        f"{res['train_launches'][1]} [{device_info['smi']}]")
    if not learning_check.passed(res):
        fail(f"the learning check failed: {res}")
    return res


def start_e2e_smoke(work: str) -> tuple[subprocess.Popen, float]:
    """Phase 38 (b), started: ``python -m vavae_tpu_torch e2e_onchip --smoke
    --device cuda``, its output to ``work``."""
    with open(os.path.join(work, "e2e_smoke.log"), "w") as log_file:
        p = subprocess.Popen([sys.executable, "-m", "vavae_tpu_torch", "e2e_onchip", "--smoke",
                              "--device", "cuda", "--workdir", os.path.join(work, "e2e"),
                              "--out", os.path.join(work, "e2e_smoke.json")],
                             cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log_file,
                             stderr=subprocess.STDOUT, start_new_session=True)
    return p, time.perf_counter()


def stop_e2e_smoke(p: subprocess.Popen) -> None:
    """Phase 38 (b)'s process group (the command and its stage) killed."""
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def finish_e2e_smoke(device_info: dict, work: str, p: subprocess.Popen, t0: float) -> dict:
    """Phase 38 (b), finished: every stage of the run exited 0 on the card
    and its record holds them all, each with finite metrics."""
    try:
        rc = p.wait(timeout=900)
    finally:
        stop_e2e_smoke(p)
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(os.path.join(work, "e2e_smoke.log")) as f:
            fail(f"e2e_onchip --smoke: rc {rc}\n{f.read()[-4000:]}")
    with open(os.path.join(work, "e2e_smoke.json")) as f:
        doc = json.load(f)
    stages = doc["stages"]
    if list(stages) != list(e2e_onchip.STAGES) or not doc["source_sha256"]:
        fail(f"e2e_onchip --smoke: stages {list(stages)}, source hash {doc['source_sha256']}")
    if doc["device"]["smi"] != device_info["smi"]:
        fail(f"e2e_onchip --smoke: device {doc['device']}, expected {device_info['smi']}")
    tok, dit, gauge = (stages[s]["metrics"] for s in ("evaluate_tokenizer", "train_dit",
                                                        "gauge_fid"))
    numbers = [stages[s]["wall_s"] for s in stages] + [
        tok["psnr"], tok["ssim"], dit["final_train_loss"], stages["train_vavae"]["metrics"]["val"],
        gauge["gauge_fid_vs_real"], gauge["real_split_floor"], gauge["gauge_fid_matched_n"]]
    if not all(np.isfinite(numbers)) or stages["sample"]["metrics"]["images"] != 4:
        fail(f"e2e_onchip --smoke: record {stages}")
    log(f"[e2e smoke] e2e_onchip --smoke on the card: "
        + ", ".join(f"{s} {stages[s]['wall_s']:.1f} s" for s in stages)
        + f"; {seconds:.1f} s in all [{device_info['smi']}]")
    return {"seconds": seconds, "stages": {s: stages[s]["wall_s"] for s in stages}}


def run_learning(device_info: dict) -> dict:
    """Phase 38: (b) the e2e smoke started in its subprocesses, (a) the
    learning check beside it in this process, then (b)'s record read; and
    #1 and #2 in fp32 at the full e2e run's DiT-S/2 train step (batch 32).
    (a) is host-bound and (b) is mostly processes starting, so the two
    share the card for the phase's time."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p38_")
    try:
        smoke, t_smoke = start_e2e_smoke(work)
        try:
            learning = phase_learning(device_info)
        except BaseException:
            stop_e2e_smoke(smoke)
            raise
        out = {"learning": learning,
               "e2e_smoke": finish_e2e_smoke(device_info, work, smoke, t_smoke),
               "e2e_kernels": lora_kernel_rows(SEED + 38, B=32, H=6, tag="e2e")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_seconds"] = time.perf_counter() - t0
    log(f"[learning] phase 38 {out['phase_seconds']:.1f} s")
    return out


# -- phase 39: the big registry variant at full size ----------------------------------

BIG_VARIANT, BIG_BATCH, BIG_STEPS = "LightningDiT-1p6B/1", 8, 2
BIG_PATH_DEPTH = 4


def run_big_variant(seed: int, device_info: dict) -> dict:
    """Phase 39: (a) ``big_variant``'s body on the full-size 1p6B/1 at batch
    8, #1 and #2 counted over its run, the state's bytes held to 14 an
    element and the gradients' to 4; (b) the loss gradients of a 1p6B-width
    DiT cut to depth 4 with both kernels against plain attention."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reset_counts()
    rec = big_variant.run(BIG_VARIANT, BIG_BATCH, BIG_STEPS, seed, "cuda")
    got = counts()
    depth = dit._VARIANTS["1p6B"]["depth"]
    expect_counts(got, {"nat_attention_fwd": BIG_STEPS * 2 * depth,
                        "nat_attention_bwd": BIG_STEPS * depth}, "phase 39 big_variant")
    n = rec["params"]
    want = {part: n * size for part, size in big_variant.PART_BYTES.items()}
    held = {part: v["measured"] for part, v in rec["state_bytes"].items()}
    if held != want or rec["largest_param_shape"] != [10752, 1792]:
        fail(f"phase 39: state bytes {held}, expected {want}; largest parameter "
             f"{rec['largest_param_shape']}")
    log(f"[big] {BIG_VARIANT} ({n:,} parameters) batch {BIG_BATCH}, {BIG_STEPS} steps: loss "
        f"{rec['loss_step1']:.4f} → {rec['loss_step2']:.4f}, init {rec['init_s']:.2f} s, steps "
        f"{rec['first_step_s']:.3f} / {rec['second_step_s']:.3f} s, {rec['ms_per_step']:.2f} "
        f"ms/step, {rec['img_per_s']:.2f} img/s, peak {rec['peak_bytes'] / 2**30:.2f} GiB, "
        f"state {sum(want.values()) - want['grads']:,} B + gradients {want['grads']:,} B, "
        f"launches per step {rec['launches_per_step']} [{device_info['smi']}]")
    torch.cuda.empty_cache()
    cfg = Config(PRODUCTION).merged_with({"model": {"model_type": BIG_VARIANT}})
    with variant_depth("1p6B", BIG_PATH_DEPTH):
        model = create_dit(cfg.model, 16, cfg.data.num_classes, device="cuda")
    randomize_(model, seed)
    path = phase_train_path(cfg, model, seed, what=f"{BIG_VARIANT}-width")
    del model
    torch.cuda.empty_cache()
    out = {"command": rec, "train_path": path, "phase_seconds": time.perf_counter() - t0}
    log(f"[big] phase 39 {out['phase_seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every measured number to this JSON file")
    ap.add_argument("--phase36", action="store_true",
                    help="run only the device check and phase 36 (WebP, BMP, the t-SNE)")
    ap.add_argument("--phase37", action="store_true",
                    help="run only the device check and phase 37 (GIF, TIFF, PNM, ICO)")
    ap.add_argument("--phase38", action="store_true",
                    help="run only the device check, the build and phase 38 (the learning "
                         "check and the e2e smoke)")
    ap.add_argument("--phase33", action="store_true",
                    help="run only the device check, the build, phase 3 at a tensor-parallel "
                         "rank's shapes and phase 33 (the multi-device paths)")
    ap.add_argument("--phase39", action="store_true",
                    help="run only the device check, the build, phase 3 at the big variants' "
                         "shapes and phase 39 (LightningDiT-1p6B/1 at full size)")
    ap.add_argument("--dist-case", help=argparse.SUPPRESS)  # a rank of phase 33's worlds
    ap.add_argument("--dist-work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.dist_case:
        _dist_worker(args.dist_case, args.dist_work)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    device = phase_device()
    if args.phase36:
        work = tempfile.mkdtemp(prefix="chip_smoke_p36_")
        try:
            images_tsne = phase_images_tsne(SEED, device, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": device, "images_tsne": images_tsne}, f, indent=1)
        return 0
    if args.phase37:
        work = tempfile.mkdtemp(prefix="chip_smoke_p37_")
        try:
            other_images = phase_other_images(SEED, device, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": device, "other_images": other_images}, f, indent=1)
        return 0
    builds = phase_build()
    if args.phase38:
        learning = run_learning(device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": device, "build": builds, "learning": learning}, f, indent=1)
        return 0
    if args.phase33:
        kernels = phase_kernels(SEED, TP4_CASES)
        kernels.update(phase_bwd_kernel(SEED, TP4_CASES))
        multidevice = run_multidevice(SEED, device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": device, "build": builds, "kernels": kernels,
                           "multidevice": multidevice}, f, indent=1)
        return 0
    if args.phase39:
        kernels = phase_kernels(SEED, BIG_CASES)
        kernels.update(phase_bwd_kernel(SEED, BIG_CASES))
        big = run_big_variant(SEED, device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": device, "build": builds, "kernels": kernels,
                           "big_variant": big}, f, indent=1)
        return 0
    kernels = phase_kernels(SEED)
    kernels.update(phase_bwd_kernel(SEED))
    kernels.update(phase_small_kernels(SEED))
    kernels.update(phase_long_kernel(SEED))
    kernels.update(phase_fp32_kernels(SEED))
    production = run_paths("production", device)
    qknorm = run_paths("qknorm", device)
    no_rope = phase_no_rope(SEED)
    hires = phase_hires(SEED, device)
    samplers = run_samplers(SEED, device)
    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    io_work = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        tokenizer = run_tokenizer(SEED, device, keep)
        imagenet_root = os.path.join(io_work, "imagenet")
        manifest = write_imagenet_tree(imagenet_root)
        vae_training = run_vae_training(SEED, device, keep, imagenet_root)
        apps = run_microdoppler_apps(SEED, device)
        tools = run_tools(SEED, device, keep)
        multidevice = run_multidevice(SEED, device)
        data_io = phase_imagenet(SEED, device, io_work, imagenet_root, manifest)
        data_io["vae"] = vae_training["train"].pop("imagenet")
        commands = phase_commands(SEED, device, os.path.join(keep, "extract_fp32"))
        images_tsne = phase_images_tsne(SEED, device, io_work)
        other_images = phase_other_images(SEED, device, io_work)
        learning = run_learning(device)
        big = run_big_variant(SEED, device)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(io_work, ignore_errors=True)

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
                       "vae_training": vae_training, "apps": apps, "tools": tools,
                       "multidevice": multidevice, "data_io": data_io, "commands": commands,
                       "images_tsne": images_tsne, "other_images": other_images,
                       "learning": learning, "big_variant": big,
                       "seconds": time.perf_counter() - t0},
                      f, indent=1)
    log(f"[run] phases 1-39: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

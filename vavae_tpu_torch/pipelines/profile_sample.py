"""Where the time of the sampling path goes, on the card.

    python -m vavae_tpu_torch.pipelines.profile_sample [--qknorm] [--image_size S]
        [--batch B] [--out FILE.json]

Profiles (torch.profiler, CUDA activity) the LightningDiT-XL/1 bf16 forward
at the two batch sizes of the split-CFG euler program (2B in the CFG phase,
B in the cond-only phase; B = 8 by default) and the f16d32 VA-VAE decode at
batch B, with seeded random weights, at ``--image_size`` (256 by default:
16×16 latents; 1024 gives 64×64 latents, N = 4,096 tokens, where attention
takes the long route). For each it prints the device time per forward by
kernel class (the attention kernel, matrix products, everything else), the
wall time of the window and the device's busy share of it. Where attention
takes the long route (N > 1024), it also times the route's rotation outside
the kernel alone (``rope_uncast`` of q and k with the fp32 tables, as
``_LongAttention`` runs it on the strided views of the projection), per
forward: its share of the "other" class. ``--qknorm`` profiles the
production model with ``use_qknorm: true`` instead.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.ops.flash_attention import SMALL_SEQ_MAX, rope_uncast
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.weights import randomize_

XL1 = {"model_type": "LightningDiT-XL/1", "use_qknorm": False, "use_swiglu": True,
       "use_rope": True, "use_rmsnorm": True, "wo_shift": False, "in_chans": 32, "bf16": True}
_GEMM = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "attn_fwd" in low or "flash_fwd" in low:  # the forward bodies of every entry
        return "attention_kernel"
    if "attn_bwd" in low:  # attention_bwd.cuh
        return "attention_bwd_kernel"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "foreach"  # the optimizer's and the EMA's fused list updates
    if "fprop" in low or "conv" in low:
        return "conv"
    if any(k in low for k in _GEMM):
        return "matmul"
    return "other"


def profile(fn, reps: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel class, wall ms per call and
    the busy share (device kernel time over wall time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_class: dict[str, float] = {}
    top: list[tuple[float, str]] = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        ms = us / 1e3 / reps
        by_class[kernel_class(ev.key)] = by_class.get(kernel_class(ev.key), 0.0) + ms
        top.append((ms, ev.key))
    device = sum(by_class.values())
    top.sort(reverse=True)
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "by_class_ms": by_class, "top": [[n[:90], t] for t, n in top[:8]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qknorm", action="store_true", help="the model with use_qknorm: true")
    ap.add_argument("--image_size", type=int, default=256, help="data.image_size (f16 VAE)")
    ap.add_argument("--batch", type=int, default=8, help="the sampler's per-batch size")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    seed = 0
    dev = resolve_device("cuda")
    s = args.image_size // 16
    model = create_dit(dict(XL1, use_qknorm=args.qknorm), s, 1000, device=dev).eval()
    randomize_(model, seed)
    vae = VA_VAE(embed_dim=32, img_size=args.image_size, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {"device": torch.cuda.get_device_name(0), "qknorm": args.qknorm,
               "image_size": args.image_size, "tokens": s * s}
    with torch.inference_mode():
        for B in (2 * args.batch, args.batch):
            x = torch.randn((B, s, s, 32), generator=gen, device=dev)
            t = torch.rand((B,), generator=gen, device=dev)
            y = torch.randint(0, 1000, (B,), generator=gen, device=dev)
            fwd = results[f"dit_forward_b{B}"] = profile(lambda: model(x, t, y))
            if s * s > SMALL_SEQ_MAX and model.use_rope:
                D = model.rope_cos.shape[-1]  # the head dim
                qkv = torch.randn((B, s * s, 3, model.num_heads, D), generator=gen, device=dev)
                qkv = qkv.to(torch.bfloat16)
                rot = profile(lambda: [rope_uncast(qkv[:, :, i], model.rope()) for i in range(2)])
                fwd["rope_uncast_ms"] = rot["device_ms"] * model.depth
        z = torch.randn((args.batch, s, s, 32), generator=gen, device=dev)
        results[f"vae_decode_b{args.batch}"] = profile(lambda: vae.decode(z))
    for key, r in results.items():
        print(key, json.dumps(r) if isinstance(r, dict) else r, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

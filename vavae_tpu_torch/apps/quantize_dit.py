"""Post-training INT8 quantization of a DiT checkpoint (port of
``vavae_tpu/apps/quantize_dit.py``).

Per-output-channel symmetric int8 Linear weights (``ops/quant.py``); the
report gives the fp and int8 sizes, the compression, the fp and
dequantized forward latency and the mean relative output deviation.
``--sample_check N`` samples N latents with the config's sampler twice from
the same noise, once with the fp weights and once with the dequantized
ones, and reports their deviation. ``--out`` writes the int8 tree in the
JAX package's layout and keys (``quantize_params`` of the JAX param tree),
which the JAX package restores with ``quantize_params(eval_shape)`` as the
target and ``load_int8`` here reads back. Runs on the card unless
``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.quantize_dit --config CFG.yaml --ckpt DIT.safetensors \\
        --sample_check 4 --out dit_int8.safetensors
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.models.dit import create_dit
from vavae_tpu_torch.ops.quant import (
    DEFAULT_TARGETS,
    benchmark_quantization,
    dequantize_params,
    quantize_params,
)
from vavae_tpu_torch.utils.config import load_config
from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.safetensors_io import (
    flatten,
    tree_metadata,
    unflatten,
    write_safetensors,
)
from vavae_tpu_torch.utils.weights import dit_state_from_jax, dit_state_to_jax


def save_int8(path: str, qparams: dict) -> str:
    """The int8 tree as the JAX package's ``save_state_file`` writes it."""
    write_safetensors(path, flatten(dit_state_to_jax(qparams)), tree_metadata())
    return path


def load_int8(path: str) -> dict:
    """An int8 DiT file (either package's) → the port's names: int8 leaves
    ``{"values" (out, in), "scales" (out, 1)}``, the rest fp32 tensors."""
    from vavae_tpu_torch.train.checkpoint import read_state_file

    return dit_state_from_jax(unflatten(read_state_file(path)))


def example_inputs(cfg, batch: int, latent_size: int, channels: int, dev: torch.device):
    """The benchmark's forward inputs: x ~ N(0, 1) from seed 1 (drawn on the
    CPU, so every device gets the same), t evenly over [0.1, 0.9], labels
    0, 1, … modulo the classes."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((batch, latent_size, latent_size, channels), generator=gen).to(dev)
    t = torch.linspace(0.1, 0.9, batch, device=dev)
    y = torch.arange(batch, device=dev) % cfg.data.num_classes
    return x, t, y


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="DiT config yaml")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (.safetensors/.msgpack/.pt); default cfg.ckpt_path")
    ap.add_argument("--targets", default=",".join(DEFAULT_TARGETS),
                    help="comma-separated kernel-name suffixes to quantize")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sample_check", type=int, default=0,
                    help="ODE-sample N latents with fp vs dequantized weights "
                         "and report the deviation")
    ap.add_argument("--out", default=None,
                    help="write the int8 checkpoint here (.safetensors, the JAX "
                         "package's tree; it restores there with "
                         "quantize_params(eval_shape) as the target)")
    ap.add_argument("--report", default=None, help="JSON report path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.config, overrides=args.overrides)
    latent_size = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent_size, cfg.data.num_classes, device=dev).eval()
    ckpt: Optional[str] = args.ckpt or cfg.get("ckpt_path")
    if ckpt:
        from vavae_tpu_torch.pipelines.sample import load_dit_params

        load_dit_params(model, ckpt)
    else:
        print("no checkpoint given — benchmarking with random-init weights")
    params = {k: v.detach() for k, v in model.named_parameters()}

    targets = tuple(t for t in args.targets.split(",") if t)
    x, t, y = example_inputs(cfg, args.batch_size, latent_size, model.in_channels, dev)

    def apply_fn(p, x, t, y):
        return torch.func.functional_call(model, p, (x, t, y))

    report = benchmark_quantization(apply_fn, params, (x, t, y), targets=targets, reps=args.reps)

    qparams = None
    if args.sample_check:
        from vavae_tpu_torch.pipelines.sample import build_sample_fn

        labels = torch.arange(args.sample_check, device=dev) % cfg.data.num_classes
        generate = build_sample_fn(cfg, model, device=dev)
        seed = cfg.train.get("global_seed", 0)

        def sample() -> np.ndarray:
            gen = torch.Generator(device=dev).manual_seed(seed)  # the same noise each time
            return generate(labels, generator=gen).float().cpu().numpy()

        fp_lat = sample()
        qparams, _ = quantize_params(params, targets)
        saved = {k: v.clone() for k, v in params.items()}
        with torch.no_grad():
            model.load_state_dict(dequantize_params(qparams), strict=True)
            q_lat = sample()
            model.load_state_dict(saved, strict=True)
        denom = float(np.sqrt((fp_lat**2).mean())) or 1.0
        report["sample_latent_rel_l2"] = float(np.sqrt(((fp_lat - q_lat) ** 2).mean())) / denom
        report["sample_latent_max_abs"] = float(np.abs(fp_lat - q_lat).max())

    if args.out:
        if qparams is None:
            qparams, _ = quantize_params(params, targets)
        save_int8(args.out, qparams)
        report["int8_checkpoint"] = args.out

    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()

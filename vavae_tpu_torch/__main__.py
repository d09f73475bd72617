"""The port's command index: ``python -m vavae_tpu_torch [command] [args...]``.

The JAX package's 22 commands (``vavae_tpu/__main__.py``), each pointing at
the port's module, and the port's own profiling pipelines.
``python -m vavae_tpu_torch`` lists them; ``python -m vavae_tpu_torch
sample --demo ...`` is ``python -m vavae_tpu_torch.pipelines.sample --demo
...``. Exit codes: 0, 1 without a command, 2 for an unknown one, else the
command's own.
"""
from __future__ import annotations

import importlib
import sys

_P, _A = "vavae_tpu_torch.pipelines.", "vavae_tpu_torch.apps."

# command -> (module, one-line description)
COMMANDS = {
    # pipelines
    "extract_features": (_P + "extract_features", "images -> latent safetensors shards + stats"),
    "train_dit": (_P + "train_dit", "train/finetune LightningDiT on latent shards"),
    "sample": (_P + "sample", "CFG sampling / FID-50k PNGs / --demo grids"),
    "evaluate_tokenizer": (_P + "evaluate_tokenizer", "tokenizer rFID/PSNR/LPIPS/SSIM"),
    "train_vavae": (_P + "train_vavae", "VA-VAE GAN+VF training (staged recipes)"),
    # tools
    "fid": ("vavae_tpu_torch.eval.fid", "FID between two paths; stats/npz packers"),
    # micro-Doppler application layer
    "prepare_dataset_split": (_A + "prepare_dataset_split", "per-user 8:2 split JSON"),
    "convert_latents": (_A + "convert_latents", "legacy .pt latent dumps -> official shards"),
    "train_classifier": (_A + "train_classifier",
                         "user classifier (baseline/improved/calibrated/domain_adaptive)"),
    "classifier_eval": (_A + "classifier_eval", "classifier reliability verdict on real data"),
    "generate_and_filter": (_A + "generate_and_filter",
                            "rejection-sampling loop with quality gates"),
    "generation_evaluator": (_A + "generation_evaluator", "identity/diversity/coverage composite"),
    "analyze_metrics": (_A + "analyze_metrics", "filtering-metric distributions + thresholds"),
    "select_users": (_A + "select_users", "pick users by classifier stats"),
    "iterative_finetune": (_A + "iterative_finetune", "generate -> filter -> re-train loop"),
    "lora_finetune": (_A + "lora_finetune", "LoRA adapters on a frozen DiT"),
    "quantize_dit": (_A + "quantize_dit", "INT8 post-training quantization harness"),
    "autotune_sampler": (_A + "autotune_sampler",
                         "measure accelerations on YOUR model, recommend a sample: block"),
    "validate_export": (_A + "validate_export",
                        "VAE recon/VF/discrimination report + encoder export"),
    "domain_adaptation": (_A + "domain_adaptation", "LCCS/PNC/NCC adaptation + grid search"),
    "preflight": (_A + "preflight", "config doctor: shapes, weights, datasets, outputs"),
    "export_torch": (_A + "export_torch",
                     "export checkpoints BACK to the reference's torch formats"),
    # the port's profilers (the card)
    "profile_sample": (_P + "profile_sample", "device time of sampling by kernel class"),
    "profile_train": (_P + "profile_train", "device time of a train step by kernel class"),
    "profile_attention_fwd": (_P + "profile_attention_fwd",
                              "attention forward bodies with parts taken out"),
}


def main() -> int:
    argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        width = max(map(len, COMMANDS))
        print("usage: python -m vavae_tpu_torch <command> [args...]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:<{width}}  {desc}")
        print("\n`python -m vavae_tpu_torch <command> --help` for per-command flags;"
              "\nthe commands that compute run on the card unless given --device cpu.")
        return 0 if argv else 1
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r} — run `python -m vavae_tpu_torch` for the list",
              file=sys.stderr)
        return 2
    module = importlib.import_module(COMMANDS[cmd][0])
    sys.argv = [f"python -m {COMMANDS[cmd][0]}"] + argv[1:]
    ret = module.main()
    # mains return their results (dicts, states) or an exit code
    return ret if isinstance(ret, int) and not isinstance(ret, bool) else 0


if __name__ == "__main__":
    sys.exit(main())

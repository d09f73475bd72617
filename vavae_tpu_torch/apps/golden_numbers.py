"""The golden-numbers runbook (port of ``scripts/golden_numbers.py``;
``docs/GOLDEN_NUMBERS.md``): the runs that reproduce the reference's
headline numbers (tokenizer rFID, PSNR, SSIM and LPIPS; latent extraction;
FID-50k sampling) once the released artifacts are on disk.

Artifacts, by environment variable:
  VAVAE_GN_VAE_CKPT       vavae-imagenet256-f16d32-dinov2.pt
  VAVAE_GN_DIT_CKPT       lightningdit-xl-imagenet256-{64,800}ep.pt
  VAVAE_GN_IMAGENET_VAL   ImageNet val dir (synset folders)
  VAVAE_GN_IMAGENET_TRAIN ImageNet train dir (optional; extraction)
  VAVAE_GN_FID_NPZ        VIRTUAL_imagenet256_labeled.npz
  VAVAE_FID_WEIGHTS       pt_inception-2015-12-05 weights
  VAVAE_LPIPS_WEIGHTS     taming vgg.pth (lin heads; full dumps also work)
  VAVAE_VGG16_WEIGHTS     torchvision vgg16 state dict (needed with the
                          genuine vgg.pth, which has no conv backbone)

    python -m vavae_tpu_torch golden_numbers --check       # the host: layout and loaders
    python -m vavae_tpu_torch golden_numbers [--config CFG] [--skip_*] [--device cpu]

``--check`` needs no card: it loads each checkpoint through the port's
own loaders (the Inception and LPIPS weights, the VA-VAE through
``VA_VAE``, the DiT's key layout against ``--config``'s model) and checks
the port's committed whole-workflow record (``docs/torch_e2e_workflow.json``,
from ``e2e_onchip``). Without it, the legs run on the card (``--device cpu``
for the CPU) through ``python -m vavae_tpu_torch``: ``evaluate_tokenizer``
(reconstructions dumped, so rFID is computed), ``extract_features`` (with
``VAVAE_GN_IMAGENET_TRAIN``), ``sample`` with the FID against the
reference batch, and the sampler gauge: ``autotune_sampler`` on the DiT
checkpoint, which ranks the acceleration ladder against its exact
euler-250 samples (where the JAX runbook calls its TPU benchmark
``scripts/bench_sampler_quality.py``). ``--image_size``, ``--max_images``
and ``--tokenizer_config`` rehearse the legs at a small size.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CONFIG = "vavae_tpu_torch/configs/reproductions/lightningdit_xl_vavae_f16d32_800ep_cfg.yaml"
E2E_RECORD = os.path.join("docs", "torch_e2e_workflow.json")
E2E_STAGES = ("dataset", "train_vavae", "extract_features", "train_dit", "sample",
              "evaluate_tokenizer", "gauge_fid")

REQUIRED = {
    "VAVAE_GN_VAE_CKPT": "VA-VAE f16d32 checkpoint (.pt/.ckpt)",
    "VAVAE_GN_DIT_CKPT": "LightningDiT-XL checkpoint (.pt)",
    "VAVAE_GN_IMAGENET_VAL": "ImageNet val dir",
    "VAVAE_GN_FID_NPZ": "ADM reference npz",
    "VAVAE_FID_WEIGHTS": "pytorch-fid Inception weights",
    "VAVAE_LPIPS_WEIGHTS": "taming vgg.pth",
}


def _probe(what: str, fn) -> bool:
    """Run one loader; report it, and any error it raises, as a line."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - a report, not a recovery
        print(f"BAD     {what}: {type(e).__name__}: {e}")
        return False
    print(f"ok      {what}")
    return True


def _load_vae(tokenizer_config: str | None) -> None:
    from vavae_tpu_torch.tokenizer import VA_VAE

    VA_VAE(tokenizer_config, ckpt_path=os.environ["VAVAE_GN_VAE_CKPT"], device="cpu")


def _load_dit(config: str) -> None:
    """The checkpoint through ``load_dit_params`` into ``config``'s model
    built on the meta device: names and shapes checked, no memory taken."""
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines.sample import load_dit_params
    from vavae_tpu_torch.utils.config import load_config

    cfg = load_config(config)
    latent = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device="meta")
    with warnings.catch_warnings():  # copies into meta tensors are no-ops, and say so
        warnings.simplefilter("ignore", UserWarning)
        load_dit_params(model, os.environ["VAVAE_GN_DIT_CKPT"])


def check_e2e_record(path: str) -> None:
    """The whole-workflow record is well-formed: every stage with a finite
    wall time, the commit stamped."""
    with open(path) as f:
        doc = json.load(f)
    for stage in E2E_STAGES:
        if stage not in doc["stages"]:
            raise ValueError(f"stage {stage} missing")
        wall = doc["stages"][stage]["wall_s"]
        if not (math.isfinite(wall) and wall >= 0):
            raise ValueError(f"stage {stage}: wall_s {wall}")
    if not doc.get("sha"):
        raise ValueError("the e2e record is not sha-stamped")


def check(config: str = DEFAULT_CONFIG, tokenizer_config: str | None = None) -> bool:
    """Every required artifact present and loadable by the port (on the
    host: no card needed), and the committed e2e record well-formed."""
    ok = True
    for var, what in REQUIRED.items():
        path = os.environ.get(var)
        if not path or not os.path.exists(path):
            print(f"MISSING {var} ({what}): {path!r}")
            ok = False
        else:
            print(f"ok      {var} -> {path}")
    if not ok:
        return False
    from vavae_tpu_torch.eval.inception import load_inception
    from vavae_tpu_torch.models.lpips import load_lpips

    ok = _probe("FID Inception weights load", lambda: load_inception(
        os.environ["VAVAE_FID_WEIGHTS"], device="cpu"))
    # the genuine vgg.pth holds the lin heads only: the convolutions come
    # from VAVAE_VGG16_WEIGHTS (a full-module dump needs none)
    ok &= _probe("LPIPS weights load", lambda: load_lpips(
        os.environ["VAVAE_LPIPS_WEIGHTS"], os.environ.get("VAVAE_VGG16_WEIGHTS"), device="cpu"))
    ok &= _probe("VA-VAE checkpoint loads", lambda: _load_vae(tokenizer_config))
    ok &= _probe(f"DiT checkpoint loads into {config}'s model",
                 lambda: _load_dit(os.path.join(REPO, config)))
    record = os.path.join(REPO, E2E_RECORD)
    if os.path.exists(record):
        ok &= _probe(f"e2e workflow record {E2E_RECORD}", lambda: check_e2e_record(record))
    else:
        print(f"note    {E2E_RECORD} absent: run `python -m vavae_tpu_torch e2e_onchip` on "
              "the card to create the whole-workflow record")
    if ok:
        print("all artifacts present: run without --check to execute")
    return ok


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--latents", default="output/golden/latents")
    ap.add_argument("--workdir", default="output/golden",
                    help="tokenizer-eval PNG dump + metrics json land here; the PNG dump is "
                         "needed for rFID (evaluate_tokenizer computes it between the dumped "
                         "ref/dec folders)")
    ap.add_argument("--skip_tokenizer", action="store_true")
    ap.add_argument("--skip_extraction", action="store_true")
    ap.add_argument("--skip_sampling", action="store_true",
                    help="stop after tokenizer/extraction (rFID rehearsals)")
    ap.add_argument("--skip_gauge", action="store_true",
                    help="skip the sampler gauge (autotune_sampler) on the real model")
    # rehearsal knobs: the tests drive the real legs at a tiny scale
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--tokenizer_config", default=None,
                    help="tokenizer yaml (ddconfig honored); default = the f16d32 "
                         "production architecture")
    ap.add_argument("--device", default="cuda", help="the legs' device (cuda or cpu)")
    args = ap.parse_args(argv)

    if not check(args.config, args.tokenizer_config):
        return 1
    if args.check:
        return 0
    from vavae_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no CUDA: raises unless --device cpu
    env = os.environ
    cli = [sys.executable, "-m", "vavae_tpu_torch"]
    dev = ["--device", args.device]
    if not args.skip_tokenizer:
        cmd = cli + ["evaluate_tokenizer", "--vae_ckpt", env["VAVAE_GN_VAE_CKPT"],
                     "--data_path", env["VAVAE_GN_IMAGENET_VAL"],
                     "--image_size", str(args.image_size),
                     "--output_path", os.path.join(args.workdir, "tokenizer"),
                     "--metrics_json", os.path.join(args.workdir, "tokenizer_metrics.json")]
        if args.tokenizer_config:
            cmd += ["--config", args.tokenizer_config]
        if args.max_images:
            cmd += ["--max_images", str(args.max_images)]
        run(cmd + dev)
    if not args.skip_extraction and env.get("VAVAE_GN_IMAGENET_TRAIN"):
        cmd = cli + ["extract_features", "--data_path", env["VAVAE_GN_IMAGENET_TRAIN"],
                     "--output_path", args.latents, "--vae_ckpt", env["VAVAE_GN_VAE_CKPT"],
                     "--image_size", str(args.image_size)]
        if args.tokenizer_config:
            cmd += ["--config", args.tokenizer_config]
        run(cmd + dev)
    if args.skip_sampling:
        return 0
    # fail fast: the 800ep config has latent_norm: true, and sampling needs
    # the latents' stats to un-normalise; without them hours of card time
    # would go to wrongly scaled samples and a meaningless FID
    if not os.path.isdir(os.path.join(REPO, args.latents)):
        sys.exit(
            f"latents dir not found: {args.latents} — the sampling config needs its latent "
            "stats for de-normalization. Run the extraction step first (set "
            "VAVAE_GN_IMAGENET_TRAIN and drop --skip_extraction), or pass --latents at an "
            "existing dump."
        )
    run(cli + ["sample", "--config", args.config, f"ckpt_path={env['VAVAE_GN_DIT_CKPT']}",
               f"vae.ckpt_path={env['VAVAE_GN_VAE_CKPT']}", f"data.data_path={args.latents}",
               f"data.fid_reference_file={env['VAVAE_GN_FID_NPZ']}"] + dev)
    if not args.skip_gauge:
        # the acceleration ladder on the real model, against its exact
        # euler-250 samples
        run(cli + ["autotune_sampler", "--config", args.config,
                   "--ckpt", env["VAVAE_GN_DIT_CKPT"],
                   "--out", os.path.join(args.workdir, "sampler_gauge.json")] + dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The whole workflow on the card in one command (port of
``scripts/e2e_onchip.py``): the port's real CLIs chained at small but not
toy scale, with one metrics JSON.

  0. dataset: a procedural, class-structured image set (8 classes of
     Gaussian blobs over a class-specific stripe, 256²), 4,096 train and
     128 val PNGs written by ``utils/png.py``;
  1. VA-VAE GAN training, ``train_vavae``: the f16d32 architecture for
     2,048 steps, the GAN on from step 500, VF on the weight-free
     ``dinov2-tiny`` testbed; then the trained generator exported as a
     params file that ``VA_VAE(ckpt_path=...)`` loads;
  2. latent extraction, ``extract_features``, with the trained VAE;
  3. DiT-S/2 training, ``train_dit``, 2,000 steps on those latents;
  4. production sampling, ``sample``: 256 images, euler-250 split-CFG,
     decoded through the trained VAE to PNGs;
  5. tokenizer evaluation, ``evaluate_tokenizer`` on the val images;
  6. gauge FID: decoded samples against the real val images, a Fréchet
     distance over 4×4-pooled pixels through a seeded projection (no
     Inception weights needed), beside the interleaved real-vs-real floor
     and the generated-vs-real distance at the floor's n.

    python -m vavae_tpu_torch e2e_onchip [--workdir DIR] [--out F.json]   # the card
    python -m vavae_tpu_torch e2e_onchip --smoke --device cpu             # tiny, on the CPU

Each CLI stage is a subprocess ``python -m vavae_tpu_torch <command>
--device <device>``, timed on its own, its log in ``<workdir>/logs``.
Without CUDA the command raises unless ``--device cpu`` is passed: nothing
falls back to the CPU. The record (``--out``; by default
``docs/torch_e2e_workflow.json``, or the workdir's ``e2e_workflow.json``
with ``--smoke``) holds each stage's wall time, command and metrics, the
commit (from git, or ``--sha`` in a copy without git metadata), a hash of
the port's sources, and the card's name and power limit. It is written
after every stage, so a failed run keeps what it measured; on a kept
``--workdir`` a stage whose outputs are complete and whose entry is in the
record is not run again, so a run cut short goes on where it stopped.

Not ported: the JAX script's ``--export_gauge``, which copies the trained
VAE for the TPU benchmark of its inference (``scripts/bench_vae_infer.py``).
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT_CONFIGS = os.path.join(REPO, "vavae_tpu_torch", "configs")
STAGES = ("dataset", "train_vavae", "export_vae_params", "extract_features", "train_dit",
          "sample", "evaluate_tokenizer", "gauge_fid")
# the gauge: 4×4 mean-pooled pixels through a fixed random projection
GAUGE_POOL, GAUGE_FEATURES, GAUGE_SEED = 4, 192, 43


def _class_images(c: int, split: str, per_class: int, size: int) -> np.ndarray:
    """Class ``c``'s images of ``split`` (uint8, (per_class, size, size, 3)):
    the JAX script's arrays, operation for operation."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rng = np.random.default_rng(1000 * c + (0 if split == "train" else 1))
    # class identity: blob grid layout + stripe frequency/phase
    k = 2 + c % 4
    freq = 2 + c
    out = np.empty((per_class, size, size, 3), np.uint8)
    for i in range(per_class):
        img = 0.35 * np.sin(
            2 * np.pi * freq * (xx * np.cos(c) + yy * np.sin(c))
        )[..., None] * np.ones(3, np.float32)
        for bx in range(k):
            for by in range(k):
                cx = (bx + 0.5) / k + rng.normal(0, 0.03)
                cy = (by + 0.5) / k + rng.normal(0, 0.03)
                s = 0.5 / k * (1 + 0.2 * rng.normal())
                amp = rng.uniform(-1, 1, 3)
                g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
                img += g[..., None] * amp
        out[i] = ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8)
    return out


def make_dataset(root: str, n_classes: int, per_class_train: int, per_class_val: int,
                 size: int, threads: int = 8) -> None:
    """``root/{train,val}/c{k}/{i:04d}.png``: the JAX script's images pixel
    for pixel (each class draws from its own ``default_rng(1000·c + split)``),
    the classes made on a thread pool (numpy releases the interpreter lock)
    and written by the port's PNG writer."""
    from vavae_tpu_torch.utils.png import write_pngs

    def one(task):
        split, per_class, c = task
        d = os.path.join(root, split, f"c{c}")
        os.makedirs(d, exist_ok=True)
        images = _class_images(c, split, per_class, size)
        write_pngs(images, [os.path.join(d, f"{i:04d}.png") for i in range(per_class)])

    tasks = [(split, per_class, c)
             for split, per_class in (("train", per_class_train), ("val", per_class_val))
             for c in range(n_classes)]
    with ThreadPoolExecutor(max(1, threads)) as pool:
        for _ in pool.map(one, tasks):  # raises a task's error
            pass


def run_stage(name: str, cmd: list, logdir: str, doc: dict, timeout: int = 7200) -> str:
    """Run one CLI stage with its output in ``logdir/<name>.log``, record its
    wall time and command; returns the log's last 1,500 characters."""
    print(f"=== e2e stage: {name} ===\n$ {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    log = os.path.join(logdir, f"{name}.log")
    with open(log, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=REPO, timeout=timeout)
    wall = time.perf_counter() - t0
    with open(log) as f:
        tail = f.read()[-1500:]
    if p.returncode != 0:
        print(tail, flush=True)
        raise RuntimeError(f"stage {name} failed rc={p.returncode} ({log})")
    doc["stages"][name] = {"wall_s": round(wall, 1), "cmd": " ".join(cmd), "metrics": {}}
    print(f"=== {name}: ok in {wall:.1f}s ===", flush=True)
    return tail


def export_generator(ckpt: str, out: str) -> int:
    """The generator of a VA-VAE train state (``gen_params|vae|…``) as a
    params file that ``VA_VAE(ckpt_path=out)`` and ``extract_features
    --vae_ckpt`` load. Returns its count of tensors."""
    from vavae_tpu_torch.train.checkpoint import read_state_file
    from vavae_tpu_torch.utils.safetensors_io import tree_metadata, write_safetensors

    prefix = "gen_params|vae|"
    flat = {k[len(prefix):]: v for k, v in read_state_file(ckpt).items() if k.startswith(prefix)}
    if not flat:
        raise ValueError(f"{ckpt} holds no {prefix} leaves: expected a VA-VAE train state")
    write_safetensors(out, flat, tree_metadata())
    return len(flat)


def load_folder(folder: str, limit: int, size: int) -> np.ndarray:
    """The first ``limit`` PNGs under ``folder`` (sorted paths) as (n, size,
    size, 3) floats in [-1, 1], each BICUBIC-resized to ``size`` first
    (PIL's ``resize``; the identity at that size)."""
    from vavae_tpu_torch.utils.pil_resize import resize_uint8
    from vavae_tpu_torch.utils.png import read_image_rgb

    files = sorted(glob.glob(os.path.join(folder, "**", "*.png"), recursive=True))[:limit]
    return np.stack([resize_uint8(read_image_rgb(f), (size, size)).astype(np.float32)
                     / 127.5 - 1.0 for f in files])


def gauge_features(x: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) → (B, 192): 4×4 mean pooling, then the seeded projection."""
    B, H, W, C = x.shape
    P = GAUGE_POOL
    D = (H // P) * (W // P) * C
    proj = (np.random.default_rng(GAUGE_SEED).normal(size=(D, GAUGE_FEATURES)).astype(np.float32)
            / np.sqrt(D))
    pooled = x.reshape(B, H // P, P, W // P, P, C).mean((2, 4))
    return pooled.reshape(B, -1) @ proj


def gauge_fid(real: np.ndarray, fake: np.ndarray) -> dict:
    """The gauge between ``fake`` and ``real`` (n each), the floor of the
    real set against itself split interleaved (n/2 against n/2: the files
    sort by class, so halves would compare disjoint classes), and
    generated ``[0::2]`` against real ``[1::2]``, at the floor's n."""
    from vavae_tpu_torch.eval.fid import activation_statistics, frechet_distance

    def distance(a, b):
        return float(frechet_distance(*activation_statistics(gauge_features(a)),
                                      *activation_statistics(gauge_features(b))))

    floor = distance(real[0::2], real[1::2])
    matched = distance(fake[0::2], real[1::2])
    return {"gauge_fid_vs_real": distance(real, fake), "real_split_floor": floor,
            "gauge_fid_matched_n": matched, "matched_over_floor": matched / floor,
            "n": int(len(real)), "n_matched": int(len(real[1::2]))}


def source_hash() -> str:
    """sha256 over the port's sources (paths and bytes, sorted): names the
    code of a run made where git metadata is missing."""
    h = hashlib.sha256()
    root = os.path.join(REPO, "vavae_tpu_torch")
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        if os.path.isfile(path) and path.endswith((".py", ".cu", ".cuh", ".cpp", ".yaml")):
            h.update(os.path.relpath(path, REPO).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _git(*args: str) -> str | None:
    try:
        p = subprocess.run(["git", *args], capture_output=True, text=True, cwd=REPO, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() if p.returncode == 0 else None


def device_record(device) -> dict:
    """The card's ``nvidia-smi`` name and power limit and torch's name for
    it; on the CPU, the CPU."""
    import torch

    if device.type != "cuda":
        return {"smi": None, "name": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return {"smi": smi.stdout.strip().splitlines()[0],
            "name": torch.cuda.get_device_name(device)}


def sizes(smoke: bool) -> dict:
    if smoke:
        return {"n_classes": 2, "train_per_class": 8, "val_per_class": 4, "image_size": 32,
                "vae_epochs": 1, "dit_steps": 5, "sample_steps": 4, "fid_num": 4,
                "vae_batch": 4, "dit_batch": 4, "sample_batch": 2}
    # 2,048 VA-VAE steps as 4 epochs of 512 over 4,096 images (a checkpoint
    # an epoch), as in the JAX record
    return {"n_classes": 8, "train_per_class": 512, "val_per_class": 16, "image_size": 256,
            "vae_epochs": 4, "dit_steps": 2000, "sample_steps": 250, "fid_num": 256,
            "vae_batch": 8, "dit_batch": 32, "sample_batch": 32}


def vae_config(smoke: bool, img: int) -> dict:
    from vavae_tpu_torch.utils import yaml_io

    if smoke:
        return {"ckpt_path": None, "model": {
            "base_learning_rate": 1e-4, "params": {
                "monitor": "val/rec_loss", "embed_dim": 4,
                "lossconfig": {"params": {"disc_start": 2, "kl_weight": 1e-6,
                                          "disc_weight": 0.5}},
                "ddconfig": {"double_z": True, "z_channels": 4, "resolution": img,
                             "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 1],
                             "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}}}
    # the production f16d32 architecture; VF on the weight-free tiny testbed,
    # the GAN on early
    with open(os.path.join(PORT_CONFIGS, "vavae_f16d32.yaml")) as f:
        cfg = yaml_io.safe_load(f)
    cfg["model"]["params"]["use_vf"] = "dinov2-tiny"
    cfg["model"]["params"]["lossconfig"]["params"]["disc_start"] = 500
    return cfg


def dit_config(vae_cfg: dict, vae_cfg_path: str, vae_params_path: str, lat: str, W: str,
               sz: dict) -> dict:
    steps = sz["dit_steps"]
    return {
        "ckpt_path": None,
        "data": {"data_path": lat, "valid_path": None, "image_size": sz["image_size"],
                 "num_classes": sz["n_classes"], "latent_norm": True, "latent_multiplier": 1.0},
        # latent geometry follows the VAE: downsample 2^(len(ch_mult) - 1)
        "vae": {"model_name": "vavae_f16d32",
                "downsample_ratio": 2 ** (len(vae_cfg["model"]["params"]["ddconfig"]["ch_mult"])
                                          - 1),
                "config": vae_cfg_path, "ckpt_path": vae_params_path},
        "model": {"model_type": "LightningDiT-S/2", "use_qknorm": False, "use_swiglu": True,
                  "use_rope": True, "use_rmsnorm": True,
                  "in_chans": vae_cfg["model"]["params"]["embed_dim"],
                  "use_checkpoint": False, "class_dropout_prob": 0.1},
        "train": {"max_steps": steps, "global_batch_size": sz["dit_batch"], "global_seed": 0,
                  "output_dir": os.path.join(W, "dit_out"), "exp_name": "e2e",
                  "log_every": max(steps // 10, 1), "ckpt_every": steps, "resume": False,
                  "ema_decay": 0.995},
        "optimizer": {"lr": 2e-4, "beta2": 0.95, "max_grad_norm": 1.0, "weight_decay": 0.0},
        "transport": {"path_type": "Linear", "prediction": "velocity", "loss_weight": None,
                      "sample_eps": None, "train_eps": None, "use_lognorm": True,
                      "use_cosine_loss": True, "partitial_train": None, "partial_ratio": 1.0,
                      "shift_lg": False},
        "sample": {"mode": "ODE", "sampling_method": "euler", "atol": 1e-6, "rtol": 1e-3,
                   "reverse": False, "likelihood": False,
                   "num_sampling_steps": sz["sample_steps"], "cfg_scale": 4.0,
                   "per_proc_batch_size": sz["sample_batch"], "cfg_interval_start": 0.11,
                   "timestep_shift": 0.3, "fid_num": sz["fid_num"]},
    }


def _previous_stages(out_json: str, sz: dict) -> dict:
    """The stages of an earlier record at ``out_json`` with the same sizes."""
    try:
        with open(out_json) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        return {}
    return prev.get("stages", {}) if prev.get("sizes") == sz else {}


def _write_yaml(path: str, tree: dict) -> None:
    from vavae_tpu_torch.utils import yaml_io

    with open(path, "w") as f:
        yaml_io.safe_dump(tree, f)


def run_stages(doc: dict, dump: Callable[[], None], W: str, device: str, prev: dict) -> None:
    from vavae_tpu_torch.pipelines.train_vavae import stage_epochs_done

    sz = doc["sizes"]
    img, n_classes = sz["image_size"], sz["n_classes"]
    logdir, data = os.path.join(W, "logs"), os.path.join(W, "data")
    py = sys.executable
    cli = [py, "-m", "vavae_tpu_torch"]
    dev = ["--device", device]

    def finished(name: str, complete: bool) -> bool:
        """A stage already complete in the workdir keeps its recorded entry."""
        if complete and name in prev:
            doc["stages"][name] = dict(prev[name], reused=True)
            print(f"=== e2e stage: {name} complete in {W}: not run again ===", flush=True)
            return True
        return False

    # -- 0. dataset ------------------------------------------------------------
    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(data, "train")):
        make_dataset(data, n_classes, sz["train_per_class"], sz["val_per_class"], img)
    doc["stages"]["dataset"] = {
        "wall_s": round(time.perf_counter() - t0, 1),
        "metrics": {"train_images": n_classes * sz["train_per_class"],
                    "val_images": n_classes * sz["val_per_class"]}}
    dump()

    # -- 1. VA-VAE training ------------------------------------------------------
    vae_cfg = vae_config(doc["smoke"], img)
    vae_cfg_path = os.path.join(W, "vae.yaml")
    _write_yaml(vae_cfg_path, vae_cfg)
    vae_out = os.path.join(W, "vae_out")
    if not finished("train_vavae",
                    stage_epochs_done(os.path.join(vae_out, "stage1")) >= sz["vae_epochs"]):
        run_stage("train_vavae", cli + [
            "train_vavae", "--base", vae_cfg_path,
            "--data_path", os.path.join(data, "train"), "--val_path", os.path.join(data, "val"),
            "--output_dir", vae_out, "--batch_size", str(sz["vae_batch"]),
            "--stages", "single", "--allow_random_foundation",
            f"train.max_epochs={sz['vae_epochs']}"] + dev, logdir, doc)
    # the best-validation record
    best = sorted(glob.glob(os.path.join(vae_out, "**", "best", "metric.json"), recursive=True))
    if best:
        with open(best[-1]) as f:
            doc["stages"]["train_vavae"]["metrics"] = json.load(f)
    dump()

    # the newest checkpoint by path (best/ sorts after the stage's own, as
    # in the JAX script) → the generator's params file
    t0 = time.perf_counter()
    ckpts = sorted(glob.glob(os.path.join(vae_out, "**", "*.safetensors"), recursive=True))
    if not ckpts:
        raise RuntimeError(f"no VAE checkpoints under {vae_out}")
    vae_params_path = os.path.join(W, "vae_trained_params.safetensors")
    n_tensors = export_generator(ckpts[-1], vae_params_path)
    doc["stages"]["export_vae_params"] = {
        "wall_s": round(time.perf_counter() - t0, 1),
        "metrics": {"from_ckpt": ckpts[-1], "tensors": n_tensors}}
    dump()

    # -- 2. latent extraction ----------------------------------------------------
    lat = os.path.join(W, "latents")
    from vavae_tpu_torch.data.latent_dataset import STATS_FILE

    if not finished("extract_features", os.path.exists(os.path.join(lat, STATS_FILE))):
        run_stage("extract_features", cli + [
            "extract_features", "--config", vae_cfg_path, "--vae_ckpt", vae_params_path,
            "--data_path", os.path.join(data, "train"), "--output_path", lat,
            "--image_size", str(img), "--batch_size", str(max(sz["vae_batch"], 8))] + dev,
            logdir, doc)
    dump()

    # -- 3. DiT training ---------------------------------------------------------
    dit_cfg_path = os.path.join(W, "dit.yaml")
    _write_yaml(dit_cfg_path, dit_config(vae_cfg, vae_cfg_path, vae_params_path, lat, W, sz))
    dit_ckpt = os.path.join(W, "dit_out", "e2e", "checkpoints",
                            f"{sz['dit_steps']:07d}.safetensors")
    if not finished("train_dit", os.path.exists(dit_ckpt)):
        run_stage("train_dit", cli + ["train_dit", "--config", dit_cfg_path] + dev, logdir, doc)
    with open(os.path.join(logdir, "train_dit.log")) as f:
        tail = f.read()[-1500:]
    losses = re.findall(r"Train Loss: ([0-9.]+)", tail)
    rates = re.findall(r"Steps/Sec: ([0-9.]+)", tail)
    doc["stages"]["train_dit"]["metrics"] = {
        "final_train_loss": float(losses[-1]) if losses else None,
        "steps_per_sec": float(rates[-1]) if rates else None}
    if not os.path.exists(dit_ckpt):
        raise RuntimeError(f"train_dit left no checkpoint {dit_ckpt}")
    dump()

    # -- 4. production-config CFG sampling ---------------------------------------
    sample_dir = os.path.join(W, "samples")

    def pngs():
        return glob.glob(os.path.join(sample_dir, "*.png"))

    if not finished("sample", len(pngs()) >= sz["fid_num"]):
        run_stage("sample", cli + ["sample", "--config", dit_cfg_path, f"ckpt_path={dit_ckpt}",
                                   f"sample_folder={sample_dir}"] + dev, logdir, doc)
    n_png = len(pngs())
    doc["stages"]["sample"]["metrics"] = {
        "images": n_png,
        "samples_per_sec_incl_startup": round(n_png / doc["stages"]["sample"]["wall_s"], 3)}
    if n_png < sz["fid_num"]:
        raise RuntimeError(f"sample wrote {n_png} PNGs, expected {sz['fid_num']}")
    dump()

    # -- 5. tokenizer evaluation -------------------------------------------------
    tok_json = os.path.join(W, "tokenizer_eval.json")
    if not finished("evaluate_tokenizer", os.path.exists(tok_json)):
        run_stage("evaluate_tokenizer", cli + [
            "evaluate_tokenizer", "--config", vae_cfg_path, "--vae_ckpt", vae_params_path,
            "--data_path", os.path.join(data, "val"), "--image_size", str(img),
            "--metrics_json", tok_json] + dev, logdir, doc)
    with open(tok_json) as f:
        doc["stages"]["evaluate_tokenizer"]["metrics"] = json.load(f)
    dump()

    # -- 6. gauge FID: decoded samples vs real val images ------------------------
    t0 = time.perf_counter()
    n_fid = min(sz["fid_num"], n_classes * sz["val_per_class"])
    metrics = gauge_fid(load_folder(os.path.join(data, "val"), n_fid, img),
                        load_folder(sample_dir, n_fid, img))
    metrics["note"] = ("4x4-pooled seeded-projection Frechet (no Inception weights needed); "
                       "the floor is an interleaved real/real split at n/2, the matched "
                       "distance generated[0::2] against real[1::2] at the same n")
    doc["stages"]["gauge_fid"] = {"wall_s": round(time.perf_counter() - t0, 1),
                                  "metrics": metrics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="working tree (default: vavae_e2e[_smoke] under the temp directory); "
                         "kept, so a rerun skips the stages already complete there")
    ap.add_argument("--out", default=None,
                    help="the record (default docs/torch_e2e_workflow.json; with --smoke "
                         "the workdir's e2e_workflow.json)")
    ap.add_argument("--smoke", action="store_true", help="tiny sizes (a CPU drive)")
    ap.add_argument("--device", default="cuda", help="every stage's device (cuda or cpu)")
    ap.add_argument("--sha", default=None,
                    help="the commit to record where git metadata is missing (a copy of a "
                         "checkout); git's HEAD wins where there is one")
    args = ap.parse_args(argv)

    from vavae_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # no CUDA: raises unless --device cpu
    W = args.workdir or os.path.join(tempfile.gettempdir(),
                                     "vavae_e2e_smoke" if args.smoke else "vavae_e2e")
    os.makedirs(os.path.join(W, "logs"), exist_ok=True)
    out_json = args.out or (os.path.join(W, "e2e_workflow.json") if args.smoke
                            else os.path.join(REPO, "docs", "torch_e2e_workflow.json"))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)

    sz = sizes(args.smoke)
    head = _git("rev-parse", "HEAD")
    status = _git("status", "--porcelain") if head else None
    doc = {"sha": head or args.sha, "tree_dirty": bool(status) if head else None,
           "source_sha256": source_hash(), "smoke": args.smoke, "workdir": W,
           "device": device_record(device), "sizes": sz, "stages": {}}
    prev = _previous_stages(out_json, sz)
    t_all = time.perf_counter()

    def dump() -> None:
        # every stage's record survives a later stage's failure
        doc["total_wall_s"] = round(time.perf_counter() - t_all, 1)
        os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(doc, f, indent=2)

    try:
        run_stages(doc, dump, W, args.device, prev)
    finally:
        dump()
    missing = [s for s in STAGES if s not in doc["stages"]]
    if missing:
        raise RuntimeError(f"the record lacks stages {missing}")
    print(json.dumps({"e2e": "ok", "total_wall_s": doc["total_wall_s"],
                      "gauge_fid": doc["stages"]["gauge_fid"]["metrics"]["gauge_fid_vs_real"],
                      "out": out_json}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

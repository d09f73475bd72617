"""A/B of checkouts on one card, in turns within one process tree.

    python3 chip_ab.py --out DIR --order parent,change,change,parent \\
        parent=PATH change=. [--train parent,change] [--profile-train parent,change] \\
        [--profile-sample parent,change]

Each label names a checkout of this repository. For each entry of
``--order`` the script runs, in that checkout's directory and in a process
of its own, ``chip_smoke.py``'s build and kernel phases (``phase_build``,
``phase_kernels``, ``phase_bwd_kernel``, ``phase_small_kernels``,
``phase_long_kernel``) and, for the labels in ``--train``, its XL/1 train
steps at batch 32 on both attention branches (``phase_train_steps``); for
the labels in ``--profile-train``, ``vavae_tpu_torch.pipelines.profile_train``
of that checkout (production branch); for the labels in ``--profile-sample``,
its ``vavae_tpu_torch.pipelines.profile_sample --image_size 1024 --batch 2``
(the 1024² sampling forwards, where attention takes the long route). Every
run also times the checkout's two small-route forward wrappers, with and
without RoPE, at the shapes in
``FWD_SHAPES``, and the fp32 fused-qkv forward and backward (with SDPA's
fp32 forward and backward) at ``FP32_SHAPES``, so that checkouts whose
``chip_smoke.py`` measures other shapes are read at the same ones. Every checkout builds and runs its own
kernels and modules, but all are timed by this tree's
``vavae_tpu_torch/utils/device_timing.py``, loaded into each run in place of
the checkout's own timing functions, so that every reading has one
definition. Writes ``DIR/ab_<label><n>.json`` (and ``.log``) per run and
prints a summary: each kernel's device ms at the main paths' shapes, the
forward kernels' at every shape measured (with SDPA's), the backward's
device ms by launch, the registers and spills of the forward wgmma bodies
where the checkout has them, ms/step and the profilers' splits.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TIMING = HERE / "vavae_tpu_torch" / "utils" / "device_timing.py"
KERNELS = ("nat_attention_fwd", "nat_attention_bwd", "attn_small_fwd_rope", "attn_small_fwd",
           "attn_small_bwd", "flash_fwd")
FWD_KERNELS = ("nat_attention_fwd", "attn_small_fwd_rope", "attn_small_fwd")
FWD_SHAPES = [(16, 16, 256, 72), (4, 16, 1024, 72)]  # the 256² paths' and N = 1,024
# fp32 #1 and #2 with RoPE at the micro-Doppler DiTs' shapes: the LoRA step,
# the B/2 train step and CFG sampling, the e2e DiT-S/2 train step; and a
# ragged head of three tiles
FP32_SHAPES = [(16, 6, 64, 64), (8, 12, 64, 64), (32, 6, 64, 64), (2, 6, 130, 64)]

RUNNER = """
import importlib.util, json, math, sys
import torch
import chip_smoke as c
spec = importlib.util.spec_from_file_location("_ab_device_timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
for name in ("time_ms", "device_kernels", "device_ms"):
    setattr(c, name, getattr(timing, name))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
r = {"device": c.phase_device(), "build_s": c.phase_build()}
for phase in ("phase_kernels", "phase_bwd_kernel", "phase_small_kernels", "phase_long_kernel"):
    r.update(getattr(c, phase)(c.SEED))
from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops.flash_attention import flash_attention, fused_qkv_attention
gen = torch.Generator(device="cuda").manual_seed(c.SEED + 40)
r["forward_shapes"] = {}
for B, H, N, D in json.loads(sys.argv[4]):
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").bfloat16()
    q, k = (torch.randn((B, N, H, D), generator=gen, device="cuda").bfloat16() for _ in range(2))
    cos, sin = rope_2d_freqs(D, int(N ** 0.5))
    for tables in ((torch.as_tensor(cos[:N], device="cuda"), torch.as_tensor(sin[:N], device="cuda")),
                   None):
        tag = f"({B}, {H}, {N}, {D}){' rope' if tables else ''}"
        r["forward_shapes"]["nat_attention_fwd " + tag] = c.device_ms(
            lambda: fused_qkv_attention(qkv, rope=tables))
        r["forward_shapes"]["attn_small_fwd " + tag] = c.device_ms(
            lambda: flash_attention(q, k, qkv[:, :, 2], rope=tables))
from vavae_tpu_torch.ops.flash_attention import fold_sin, fused_qkv_attention_bwd
r["fp32"] = {}
for B, H, N, D in json.loads(sys.argv[5]):
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda")
    g = torch.randn((B, N, H, D), generator=gen, device="cuda")
    cos, sin = rope_2d_freqs(D, math.ceil(N ** 0.5))
    tables = (torch.as_tensor(cos[:N], device="cuda"), torch.as_tensor(sin[:N], device="cuda"))
    cosf, sinf = fold_sin(tables, device="cuda")
    rot = lambda x: x * cosf[None, :, None] + torch.roll(x, D // 2, dims=-1) * sinf[None, :, None]
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in (rot(qkv[:, :, 0]), rot(qkv[:, :, 1]), qkv[:, :, 2]))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    out, gt = sdpa(), g.transpose(1, 2).contiguous()
    fwd = lambda: fused_qkv_attention(qkv, rope=tables)
    bwd = lambda: fused_qkv_attention_bwd(qkv, g, rope=tables)
    r["fp32"][f"({B}, {H}, {N}, {D})"] = {
        "fwd_device_ms": c.device_kernels(fwd), "bwd_device_ms": c.device_kernels(bwd),
        "sdpa_device_ms": c.device_ms(sdpa),
        "sdpa_bwd_device_ms": c.device_ms(
            lambda: torch.autograd.grad(out, (q, k, v), gt, retain_graph=True))}
if sys.argv[3] == "1":
    for branch in ("production", "qknorm"):
        r["train_" + branch] = c.phase_train_steps(c.SEED, r["device"], branch)
with open(sys.argv[2], "w") as f:
    json.dump(r, f, indent=1)
"""


def run(label: str, checkout: Path, out: Path, train: bool, profile: bool,
        profile_sample: bool) -> int:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    with open(out.with_suffix(".log"), "w") as log:
        rc = subprocess.run([sys.executable, "-c", RUNNER, str(TIMING), str(out), str(int(train)),
                             json.dumps(FWD_SHAPES), json.dumps(FP32_SHAPES)],
                            cwd=checkout, env=env, stdout=log, stderr=subprocess.STDOUT).returncode
        if rc == 0 and profile:
            prof = out.with_name(out.stem + "_profile_train.json")
            rc = subprocess.run([sys.executable, "-m", "vavae_tpu_torch.pipelines.profile_train",
                                 "--out", str(prof)], cwd=checkout, env=env, stdout=log,
                                stderr=subprocess.STDOUT).returncode
        if rc == 0 and profile_sample:
            prof = out.with_name(out.stem + "_profile_sample.json")
            rc = subprocess.run([sys.executable, "-m", "vavae_tpu_torch.pipelines.profile_sample",
                                 "--image_size", "1024", "--batch", "2", "--out", str(prof)],
                                cwd=checkout, env=env, stdout=log,
                                stderr=subprocess.STDOUT).returncode
    print(f"{out.stem}: rc={rc}", flush=True)
    return rc


def summary(out: Path) -> None:
    r = json.loads(out.read_text())
    parts = [f"{n} {r[n]['rows'][0]['device_ms']:.4f}" for n in KERNELS if n in r]
    print(f"{out.stem} device ms: " + " | ".join(parts))
    for n in FWD_KERNELS:
        print(f"{out.stem} {n} device ms by shape: " + ", ".join(
            f"{tuple(row['shape'])}{' rope' if row['rope'] else ''} {row['device_ms']:.4f} "
            f"(SDPA {row['library_device_ms']:.4f})" for row in r.get(n, {}).get("rows", [])))
    if "forward_shapes" in r:
        print(f"{out.stem} forward wrappers, device ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r["forward_shapes"].items()))
    for shape, t in r.get("fp32", {}).items():
        fwd, bwd = (sum(t[key].values()) for key in ("fwd_device_ms", "bwd_device_ms"))
        body = [k.split("(")[0].split("::")[-1] for k in t["fwd_device_ms"]]
        print(f"{out.stem} fp32 {shape} rope: #1 device {fwd:.4f} ms ({', '.join(body)}), SDPA "
              f"{t['sdpa_device_ms']:.4f}; #2 device {bwd:.4f} ms, SDPA backward "
              f"{t['sdpa_bwd_device_ms']:.4f}")
    for source, kernels in r["build_s"].get("resources", {}).items():
        for kernel, res in sorted(kernels.items()):
            if kernel.startswith(("attn_fwd_wgmma_kernel", "flash_fwd_wgmma_kernel",
                                  "attn_fwd_tf32_kernel", "attn_bwd_tf32_kernel")):
                print(f"{out.stem} {source}.cu {kernel}: {res}")
    for n in ("nat_attention_bwd", "attn_small_bwd"):
        by = r.get(n, {}).get("rows", [{}])[0].get("device_ms_by_kernel")
        if by:
            print(f"{out.stem} {n} by launch: " + ", ".join(
                f"{k[:40]} {v:.4f}" for k, v in sorted(by.items())))
    for branch in ("production", "qknorm"):
        t = r.get("train_" + branch)
        if t:
            print(f"{out.stem} train {branch}: {t['ms_per_step']:.2f} ms/step, "
                  f"{t['img_per_s']:.2f} img/s")
    prof = out.with_name(out.stem + "_profile_train.json")
    if prof.exists():
        p = json.loads(prof.read_text())["train_step"]
        print(f"{out.stem} profile_train: wall {p['wall_ms']:.2f} ms, device "
              f"{p['device_ms']:.2f} ms, busy {p['busy_share']:.3f}, by class "
              + ", ".join(f"{k} {v:.2f}" for k, v in p["by_class_ms"].items()))
    prof = out.with_name(out.stem + "_profile_sample.json")
    if prof.exists():
        for key, p in json.loads(prof.read_text()).items():
            if key.startswith("dit_forward"):
                rope = f", rope_uncast {p['rope_uncast_ms']:.2f}" if "rope_uncast_ms" in p else ""
                print(f"{out.stem} profile_sample 1024² {key}: wall {p['wall_ms']:.2f} ms, device "
                      f"{p['device_ms']:.2f} ms, busy {p['busy_share']:.3f}, by class "
                      + ", ".join(f"{k} {v:.2f}" for k, v in p["by_class_ms"].items()) + rope)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", help="LABEL=PATH of each checkout")
    ap.add_argument("--order", required=True, help="comma-separated labels, run in this order")
    ap.add_argument("--out", required=True, help="directory for each run's JSON and log")
    ap.add_argument("--train", default="", help="labels whose runs also take the train steps")
    ap.add_argument("--profile-train", default="",
                    help="labels whose runs also run profile_train")
    ap.add_argument("--profile-sample", default="",
                    help="labels whose runs also run profile_sample at 1024²")
    args = ap.parse_args(argv)
    paths = dict(c.split("=", 1) for c in args.checkouts)
    paths = {k: Path(v).resolve() for k, v in paths.items()}
    train, profile, profile_sample = (set(filter(None, s.split(","))) for s in (
        args.train, args.profile_train, args.profile_sample))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    seen: dict = {}
    outs, failed = [], 0
    for label in args.order.split(","):
        seen[label] = seen.get(label, 0) + 1
        out = (out_dir / f"ab_{label}{seen[label]}.json").resolve()
        if run(label, paths[label], out, label in train, label in profile,
               label in profile_sample) != 0:
            failed += 1
            continue
        outs.append(out)
    for out in outs:
        summary(out)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""LightningDiT-1p6B/1 trained by ``train_dit`` under the tensor axis, each
layout held against one card's run from the same init and batches.

    python -m vavae_tpu_torch.apps.tensor_parallel_check [--out F.json] [--workdir DIR]
        [--model LightningDiT-1p6B/1] [--depth 28] [--batch 8] [--steps 10]
        [--layouts tensor4,data2_tensor2,fsdp2_tensor2,tensor4_qknorm] [--device cpu]

Writes seeded synthetic f16d32 latent shards (16×16×32, N = 256 tokens at
patch 1) and one saved init: the model's own (the JAX-style init, adaLN and
the final layer zero, so the blocks' weights first move at step 2) drawn
from seed 0, of the QK-norm model, whose names hold the production
model's. (Every weight drawn at 0.02, as ``chip_smoke.py`` phase 33 draws
them at depth 2, sends the depth-28 loss from 2.75 to 21.8 at step 2 under
lr 2e-4.) Then runs ``train_dit`` on them, each run the documented
command's arguments handed to ``train_dit.main``

    --config vavae_tpu_torch/configs/lightningdit_xl_vavae_f16d32.yaml
    model.model_type=LightningDiT-1p6B/1 parallel.tensor=4 train.weight_init=INIT ...

once in one process for each attention branch, then under each layout in a
world of four processes started by ``torch.distributed.run`` (one
process a card, NCCL; gloo with ``--device cpu``). Each process records
around ``DiTTrainer.train_step``: every step's loss, gradient norm and
milliseconds (synchronised at both ends), the attention kernels' launches
(#1/#2, or #3/#6 with QK-norm), its local heads and MLP rows, its state's
bytes, its peak memory (the gather below left out), and the parameters after
step 2, gathered from every rank (rank 0 compares them). The checkpoint
writes are left out: 26 GB of state a run at full size; the checkpoint's
layout is held by the tests (``tests/test_torch_mesh.py``). ``--depth``
cuts the variant's depth for a rehearsal on the CPU.

Every layout's losses of steps 1-2, gradient norms of steps 1-2 and
parameters after step 2 are held to ``chip_smoke.py`` phase 33's limits of
one process's (5e-5, 5e-4, 5e-4 relative); on the card every step launches
each kernel of its branch 2·depth and depth times on every rank; the ranks'
losses must be equal. Any miss fails the command. Writes one JSON record.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "lightningdit_xl_vavae_f16d32.yaml")
# name -> (parallel overrides, use_qknorm); each spans a world of WORLD
WORLD, SEED = 4, 0
LAYOUTS = {
    "tensor4": ({"tensor": 4}, False),
    "data2_tensor2": ({"data": 2, "tensor": 2}, False),
    "fsdp2_tensor2": ({"fsdp": 2, "tensor": 2}, False),
    "tensor4_qknorm": ({"tensor": 4}, True),
}
# chip_smoke.py phase 33's limits (relative to one process)
LOSS_TOL, NORM_TOL, PARAM_TOL = 5e-5, 5e-4, 5e-4
COMPARED_STEPS = 2
LATENT, CHANNELS, CLASSES = 16, 32, 1000
SHARD_ROWS = 64


def fail(msg: str) -> None:
    raise RuntimeError(f"tensor_parallel_check: {msg}")


def _variant(model: str) -> str:
    """``LightningDiT-1p6B/1`` → ``1p6B``."""
    return model.split("-", 1)[1].split("/")[0]


def write_inputs(work: str, model: str, depth: int, rows: int, seed: int,
                 device: str = "cuda") -> str:
    """The latent shards (``rows`` rows or more) and the saved init, drawn
    on ``device``; returns the init's path."""
    from vavae_tpu_torch.models import dit
    from vavae_tpu_torch.utils.config import load_config
    from vavae_tpu_torch.utils.safetensors_io import flatten, write_safetensors
    from vavae_tpu_torch.utils.weights import dit_state_to_jax

    rs = np.random.default_rng(seed)
    for i in range(math.ceil(rows / SHARD_ROWS)):
        lat = rs.standard_normal((SHARD_ROWS, CHANNELS, LATENT, LATENT)).astype(np.float32)
        write_safetensors(os.path.join(work, "latents", f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, CLASSES, (SHARD_ROWS,)).astype(np.int32)})
    cfg = load_config(CONFIG, overrides=[f"model.model_type={model}", "model.use_qknorm=true"])
    size = _variant(model)
    saved = dict(dit._VARIANTS[size])
    dit._VARIANTS[size]["depth"] = depth
    try:
        with torch.random.fork_rng(devices=[torch.device(device)] if device != "cpu" else []):
            torch.manual_seed(seed)
            net = dit.create_dit(cfg.model, LATENT, CLASSES, device=device)
    finally:
        dit._VARIANTS[size] = saved
    path = os.path.join(work, "init.safetensors")
    sd = {k: v.cpu() for k, v in net.state_dict().items()}
    del net
    write_safetensors(path, flatten(dit_state_to_jax(sd), "params"))
    return path


def train_args(spec: dict) -> list[str]:
    """``train_dit``'s arguments for one run: the documented command's."""
    parallel, qknorm = spec["parallel"], spec["qknorm"]
    args = ["--config", CONFIG,
            f"model.model_type={spec['model']}", f"model.use_qknorm={str(qknorm).lower()}",
            f"data.data_path={os.path.join(spec['work'], 'latents')}", "data.latent_norm=false",
            f"train.global_batch_size={spec['batch']}", f"train.max_steps={spec['steps']}",
            "train.log_every=1", "train.ckpt_every=1000000000", "train.async_checkpoint=false",
            "train.resume=false", f"train.weight_init={spec['init']}",
            f"train.global_seed={spec['seed']}",
            f"train.output_dir={os.path.join(spec['work'], 'runs')}", f"train.exp_name={spec['name']}"]
    args += [f"parallel.{k}={v}" for k, v in parallel.items()]
    if spec["device"] == "cpu":
        args += ["--device", "cpu"]
    return args


# -- one run (each process of it) -------------------------------------------------------


# the attention kernels' counters: name -> (wrapper attribute's owner, attribute)
KERNELS = {"nat_attention_fwd": ("fused_qkv_attention", "launches"),
           "nat_attention_bwd": ("fused_qkv_attention", "bwd_launches"),
           "attn_small_fwd_rope": ("flash_attention", "rope_launches"),
           "attn_small_fwd": ("flash_attention", "launches"),
           "attn_small_bwd": ("flash_attention", "bwd_launches"),
           "flash_fwd": ("flash_attention", "long_launches")}


def _launches() -> dict:
    from vavae_tpu_torch.ops import flash_attention as ops

    return {k: getattr(getattr(ops, fn), attr) for k, (fn, attr) in KERNELS.items()}


def want_launches(qknorm: bool, depth: int, on_card: bool) -> dict:
    """Each kernel's launches a train step (remat "dots" runs the forward
    again in the backward); on the CPU the wrappers launch nothing."""
    fwd, bwd = ("attn_small_fwd_rope", "attn_small_bwd") if qknorm else (
        "nat_attention_fwd", "nat_attention_bwd")
    want = dict.fromkeys(KERNELS, 0)
    if on_card:
        want.update({fwd: 2 * depth, bwd: depth})
    return want


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run_one(spec: dict) -> dict:
    """This process's part of one run: ``train_dit.main`` with the run's
    arguments, recorded around each train step; writes the record to
    ``{work}/{name}_rank{r}.json``."""
    from vavae_tpu_torch.apps.big_variant import held_bytes
    from vavae_tpu_torch.models import dit
    from vavae_tpu_torch.parallel import mesh as mesh_lib
    from vavae_tpu_torch.pipelines import train_dit
    from vavae_tpu_torch.train import checkpoint as ckpt_lib
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer, local_tensor

    dit._VARIANTS[_variant(spec["model"])]["depth"] = spec["depth"]
    ckpt_lib.save_checkpoint = lambda *a, **k: ""  # the checkpoint writes are left out
    rec = {"steps": [], "peak_bytes_before_gather": 0}  # peaks over the steps
    step_fn = DiTTrainer.train_step

    def recorded(self, state, batch, draws=None):
        dev = self.device
        if not rec["steps"]:  # the state as the loop holds it
            rec["peak_bytes_setup"] = _peak(dev)  # the full state, before distribute cut it
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            block = self.model.blocks[0]
            rec.update(local_heads=block.attn.num_heads, mlp_rows=block.mlp.w3.weight.shape[1],
                       local_params=sum(local_tensor(p).numel() for p in state.params),
                       state_bytes={"params": held_bytes(state.params),
                                    "ema": held_bytes(state.ema_params),
                                    "mu": held_bytes(state.opt.mu),
                                    "nu": held_bytes(state.opt.nu)})
        before = _launches()
        _sync(dev)
        t0 = time.perf_counter()
        m = step_fn(self, state, batch, draws)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        after = _launches()
        rec["steps"].append({"loss": loss, "grad_norm": norm, "ms": ms,
                             "launches": {k: after[k] - before[k] for k in KERNELS}})
        if state.step == COMPARED_STEPS:
            rec["peak_bytes_before_gather"] = _peak(dev)
            full = state.full(state.params)  # collective
            if mesh_lib.process_index() == 0:
                rec["params_after_2"] = _compare_or_save(spec, full)
            del full
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
        return m

    DiTTrainer.train_step = recorded
    t0 = time.perf_counter()
    state = train_dit.main(train_args(spec))
    rec["run_s"] = time.perf_counter() - t0
    if state.step != spec["steps"]:
        fail(f"{spec['name']}: train_dit stopped at step {state.step} of {spec['steps']}")
    dev = state.params[0].device
    rec["peak_bytes"] = max(rec["peak_bytes_before_gather"], _peak(dev))
    rec["rank"], rec["world"] = mesh_lib.process_index(), mesh_lib.process_count()
    if dev.type == "cuda":
        from vavae_tpu_torch.apps.e2e_onchip import device_record

        rec["device"] = device_record(dev)
    with open(os.path.join(spec["work"], f"{spec['name']}_rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    mesh_lib.barrier()
    mesh_lib.shutdown()
    return rec


def _compare_or_save(spec: dict, full: list[torch.Tensor]) -> dict:
    """One process's run saves its parameters after step 2; a world's rank
    0 holds its gathered ones to them: the relative Frobenius distance."""
    path = os.path.join(spec["work"], f"params_{spec['reference']}.pt")
    if spec["reference"] == spec["name"]:
        torch.save([p.detach().float().cpu() for p in full], path)
        return {"saved": path}
    want = torch.load(path)
    diff = norm = 0.0
    for got, w in zip(full, want):
        w = w.to(got.device, torch.float64)
        diff += (got.detach().double() - w).square().sum().item()
        norm += w.square().sum().item()
    return {"rel": math.sqrt(diff / norm)}


# -- the orchestration -----------------------------------------------------------------


def _launch(spec: dict, nproc: int, timeout: float) -> None:
    """One run: a process, or ``nproc`` through ``torch.distributed.run``."""
    path = os.path.join(spec["work"], f"{spec['name']}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    entry = ["-m", "vavae_tpu_torch.apps.tensor_parallel_check", "--spec-file", path]
    cmd = [sys.executable] + (entry if nproc == 1 else
                              ["-m", "torch.distributed.run", "--standalone",
                               f"--nproc_per_node={nproc}"] + entry)
    log = os.path.join(spec["work"], f"{spec['name']}.log")
    with open(log, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, timeout=timeout,
                           cwd=os.path.dirname(os.path.dirname(os.path.dirname(CONFIG))))
    if p.returncode != 0:
        with open(log) as f:
            fail(f"run {spec['name']} exited {p.returncode}:\n{f.read()[-6000:]}")


def _ranks(spec: dict, nproc: int) -> list[dict]:
    out = []
    for r in range(nproc):
        with open(os.path.join(spec["work"], f"{spec['name']}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _summary(ranks: list[dict], want: dict) -> dict:
    """A run's record from its ranks', checked: equal losses on every rank
    and every step's launches exact (``want``)."""
    r0 = ranks[0]
    losses = [s["loss"] for s in r0["steps"]]
    for r in ranks[1:]:
        if [s["loss"] for s in r["steps"]] != losses:
            fail(f"the ranks' losses differ: {[[s['loss'] for s in r['steps']] for r in ranks]}")
    for r in ranks:
        bad = [s["launches"] for s in r["steps"] if s["launches"] != want]
        if bad:
            fail(f"rank {r['rank']}: launches per step {bad}, expected {want}")
    ms = [s["ms"] for s in r0["steps"][1:]]  # step 1 builds and warms
    return {
        "losses": losses, "grad_norms": [s["grad_norm"] for s in r0["steps"]],
        "ms_per_step_median": statistics.median(ms), "ms_per_step_range": [min(ms), max(ms)],
        "ranks": [{k: r[k] for k in ("rank", "local_heads", "mlp_rows", "local_params",
                                     "state_bytes", "peak_bytes", "peak_bytes_setup", "run_s")}
                  | {"peak_gib": r["peak_bytes"] / 2**30,
                     "ms_per_step": [s["ms"] for s in r["steps"]],
                     "launches_per_step": {k: v for k, v in r["steps"][0]["launches"].items()
                                           if v}} for r in ranks],
        "device": r0.get("device"),
    }


def check(args) -> dict:
    work = args.workdir or tempfile.mkdtemp(prefix="tp_check_")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    init = write_inputs(work, args.model, args.depth, args.batch * args.steps, SEED, args.device)
    setup_s = time.perf_counter() - t0
    on_card = args.device != "cpu"
    depth = args.depth
    base = {"work": work, "model": args.model, "depth": depth, "batch": args.batch,
            "steps": args.steps, "seed": SEED, "init": init, "device": args.device}
    smi = None
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    record = {"model": args.model, "depth": depth, "batch": args.batch, "steps": args.steps,
              "world": WORLD, "smi": smi, "setup_s": setup_s, "limits": {
                  "loss": LOSS_TOL, "grad_norm": NORM_TOL, "params": PARAM_TOL,
                  "compared_steps": COMPARED_STEPS}, "one_card": {}, "layouts": {}}
    names = args.layouts.split(",")
    for qknorm in sorted({LAYOUTS[n][1] for n in names}):
        name = "one_card_qknorm" if qknorm else "one_card"
        spec = dict(base, name=name, reference=name, parallel={}, qknorm=qknorm)
        _launch(spec, 1, args.timeout)
        want = want_launches(qknorm, depth, on_card)
        record["one_card"][name] = _summary(_ranks(spec, 1), want) | {
            "cmd": "python -m vavae_tpu_torch train_dit " + " ".join(train_args(spec))}
    for name in names:
        parallel, qknorm = LAYOUTS[name]
        ref = "one_card_qknorm" if qknorm else "one_card"
        spec = dict(base, name=name, reference=ref, parallel=parallel, qknorm=qknorm)
        _launch(spec, WORLD, args.timeout)
        ranks = _ranks(spec, WORLD)
        out = _summary(ranks, want_launches(qknorm, depth, on_card))
        want = record["one_card"][ref]
        rel = {key: [abs(a - b) / abs(b) for a, b in zip(out[key], want[key])]
               for key in ("losses", "grad_norms")}
        k = COMPARED_STEPS
        dist = {"loss": max(rel["losses"][:k]), "grad_norm": max(rel["grad_norms"][:k]),
                "params": ranks[0]["params_after_2"]["rel"]}
        out["rel_per_step"] = rel  # beyond step 2 the runs drift apart as Adam amplifies rounding
        out.update(parallel=parallel, qknorm=qknorm, to_one_card=dist, cmd=(
            f"torchrun --nproc_per_node={WORLD} -m vavae_tpu_torch train_dit "
            + " ".join(train_args(spec))))
        out["within_limits"] = (dist["loss"] <= LOSS_TOL and dist["grad_norm"] <= NORM_TOL
                                and dist["params"] <= PARAM_TOL)
        record["layouts"][name] = out
        print(f"[tp] {name}: {json.dumps(dist)}; ms/step median {out['ms_per_step_median']:.2f}; "
              f"local heads {[r['local_heads'] for r in out['ranks']]}, MLP rows "
              f"{[r['mlp_rows'] for r in out['ranks']]}, peak GiB "
              f"{[round(r['peak_gib'], 2) for r in out['ranks']]}", flush=True)
    record["seconds"] = time.perf_counter() - t0
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # one process of one run (a name no option of torch.distributed.run begins with)
    ap.add_argument("--spec-file", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    ap.add_argument("--workdir")
    ap.add_argument("--model", default="LightningDiT-1p6B/1")
    ap.add_argument("--depth", type=int, default=28)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--timeout", type=float, default=1800.0, help="each run's limit (s)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.spec_file:
        with open(args.spec_file) as f:
            run_one(json.load(f))
        return
    if args.device != "cpu" and torch.cuda.device_count() < WORLD:
        fail(f"{WORLD} cards wanted, {torch.cuda.device_count()} seen")
    record = check(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    missed = {n: out["to_one_card"] for n, out in record["layouts"].items()
              if not out["within_limits"]}
    if missed:  # after the record is written
        fail(f"{missed} from one card's; limits {LOSS_TOL}, {NORM_TOL}, {PARAM_TOL}")
    print(json.dumps({k: record[k] for k in ("model", "depth", "seconds")}))


if __name__ == "__main__":
    main()

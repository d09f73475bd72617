"""Autotune the sampler for a checkpoint: measure, then recommend a
``sample:`` block (port of ``vavae_tpu/apps/autotune_sampler.py``).

    python -m vavae_tpu_torch.apps.autotune_sampler --config DIT.yaml [--ckpt CKPT]
        [--budget 0.01] [--n 256] [--batch 32] [--ref_steps 250] [--smoke]
        [--out evidence.json] [--emit_yaml overlay.yaml] [--device cpu]

It samples the checkpoint's exact euler reference (250 steps) at the
config's production sampler settings, then a ladder of cheaper methods
(euler 125/100/50, Adams–Bashforth 3 at 100/62, heun 83/62, the fixed
velocity cache k = 3, 6 and the adaptive cache), from the same noise, and
measures each one's deviation from the reference: per-sample relative L2
(p50, p99) and a latent FID over a fixed random projection. The adaptive
cache's tolerances are placed at 2, 4 and 8 times the noise floor a probe
run (tolerance 1e-6) measures on this model's field. It recommends the
cheapest method whose p99 stays inside ``--budget``, or exact euler when
none does. The accelerated knobs are offered only when the config's
sampling takes the split-CFG euler path (cfg_scale > 1, mode ODE,
cfg_interval_start > 0); otherwise ``pipelines.sample`` would ignore them.

Costs are CFG-forward equivalents (``transport/cost.py``). The noise of
batch b is drawn from a generator seeded 1000 + b (the probe uses batch
0's), on the card unless ``--device cpu``; ``autotune`` takes the noise
batches as an argument. Outputs: the evidence table, the ``sample:`` block
(YAML, written by ``utils/yaml_io.py``), the JSON evidence (``--out``) and
the block as an overlay file (``--emit_yaml``) that ``load_config(cfg,
overlay)`` merges.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from vavae_tpu_torch.eval.fid import activation_statistics, frechet_distance
from vavae_tpu_torch.transport.cost import adaptive_cache_cost, fixed_grid_cost
from vavae_tpu_torch.utils import yaml_io

# ``sample:`` keys carried from the user's config into the recommendation
CARRIED = ("mode", "cfg_scale", "timestep_shift", "cfg_interval_start", "cfg_channels",
           "reverse", "null_class")


def _method_config(rec: dict) -> dict:
    """The ``sample:`` keys that reproduce a gauged method (the keys
    ``pipelines/sample.py`` reads)."""
    out = {"sampling_method": "euler", "num_sampling_steps": rec["num_steps"],
           "multistep_order": 1, "velocity_cache_interval": 1, "velocity_cache_adaptive": False}
    kind = rec["kind"]
    if kind == "ab":
        out["multistep_order"] = rec["order"]
    elif kind == "heun":
        out["sampling_method"] = "heun"
    elif kind == "vcache":
        out["velocity_cache_interval"] = rec["k"]
    elif kind == "vcacheA":
        out.update(velocity_cache_adaptive=True, velocity_cache_tol=rec["tol"],
                   velocity_cache_max_interval=rec["max_interval"])
    return out


def tolerance_candidates(floor: Optional[float]) -> list[float]:
    """The adaptive cache's tolerances: 2, 4 and 8 times the measured noise
    floor (rounded to 5 decimals), clipped to [1e-3, 0.2]; 0.01, 0.02,
    0.05 when there is no floor."""
    cands = [round(floor * m, 5) for m in (2.0, 4.0, 8.0)] if floor else [0.01, 0.02, 0.05]
    return sorted({min(max(t, 1e-3), 0.2) for t in cands})


def ladder(smoke: bool, accel_exercised: bool, ref_steps: int,
           tol_cands: Sequence[float]) -> list[tuple[str, dict]]:
    """The candidate methods, (label, record), in the order they are gauged."""
    if smoke and not accel_exercised:
        return [("euler_8", {"kind": "euler", "num_steps": 8})]
    if smoke:
        return [
            ("euler_8", {"kind": "euler", "num_steps": 8}),
            ("ab3_16", {"kind": "ab", "num_steps": 16, "order": 3}),
            ("heun_8", {"kind": "heun", "num_steps": 8}),
            ("vcache2_16", {"kind": "vcache", "num_steps": 16, "k": 2}),
            (f"vcacheA_tol{tol_cands[0]:g}",
             {"kind": "vcacheA", "num_steps": 16, "tol": tol_cands[0], "max_interval": 4}),
        ]
    euler = [(f"euler_{n}", {"kind": "euler", "num_steps": n}) for n in (125, 100, 50)]
    if not accel_exercised:
        return euler
    return (euler
            + [(f"ab3_{n}", {"kind": "ab", "num_steps": n, "order": 3}) for n in (100, 62)]
            + [(f"heun_{n}", {"kind": "heun", "num_steps": n}) for n in (83, 62)]
            + [(f"vcache{k}_{ref_steps}", {"kind": "vcache", "num_steps": ref_steps, "k": k})
               for k in (3, 6)]
            + [(f"vcacheA_tol{t:g}", {"kind": "vcacheA", "num_steps": ref_steps, "tol": t,
                                      "max_interval": 8}) for t in tol_cands])


def autotune(cfg, model, noise: Sequence, *, budget: float = 0.01, ref_steps: int = 250,
             smoke: bool = False, config_path: str = "", ckpt: str = "") -> dict:
    """Gauge the ladder on ``model`` (weights loaded, on its device) at the
    ``sample:`` settings of ``cfg``, every method from the same noise
    batches ``noise`` ((B, h, w, C) each; the probe takes the first), and
    return the evidence document with its recommendation."""
    from vavae_tpu_torch.transport import Sampler, build_transport

    sc = cfg.sample
    dev = next(model.parameters()).device
    transport = build_transport(cfg)
    sampler = Sampler(transport)
    n_classes = cfg.data.num_classes
    null_class = sc.get("null_class", n_classes)
    # the defaults of pipelines/sample.py: the recommendation is for the
    # sampler the config runs
    cfg_scale = sc.get("cfg_scale", 1.0)
    shift = sc.get("timestep_shift", 0.0)
    start = sc.get("cfg_interval_start", 0.0)
    cfg_channels = sc.get("cfg_channels")
    reverse = sc.get("reverse", False)
    noise = [torch.as_tensor(z, dtype=torch.float32, device=dev) for z in noise]
    B = noise[0].shape[0]
    labels = torch.arange(B, device=dev) % n_classes
    y_cfg = torch.cat([labels, torch.full_like(labels, null_class)])

    def cond(x, t):
        return model(x, t, labels)

    def guided(x, t):
        return model.forward_with_cfg(x, t, y_cfg, cfg_scale, cfg_channels=cfg_channels)

    def make_generate(num_steps, order=1, k=1, method="euler", tol=None, max_interval=8):
        if method == "vcacheA":
            return sampler.sample_ode_cfg(
                num_steps=num_steps, timestep_shift=shift, cfg_interval_start=start,
                cache_adaptive=True, cache_tol=tol, cache_max_interval=max_interval,
                reverse=reverse, return_stats=True)
        return sampler.sample_ode_cfg(
            num_steps=num_steps, timestep_shift=shift, cfg_interval_start=start,
            sampling_method=method, multistep_order=order, cache_interval=k, reverse=reverse)

    @torch.inference_mode()
    def sample_set(rec):
        # "ab" runs the euler program with multistep_order
        method = {"heun": "heun", "vcacheA": "vcacheA"}.get(rec["kind"], "euler")
        gen = make_generate(rec["num_steps"], rec.get("order", 1), rec.get("k", 1), method,
                            rec.get("tol"), rec.get("max_interval", 8))
        outs, evals = [], []
        t0 = time.perf_counter()
        for z in noise:
            res = gen(z, cond, guided)
            if rec["kind"] == "vcacheA":
                res, stats = res
                evals.append(int(stats["cfg_evals"]))
            outs.append(res.float().cpu().numpy())
        seconds = time.perf_counter() - t0  # the last copy to the host waited for the card
        cost = (float(np.mean([adaptive_cache_cost(transport, rec["num_steps"], shift, start, e,
                                                   reverse) for e in evals]))
                if evals else fixed_grid_cost(transport, rec["num_steps"], shift, start,
                                              "heun" if rec["kind"] == "heun" else "euler",
                                              rec.get("k", 1), reverse))
        return np.concatenate(outs), cost, seconds, evals

    print(f"[autotune] exact euler-{ref_steps} reference ({len(noise) * B} samples, "
        f"cfg_scale={cfg_scale:g})")
    exact, ref_cost, ref_seconds, _ = sample_set({"kind": "euler", "num_steps": ref_steps})
    enorm = np.linalg.norm(exact.reshape(len(exact), -1), axis=-1)
    D = int(np.prod(exact.shape[1:]))
    proj = np.random.default_rng(42).normal(size=(D, 192)).astype(np.float32) / np.sqrt(D)

    def feats(x):
        return x.reshape(len(x), -1) @ proj

    mu_e, sig_e = activation_statistics(feats(exact))

    accel_exercised = (cfg_scale > 1.0 and str(sc.get("mode", "ODE")).upper() == "ODE"
                       and start > 0.0)
    if not accel_exercised:
        print("[autotune] NOTE: this config does not take the split-CFG euler path (needs "
            "cfg_scale > 1, mode ODE, cfg_interval_start > 0) — pipelines.sample would ignore "
            "multistep/velocity-cache knobs, so only euler step-count candidates are gauged")
    # a tolerance far below any floor makes the controller evaluate densely,
    # so its calibration completes: the floor it reports is the lower end of
    # the useful tolerances on this field
    floor, probe_evals = None, None
    if accel_exercised:
        probe = make_generate(ref_steps, method="vcacheA", tol=1e-6)
        with torch.inference_mode():
            _, pstats = probe(noise[0], cond, guided)
        probe_evals = int(pstats["cfg_evals"])
        floor = float(pstats["noise_floor"])
        if not np.isfinite(floor) or floor <= 0:
            floor = None
    tol_cands = tolerance_candidates(floor)
    if accel_exercised:
        print(f"[autotune] measured noise floor: "
            f"{'%.5f' % floor if floor else 'n/a (below calibration)'} -> adaptive tol "
            f"candidates {tol_cands}")

    doc = {"config": os.path.abspath(config_path) if config_path else "", "ckpt": ckpt,
           "platform": dev.type, "budget_rel_l2_p99": budget, "cfg_scale": cfg_scale,
           "timestep_shift": shift, "cfg_interval_start": start, "reverse": reverse,
           "n_samples": len(noise) * B, "reference": f"euler_{ref_steps}",
           "reference_cost": ref_cost, "reference_seconds": ref_seconds,
           "accel_exercised_by_production_path": accel_exercised, "noise_floor": floor,
           "probe_cfg_evals": probe_evals, "methods": {}}
    rows = []
    for label, rec in ladder(smoke, accel_exercised, ref_steps, tol_cands):
        s, cost, seconds, evals = sample_set(rec)
        dev_l2 = np.linalg.norm((s - exact).reshape(len(s), -1), axis=-1) / enorm
        mu, sig = activation_statistics(feats(s))
        fid = float(frechet_distance(mu_e, sig_e, mu, sig))
        row = {"label": label, "cost": cost, "cost_pct": 100 * cost / ref_cost,
               "rel_l2_p50": float(np.percentile(dev_l2, 50)),
               "rel_l2_p99": float(np.percentile(dev_l2, 99)), "latent_fid": fid, "rec": rec,
               "seconds": seconds}
        if evals:
            row["cfg_evals"] = evals
        rows.append(row)
        doc["methods"][label] = {k: v for k, v in row.items() if k != "label"}
        print(f"[autotune] {label:18s} cost {cost:7.1f} ({row['cost_pct']:5.1f}%)  relL2 p50 "
            f"{row['rel_l2_p50']:.5f} p99 {row['rel_l2_p99']:.5f}  latent_fid {fid:.6f}  "
            f"{seconds:.2f} s")

    feasible = sorted((r for r in rows if r["rel_l2_p99"] <= budget and r["cost"] < ref_cost),
                      key=lambda r: (r["cost"], r["latent_fid"]))
    if feasible:
        best = feasible[0]
        block = _method_config(best["rec"])
        verdict = (f"{best['label']} meets the budget at {best['cost_pct']:.0f}% of exact cost "
                   f"(p99 rel-L2 {best['rel_l2_p99']:.5f} <= {budget:g})")
    else:
        best = None
        block = {"sampling_method": "euler", "num_sampling_steps": ref_steps,
                 "multistep_order": 1, "velocity_cache_interval": 1,
                 "velocity_cache_adaptive": False}
        verdict = (f"NO acceleration met budget {budget:g} — keep exact euler-{ref_steps} (the "
                   "acceleration matrix says this happens on real fields; measuring it is the "
                   "point)")
    for k in CARRIED:  # the user's own production settings, unchanged
        if k in sc:
            block[k] = sc[k]
    doc["recommendation"] = {"verdict": verdict, "sample_block": block,
                             "winner": best["label"] if best else f"euler_{ref_steps}"}
    return doc


def main(argv=None) -> int:
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines.sample import load_dit_params
    from vavae_tpu_torch.utils.config import load_config
    from vavae_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description="measure sampler accelerations on a checkpoint "
                                             "and recommend a sample: config block")
    ap.add_argument("--config", required=True,
                    help="the DiT sampling config (the file pipelines.sample takes)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (.safetensors/.msgpack train state, or a reference .pt; "
                         "EMA preferred); default: the config's ckpt_path")
    ap.add_argument("--budget", type=float, default=0.01,
                    help="max acceptable per-sample rel-L2 p99 vs exact euler (default 0.01)")
    ap.add_argument("--n", type=int, default=None,
                    help="samples per method (default 256 on the card, 32 on the CPU)")
    ap.add_argument("--batch", type=int, default=None,
                    help="per-batch size (default 32 on the card, 8 on the CPU)")
    ap.add_argument("--ref_steps", type=int, default=None,
                    help="exact-reference step count (default 250, the production grid)")
    ap.add_argument("--out", default=None, help="JSON evidence path")
    ap.add_argument("--emit_yaml", default=None,
                    help="write the recommended sample: block as a YAML overlay file")
    ap.add_argument("--smoke", action="store_true", help="tiny ladder and few samples")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    ckpt = args.ckpt or cfg.get("ckpt_path")
    if not ckpt:
        raise SystemExit("autotune needs a trained checkpoint: pass --ckpt or set ckpt_path "
                         "in the config (gauging a random-init model would recommend a "
                         "sampler for noise)")
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    latent = cfg.data.image_size // cfg.get("vae", {}).get("downsample_ratio", 16)
    model = create_dit(cfg.model, latent, cfg.data.num_classes, device=dev).eval()
    load_dit_params(model, ckpt)
    B = args.batch or (32 if on_card else 8)
    n_total = args.n or ((256 if on_card else 32) if not args.smoke else 2 * B)
    ref_steps = args.ref_steps or (250 if not args.smoke else 16)
    shape = (B, latent, latent, model.in_channels)
    noise = [torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(1000 + b),
                         device=dev) for b in range(max(1, n_total // B))]
    doc = autotune(cfg, model, noise, budget=args.budget, ref_steps=ref_steps, smoke=args.smoke,
                   config_path=args.config, ckpt=ckpt)
    out = args.out or "autotune_sampler.json"
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)
    verdict = doc["recommendation"]["verdict"]
    yaml_block = yaml_io.safe_dump({"sample": doc["recommendation"]["sample_block"]})
    print(f"\n[autotune] VERDICT: {verdict}")
    print("[autotune] recommended config block:\n" + yaml_block, flush=True)
    print(f"[autotune] evidence -> {out}")
    if args.emit_yaml:
        with open(args.emit_yaml, "w") as f:
            f.write("# generated by vavae_tpu_torch.apps.autotune_sampler\n"
                    f"# {verdict}\n" + yaml_block)
        print(f"[autotune] overlay -> {args.emit_yaml}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

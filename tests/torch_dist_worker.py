"""Worlds of processes for the port's multi-device tests, over gloo on the
CPU.

``Launch(cases, world, outdir)`` starts ``world`` copies of this file,
each joining the world through ``multihost_init``'s environment contract
(torchrun's names, or the JAX package's with ``env_style="jax"``), with a
timeout on the process group and on every wait, so a hung collective fails
the test instead of eating the suite's clock. Each process runs the named
cases in order and saves what it saw to ``outdir/{case}_{rank}.pt``; the
tests compare that with the same work done in one process.

    python tests/torch_dist_worker.py CASE[,CASE...] OUTDIR
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DIST_TIMEOUT_S = 120  # each process group's
WAIT_S = 240          # each launch's


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Launch:
    """A world of ``world`` processes running ``cases``, started at once;
    ``wait()`` returns each process's output and fails (after killing the
    rest) when one exits non-zero or the launch outlasts ``WAIT_S``. The
    caller computes its single-process references meanwhile."""

    def __init__(self, cases, world: int, outdir, env_style: str = "torchrun",
                 extra_env=None):
        port = free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ)
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                      "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
                env.pop(k, None)
            if env_style == "jax":
                env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                           JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank))
            else:
                env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
            env.update(VAVAE_DIST_TIMEOUT=str(DIST_TIMEOUT_S), OMP_NUM_THREADS="1",
                       MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                       PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
            env.update(extra_env or {})
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), ",".join(cases), str(outdir)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(self) -> list[str]:
        outs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=WAIT_S)
                outs.append(out)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {rank} of {len(self.procs)} failed:\n{out[-6000:]}"
        return outs


def launch(cases, world: int, outdir, **kw) -> list[str]:
    """``Launch(...).wait()``."""
    return Launch(cases, world, outdir, **kw).wait()


def rel(got, want) -> float:
    """The relative Frobenius distance of two lists of tensors or arrays."""
    import numpy as np
    import torch

    g = torch.cat([torch.as_tensor(np.asarray(x)).double().ravel() for x in got])
    w = torch.cat([torch.as_tensor(np.asarray(x)).double().ravel() for x in want])
    return float((g - w).norm() / w.norm())


# -- shared inputs (the tests rebuild them in one process) -----------------------------


def tiny_dit(seed: int = 0, **kw):
    """The JAX mesh tests' DiT, weights drawn from ``seed``."""
    import torch

    from vavae_tpu_torch.models.dit import LightningDiT

    args = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2,
                num_heads=4, num_classes=8, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    args.update(kw)
    torch.manual_seed(seed)
    return LightningDiT(**args)


def dit_batches(n: int, B: int = 8, seed: int = 0, classes: int = 8):
    import numpy as np

    rs = np.random.default_rng(seed)
    return [(rs.normal(size=(B, 8, 8, 4)).astype(np.float32),
             rs.integers(0, classes, size=(B,)).astype(np.int32)) for _ in range(n)]


# parallel layouts of the DiT step cases: name -> ((data, fsdp, tensor), model
# kwargs); a world runs those whose sizes multiply to its own
DIT_CASES = {
    "dp": ((2, 1, 1), {}),
    "fsdp": ((1, 2, 1), {}),
    "tp": ((1, 1, 2), {}),
    "tp_qknorm": ((1, 1, 2), {"use_qknorm": True}),
    "tp_mlp": ((1, 1, 2), {"use_swiglu": False}),
    "dp_fsdp": ((2, 2, 1), {}),  # HSDP: FSDP2 on the 2-D data × fsdp mesh
    "dp_tp": ((2, 1, 2), {}),
    "fsdp_tp": ((1, 2, 2), {}),  # FSDP2 over the head split
    "fsdp_tp_qknorm": ((1, 2, 2), {"use_qknorm": True}),
    # tensor sizes that divide neither the heads nor the MLP width, as the
    # JAX trainer takes them: uneven pieces (tensor_parallel.pieces)
    "tp4": ((1, 1, 4), {}),  # MLP rows 43, 43, 42, 42 of 170
    "tp4_heads6": ((1, 1, 4), {"hidden_size": 48, "num_heads": 6}),  # heads 2, 2, 1, 1
    "tp4_heads2": ((1, 1, 4), {"num_heads": 2}),  # heads 1, 1, 0, 0
    "tp4_qknorm": ((1, 1, 4), {"use_qknorm": True}),
    "tp4_qknorm_heads2": ((1, 1, 4), {"num_heads": 2, "use_qknorm": True}),
    "fsdp_tp_heads3": ((1, 2, 2), {"hidden_size": 48, "num_heads": 3}),  # heads 2, 1
    "fsdp_tp_heads1": ((1, 2, 2), {"hidden_size": 32, "num_heads": 1}),  # heads 1, 0
}
# the layouts of the step from the JAX init: name -> (this world's mesh,
# the JAX mesh8's make_mesh kwargs)
JAX_LAYOUTS = {
    "dp": ((2, 1, 1), {}),
    "fsdp": ((1, 2, 1), {"data": 2, "fsdp": 4}),
    "tp": ((1, 1, 2), {"data": 4, "tensor": 2}),
    "tp4": ((1, 1, 4), {"data": 2, "tensor": 4}),  # MLP 170: uneven here, w3 replicated there
}
TRAIN_OPT = dict(lr=1e-3, max_grad_norm=0.05, ema_decay=0.9)


def dit_trainer(model, mesh=None, **kw):
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.transport.transport import create_transport

    return DiTTrainer(model, create_transport("Linear", "velocity"), mesh=mesh,
                      **{**TRAIN_OPT, **kw})


def run_dit_steps(trainer, state, batches, mesh=None, draws=None):
    """Steps on ``batches`` (global), this rank's rows; (losses, grad norms)."""
    from vavae_tpu_torch.parallel.mesh import shard_batch

    losses, norms = [], []
    for i, batch in enumerate(batches):
        local = shard_batch(mesh, batch) if mesh is not None else batch
        m = trainer.train_step(state, local, draws=None if draws is None else draws[i])
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms


def tiny_vae_trainer(mesh=None):
    import torch

    from vavae_tpu_torch.models.vae import AutoencoderKL
    from vavae_tpu_torch.train.vae_loss import VAELossConfig
    from vavae_tpu_torch.train.vae_trainer import VAETrainer

    torch.manual_seed(0)
    vae = AutoencoderKL(embed_dim=4, ch=32, ch_mult=(1, 2), resolution=32)
    tr = VAETrainer(vae, loss_cfg=VAELossConfig(disc_start=0, kl_weight=1e-6,
                                                perceptual_weight=0.0),
                    lr=1e-4, use_vf=False, lpips=None, disc_layers=2, mesh=mesh)
    return tr, tr.init_state(0)


def vae_images():
    import numpy as np

    return (np.random.default_rng(9).normal(size=(8, 32, 32, 3)) * 0.5).astype(np.float32)


def vae_state_dict(state):
    import torch

    return {n: t.detach().clone() for names, ts in (
        (state.gen_names, state.gen_params), (state.disc_names, state.disc_params),
        (state.stat_names, state.disc_stats)) for n, t in zip(names, ts)} | {
        "gen_opt.mu." + n: t.clone() for n, t in zip(state.gen_names, state.gen_opt.mu)} | {
        "disc_opt.nu." + n: t.clone() for n, t in zip(state.disc_names, state.disc_opt.nu)} | {
        "step": torch.tensor(state.step)}


# classifier modes of the data-parallel step: name -> ClassifierTrainer kwargs
CLASSIFIER_CASES = {
    "baseline": {},
    "improved_global": {"mode": "improved", "contrastive_type": "global"},
    "calibrated_mixup": {"mode": "calibrated", "use_mixup": True},
    "domain_adaptive": {"mode": "domain_adaptive"},
}


def classifier_batches(n: int = 2):
    import numpy as np

    rs = np.random.default_rng(5)
    y = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    return [(rs.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32), rs.permutation(y))
            for _ in range(n)]


def run_classifier(kw, mesh=None):
    """Two steps of a 4-user classifier: (losses, accuracies, the state's
    tensors after the first step). Adam's first step moves every weight by
    about ±lr whatever its gradient's size, so later states are compared
    through the losses."""
    import torch

    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer
    from vavae_tpu_torch.parallel.mesh import shard_batch

    tr = ClassifierTrainer(num_classes=4, device="cpu", mesh=mesh, memory_size=8, **kw)
    state = tr.init_state(0)
    losses, accs, tensors = [], [], None
    for batch in classifier_batches():
        m = tr.train_step(state, shard_batch(mesh, batch) if mesh is not None else batch)
        losses.append(m["loss"].item())
        accs.append(m["acc"].item())
        if tensors is None:
            tensors = dict(zip(state.names + state.stat_names,
                               (t.detach().clone() for t in state.params + state.stats)))
            extras = state.extras
            if isinstance(extras, dict):
                tensors.update({f"extras.{k}": v.clone() for k, v in extras.items()})
            elif extras is not None:
                tensors["extras"] = extras.clone()
            tensors["mu"] = torch.cat([t.ravel() for t in state.opt.mu])
    return losses, accs, tensors


# -- cases ---------------------------------------------------------------------------


def case_mesh(out):
    """Mesh shapes and coordinates, shard_batch, the collectives, and a DP
    gradient of mean((x @ w)²) (tests/test_mesh.py's)."""
    import numpy as np
    import torch

    from vavae_tpu_torch.parallel import mesh as M

    res = {"rank": M.process_index(), "world": M.process_count(), "meshes": {}}
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    for shape in ((2, 1, 1), (1, 2, 1), (1, 1, 2), (None, 1, 1)):
        mesh = M.make_mesh(*shape)
        rows = torch.from_numpy(M.shard_batch(mesh, x))
        mean = rows.mean().reshape(1)
        M.all_reduce_mean_([mean], mesh.group(M.DP))
        res["meshes"][str(shape)] = {"shape": dict(mesh.shape), "coords": dict(mesh.coords),
                                     "rows": rows, "mean": mean.item()}
    res["allgather"] = M.process_allgather(np.asarray([M.process_index(), 7.0])).tolist()
    res["fname"] = M.process_fname("latents", ".safetensors", 3)

    mesh = M.make_mesh()
    w = torch.ones(4, 4, requires_grad=True)
    xg = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    torch.square(torch.from_numpy(M.shard_batch(mesh, xg)) @ w).mean().backward()
    g = w.grad.clone()
    M.all_reduce_mean_([g], mesh.group(M.DP))
    res["grad"] = g
    return res


def case_dit_steps(out):
    """Two DiT train steps under each layout of DIT_CASES that spans this
    world: losses, grad norms, the gathered params and EMA, and where the
    parameters live."""
    import math

    from torch.distributed.tensor import DTensor

    from vavae_tpu_torch.parallel import mesh as M
    from vavae_tpu_torch.train.dit_trainer import local_tensor

    res = {}
    for name, (shape, kw) in DIT_CASES.items():
        if math.prod(shape) != M.process_count():
            continue
        mesh = M.make_mesh(*shape)
        model = tiny_dit(**kw)
        tr = dit_trainer(model, mesh)
        state = tr.distribute(tr.init_state())
        qkv = state.names.index("blocks.0.attn.qkv.weight")
        w12 = next(i for i, n in enumerate(state.names) if n.startswith("blocks.0.mlp.")
                   and n.endswith(".weight"))
        losses, norms = run_dit_steps(tr, state, dit_batches(2), mesh)
        full = state.gathered()
        res[name] = {
            "losses": losses, "norms": norms,
            "params": dict(zip(full.names, (p.detach().clone() for p in full.params))),
            "ema": dict(zip(full.names, full.ema_params)),
            "mu": dict(zip(full.names, full.opt.mu)),
            "qkv_dtensor": isinstance(state.params[qkv], DTensor),
            "qkv_local": local_tensor(state.params[qkv]).detach().clone(),
            "fan_out_local": local_tensor(state.params[w12]).detach().clone(),
            "num_heads": model.blocks[0].attn.num_heads,
            "local_numel": sum(local_tensor(p).numel() for p in state.params),
        }
    return res


def case_grad_accum(out):
    """grad_accum = 2 under DP: two micro-steps on two global batches."""
    from vavae_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh()
    tr = dit_trainer(tiny_dit(class_dropout_prob=0.0), mesh, grad_accum=2)
    state = tr.distribute(tr.init_state())
    run_dit_steps(tr, state, dit_batches(2, seed=3), mesh)
    return {"params": dict(zip(state.names, (p.detach().clone() for p in state.params)))}


def case_jax_inputs(out):
    """One step from the JAX init with the JAX draws handed in
    (``jax_inputs.pt``, written by the test) under each layout of
    JAX_LAYOUTS that spans this world; the gathered params and EMA."""
    import math

    import torch

    from vavae_tpu_torch.parallel import mesh as M

    inp = torch.load(os.path.join(out, "jax_inputs.pt"), weights_only=False)
    res = {}
    for name, (shape, _) in JAX_LAYOUTS.items():
        if math.prod(shape) != M.process_count():
            continue
        mesh = M.make_mesh(*shape)
        model = tiny_dit(class_dropout_prob=0.0)
        model.load_state_dict(inp["params"])
        tr = dit_trainer(model, mesh, **inp["opt"])
        state = tr.distribute(tr.init_state())
        losses, norms = run_dit_steps(tr, state, [inp["batch"]], mesh, draws=[inp["draws"]])
        full = state.gathered()
        res[name] = {"loss": losses[0], "grad_norm": norms[0],
                     "params": dict(zip(full.names, (p.detach().clone() for p in full.params))),
                     "ema": dict(zip(full.names, full.ema_params))}
    return res


def case_tp_ckpt(out):
    """A checkpoint written under tensor = 4 resumed under tensor = 1, and
    the reverse: step 1 of DIT_CASES' tiny DiT in one layout,
    ``save_checkpoint``, ``restore_checkpoint`` into a state of another
    init in the other layout, step 2 there; the losses and the gathered
    state after step 2."""
    from vavae_tpu_torch.parallel import mesh as M
    from vavae_tpu_torch.train import checkpoint as ckpt_lib

    batches = dit_batches(2)
    mesh4 = M.make_mesh(1, 1, 4)
    res = {}
    for name, (first, second) in {"tensor4_to_1": (mesh4, None),
                                  "tensor1_to_4": (None, mesh4)}.items():
        tr = dit_trainer(tiny_dit(), first)
        state = tr.distribute(tr.init_state())
        losses, _ = run_dit_steps(tr, state, batches[:1], first)
        ckpt_dir = os.path.join(out, f"ckpt_{name}")
        ckpt_lib.save_checkpoint(ckpt_dir, 1, state)  # collective; rank 0 writes
        tr = dit_trainer(tiny_dit(seed=1), second)
        state = tr.init_state()
        ckpt_lib.restore_checkpoint(os.path.join(ckpt_dir, "0000001.safetensors"), state)
        state = tr.distribute(state)
        losses += run_dit_steps(tr, state, batches[1:], second)[0]
        full = state.gathered()
        res[name] = {"losses": losses, "step": full.step, "tensor": [
            m.size(M.TENSOR_AXIS) if m is not None else 1 for m in (first, second)]} | {
            key: dict(zip(full.names, (t.detach().clone() for t in ts)))
            for key, ts in (("params", full.params), ("ema", full.ema_params),
                            ("mu", full.opt.mu), ("nu", full.opt.nu))}
    return res


def case_multihost(out):
    """tests/test_multihost.py's worker: a DiT step and a VA-VAE GAN step
    on rank shards, the process-indexed names, a checkpoint by rank 0."""
    import torch

    from vavae_tpu_torch.parallel import mesh as M
    from vavae_tpu_torch.train import checkpoint as ckpt_lib

    mesh = M.make_mesh()
    model = tiny_dit(hidden_size=32, num_heads=2, num_classes=4, class_dropout_prob=0.0)
    tr = dit_trainer(model, mesh)
    state = tr.distribute(tr.init_state())
    losses, _ = run_dit_steps(tr, state, dit_batches(1, seed=7, classes=4), mesh)
    path = ckpt_lib.save_checkpoint(os.path.join(out, "mh_ckpt"), 1, state)

    vtr, vstate = tiny_vae_trainer(mesh)
    vm = vtr.train_step(vstate, M.shard_batch(mesh, vae_images()))
    return {"loss": losses[0], "ckpt": path, "fname": M.process_fname("latents", ".safetensors", 0),
            "vae": {k: v.item() for k, v in vm.items()}, "vae_state": vae_state_dict(vstate),
            "bn_mean": vtr.disc.bn1.batch_moments[0].clone()}


def case_classifier(out):
    """Two data-parallel classifier steps in each mode of CLASSIFIER_CASES."""
    from vavae_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh()
    return {name: run_classifier(kw, mesh) for name, kw in CLASSIFIER_CASES.items()}


def case_pipelines(out):
    """do_train under DP, FSDP and TP, sample, extract_features and
    evaluate_tokenizer, each as a user runs it, on the test's files
    (``pipelines.pt``: their configs)."""
    import torch

    from vavae_tpu_torch.parallel import mesh as M

    spec = torch.load(os.path.join(out, "pipelines.pt"), weights_only=False)
    res = {}
    if "variants" in spec:
        import vavae_tpu_torch.models.dit as dit

        dit._VARIANTS.update(spec["variants"])
    from vavae_tpu_torch.pipelines.evaluate_tokenizer import evaluate_tokenizer
    from vavae_tpu_torch.pipelines.extract_features import extract
    from vavae_tpu_torch.pipelines.sample import do_sample
    from vavae_tpu_torch.pipelines.train_dit import do_train
    from vavae_tpu_torch.tokenizer import VA_VAE

    if spec.get("posterior_mode"):  # the test compares encodes, not draws
        VA_VAE.encode_images = lambda self, images, generator=None: (
            self.encode_moments(images).mode())
    for name, cfg in spec["train"].items():
        res[name] = do_train(cfg, device="cpu").step
    res["sample"] = sorted(os.listdir(do_sample(spec["sample"], device="cpu")))
    vae = VA_VAE(spec["vae_config"], img_size=spec["image_size"], device="cpu")
    extract(spec["images"], os.path.join(out, "latents_w"), vae, **spec["extract_kw"])
    res["eval"] = evaluate_tokenizer(vae, spec["images"], output_path=os.path.join(out, "eval_w"),
                                     **spec["eval_kw"])
    from vavae_tpu_torch.apps import generate_and_filter, iterative_finetune

    res["filter"] = generate_and_filter.run(**spec["filter_kw"])
    state, res["history"], _ = iterative_finetune.main(spec["iterative_argv"])
    M.barrier()
    return res


def case_preempt(out):
    """do_train under FSDP with a preemption signal (SIGUSR1 standing in for
    SIGTERM) that reaches rank 1 alone, after step 3 (``pipelines.pt``'s
    ``preempt`` config): the step each rank stopped at."""
    import signal

    import torch

    from vavae_tpu_torch.parallel import mesh as M
    from vavae_tpu_torch.pipelines import train_dit
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.utils.preemption import PreemptionGuard

    spec = torch.load(os.path.join(out, "pipelines.pt"), weights_only=False)
    import vavae_tpu_torch.models.dit as dit

    dit._VARIANTS.update(spec["variants"])
    train_dit.PreemptionGuard = lambda: PreemptionGuard(signals=(signal.SIGUSR1,))
    step = DiTTrainer.train_step

    def train_step(self, state, batch):
        m = step(self, state, batch)
        if state.step == 3 and M.process_index() == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return m

    DiTTrainer.train_step = train_step
    return {"step": train_dit.do_train(spec["preempt"], device="cpu").step}


def case_big_variant(out):
    """The big-variant command's body (``apps/big_variant.py:run``) on
    LightningDiT-S/2 at batch 2: FSDP over the world."""
    from vavae_tpu_torch.apps import big_variant

    return big_variant.run("LightningDiT-S/2", 2, 2, 0, "cpu")


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main() -> None:
    cases, outdir = sys.argv[1].split(","), sys.argv[2]
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from vavae_tpu_torch.parallel import mesh as M

    M.multihost_init("cpu")
    rank = M.process_index()
    for case in cases:
        res = CASES[case](outdir)
        torch.save(res, os.path.join(outdir, f"{case}_{rank}.pt"))
    M.barrier()
    M.shutdown()
    print(f"rank {rank}: OK {cases}")


if __name__ == "__main__":
    main()

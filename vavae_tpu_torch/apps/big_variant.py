"""The registry's big variants trained at full size (port of
``scripts/dryrun_big_variant.py``).

    python -m vavae_tpu_torch big_variant [LightningDiT-1p6B/1] [8] [--steps 2] [--seed 0]
    python -m vavae_tpu_torch big_variant LightningDiT-S/2 2 --device cpu
    torchrun --nproc_per_node=4 -m vavae_tpu_torch big_variant LightningDiT-1p6B/1 8

Builds the model as the JAX script builds it (16×16×32 latents, N = 256
tokens with patch 1, 1,000 classes, SwiGLU, RoPE, RMSNorm, remat "dots",
bf16 compute over fp32 weights), directly on the device from the seed, and
``DiTTrainer`` with the Linear/velocity transport and a bf16 Adam first
moment, everything else at its defaults. Then ``--steps`` train steps on
one seeded batch (x ~ N(0, 1), y = arange(batch) % 1000).

The world chooses the mode. One process holds the whole state on one card;
under torchrun's variables (``parallel/mesh.py:multihost_init``) the model
is FSDP2-sharded over ``make_mesh(data=1, fsdp=world)`` and the batch split
over the ranks, as the JAX script's fsdp mesh.

The layout differs from the JAX script's: the port keeps one tensor per
block, where flax scans the blocks into stacked ``[depth, ...]`` leaves,
and FSDP2 shards dim 0 of each, where the JAX mesh shards the stacked
kernel's last dim. So the largest parameter is adaLN's ``(6·width, width)``
(``(10752, 1792)`` for 1p6B) and its shard ``(10752/world, 1792)``, where the
JAX script shows ``[28, 1792, 10752]`` and ``[28, 1792, 1344]``.

The command fails (never yields a number) unless every step's loss is
finite, the state's step equals ``--steps``, the parameters and the EMA
moved, each rank's shard of the largest parameter holds 1/world of it,
attention kernels #1 and #2 ran exactly [2·depth, depth] times a step on the
card (remat "dots" runs the forward again in the backward; on the CPU the
wrappers take their plain versions and launch nothing), and each part of
the state holds the bytes its arithmetic says. Rank 0 prints one JSON line:
the JAX script's fields, then the port's.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from vavae_tpu_torch.apps.e2e_onchip import device_record
from vavae_tpu_torch.models.dit import LightningDiT, LightningDiT_models
from vavae_tpu_torch.ops.flash_attention import fused_qkv_attention
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.train.dit_trainer import DiTTrainer, local_tensor
from vavae_tpu_torch.transport import create_transport

LATENT, CHANNELS, CLASSES = 16, 32, 1000
MODEL_KW = dict(input_size=LATENT, in_channels=CHANNELS, num_classes=CLASSES, use_swiglu=True,
                use_rope=True, use_rmsnorm=True, use_checkpoint=True, checkpoint_policy="dots")
# the train state's parts: what a tensor of each holds per element
PART_BYTES = {"params": 4, "ema": 4, "mu": 2, "nu": 4, "grads": 4}


def build_model(name: str, device: torch.device, seed: int = 0) -> LightningDiT:
    """``name`` from the registry as the JAX script builds it, its JAX-style
    init drawn from ``seed`` on ``device`` itself."""
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with torch.device(device):
            return LightningDiT_models[name](**MODEL_KW, dtype=torch.bfloat16)


class MeasuredTrainer(DiTTrainer):
    """``DiTTrainer`` that keeps the gradients' bytes each step hands its
    optimizer (the step drops the gradients before it returns)."""

    grad_bytes: int = 0

    def apply_gradients(self, state, grads) -> None:
        self.grad_bytes = held_bytes(grads)
        super().apply_gradients(state, grads)


def build_trainer(model: LightningDiT, mesh=None, seed: int = 0) -> MeasuredTrainer:
    return MeasuredTrainer(model, create_transport("Linear", "velocity"),
                           adam_mu_dtype="bfloat16", global_seed=seed, mesh=mesh)


def draw_batch(batch: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's batch: x ~ N(0, 1) (batch, 16, 16, 32), y = arange %
    1000, drawn on the host so every device and world gets the same."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, LATENT, LATENT, CHANNELS), generator=gen)
    return x, torch.arange(batch, dtype=torch.int32) % CLASSES


def held_bytes(tensors) -> int:
    """The bytes the allocator holds for ``tensors``: each distinct storage
    once (FSDP2 keeps a parameter's shard in a buffer padded to the
    largest rank's rows, and lays a group's gradient shards out in one)."""
    storages = {}
    for t in tensors:
        s = local_tensor(t).untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())


def state_arithmetic(shapes: list[torch.Size], world: int, rank: int) -> dict:
    """Each part's bytes on ``rank`` from the parameters' full shapes. One
    process: elements × bytes an element. Under FSDP over ``world``: the
    parameters and the gradients at FSDP2's padded rows, ceil(rows /
    world) on every rank; the EMA and the moments at ``torch.chunk``'s
    rows (the trainer cuts them so), the last ranks' fewer or none."""
    padded = chunked = 0
    for shape in shapes:
        rest = math.prod(shape[1:])
        per = math.ceil(shape[0] / world)
        padded += per * rest
        chunked += max(0, min(per, shape[0] - rank * per)) * rest
    return {part: (padded if part in ("params", "grads") else chunked) * size
            for part, size in PART_BYTES.items()}


def kernel_launches() -> tuple[int, int]:
    return fused_qkv_attention.launches, fused_qkv_attention.bwd_launches


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_steps(trainer: DiTTrainer, state, batch, steps: int, draws=None) -> dict:
    """``steps`` train steps on ``batch`` (this rank's rows), each timed to
    its end on the device: its loss, seconds and kernel #1/#2 launches.
    ``draws[i]`` = (t, x0, drop or None) replaces step i's own draws."""
    losses, seconds, launches = [], [], []
    for i in range(steps):
        c0 = kernel_launches()
        _sync(trainer.device)
        t0 = time.perf_counter()
        m = trainer.train_step(state, batch, draws=None if draws is None else draws[i])
        losses.append(m["loss"].item())
        _sync(trainer.device)
        seconds.append(time.perf_counter() - t0)
        launches.append([b - a for a, b in zip(c0, kernel_launches())])
    return {"losses": losses, "seconds": seconds, "launches": launches}


def fail(msg: str) -> None:
    raise RuntimeError(f"big_variant: {msg}")


def run(name: str = "LightningDiT-1p6B/1", batch: int = 8, steps: int = 2, seed: int = 0,
        device: str | torch.device = "cuda") -> dict:
    """Build, step and check (module docstring); this rank's record."""
    dev = mesh_lib.multihost_init(device)  # raises without a card unless device is the CPU
    world, rank = mesh_lib.process_count(), mesh_lib.process_index()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    model = build_model(name, dev, seed)
    mesh = mesh_lib.make_mesh(data=1, fsdp=world) if world > 1 else None
    trainer = build_trainer(model, mesh, seed)
    names = [n for n, _ in model.named_parameters()]
    shapes = [p.shape for p in model.parameters()]
    state = trainer.distribute(trainer.init_state())
    _sync(dev)
    init_s = time.perf_counter() - t0

    big = max(range(len(shapes)), key=lambda i: math.prod(shapes[i]))
    shard = tuple(local_tensor(state.params[big]).shape)
    if math.prod(shard) * world != math.prod(shapes[big]):
        fail(f"rank {rank}: {names[big]} {tuple(shapes[big])} has a shard {shard}, not 1/{world}")
    watch = [i for i, n in enumerate(names) if "adaLN" in n or "final_layer" in n]
    before = [local_tensor(state.params[i]).detach().clone() for i in watch]
    ema_before = [state.ema_params[i].clone() for i in watch]

    xy = draw_batch(batch, seed)
    local = tuple(a.to(dev) for a in (mesh_lib.shard_batch(mesh, xy) if mesh else xy))
    out = train_steps(trainer, state, local, steps)
    losses, seconds = out["losses"], out["seconds"]

    depth = model.depth
    want_launches = [2 * depth, depth] if dev.type == "cuda" else [0, 0]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss {losses}")
    if state.step != steps:
        fail(f"state.step {state.step} after {steps} steps")
    if all(torch.equal(a, local_tensor(state.params[i])) for a, i in zip(before, watch)):
        fail("the steps left the parameters unchanged")
    if all(torch.equal(a, state.ema_params[i]) for a, i in zip(ema_before, watch)):
        fail("the steps left the EMA unchanged")
    if any(got != want_launches for got in out["launches"]):
        fail(f"kernel #1/#2 launches per step {out['launches']}, expected {want_launches}")
    measured = {"params": held_bytes(state.params), "ema": held_bytes(state.ema_params),
                "mu": held_bytes(state.opt.mu), "nu": held_bytes(state.opt.nu),
                "grads": trainer.grad_bytes}
    arithmetic = state_arithmetic(shapes, world, rank)
    if measured != arithmetic:
        fail(f"rank {rank}: the state's bytes {measured} differ from their arithmetic "
             f"{arithmetic}")

    timed = seconds[1:] or seconds
    n_params = sum(math.prod(s) for s in shapes)
    return {
        # the JAX script's fields
        "model": name, "batch": batch, "platform": "gpu" if dev.type == "cuda" else "cpu",
        "n_devices": world, "mesh": f"fsdp={world}", "params_b": round(n_params / 1e9, 3),
        "largest_param_shape": list(shapes[big]), "largest_param_shard_shape": list(shard),
        "loss_step1": losses[0], "loss_step2": losses[1] if steps > 1 else None,
        "init_s": init_s, "first_step_s": seconds[0],
        "second_step_s": seconds[1] if steps > 1 else None,
        # the port's
        "steps": steps, "seed": seed, "losses": losses, "step_s": seconds,
        "ms_per_step": statistics.median(timed) * 1e3,
        "img_per_s": batch / statistics.median(timed),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "launches_per_step": out["launches"][0], "launches_expected": want_launches,
        "device": device_record(dev), "rank": rank,
        "backend": torch.distributed.get_backend() if world > 1 else None,
        "params": n_params, "largest_param": names[big],
        "state_bytes": {part: {"measured": measured[part], "arithmetic": arithmetic[part]}
                        for part in PART_BYTES},
        "layout": "one tensor a block, FSDP2 dim-0 shards padded to ceil(rows / world) for "
                  "the parameters and gradients, torch.chunk rows for the EMA and moments; "
                  "the JAX script scans the blocks into [depth, ...] leaves",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="LightningDiT-1p6B/1",
                    choices=sorted(LightningDiT_models))
    ap.add_argument("batch", nargs="?", type=int, default=8,
                    help="global batch; it must divide over the world")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0, help="the init, the batch and the steps' draws")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    record = run(args.model, args.batch, args.steps, args.seed, args.device)
    if record["rank"] == 0:
        print(json.dumps(record), flush=True)
    mesh_lib.shutdown()
    return record


if __name__ == "__main__":
    main()

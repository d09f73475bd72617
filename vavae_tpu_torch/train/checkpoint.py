"""Step-numbered safetensors checkpoints of the DiT and the VA-VAE train
states (port of ``vavae_tpu/train/checkpoint.py``).

``{ckpt_dir}/{step:07d}.safetensors`` holds, with ``|``-joined keys, the
JAX package's tree:
  - DiT ``TrainState``: ``step``; ``params|…`` and ``ema_params|…``
    (``dit_state_to_jax``: scan-stacked blocks, Dense kernels (in, out)), so
    the port's ``load_dit_params`` and the JAX package's sampler both read
    them; ``opt_state|torch_adamw|…``: the port's AdamW count and moments
    (and the ``MultiSteps`` accumulator) under the torch parameter names.
    The JAX package's readers restore ``opt_state`` as None and drop it.
  - VA-VAE ``VAETrainState``: the JAX ``VAETrainState`` leaf for leaf:
    ``step``, ``gen_params|vae|…`` (``vae_state_to_jax``) and
    ``gen_params|proj|kernel``, ``disc_params|…``, ``disc_batch_stats|…``,
    and optax's Adam states ``{gen,disc}_opt|0|{count,mu|…,nu|…}`` with
    the empty ``{gen,disc}_opt|1``; so the JAX package's
    ``restore_checkpoint`` reads a port file and the port reads a JAX one.
``config.json`` sits beside the files. Resume takes the highest step
number, not the largest file. Files are written by a temporary file and a
rename; restoring is strict, except ``restore_weights``, the lenient,
shape-checked, weights-only load of a finetune's ``weight_init``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.train.dit_trainer import TrainState
from vavae_tpu_torch.train.vae_trainer import VAETrainState
from vavae_tpu_torch.utils.safetensors_io import (
    SEP,
    bf16_bits_to_float32,
    flatten,
    map_safetensors,
    tree_metadata,
    unflatten,
    write_safetensors,
)
from vavae_tpu_torch.utils.weights import (
    dit_state_from_jax,
    dit_state_to_jax,
    disc_state_from_jax,
    disc_state_to_jax,
    vae_state_from_jax,
    vae_state_to_jax,
)

OPT = "opt_state|torch_adamw"


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:  # stored as its bits, named in the metadata
        return t.detach().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.detach().cpu().numpy()


def state_tensors(state: TrainState) -> tuple[dict[str, np.ndarray], list[str]]:
    """The file's tensors for ``state`` and the keys stored as bf16 bits."""
    out = {"step": np.asarray(state.step, np.int32)}
    for prefix, tensors in (("params", state.params), ("ema_params", state.ema_params)):
        tree = dit_state_to_jax(dict(zip(state.names, tensors)))
        out.update(flatten(tree, prefix))
    out[f"{OPT}|count"] = np.asarray(state.opt.count, np.int32)
    out[f"{OPT}|mini_step"] = np.asarray(state.mini_step, np.int32)
    groups = {"mu": state.opt.mu, "nu": state.opt.nu}
    if state.acc_grads is not None:
        groups["acc"] = state.acc_grads
    bf16 = []
    for group, tensors in groups.items():
        for name, t in zip(state.names, tensors):
            key = f"{OPT}|{group}|{name}"
            out[key] = _host(t)
            if t.dtype == torch.bfloat16:
                bf16.append(key)
    return out, bf16


# -- the VA-VAE train state in the JAX tree -------------------------------------


def _gen_tree(names: list[str], tensors: list[torch.Tensor]) -> dict:
    """The generator's tensors (port names) → the JAX ``gen_params`` tree."""
    sd = dict(zip(names, tensors))
    tree = {"vae": vae_state_to_jax({k[len("vae."):]: v for k, v in sd.items()
                                     if k.startswith("vae.")})}
    if "proj.weight" in sd:  # 1×1 conv (D, E, 1, 1) → kernel (1, 1, E, D)
        tree["proj"] = {"kernel": np.transpose(_host(sd["proj.weight"].float()), (2, 3, 1, 0))}
    return tree


def _gen_sd(tree: dict) -> dict[str, torch.Tensor]:
    sd = {f"vae.{k}": v for k, v in vae_state_from_jax(tree["vae"]).items()}
    if "proj" in tree:
        sd["proj.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(tree["proj"]["kernel"], np.float32),
                                              (3, 2, 0, 1))))
    return sd


def vae_state_tensors(state: VAETrainState) -> tuple[dict[str, np.ndarray], list[str]]:
    """The file's tensors for a VA-VAE train state, and its empty subtrees."""
    out = {"step": np.asarray(state.step, np.int32)}
    out.update(flatten(_gen_tree(state.gen_names, state.gen_params), "gen_params"))
    disc = disc_state_to_jax({**dict(zip(state.disc_names, state.disc_params)),
                              **dict(zip(state.stat_names, state.disc_stats))})
    out.update(flatten(disc["params"], "disc_params"))
    empty = ["gen_opt|1", "disc_opt|1"]
    if "batch_stats" in disc:
        out.update(flatten(disc["batch_stats"], "disc_batch_stats"))
    else:
        empty.append("disc_batch_stats")
    for name, opt, tree_of in (
        ("gen_opt", state.gen_opt, lambda t: _gen_tree(state.gen_names, t)),
        ("disc_opt", state.disc_opt,
         lambda t: disc_state_to_jax(dict(zip(state.disc_names, t)))["params"]),
    ):
        out[f"{name}|0|count"] = np.asarray(opt.count, np.int32)
        out.update(flatten(tree_of(opt.mu), f"{name}|0|mu"))
        out.update(flatten(tree_of(opt.nu), f"{name}|0|nu"))
    return out, empty


def _copy_named(names: list[str], dst: list[torch.Tensor], sd: dict[str, torch.Tensor]) -> None:
    for name, t in zip(names, dst):
        t.copy_(sd[name])


def _load_vae_state(tensors: dict, state: VAETrainState, weights_only: bool = False) -> None:
    """Copy a file's VA-VAE tree (numpy leaves, JAX layout) into ``state``."""
    tree = unflatten({k: np.asarray(v) for k, v in tensors.items()})
    _copy_named(state.gen_names, state.gen_params, _gen_sd(tree["gen_params"]))
    disc = disc_state_from_jax({"params": tree["disc_params"],
                                "batch_stats": tree.get("disc_batch_stats", {})})
    _copy_named(state.disc_names, state.disc_params, disc)
    _copy_named(state.stat_names, state.disc_stats, disc)
    if weights_only:
        return
    for name, opt, names, sd_of in (
        ("gen_opt", state.gen_opt, state.gen_names, _gen_sd),
        ("disc_opt", state.disc_opt, state.disc_names,
         lambda t: disc_state_from_jax({"params": t})),
    ):
        adam = tree[name]["0"]
        _copy_named(names, opt.mu, sd_of(adam["mu"]))
        _copy_named(names, opt.nu, sd_of(adam["nu"]))
        opt.count = int(adam["count"])
    state.step = int(tree["step"])


@torch.no_grad()
def restore_weights(path: str, state: VAETrainState) -> tuple[int, int]:
    """A finetune's ``weight_init`` from a VA-VAE train-state file (the
    port's or the JAX package's): the generator's and the discriminator's
    weights and batch stats only, leaf by leaf where the shape matches the
    model's; step and both optimizers stay fresh. Leaves of another shape
    or missing from the file keep the fresh init, leaves the model lacks
    are dropped, each reported. Returns (loaded, skipped)."""
    tensors, _ = map_safetensors(path)
    want, _ = vae_state_tensors(state)
    weights = ("gen_params|", "disc_params|", "disc_batch_stats|")
    merged, loaded, skipped = dict(want), 0, 0
    for key in (k for k in want if k.startswith(weights)):
        if key not in tensors:
            print(f"[restore] missing in checkpoint, keeping init: {key}")
            skipped += 1
        elif tensors[key].shape != want[key].shape:
            print(f"[restore] shape mismatch for {key}: checkpoint {tensors[key].shape} vs "
                  f"model {want[key].shape} — keeping init")
            skipped += 1
        else:
            merged[key] = tensors[key]
            loaded += 1
    for key in (k for k in tensors if k.startswith(weights) and k not in want):
        print(f"[restore] not in model, dropped: {key}")
        skipped += 1
    print(f"[restore summary] loaded {loaded} leaves, skipped {skipped}")
    _load_vae_state(merged, state, weights_only=True)
    return loaded, skipped


# -- both states -------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState | VAETrainState,
                    config: Optional[dict] = None) -> str:
    """Write ``state`` to ``{ckpt_dir}/{step:07d}.safetensors`` (and
    ``config.json`` beside it); returns the path."""
    path = os.path.join(ckpt_dir, f"{step:07d}.safetensors")
    if isinstance(state, VAETrainState):
        tensors, empty = vae_state_tensors(state)
        write_safetensors(path, tensors, tree_metadata(empty_keys=empty))
    else:
        tensors, bf16 = state_tensors(state)
        write_safetensors(path, tensors, tree_metadata(bf16))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint with the highest step number in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in
             (re.fullmatch(r"(\d+)\.safetensors", n) for n in os.listdir(ckpt_dir)) if m]
    return os.path.join(ckpt_dir, f"{max(steps):07d}.safetensors") if steps else None


def checkpoint_count(ckpt_dir: str) -> int:
    """Distinct step-numbered checkpoints in ``ckpt_dir`` (``.safetensors``
    or the JAX package's legacy ``.msgpack``): the VA-VAE loop writes one a
    completed epoch, so this is the epochs-done count of a stage directory
    without ``epoch.json``."""
    if not os.path.isdir(ckpt_dir):
        return 0
    return len({m.group(1) for m in (re.fullmatch(r"(\d+)\.(?:safetensors|msgpack)", n)
                                     for n in os.listdir(ckpt_dir)) if m})


@torch.no_grad()
def restore_checkpoint(path: str, state: TrainState | VAETrainState):
    """Load the file at ``path`` into ``state`` in place, strictly: the
    file must hold exactly the tensors ``save_checkpoint`` writes for this
    state, with the same shapes."""
    tensors, meta = map_safetensors(path)
    bf16 = set(json.loads(meta.get("tree", "{}")).get("dtypes", {}))
    vae = isinstance(state, VAETrainState)
    want = vae_state_tensors(state)[0] if vae else state_tensors(state)[0]
    missing, extra = sorted(set(want) - set(tensors)), sorted(set(tensors) - set(want))
    bad = [k for k in want if k in tensors and tensors[k].shape != want[k].shape]
    if missing or extra or bad:
        raise ValueError(f"{path} does not match the train state: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}, shape mismatch {bad[:5]}")
    if vae:
        _load_vae_state({k: bf16_bits_to_float32(v) if k in bf16 else v
                         for k, v in tensors.items()}, state)
        return state

    def value(key: str) -> torch.Tensor:
        arr = tensors[key]
        return torch.from_numpy(bf16_bits_to_float32(arr) if key in bf16 else np.array(arr))

    for prefix, dst in (("params", state.params), ("ema_params", state.ema_params)):
        tree = unflatten({k[len(prefix) + 1:]: tensors[k] for k in want
                          if k.startswith(prefix + SEP)})
        sd = dit_state_from_jax(tree)
        for name, t in zip(state.names, dst):
            t.copy_(sd[name])
    for group, dst in (("mu", state.opt.mu), ("nu", state.opt.nu), ("acc", state.acc_grads)):
        for name, t in zip(state.names, dst or []):
            t.copy_(value(f"{OPT}|{group}|{name}"))
    state.opt.count = int(tensors[f"{OPT}|count"])
    state.mini_step = int(tensors[f"{OPT}|mini_step"])
    state.step = int(tensors["step"])
    return state

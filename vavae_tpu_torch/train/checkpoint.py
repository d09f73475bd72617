"""Step-numbered safetensors checkpoints of the DiT train state (port of
``vavae_tpu/train/checkpoint.py``).

``{ckpt_dir}/{step:07d}.safetensors`` holds, with ``|``-joined keys:
  - ``step``: the step count (0-d int32);
  - ``params|…`` and ``ema_params|…``: the weights in the JAX package's tree
    (``dit_state_to_jax``: scan-stacked blocks, Dense kernels (in, out)), so
    the port's ``load_dit_params`` and the JAX package's sampler both read
    them;
  - ``opt_state|torch_adamw|…``: the port's AdamW count and moments (and
    the ``MultiSteps`` accumulator) under the torch parameter names. The
    JAX package's readers restore ``opt_state`` as None and drop this subtree.
``config.json`` sits beside the files. Resume takes the highest step
number, not the largest file. Files are written by a temporary file and a
rename; restoring is strict.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.train.dit_trainer import TrainState
from vavae_tpu_torch.utils.safetensors_io import (
    SEP,
    bf16_bits_to_float32,
    flatten,
    map_safetensors,
    tree_metadata,
    unflatten,
    write_safetensors,
)
from vavae_tpu_torch.utils.weights import dit_state_from_jax, dit_state_to_jax

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


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState,
                    config: Optional[dict] = None) -> str:
    """Write ``state`` to ``{ckpt_dir}/{step:07d}.safetensors`` (and
    ``config.json`` beside it); returns the path."""
    path = os.path.join(ckpt_dir, f"{step:07d}.safetensors")
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


@torch.no_grad()
def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the file at ``path`` into ``state`` in place, strictly: the
    file must hold exactly the tensors ``save_checkpoint`` writes for this
    state, with the same shapes."""
    tensors, meta = map_safetensors(path)
    bf16 = set(json.loads(meta.get("tree", "{}")).get("dtypes", {}))
    want, _ = state_tensors(state)
    missing, extra = sorted(set(want) - set(tensors)), sorted(set(tensors) - set(want))
    bad = [k for k in want if k in tensors and tensors[k].shape != want[k].shape]
    if missing or extra or bad:
        raise ValueError(f"{path} does not match the train state: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}, shape mismatch {bad[:5]}")

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

"""LoRA adapters over the DiT's weights (port of ``vavae_tpu/train/lora.py``).

Rank-r adapters (A ~ N(0, 0.01²), B = 0, scale α/r) on every weight whose
module is named ``qkv``, ``proj``, ``w12`` or ``w3``: the attention qkv and
output projections, the SwiGLU projections and the patch embedding's
``x_embedder.proj``, as the JAX package's name rule selects them.

The port keys the adapters by the DiT's parameter name, one per block:
``{"blocks.3.attn.qkv.weight": {"a": (in, r), "b": (r, out), "alpha": ()}}``
in fp32, A and B in the JAX package's (in, out) orientation. ``merge_lora``
gives ``W + (α/r)·(A·B)ᵀ`` on the port's (out, in) weights, the JAX
``W + (α/r)·A·B`` on its kernels. The LoRA-only file is the JAX package's
flax msgpack of its tree, keyed by the flax parameter path with the blocks
scan-stacked (``blocks/block/attn/qkv/kernel/{a, b}`` of shape (depth, in,
r) and (depth, r, out), one ``alpha`` for the stack); ``load_lora`` also
reads the unstacked ``block_{i}`` layout.
"""
from __future__ import annotations

import contextlib
import re
from typing import Mapping, Sequence

import numpy as np
import torch

from vavae_tpu_torch.utils.msgpack_io import read_msgpack, widen, write_msgpack

DEFAULT_TARGETS = ("qkv", "proj", "w12", "w3")
Adapters = dict[str, dict[str, torch.Tensor]]


def is_target(name: str, targets: Sequence[str] = DEFAULT_TARGETS) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in targets


@torch.no_grad()
def init_lora(named_params: Mapping[str, torch.Tensor], rank: int = 8, alpha: float = 16.0,
              targets: Sequence[str] = DEFAULT_TARGETS,
              generator: torch.Generator | None = None) -> Adapters:
    """Adapters for every targeted weight of ``named_params`` (A drawn from
    ``generator`` on its device, B zero, so the merge starts as the base)."""
    lora: Adapters = {}
    for name, w in named_params.items():
        if not is_target(name, targets):
            continue
        d_out, d_in = w.shape
        dev = w.device
        a = 0.01 * torch.randn((d_in, rank), generator=generator, device=dev)
        lora[name] = {"a": a, "b": torch.zeros((rank, d_out), device=dev),
                      "alpha": torch.tensor(float(alpha), device=dev)}
    return lora


def merge_lora(params: Mapping[str, torch.Tensor], lora: Adapters, rank: int
               ) -> dict[str, torch.Tensor]:
    """The adapted weights ``W + (α/r)·(A·B)ᵀ``, the delta cast to W's
    dtype before the scale, as the JAX ``merge_lora`` (differentiable in A
    and B)."""
    out = {}
    for name, ad in lora.items():
        w = params[name]
        delta = (ad["a"] @ ad["b"]).to(w.dtype)
        out[name] = w + ((ad["alpha"] / rank) * delta).t()
    return out


@contextlib.contextmanager
def swapped_weights(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor]):
    """``model`` computes with ``tensors`` in place of the parameters of those
    names inside the block, the original parameters back after it. Unlike
    ``torch.func.functional_call`` the swap can span a backward pass, where
    activation checkpointing runs the blocks' forward again and must see
    the same weights."""
    saved = []
    try:
        for name, t in tensors.items():
            mod_name, leaf = name.rsplit(".", 1)
            mod = model.get_submodule(mod_name)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def lora_size(lora: Adapters) -> int:
    """Elements of the JAX tree's leaves: A and B, and one ``alpha`` per
    flax kernel (a scan-stacked kernel has one for all its blocks)."""
    paths = {tuple(_jax_path(name)[0]) for name in lora}
    return sum(ad[k].numel() for ad in lora.values() for k in ("a", "b")) + len(paths)


# -- the JAX package's tree ------------------------------------------------------


def _jax_path(name: str) -> tuple[list[str], int | None]:
    """A port weight name → (flax path of its kernel, block index or None)."""
    parts = name.split(".")[:-1]
    if parts[0] == "blocks":
        return ["blocks", "block", *parts[2:], "kernel"], int(parts[1])
    return [*parts, "kernel"], None


def lora_to_jax(lora: Adapters) -> dict:
    """The JAX package's LoRA tree (numpy fp32), blocks scan-stacked."""
    tree: dict = {}
    stacks: dict[tuple, dict[int, dict]] = {}
    for name, ad in lora.items():
        path, i = _jax_path(name)
        host = {k: np.asarray(v.detach().float().cpu().numpy(), np.float32) for k, v in ad.items()}
        if i is None:
            _set(tree, path, host)
        else:
            stacks.setdefault(tuple(path), {})[i] = host
    for path, per_block in stacks.items():
        depth = len(per_block)
        if sorted(per_block) != list(range(depth)):
            raise ValueError(f"{'/'.join(path)}: adapters of blocks {sorted(per_block)}")
        alphas = {float(per_block[i]["alpha"]) for i in range(depth)}
        if len(alphas) != 1:
            raise ValueError(f"{'/'.join(path)}: one alpha per stack, got {sorted(alphas)}")
        _set(tree, list(path), {
            "a": np.stack([per_block[i]["a"] for i in range(depth)]),
            "b": np.stack([per_block[i]["b"] for i in range(depth)]),
            "alpha": per_block[0]["alpha"],
        })
    return tree


def lora_from_jax(tree: Mapping, device: str | torch.device = "cpu") -> Adapters:
    """The JAX package's LoRA tree (scan-stacked or ``block_{i}``) → the
    port's adapters."""
    out: Adapters = {}

    def leaf(x) -> torch.Tensor:
        return torch.from_numpy(np.array(widen(x), np.float32)).to(device)

    def walk(node: Mapping, path: list[str]) -> None:
        if "a" in node and "b" in node:
            mods = path[:-1]  # drop "kernel"
            if mods[:2] == ["blocks", "block"]:
                a, b = np.asarray(widen(node["a"])), np.asarray(widen(node["b"]))
                for i in range(a.shape[0]):
                    out[".".join(["blocks", str(i), *mods[2:], "weight"])] = {
                        "a": leaf(a[i]), "b": leaf(b[i]), "alpha": leaf(node["alpha"])}
                return
            m = re.fullmatch(r"block_(\d+)", mods[0])
            mods = ["blocks", m.group(1), *mods[1:]] if m else mods
            out[".".join([*mods, "weight"])] = {k: leaf(node[k]) for k in ("a", "b", "alpha")}
            return
        for k, v in node.items():
            walk(v, path + [k])

    walk(tree, [])
    return out


def _set(tree: dict, path: list[str], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def save_lora(path: str, lora: Adapters) -> None:
    """The LoRA-only file: flax msgpack of the JAX tree (the JAX package's
    ``load_lora`` reads it)."""
    write_msgpack(path, lora_to_jax(lora))


def load_lora(path: str, device: str | torch.device = "cpu") -> Adapters:
    return lora_from_jax(read_msgpack(path), device)

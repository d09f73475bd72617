"""Weight bridge between JAX-package param trees and the port's state dicts.

Each function takes a flax param tree as numpy arrays and returns a
``state_dict`` (of CPU tensors) for the port's module, so both compute the
same function. The walk is the one of ``vavae_tpu/utils/torch_export.py``,
whose target names are the reference's, which the port's modules use:

  - flax Dense kernel (in, out)  → Linear weight (out, in)
  - flax Conv kernel HWIO        → Conv2d weight OIHW
  - Embed ``embedding``          → Embedding weight
  - RMSNorm ``weight``, GroupNorm ``scale``/``bias`` (under the extra
    ``norm`` level of GroupNorm32) → weight/bias
  - the ``nn.scan``-stacked DiT blocks unstack along the leading depth axis
  - the split-half RoPE q/k column order is KEPT: the attention kernel
    relies on it (only a reference ``.pt`` needs ``rope_permute_qkv``).

The port's PatchEmbed is a Linear over the (p, p, C) flattening, as the JAX
Dense, so its weight is the transposed kernel. ``dit_state_to_jax`` walks
the other way, so the port's checkpoints hold the JAX package's tree.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vavae_tpu_torch.models.posembed import rope_permutation


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(sd: dict, tree: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _dense(sd: dict, tree: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(tree["kernel"]), (1, 0)))
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _t(tree["bias"])


def _groupnorm(sd: dict, tree: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(tree["norm"]["scale"])  # GroupNorm32 wraps under "norm"
    sd[f"{prefix}.bias"] = _t(tree["norm"]["bias"])


# -- VAE -------------------------------------------------------------------------


def _resnet_block(sd: dict, tree: Mapping, p: str) -> None:
    _groupnorm(sd, tree["norm1"], f"{p}.norm1")
    _conv(sd, tree["conv1"], f"{p}.conv1")
    _groupnorm(sd, tree["norm2"], f"{p}.norm2")
    _conv(sd, tree["conv2"], f"{p}.conv2")
    if "nin_shortcut" in tree:
        _conv(sd, tree["nin_shortcut"], f"{p}.nin_shortcut")


def _attn_block(sd: dict, tree: Mapping, p: str) -> None:
    _groupnorm(sd, tree["norm"], f"{p}.norm")
    for name in ("q", "k", "v", "proj_out"):
        _conv(sd, tree[name], f"{p}.{name}")


def vae_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX AutoencoderKL params → the port's AutoencoderKL state dict."""
    sd: dict[str, torch.Tensor] = {}
    for side in ("encoder", "decoder"):
        for key, sub in params[side].items():
            if key in ("conv_in", "conv_out"):
                _conv(sd, sub, f"{side}.{key}")
            elif key == "norm_out":
                _groupnorm(sd, sub, f"{side}.norm_out")
            elif key.startswith("mid_block"):
                _resnet_block(sd, sub, f"{side}.mid.block_{key[-1]}")
            elif key == "mid_attn_1":
                _attn_block(sd, sub, f"{side}.mid.attn_1")
            elif "_block_" in key:  # down_{i}_block_{j} / up_{i}_block_{j}
                kind, i, _, j = key.split("_")
                _resnet_block(sd, sub, f"{side}.{kind}.{i}.block.{j}")
            elif "_attn_" in key:
                kind, i, _, j = key.split("_")
                _attn_block(sd, sub, f"{side}.{kind}.{i}.attn.{j}")
            elif key.endswith(("_downsample", "_upsample")):
                kind, i, samp = key.split("_")
                _conv(sd, sub["conv"], f"{side}.{kind}.{i}.{samp}.conv")
            else:
                raise KeyError(f"unknown {side} entry {key!r}")
    _conv(sd, params["quant_conv"], "quant_conv")
    _conv(sd, params["post_quant_conv"], "post_quant_conv")
    return sd


# -- DiT -------------------------------------------------------------------------


def _dit_block(sd: dict, tree: Mapping, p: str) -> None:
    _dense(sd, tree["attn"]["qkv"], f"{p}.attn.qkv")
    _dense(sd, tree["attn"]["proj"], f"{p}.attn.proj")
    _dense(sd, tree["adaLN"], f"{p}.adaLN_modulation.1")
    for name in ("q_norm", "k_norm"):
        if name in tree["attn"]:
            w = tree["attn"][name]
            if "weight" in w:  # RMSNorm
                sd[f"{p}.attn.{name}.weight"] = _t(w["weight"])
            else:  # LayerNorm scale/bias
                sd[f"{p}.attn.{name}.weight"] = _t(w["scale"])
                sd[f"{p}.attn.{name}.bias"] = _t(w["bias"])
    for name in ("norm1", "norm2"):
        if name in tree:  # RMSNorm weights; the LayerNorm variant has none
            sd[f"{p}.{name}.weight"] = _t(tree[name]["weight"])
    for name, sub in tree["mlp"].items():  # w12/w3 (SwiGLU) or fc1/fc2
        _dense(sd, sub, f"{p}.mlp.{name}")


def dit_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX LightningDiT params (scan-stacked or ``block_{i}``) → the port's
    LightningDiT state dict."""
    sd: dict[str, torch.Tensor] = {}
    _dense(sd, params["x_embedder"]["proj"], "x_embedder.proj")
    _dense(sd, params["t_embedder"]["fc1"], "t_embedder.mlp.0")
    _dense(sd, params["t_embedder"]["fc2"], "t_embedder.mlp.2")
    sd["y_embedder.embedding_table.weight"] = _t(params["y_embedder"]["table"]["embedding"])
    if "blocks" in params:
        stacked = params["blocks"]["block"]
        depth = len(np.asarray(stacked["adaLN"]["kernel"]))

        def take(tree, i):
            if isinstance(tree, Mapping):
                return {k: take(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        for i in range(depth):
            _dit_block(sd, take(stacked, i), f"blocks.{i}")
    else:
        i = 0
        while f"block_{i}" in params:
            _dit_block(sd, params[f"block_{i}"], f"blocks.{i}")
            i += 1
    _dense(sd, params["final_layer"]["adaLN"], "final_layer.adaLN_modulation.1")
    _dense(sd, params["final_layer"]["linear"], "final_layer.linear")
    if "norm_final" in params["final_layer"]:
        sd["final_layer.norm_final.weight"] = _t(params["final_layer"]["norm_final"]["weight"])
    return sd


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _dense_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _dit_block_to_jax(sd: Mapping[str, torch.Tensor], p: str) -> dict:
    attn = {"qkv": _dense_to_jax(sd, f"{p}.attn.qkv"), "proj": _dense_to_jax(sd, f"{p}.attn.proj")}
    for name in ("q_norm", "k_norm"):
        key = f"{p}.attn.{name}"
        if f"{key}.bias" in sd:  # LayerNorm
            attn[name] = {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}
        elif f"{key}.weight" in sd:  # RMSNorm
            attn[name] = {"weight": _np(sd[f"{key}.weight"])}
    tree = {"attn": attn, "adaLN": _dense_to_jax(sd, f"{p}.adaLN_modulation.1"), "mlp": {}}
    for name in ("norm1", "norm2"):
        if f"{p}.{name}.weight" in sd:
            tree[name] = {"weight": _np(sd[f"{p}.{name}.weight"])}
    for name in ("w12", "w3", "fc1", "fc2"):
        if f"{p}.mlp.{name}.weight" in sd:
            tree["mlp"][name] = _dense_to_jax(sd, f"{p}.mlp.{name}")
    return tree


def dit_state_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's LightningDiT state dict → the JAX package's param tree,
    with the blocks scan-stacked under ``blocks/block`` (leading depth
    axis), as numpy fp32: the inverse of ``dit_state_from_jax``."""
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    blocks = [_dit_block_to_jax(sd, f"blocks.{i}") for i in range(depth)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    final = {"adaLN": _dense_to_jax(sd, "final_layer.adaLN_modulation.1"),
             "linear": _dense_to_jax(sd, "final_layer.linear")}
    if "final_layer.norm_final.weight" in sd:
        final["norm_final"] = {"weight": _np(sd["final_layer.norm_final.weight"])}
    return {
        "x_embedder": {"proj": _dense_to_jax(sd, "x_embedder.proj")},
        "t_embedder": {"fc1": _dense_to_jax(sd, "t_embedder.mlp.0"),
                       "fc2": _dense_to_jax(sd, "t_embedder.mlp.2")},
        "y_embedder": {"table": {"embedding": _np(sd["y_embedder.embedding_table.weight"])}},
        "blocks": {"block": stack(blocks)},
        "final_layer": final,
    }


@torch.no_grad()
def randomize_(model: torch.nn.Module, seed: int, std: float = 0.02) -> None:
    """Seeded non-zero weights for runs without a checkpoint: norm weights
    1 + N(0, std²), every other parameter N(0, std²). (A fresh DiT outputs
    exactly 0: its init zeroes adaLN and the final layer.)"""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=gen, device=device, dtype=p.dtype)
        p.copy_(1.0 + std * noise if "norm" in name else std * noise)


# -- reference torch checkpoints -------------------------------------------------


def rope_permute_qkv(w: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Permute the q and k output rows of a reference qkv Linear weight
    (3·dim, in) or bias (3·dim,) from interleaved to split-half RoPE order
    (``vavae_tpu/utils/torch_convert.py:_rope_permute_qkv``). q·kᵀ is
    invariant to a permutation shared by q and k."""
    dim = w.shape[0] // 3
    head_dim = dim // num_heads
    perm = torch.as_tensor(rope_permutation(head_dim))
    x = w.reshape(3, num_heads, head_dim, *w.shape[1:])
    qk = x[:2].index_select(2, perm)
    return torch.cat([qk, x[2:]], dim=0).reshape(w.shape)


def dit_state_from_reference(sd: Mapping[str, torch.Tensor], num_heads: int,
                             use_rope: bool) -> dict[str, torch.Tensor]:
    """A reference LightningDiT state dict → the port's names and layouts:
    the conv patch embedding becomes the (p, p, C)-flattened Linear, the
    frozen ``pos_embed`` is dropped (the port rebuilds it), and with RoPE the
    q/k rows (and any qk-norm weights) move to split-half order."""
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        if k == "pos_embed":
            continue
        v = v.float()
        if k == "x_embedder.proj.weight" and v.dim() == 4:  # (D, C, p, p)
            v = v.permute(0, 2, 3, 1).reshape(v.shape[0], -1)
        elif use_rope and k.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            v = rope_permute_qkv(v, num_heads)
        elif use_rope and (".q_norm." in k or ".k_norm." in k):
            v = v.index_select(-1, torch.as_tensor(rope_permutation(v.shape[-1])))
        out[k] = v
    return out

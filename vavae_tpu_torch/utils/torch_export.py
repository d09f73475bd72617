"""The port's state dicts → the reference's torch state dicts (port of
``vavae_tpu/utils/torch_export.py``).

The inverses of ``utils/weights.py:dit_state_from_reference`` and of
``tokenizer.py:reference_vae_state``, so a checkpoint trained with the port
goes back to the reference code (``lightningdit.py`` and
``autoencoder.py`` naming):
  - the DiT's patch embedding, a Linear over the (p, p, C)-flattened
    patch here, becomes the reference's conv weight (D, C, p, p);
  - with RoPE, the q and k rows of every ``attn.qkv`` (and the q/k norm
    weights) move from the split-half order back to the reference's
    interleaved one (``models/posembed.py:rope_permutation`` inverted);
    attention outputs are unchanged, and the round trip is exact;
  - the reference's frozen sin-cos ``pos_embed`` (1, N, D), which the port
    rebuilds instead of storing, is added when ``input_size`` is given;
  - the VAE's module names are the reference's already: its tensors pass
    through as fp32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vavae_tpu_torch.models.posembed import get_2d_sincos_pos_embed, rope_permutation


def _rope_unpermute_qkv(w: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q, k rows of a (3·dim, in) weight or (3·dim,) bias from split-half
    back to interleaved order (``weights.rope_permute_qkv`` inverted)."""
    dim = w.shape[0] // 3
    head_dim = dim // num_heads
    inv = torch.as_tensor(np.argsort(rope_permutation(head_dim)))
    x = w.reshape(3, num_heads, head_dim, *w.shape[1:])
    return torch.cat([x[:2].index_select(2, inv), x[2:]], dim=0).reshape(w.shape)


def dit_state_to_reference(sd: Mapping[str, torch.Tensor], patch_size: int, num_heads: int,
                           use_rope: bool, input_size: int = 0) -> dict[str, torch.Tensor]:
    """The port's LightningDiT state dict → the reference's, fp32 and
    contiguous on the CPU."""
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = v.detach().float().cpu()
        if k == "x_embedder.proj.weight":  # (D, p·p·C), (p, p, C) order → (D, C, p, p)
            v = v.reshape(v.shape[0], patch_size, patch_size, -1).permute(0, 3, 1, 2)
        elif use_rope and k.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            v = _rope_unpermute_qkv(v, num_heads)
        elif use_rope and (".q_norm." in k or ".k_norm." in k):
            v = v.index_select(-1, torch.as_tensor(np.argsort(rope_permutation(v.shape[-1]))))
        out[k] = v.contiguous()
    if input_size:
        hidden = sd["x_embedder.proj.weight"].shape[0]
        out["pos_embed"] = torch.from_numpy(
            get_2d_sincos_pos_embed(hidden, input_size // patch_size)[None])
    return out


def vae_state_to_reference(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's AutoencoderKL state dict → the reference's (the same
    names), fp32 and contiguous on the CPU."""
    return {k: v.detach().float().cpu().contiguous() for k, v in sd.items()}

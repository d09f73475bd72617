"""Plain attention op (port of ``vavae_tpu/ops/attention.py``).

``plain_attention`` is the counterpart of the JAX ``_xla_attention``: fp32
logits, fp32 softmax, probabilities cast to the input dtype before P·V.
``dot_product_attention`` applies split-half RoPE outside the op, as the
JAX function does off the TPU. It serves the qk-norm attention branch,
whose Hopper kernels (``_attn_kernel_small_rope`` and relatives) are not
ported yet.
"""
from __future__ import annotations

import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Split-half rotation partner: (x1 | x2) -> (-x2 | x1)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, N, H, D) -> (B, N, H, D); softmax in fp32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """``rope``: optional (cos, sin) split-half tables of shape (N, D)."""
    if rope is not None:
        cos, sin = rope
        fc = cos[None, :, None, :].to(q.dtype)
        fs = sin[None, :, None, :].to(q.dtype)
        q = q * fc + rotate_half(q) * fs
        k = k * fc + rotate_half(k) * fs
    return plain_attention(q, k, v)

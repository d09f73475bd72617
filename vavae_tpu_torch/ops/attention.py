"""Attention op (port of ``vavae_tpu/ops/attention.py``).

``plain_attention`` is the counterpart of the JAX ``_xla_attention``: fp32
logits, fp32 softmax, probabilities cast to the input dtype before P·V.
``dot_product_attention`` serves the qk-norm attention branch. CUDA tensors
go through ``flash_attention``, the hand-written kernels of
``_attn_kernel_small_rope``, ``_attn_kernel_small`` and
``_attn_bwd_kernel_small`` (as the JAX function takes the Pallas kernel on
the TPU); other tensors through the plain op, with split-half RoPE applied
outside it, as the JAX function does off the TPU. A kernel failure raises.
"""
from __future__ import annotations

import torch

from vavae_tpu_torch.ops.flash_attention import flash_attention, rotate_half


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
    """q, k, v: (B, N, H, D) -> (B, N, H, D). ``rope``: optional (cos, sin)
    split-half tables of shape (N, D)."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, rope)
    if rope is not None:
        cos, sin = rope
        fc = cos[None, :, None, :].to(q.dtype)
        fs = sin[None, :, None, :].to(q.dtype)
        q = q * fc + rotate_half(q) * fs
        k = k * fc + rotate_half(k) * fs
    return plain_attention(q, k, v)

"""Attention op (port of ``vavae_tpu/ops/attention.py``).

``dot_product_attention`` serves the qk-norm attention branch. CUDA tensors
go through ``flash_attention``, the hand-written kernels of
``_attn_kernel_small_rope``, ``_attn_kernel_small`` and
``_attn_bwd_kernel_small`` for N ≤ 1024 and of ``_flash_kernel`` beyond (as
the JAX function takes the Pallas kernels on the TPU); other tensors through
``xla_rope_attention``, the plain op with split-half RoPE applied outside
it in the input dtype, as the JAX function does off the TPU. A kernel
failure raises.
"""
from __future__ import annotations

import torch

from vavae_tpu_torch.ops.flash_attention import (  # noqa: F401  (rotate_half re-exported)
    flash_attention,
    rotate_half,
    xla_rope_attention,
)


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
    return xla_rope_attention(q, k, v, rope)

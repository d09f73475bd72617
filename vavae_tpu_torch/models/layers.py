"""Core DiT layers (port of ``vavae_tpu/models/layers.py``).

Parameter names follow the reference LightningDiT modules
(``adaLN_modulation.1``, ``t_embedder.mlp.0``, ``y_embedder.embedding_table``)
so a reference ``.pt`` state dict loads with no renaming.

``dtype`` is the compute dtype, as flax's ``dtype=``: weights are stored in
fp32 and cast at use; the norms compute in fp32 inside.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

# rotate_half lives in the JAX layers module; it is re-exported here
from vavae_tpu_torch.ops.attention import dot_product_attention, rotate_half  # noqa: F401
from vavae_tpu_torch.ops.flash_attention import fused_qkv_attention


def natural_attention_enabled() -> bool:
    """Attention straight off the fused qkv tensor (the default);
    ``VAVAE_ATTN_NATURAL=0`` sends a model without QK-norm through the
    separate q, k, v route instead, for A/B comparison. Read at every
    forward, as the JAX package reads it at every trace."""
    return os.environ.get("VAVAE_ATTN_NATURAL", "1") != "0"


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` over fp32-stored weights."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


def modulate(x: torch.Tensor, shift: torch.Tensor | None, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) [+ shift], broadcast over tokens."""
    out = x * (1.0 + scale[:, None, :])
    if shift is not None:
        out = out + shift[:, None, :]
    return out


class RMSNorm(nn.Module):
    """Normalise in fp32, multiply by the weight in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (normed.to(x.dtype) * self.weight.to(x.dtype)).to(self.dtype)


class LayerNormNoAffine(nn.Module):
    """LayerNorm(elementwise_affine=False, eps=1e-6), computed in fp32."""

    def __init__(self, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(self.dtype)


class Mlp(nn.Module):
    """Two-layer MLP with tanh-approximate GELU."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwiGLUFFN(nn.Module):
    """SwiGLU with a fused gate/up projection (w12) and down projection (w3)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w12 = Linear(in_dim, 2 * hidden_dim, dtype=dtype)
        self.w3 = Linear(hidden_dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features, cos first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_embed_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.dtype = dtype
        self.mlp = nn.Sequential(
            Linear(freq_embed_size, hidden_size, dtype=dtype),
            nn.SiLU(),
            Linear(hidden_size, hidden_size, dtype=dtype),
        )

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.freq_embed_size).to(self.dtype))


class LabelEmbedder(nn.Module):
    """Class-label table with an extra null row when CFG dropout is on.

    In training (``train=True``) each label is replaced by the null row where
    a uniform draw from ``generator`` is below ``dropout_prob``;
    ``force_drop_ids`` (1 = drop) takes the place of the draw."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.dtype = dtype
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor, train: bool = False,
                force_drop_ids: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            u = torch.rand(labels.shape, generator=generator, device=labels.device)
            labels = torch.where(u < self.dropout_prob, self.num_classes, labels)
        return self.embedding_table(labels).to(self.dtype)


def apply_rope(x: torch.Tensor, freqs_cos: torch.Tensor, freqs_sin: torch.Tensor) -> torch.Tensor:
    """x: (..., N, head_dim); freqs: (N, head_dim), split-half layout."""
    return x * freqs_cos + rotate_half(x) * freqs_sin


class Attention(nn.Module):
    """Multi-head attention with qkv bias, optional QK-norm and 2-D RoPE.

    Without QK-norm (every shipped DiT config) attention runs straight off
    the fused qkv tensor through ``fused_qkv_attention``. The QK-norm branch
    normalises q and k and hands them, with the strided view of v, to
    ``dot_product_attention``, which runs ``flash_attention`` on the card.
    Both run hand-written kernels on the card and the plain versions on the
    CPU. Beyond 1024 tokens both reach the long route, whose output is fp32
    for RoPE models (q, k rotated with the fp32 tables, as in JAX); ``proj``
    casts it to the compute dtype, as the JAX ``nn.Dense`` does. With
    ``VAVAE_ATTN_NATURAL=0`` a model without QK-norm takes the separate
    q, k, v route too (``natural_attention_enabled``)."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False,
                 use_rmsnorm: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qk_norm = qk_norm
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        if qk_norm:
            if use_rmsnorm:
                self.q_norm = RMSNorm(self.head_dim, dtype=dtype)
                self.k_norm = RMSNorm(self.head_dim, dtype=dtype)
            else:
                self.q_norm = nn.LayerNorm(self.head_dim, eps=1e-6)
                self.k_norm = nn.LayerNorm(self.head_dim, eps=1e-6)

    def _norm(self, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if isinstance(norm, nn.LayerNorm):  # flax LayerNorm: fp32 statistics
            return norm(x.float()).to(self.dtype)
        return norm(x)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        B, N, _ = x.shape  # num_heads is the local count under tensor parallelism
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim)
        if self.num_heads == 0:
            # a tensor-parallel rank left with no heads: no attention, and a
            # zero partial product into proj's all-reduce
            return self.proj(qkv[:, :, 2].reshape(B, N, 0))
        if not self.qk_norm and natural_attention_enabled():
            out = fused_qkv_attention(qkv, rope=rope)
            return self.proj(out.reshape(B, N, -1))
        q, k, v = qkv.unbind(dim=2)
        if self.qk_norm:
            q = self._norm(self.q_norm, q)
            k = self._norm(self.k_norm, k)
        out = dot_product_attention(q, k, v, rope=rope)
        return self.proj(out.reshape(B, N, -1))

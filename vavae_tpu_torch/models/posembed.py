"""Positional embeddings: frozen 2-D sin-cos table and 2-D RoPE (numpy).

Copy of ``vavae_tpu/models/posembed.py``: the RoPE tables are in the
SPLIT-HALF layout (pairs (i, i + D/2) rotate together), which the attention
kernel uses as ``x·cos + roll(x, D/2)·sin'``.
"""
from __future__ import annotations

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size², embed_dim) float32 table, row-major over (row, col)."""
    coords = np.arange(grid_size, dtype=np.float32)
    grid_w, grid_h = np.meshgrid(coords, coords)
    emb_h = _sincos_1d(embed_dim // 2, grid_w)
    emb_w = _sincos_1d(embed_dim // 2, grid_h)
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def rope_2d_freqs(
    head_dim: int, grid_size: int, theta: float = 10000.0
) -> tuple[np.ndarray, np.ndarray]:
    """Axial 2-D rotary tables (cos, sin), each (grid_size², head_dim), in
    split-half layout: the angle of pair j sits at columns j and D/2 + j."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))
    t = np.arange(grid_size, dtype=np.float32)
    f = np.einsum("n,f->nf", t, freqs)
    f = np.repeat(f, 2, axis=-1)
    fh = np.broadcast_to(f[:, None, :], (grid_size, grid_size, dim))
    fw = np.broadcast_to(f[None, :, :], (grid_size, grid_size, dim))
    full = np.concatenate([fh, fw], axis=-1).reshape(grid_size * grid_size, 2 * dim)
    half = full[:, ::2]
    split = np.concatenate([half, half], axis=-1)
    return np.cos(split).astype(np.float32), np.sin(split).astype(np.float32)


def rope_permutation(head_dim: int) -> np.ndarray:
    """π mapping the interleaved RoPE layout to split-half:
    ``split[k] = interleaved[perm[k]]``."""
    idx = np.arange(head_dim)
    return np.concatenate([idx[0::2], idx[1::2]])

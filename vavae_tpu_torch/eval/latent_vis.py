"""Latent-space visualisation and uniformity metrics (port of
``vavae_tpu/eval/latent_vis.py``, pure numpy): random per-pixel latent
vectors, a t-SNE embedding, and the entropy and Gini coefficient of its
occupancy grid, used to compare VA-VAE and vanilla VAE latent spaces.
``sklearn`` (t-SNE) and ``matplotlib`` (the scatter plot) are imported only
by the functions that need them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def sample_latent_pixels(
    latents_nhwc: np.ndarray, num_samples: int = 10000, seed: int = 0
) -> np.ndarray:
    """Random per-pixel channel vectors: (N, C) from (B, H, W, C)."""
    B, H, W, C = latents_nhwc.shape
    flat = latents_nhwc.reshape(-1, C)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(flat), min(num_samples, len(flat)), replace=False)
    return flat[idx]


def calculate_uniformity_metrics(
    embedded_2d: np.ndarray, grid_size: int = 50
) -> Dict[str, float]:
    """Entropy + Gini of the 2-D embedding's occupancy histogram
    (latent_vis.py:57-86): higher entropy / lower Gini = more uniform."""
    H, xe, ye = np.histogram2d(
        embedded_2d[:, 0], embedded_2d[:, 1], bins=grid_size
    )
    p = H.flatten() / max(H.sum(), 1)
    nz = p[p > 0]
    entropy = float(-(nz * np.log(nz)).sum())
    max_entropy = np.log(grid_size * grid_size)
    sorted_p = np.sort(p)
    n = len(p)
    cum = np.cumsum(sorted_p)
    gini = float(1.0 - 2.0 * np.sum(cum) / (n * max(cum[-1], 1e-12)) + 1.0 / n)
    return {
        "entropy": entropy,
        "normalized_entropy": entropy / max_entropy,
        "gini": gini,
    }


def tsne_embed(
    features: np.ndarray, perplexity: float = 30.0, seed: int = 0
) -> np.ndarray:
    from sklearn.manifold import TSNE

    return TSNE(
        n_components=2, perplexity=perplexity, random_state=seed, init="pca"
    ).fit_transform(features)


def plot_tsne_visualization(
    latents_nhwc: np.ndarray,
    out_path: Optional[str] = None,
    num_samples: int = 10000,
    seed: int = 0,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """t-SNE embed sampled latent pixels + uniformity metrics; optionally
    save a scatter PNG (latent_vis.py:88-135)."""
    pixels = sample_latent_pixels(latents_nhwc, num_samples, seed)
    emb = tsne_embed(pixels, seed=seed)
    metrics = calculate_uniformity_metrics(emb)
    if out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(emb[:, 0], emb[:, 1], s=1, alpha=0.3)
        ax.set_title(
            f"entropy={metrics['normalized_entropy']:.3f} gini={metrics['gini']:.3f}"
        )
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return emb, metrics

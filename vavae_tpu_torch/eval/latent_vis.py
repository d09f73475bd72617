"""Latent-space visualisation and uniformity metrics (port of
``vavae_tpu/eval/latent_vis.py``): random per-pixel latent vectors, a t-SNE
embedding, and the entropy and Gini coefficient of its occupancy grid, used
to compare VA-VAE and vanilla VAE latent spaces.

The t-SNE is the port's own (``eval/tsne.py``, on the card unless
``device="cpu"``), where the JAX package calls scikit-learn's; its scatter
plot is drawn here and written by the port's PNG writer, where the JAX
package draws it with matplotlib. The drawing follows matplotlib's for
``plt.subplots(figsize=(6, 6))``, ``scatter(s=1, alpha=0.3)`` and
``savefig(dpi=150)``: a 900x900 image, the axes in matplotlib's default box
(left 0.125, right 0.9, bottom 0.11, top 0.88) with 5% data margins, each
marker a 1-pt disc with its 1-pt edge in ``C0`` (#1f77b4) at alpha 0.3
(centred on the nearest pixel, as Agg snaps markers), over white, and a
black 0.8-pt frame. The title is drawn with the port's bitmap font
(``utils/bitmap_font.py``); tick marks and their labels are not drawn.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vavae_tpu_torch.eval.tsne import tsne
from vavae_tpu_torch.utils import bitmap_font
from vavae_tpu_torch.utils.png import encode_png

FIG_PX = 900  # 6 in at 150 dpi
PT_PX = 150 / 72  # pixels a point
AXES_BOX = (0.125, 0.11, 0.9, 0.88)  # left, bottom, right, top (figure fractions)
C0 = np.array([0x1F, 0x77, 0xB4], np.float64)
MARKER_ALPHA = 0.3


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
    features: np.ndarray, perplexity: float = 30.0, seed: int = 0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """(N, 2) t-SNE embedding of ``features`` (``eval/tsne.py``)."""
    return tsne(features, perplexity=perplexity, seed=seed, device=device)[0]


def _marker_stamp() -> np.ndarray:
    """(5, 5) alpha of one marker centred on the middle pixel: the 1-pt
    disc and the 1-pt stroke of its edge, each at ``MARKER_ALPHA`` by the
    share of the pixel it covers (on a 16x16 grid a pixel), composited."""
    oversample = 16
    r_fill = 0.5 * PT_PX
    r_edge = r_fill + 0.5 * PT_PX
    sub = (np.arange(5 * oversample) + 0.5) / oversample - 2.5
    d2 = sub[:, None] ** 2 + sub[None, :] ** 2
    cover = lambda r: (d2 <= r * r).reshape(5, oversample, 5, oversample).mean(axis=(1, 3))  # noqa: E731
    return 1.0 - (1.0 - MARKER_ALPHA * cover(r_fill)) * (1.0 - MARKER_ALPHA * cover(r_edge))


def _limits(v: np.ndarray) -> Tuple[float, float]:
    """matplotlib's autoscaled view of data ``v``: 5% margins each side."""
    lo, hi = float(np.min(v)), float(np.max(v))
    if hi == lo:
        lo, hi = lo - 1.0, hi + 1.0
    d = hi - lo
    return lo - 0.05 * d, hi + 0.05 * d


def render_scatter(emb: np.ndarray, title: str = "") -> np.ndarray:
    """The (900, 900, 3) uint8 scatter plot of ``emb`` (N, 2), as the JAX
    package's matplotlib figure draws it (see the module docstring)."""
    # the axes' box in pixels and the data-to-pixel affine, as matplotlib
    # computes them (its GridSpec puts the bottom at top - (top - bottom));
    # Agg then centres each marker on floor(position + 0.5)
    left, right, top = AXES_BOX[0] * FIG_PX, AXES_BOX[2] * FIG_PX, AXES_BOX[3] * FIG_PX
    bottom = (AXES_BOX[3] - (AXES_BOX[3] - AXES_BOX[1])) * FIG_PX
    (x0, x1), (y0, y1) = _limits(emb[:, 0]), _limits(emb[:, 1])
    sx, sy = 1 / (x1 - x0), 1 / (y1 - y0)
    m00, m02 = (right - left) * sx, (right - left) * (-x0 * sx) + left
    m11, m12 = (top - bottom) * sy, (top - bottom) * (-y0 * sy) + bottom
    cx = np.floor(emb[:, 0] * m00 + (m02 + 0.5)).astype(np.int64)
    cy = np.floor(emb[:, 1] * -m11 + (-m12 + (FIG_PX + 0.5))).astype(np.int64)
    # markers over white: 1 - alpha multiplies per pixel, in any order
    log_t = np.zeros(FIG_PX * FIG_PX)
    stamp = np.log1p(-_marker_stamp())
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            y, x = cy + dy, cx + dx
            keep = (y >= 0) & (y < FIG_PX) & (x >= 0) & (x < FIG_PX)
            np.add.at(log_t, y[keep] * FIG_PX + x[keep], stamp[dy + 2, dx + 2])
    t = np.exp(log_t).reshape(FIG_PX, FIG_PX, 1)
    img = 255.0 * t + C0 * (1.0 - t)
    # the frame: 0.8-pt black spines centred on the axes' edges (snapped to
    # the pixel grid), with projecting caps, each covering pixels by area
    half = 0.4 * PT_PX
    xl, xr = np.floor(left + 0.5), np.floor(right + 0.5)
    yt, yb = np.floor(FIG_PX - top + 0.5), np.floor(FIG_PX - bottom + 0.5)
    edges = np.arange(FIG_PX + 1, dtype=np.float64)
    overlap = lambda a, b: np.clip(np.minimum(edges[1:], b) - np.maximum(edges[:-1], a), 0, 1)  # noqa: E731
    for x0s, x1s, y0s, y1s in ((xl, xl, yt, yb), (xr, xr, yt, yb), (xl, xr, yb, yb), (xl, xr, yt, yt)):
        cover = overlap(y0s - half, y1s + half)[:, None] * overlap(x0s - half, x1s + half)[None, :]
        img *= 1.0 - np.floor(cover * 255 + 0.5 + 1e-6)[..., None] / 255  # 8-bit coverage
    out = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if title:  # above the axes by matplotlib's 6-pt title pad
        h, w = bitmap_font.text_size(title)
        bitmap_font.draw_text(out, title, top=int(FIG_PX - top - 6 * PT_PX) - h,
                              left=int(round((left + right) / 2 - w / 2)))
    return out


def plot_tsne_visualization(
    latents_nhwc: np.ndarray,
    out_path: Optional[str] = None,
    num_samples: int = 10000,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, Dict[str, float]]:
    """t-SNE embed sampled latent pixels + uniformity metrics; optionally
    save a scatter PNG (latent_vis.py:88-135). The t-SNE runs on ``device``
    (the card unless ``device="cpu"``)."""
    pixels = sample_latent_pixels(latents_nhwc, num_samples, seed)
    emb = tsne_embed(pixels, seed=seed, device=device)
    metrics = calculate_uniformity_metrics(emb)
    if out_path:
        title = f"entropy={metrics['normalized_entropy']:.3f} gini={metrics['gini']:.3f}"
        with open(out_path, "wb") as f:
            f.write(encode_png(render_scatter(emb, title)))
    return emb, metrics

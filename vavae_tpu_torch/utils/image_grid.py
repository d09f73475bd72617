"""Image-grid logging (port of ``vavae_tpu/utils/image_grid.py``, the
Lightning ImageLogger's counterpart): input and reconstruction grids to
PNG files, written by the port's own PNG writer (no PIL)."""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from vavae_tpu_torch.utils.png import encode_png


def make_grid(images: np.ndarray, cols: Optional[int] = None) -> np.ndarray:
    """(N, H, W, C) float in [-1, 1] or [0, 1], or uint8 → one (rows·H,
    cols·W, C) uint8 grid, ⌈√N⌉ columns by default."""
    x = np.asarray(images)
    if x.dtype != np.uint8:
        if float(x.min()) < -0.01:  # the [-1, 1] convention
            x = (x + 1.0) / 2.0
        x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    n, h, w, c = x.shape
    cols = cols or int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = x[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, cols: Optional[int] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(make_grid(images, cols)))
    return path


def log_reconstructions(log_dir: str, step: int, inputs: np.ndarray, recons: np.ndarray,
                        samples: Optional[np.ndarray] = None, max_images: int = 8) -> None:
    """The ImageLogger's layout: ``inputs_{step}.png``, ``recon_{step}.png``
    (and ``samples_{step}.png``) in ``log_dir``."""
    save_image_grid(inputs[:max_images], os.path.join(log_dir, f"inputs_{step:07d}.png"))
    save_image_grid(recons[:max_images], os.path.join(log_dir, f"recon_{step:07d}.png"))
    if samples is not None:
        save_image_grid(samples[:max_images], os.path.join(log_dir, f"samples_{step:07d}.png"))

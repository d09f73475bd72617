"""Image quality metrics: PSNR and SSIM (port of ``vavae_tpu/eval/metrics.py``).

Both take (B, H, W, C) tensors, as the JAX package, and return (B,). SSIM
uses the standard Gaussian window (11×11, σ 1.5, K1 0.01, K2 0.03), the
torchmetrics defaults the reference's tokenizer evaluation uses.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vavae_tpu_torch.utils.device import full_fp32


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Per-image PSNR over (B, H, W, C) tensors (dB)."""
    a, b = a.float(), b.float()
    mse = torch.mean(torch.square(a - b), dim=(1, 2, 3))
    return 10.0 * torch.log10((data_range**2) / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM per image over (B, H, W, C) in [0, data_range].

    The window is a depthwise fp32 convolution with TF32 off inside this
    function: the variance terms (filt(a·a) − μ²) cancel, and a reduced-
    precision filter gave the JAX package a mean SSIM of 1.19 (which is
    mathematically ≤ 1) before it pinned its precision the same way.
    """
    C = a.shape[-1]
    kernel = torch.from_numpy(_gaussian_kernel()).to(a.device)[None, None].repeat(C, 1, 1, 1)
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)

    def filt(x):
        return F.conv2d(x, kernel, groups=C)

    with full_fp32():
        mu_a, mu_b = filt(a), filt(b)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sigma_aa = filt(a * a) - mu_aa
        sigma_bb = filt(b * b) - mu_bb
        sigma_ab = filt(a * b) - mu_ab

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    return torch.mean(num / den, dim=(1, 2, 3))

"""PIL's 8-bit resampling (``Image.resize`` with BOX or BICUBIC on RGB), in numpy.

The JAX package crops and resizes its training and extraction images with
PIL, which the card's machine lacks. This module reproduces PIL's fixed-point
rule for 8-bit images, so the port feeds the VAE the same pixels:

  - the filter's coefficients are built in double precision for each output
    pixel (support 0.5 for BOX, 2 for BICUBIC with a = -0.5, both widened by
    the downscale factor) and normalised by their sequential sum;
  - they are rounded to integers at 22 fractional bits (``PRECISION_BITS =
    32 - 8 - 2``), half away from zero;
  - each output starts from ``1 << 21``, adds pixel × coefficient, shifts
    right by 22 and clips to [0, 255];
  - the horizontal pass runs first and the vertical second, with a uint8
    image between them; a pass whose size is unchanged is skipped.

Each pass is a gather of an (out, taps) index table times the int64
coefficient table (an integer product, so exact in any order), over blocks
of rows so the temporaries stay small. The tables are cached per (in, out,
filter).
"""
from __future__ import annotations

import functools
import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"box": (_box, 0.5), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=256)
def coefficients(in_size: int, out_size: int, filter_name: str) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: (index
    (out, taps) int64, weight (out, taps) int64). Taps past a pixel's window
    carry weight 0 and a clamped index."""
    fn, support = _FILTERS[filter_name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates; both bounds are clamped, so a negative
    # xmin (where truncation and floor differ) ends at 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(taps, dtype=np.int64)
    valid = x[None, :] < xmax[:, None]
    w = fn(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(valid, w, 0.0)
    ww = np.zeros(out_size, np.float64)
    for j in range(taps):  # PIL's sequential sum (numpy's sum is pairwise)
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x[None, :], in_size - 1)
    idx.setflags(write=False)
    k.setflags(write=False)
    return idx, k


_BLOCK = 1 << 16  # gathered taps per block: small temporaries, in cache


def _pass(img: np.ndarray, axis: int, out_size: int, filter_name: str) -> np.ndarray:
    """Resample ``img`` (H, W, C) uint8 along ``axis`` (1: width, 0: height),
    a block of rows at a time."""
    idx, k = coefficients(img.shape[axis], out_size, filter_name)
    taps = idx.shape[1]
    if axis == 0:
        out = np.empty((out_size,) + img.shape[1:], np.uint8)
        rows = max(1, _BLOCK // (taps * img.shape[1] * img.shape[2]))
    else:
        out = np.empty((img.shape[0], out_size, img.shape[2]), np.uint8)
        rows = max(1, _BLOCK // (taps * out_size * img.shape[2]))
    for r in range(0, out.shape[0], rows):
        # the gathered taps last, then one integer product with the weights
        if axis == 0:  # (rows, taps, W, C) → (rows, W, C, taps)
            g = np.moveaxis(img[idx[r:r + rows]], 1, 3).astype(np.int64)
            acc = np.matmul(g, k[r:r + rows, None, :, None])[..., 0]
        else:  # (rows, out, taps, C) → (rows, out, C, taps)
            g = np.moveaxis(img[r:r + rows][:, idx], 2, 3).astype(np.int64)
            acc = np.matmul(g, k[None, :, :, None])[..., 0]
        acc += 1 << (PRECISION_BITS - 1)
        out[r:r + rows] = np.clip(acc >> PRECISION_BITS, 0, 255)
    return out


def resize_uint8(img: np.ndarray, size: tuple[int, int], resample: str = "bicubic") -> np.ndarray:
    """``Image.fromarray(img).resize(size, resample)`` for an (H, W, C) uint8
    image: ``size`` is (width, height), as PIL takes it; ``resample`` is
    ``"box"`` or ``"bicubic"``."""
    if resample not in _FILTERS:
        raise ValueError(f"resample must be one of {sorted(_FILTERS)}, got {resample!r}")
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got {img.dtype} {img.shape}")
    w, h = (int(s) for s in size)
    if w < 1 or h < 1:
        raise ValueError(f"target size {size} must be positive")
    if w != img.shape[1]:
        img = _pass(img, 1, w, resample)
    if h != img.shape[0]:
        img = _pass(img, 0, h, resample)
    return img

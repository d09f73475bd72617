"""Minimal PNG writer and reader (zlib + struct + numpy).

The writer emits 8-bit RGB with no filtering. The reader takes 8-bit
grayscale, grayscale + alpha, RGB and RGBA, not interlaced, with any of
the five scanline filters: what the port writes and what PIL writes for
such images. Other PNGs (palette, 16-bit, interlaced) raise.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 → PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_pngs(images: np.ndarray, paths) -> None:
    """images (B, H, W, 3) uint8 → one PNG per path."""
    if len(images) != len(paths):
        raise ValueError(f"{len(images)} images for {len(paths)} paths")
    for im, p in zip(images, paths):
        with open(p, "wb") as f:
            f.write(encode_png(im))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters; returns (h, w·bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(stride) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: pixel by pixel along the row
            cur = np.empty(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                pred = (left + up) >> 1 if ftype == 3 else _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8, C the file's samples per pixel (1 gray,
    2 gray + alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (8-bit gray/RGB(A), not interlaced only)")
    bpp = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as (H, W, 3) uint8, the way PIL's
    ``convert("RGB")`` makes it (gray repeated, alpha dropped)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])

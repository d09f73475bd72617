"""Minimal PNG writer and reader (zlib + struct + numpy).

The writer emits 8-bit RGB or RGBA with no filtering. The reader takes 8-bit
grayscale, grayscale + alpha, RGB and RGBA, and palette images of 1, 2, 4
or 8 bits (expanded through ``PLTE``; ``tRNS`` is ignored, as PIL's
``convert("RGB")`` ignores it), not interlaced, with any of the five
scanline filters: what the port writes and what PIL writes for such images.
Other PNGs (16-bit, interlaced) raise. ``read_image_rgb`` reads other image
types through PIL, imported only for them.
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
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8 → PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3) or (H, W, 4) uint8, got {img.shape}")
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_pngs(images: np.ndarray, paths) -> None:
    """images (B, H, W, 3 or 4) uint8 → one PNG per path."""
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


def _palette_indices(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """Unfiltered palette scanlines (h, ceil(w·depth / 8)) → indices (h, w):
    the leftmost pixel in the high bits of each byte."""
    if depth == 8:
        return rows
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # high bits first
    idx = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return idx.reshape(rows.shape[0], -1)[:, :w]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8: C is the file's samples per pixel (1
    gray, 2 gray + alpha, 3 RGB, 4 RGBA), and 3 for a palette image, whose
    indices are looked up in ``PLTE``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    readable = (ctype == 3 and depth in (1, 2, 4, 8)) or (ctype in _CHANNELS and depth == 8)
    if not readable or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (8-bit gray/RGB(A) or 1-8-bit palette, "
                         "not interlaced only)")
    raw = zlib.decompress(b"".join(idat))
    if ctype != 3:
        bpp = _CHANNELS[ctype]
        return _unfilter(raw, h, w, bpp).reshape(h, w, bpp)
    if palette is None:
        raise ValueError("palette PNG (colour type 3) without a PLTE chunk")
    idx = _palette_indices(_unfilter(raw, h, (w * depth + 7) // 8, 1), w, depth)
    if idx.max(initial=0) >= len(palette):
        raise ValueError(f"palette index {idx.max()} past the {len(palette)}-entry PLTE")
    return palette[idx]


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as (H, W, 3) uint8, the way PIL's
    ``convert("RGB")`` makes it (gray repeated, alpha dropped, palette
    looked up)."""
    with open(path, "rb") as f:
        try:
            img = decode_png(f.read())
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8: PNGs through the port's decoder, other types
    through PIL, imported only for them."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading a non-PNG image needs PIL (Pillow), which is "
                          "not installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)

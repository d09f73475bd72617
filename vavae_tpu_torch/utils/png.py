"""Minimal PNG writer and reader (zlib + struct + numpy), and the port's
image reader.

The writer emits 8-bit RGB or RGBA with no filtering (zlib level 1), a
batch at a time on a pool of threads: ``zlib.compress`` releases
the interpreter lock, so the images deflate in parallel.
The reader takes every PNG that PIL's ``convert("RGB")`` reads, and makes
the same 8-bit samples of it: grayscale of 1, 2, 4, 8 or 16 bits (scaled by
255, 85 and 17 below 8 bits; 16-bit gray clipped to 255, as PIL's ``I;16``
→ RGB clips it), grayscale + alpha, RGB and RGBA of 8 or 16 bits (the high
byte of a 16-bit sample, as PIL unpacks them), and palette images of 1, 2,
4 or 8 bits (expanded through ``PLTE``; ``tRNS`` is ignored, as
``convert("RGB")`` ignores it), plain or Adam7-interlaced, with any of the
five scanline filters. ``read_image_rgb`` picks
the reader by the file's first bytes, not its name: PNG here, JPEG, WebP and
BMP through the port's decoders (``utils/jpeg.py``, ``utils/webp.py``,
``utils/bmp.py``), and the types left (GIF, TIFF, ICO, PPM and the others
PIL reads by content) through PIL, imported only for them. ``refused_images``
lists the JPEG, WebP and BMP files those decoders refuse on their headers.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from vavae_tpu_torch.utils import bmp, webp
from vavae_tpu_torch.utils.jpeg import CHECK_HEAD, decode_jpeg, jpeg_head_refusal

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


def write_pngs(images: np.ndarray, paths, threads: int = 0) -> None:
    """images (B, H, W, 3 or 4) uint8 → one PNG per path, encoded and written
    on ``threads`` threads (0: one a core), at most one an image. The first
    failure is raised once every image has been tried."""
    if len(images) != len(paths):
        raise ValueError(f"{len(images)} images for {len(paths)} paths")

    def write(i: int) -> None:
        with open(paths[i], "wb") as f:
            f.write(encode_png(images[i]))

    n = min(threads or os.cpu_count() or 1, len(paths))
    if n <= 1:
        for i in range(len(paths)):
            write(i)
        return
    with ThreadPoolExecutor(n) as pool:
        # not ``pool.map``: its iterator cancels the images not yet started
        # when one fails
        for future in [pool.submit(write, i) for i in range(len(paths))]:
            future.result()


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of h rows of ``stride`` bytes, whose
    filters reach back ``bpp`` bytes; returns (h, stride) uint8."""
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
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(stride) & 0xFF
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


def _unpack(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered scanlines (h, bytes) → samples (h, w, channels): uint16
    for 16-bit files, uint8 values below 2^depth otherwise, the leftmost
    pixel in the high bits of a byte."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2")[:, :w * channels].reshape(h, w, channels)
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # high bits first
    idx = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return idx.reshape(h, -1)[:, :w, None]


# Adam7: each pass's first column and row, and its steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _samples(raw: bytes, h: int, w: int, depth: int, channels: int, interlace: int) -> np.ndarray:
    """The image's samples (h, w, channels) from the inflated data: one
    pass, or Adam7's seven, each unfiltered on its own."""
    bpp = max(1, depth * channels // 8)  # the filters' byte distance
    row_bytes = lambda width: (width * depth * channels + 7) // 8  # noqa: E731
    if not interlace:
        return _unpack(_unfilter(raw, h, row_bytes(w), bpp), w, depth, channels)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no bytes at all
        size = ph * (row_bytes(pw) + 1)
        rows = _unfilter(raw[pos:pos + size], ph, row_bytes(pw), bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, depth, channels)
        pos += size
    if pos != len(raw):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {pos}")
    return out


def _to_8_bits(s: np.ndarray, depth: int, ctype: int) -> np.ndarray:
    """Samples as PIL unpacks them for ``convert("RGB")``: gray below 8 bits
    scaled to 0-255, 16-bit gray (PIL's ``I;16``) clipped to 255, and the
    high byte of any other 16-bit sample."""
    if depth == 16:
        return np.minimum(s, 255).astype(np.uint8) if ctype == 0 else (s >> 8).astype(np.uint8)
    if depth < 8 and ctype == 0:
        return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return s


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8: C is the file's samples per pixel (1
    gray, 2 gray + alpha, 3 RGB, 4 RGBA), and 3 for a palette image, whose
    indices are looked up in ``PLTE``; samples of other depths than 8 are
    brought to 8 bits as PIL brings them."""
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
    if depth not in _DEPTHS.get(ctype, ()) or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    raw = zlib.decompress(b"".join(idat))
    samples = _samples(raw, h, w, depth, _CHANNELS.get(ctype, 1), interlace)
    if ctype != 3:
        return _to_8_bits(samples, depth, ctype)
    if palette is None:
        raise ValueError("palette PNG (colour type 3) without a PLTE chunk")
    idx = samples[..., 0]
    if idx.max(initial=0) >= len(palette):
        raise ValueError(f"palette index {idx.max()} past the {len(palette)}-entry PLTE")
    return palette[idx]


def _rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as (H, W, 3), the way PIL's ``convert("RGB")`` makes it
    (gray repeated, alpha dropped; a palette is already looked up)."""
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _decode_png_rgb(data: bytes, path: str) -> np.ndarray:
    try:
        return _rgb(decode_png(data))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as (H, W, 3) uint8, the way PIL's
    ``convert("RGB")`` makes it (gray repeated, alpha dropped, palette
    looked up)."""
    with open(path, "rb") as f:
        return _decode_png_rgb(f.read(), path)


_JPEG_MAGIC = b"\xff\xd8\xff"
_CHECK_THREADS = 8


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's ``Image.open(path).convert("RGB")``: by the
    file's first bytes, a PNG through ``decode_png``, a JPEG, WebP or BMP
    through the port's decoders (an ImageNet file named ``.JPEG`` may hold a
    PNG), and other types through PIL, imported only for them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        return _decode_png_rgb(data, path)
    if data[:3] == _JPEG_MAGIC:
        return decode_jpeg(data, path)
    if webp.is_webp(data[:12]):
        return webp.decode_webp(data, path)
    if data[:2] == bmp.MAGIC:
        return bmp.decode_bmp(data, path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading an image that is neither PNG, JPEG, WebP nor BMP "
                          "needs PIL (Pillow), which is not installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _refusal(path: str) -> Optional[str]:
    """The file's head read once; the rest only for a JPEG whose frame header
    lies past it, or a WebP or BMP file."""
    with open(path, "rb") as f:
        head = f.read(CHECK_HEAD)
        return (jpeg_head_refusal(head, f) or webp.webp_head_refusal(head, f)
                or bmp.bmp_head_refusal(head, f))


def refused_images(paths: Sequence[str]) -> list[tuple[str, str]]:
    """(path, reason) for each of ``paths`` that the port's JPEG, WebP or BMP
    decoder refuses on its headers alone (``jpeg_refusal``,
    ``webp_refusal``, ``bmp_refusal``), in the order of ``paths``, checked on
    a pool of threads."""
    with ThreadPoolExecutor(_CHECK_THREADS) as pool:
        reasons = list(pool.map(_refusal, paths))
    return [(p, r) for p, r in zip(paths, reasons) if r is not None]

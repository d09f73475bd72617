"""Writes the committed PNG fixtures of this folder (run from the repo root:
``python tests/data/png/make_fixtures.py``; needs PIL).

PIL writes few of these kinds, so a small encoder here writes them: every
colour type at every bit depth PNG allows (gray 1, 2, 4, 8 and 16 bits;
gray + alpha, RGB and RGBA 8 and 16; palette 1, 2, 4 and 8), each plain and
Adam7-interlaced, with each row's filter drawn from the five. The images are
smooth gradients with noise, 16-bit gray also above 255 (which PIL clips).
``expected.npz`` holds PIL's ``Image.open(p).convert("RGB")`` of each file,
under its name: the port's reader (``utils/png.py``) is held to it, on the
CPU by ``tests/test_torch_png_formats.py`` and on the card, which has no
PIL, by ``chip_smoke.py`` phase 34.
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
# colour type → (samples per pixel, bit depths)
KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
         6: (4, (8, 16))}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _filtered(rows: np.ndarray, bpp: int, rs: np.random.Generator) -> bytes:
    """Scanlines (h, bytes) with a filter byte each, the filter drawn from
    the five."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        f = int(rs.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            e = r
        elif f == 1:
            e = r - left
        elif f == 2:
            e = r - prev
        elif f == 3:
            e = r - ((left + prev) >> 1)
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            e = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([f]) + (e & 0xFF).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _packed(s: np.ndarray, depth: int) -> np.ndarray:
    """Samples (h, w, c) → scanline bytes (h, n): big-endian 16-bit, or
    sub-byte samples with the leftmost in the high bits."""
    h, w, c = s.shape
    if depth == 16:
        return s.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    v = s.reshape(h, w * c).astype(np.uint8)
    v = np.concatenate([v, np.zeros((h, -v.shape[1] % per), np.uint8)], 1).reshape(h, -1, per)
    return sum(v[:, :, i] << (8 - depth * (i + 1)) for i in range(per)).astype(np.uint8)


def encode(s: np.ndarray, depth: int, ctype: int, interlace: int, rs: np.random.Generator,
           palette: np.ndarray | None = None) -> bytes:
    h, w, c = s.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        raw = b"".join(_filtered(_packed(s[y0::dy, x0::dx], depth), bpp, rs)
                       for x0, y0, dx, dy in ADAM7 if s[y0::dy, x0::dx].size)
    else:
        raw = _filtered(_packed(s, depth), bpp, rs)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                             interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")


def _samples(h: int, w: int, c: int, depth: int, rs: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    top = (1 << depth) - 1
    planes = [(xx * (3 + k) + yy * (5 - k)) / (8 * (h + w)) for k in range(c)]
    s = np.stack(planes, -1) % 1.0 * top + rs.normal(0, top / 40 + 0.3, (h, w, c))
    return np.clip(np.rint(s), 0, top).astype(np.int64)


def fixtures() -> dict[str, bytes]:
    rs = np.random.default_rng(0)
    out = {}
    for ctype, (c, depths) in KINDS.items():
        for depth in depths:
            for interlace in (0, 1):
                h, w = (19, 23) if interlace else (17, 21)
                s = _samples(h, w, c, depth, rs)
                palette = None
                if ctype == 3:
                    palette = rs.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
                name = f"c{ctype}_d{depth}" + ("_adam7" if interlace else "") + ".png"
                out[name] = encode(s, depth, ctype, interlace, rs, palette)
    return out


def main() -> None:
    expected = {}
    for name, data in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            expected[name] = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **expected)


if __name__ == "__main__":
    main()

"""Writes the committed BMP fixtures of this folder (run from the repo root:
``python tests/data/bmp/make_fixtures.py``; needs PIL).

Each fixture is a ``.bmp`` file; ``expected.npz`` holds PIL's decode of it,
``Image.open(p).convert("RGB")``, under the file's stem. The card's machine
has no PIL: ``chip_smoke.py`` phase 36 and ``tests/test_torch_bmp.py`` read
these files.

PIL writes the 1-bit, gray, 8-bit palette, 24-bit and 32-bit files; the
rest are written byte by byte here (``bmp``): 4-bit and 1-bit palettes at
odd widths, RLE8 and RLE4 streams with encoded and absolute runs (odd
lengths, so the runs realign), end-of-line, delta and end-of-bitmap codes,
16-bit 5-5-5 and 5-6-5 (BI_BITFIELDS, masks after a 40-byte header and in
V4 and V5 headers), 32-bit bitfield layouts with and without alpha, the
12-byte core header with a 24-bit and an 8-bit (BGR-entry) palette file,
a top-down file, palette indices past the palette, and a pixel-data offset
of 0 (pixels right after the palette).
"""
from __future__ import annotations

import glob
import io
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * yy // 3, 255 - xx * 5 + yy * 2], -1)
    return ((base % 256) + rs.integers(-20, 21, base.shape)).clip(0, 255).astype(np.uint8)


def _rows(pixels: np.ndarray, bits: int, top_down: bool = False) -> bytes:
    """(h, w) indices or (h, w, k) bytes → rows padded to 4 bytes, bottom
    row first unless ``top_down``."""
    h, w = pixels.shape[:2]
    out = []
    for y in (range(h) if top_down else range(h - 1, -1, -1)):
        row = pixels[y]
        if bits < 8:
            vals = row.astype(np.uint8)
            per = 8 // bits
            padded = np.zeros(-(-w // per) * per, np.uint8)
            padded[:w] = vals
            b = np.zeros(len(padded) // per, np.uint8)
            for k in range(per):
                b |= padded[k::per] << (8 - bits * (k + 1))
            raw = b.tobytes()
        else:
            raw = np.ascontiguousarray(row).tobytes()
        out.append(raw + bytes(-len(raw) % 4))
    return b"".join(out)


def bmp(w: int, h: int, bits: int, body: bytes, *, header: int = 40, compression: int = 0,
        palette: bytes = b"", masks: tuple = (), colors: int = 0, top_down: bool = False,
        offset: int | None = None) -> bytes:
    """A BMP file: the 14-byte file header, a ``header``-byte info header
    (12: core), ``masks`` (inside a V2+ header, or after a 40-byte one),
    the palette, then ``body``."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = (2**32 - h) if top_down else h
        info = struct.pack("<IIIHHIIiiII", header, w, hh, 1, bits, compression, len(body),
                           2835, 2835, colors, 0)
        if header > 40:
            m = list(masks) + [0] * (4 - len(masks))
            info += struct.pack("<4I", *m)
        info = (info + bytes(max(0, header - len(info))))[:header]
    extra = struct.pack(f"<{len(masks)}I", *masks) if header == 40 and masks else b""
    start = 14 + len(info) + len(extra) + len(palette)
    off = start if offset is None else offset
    head = b"BM" + struct.pack("<IHHI", start + len(body), 0, 0, off)
    return head + info + extra + palette + body


def _pil_bmp(img: Image.Image) -> bytes:
    b = io.BytesIO()
    img.save(b, "BMP")
    return b.getvalue()


def _palette(n: int, seed: int, entry: int = 4) -> bytes:
    rs = np.random.default_rng(seed)
    p = rs.integers(0, 256, (n, entry)).astype(np.uint8)
    if entry == 4:
        p[:, 3] = 0
    return p.tobytes()


def _rle8_stream(w: int) -> bytes:
    """Encoded runs, an odd absolute run (padded), a delta, end of line and
    end of bitmap, for rows of width ``w`` (>= 16)."""
    s = bytearray()
    s += bytes([5, 3, 0, 3, 9, 17, 33]) + b"\0"  # run of 5; absolute run of 3, padded
    s += bytes([w - 8, 12, 0, 0])  # fill the row, end of line
    s += bytes([4, 200, 0, 2, 9, 9, 3, 1, 2, 250, 0, 0])  # delta: PIL uses the 2 bytes after
    s += bytes([0, 4, 1, 2, 3, 4, 7, 77, 0, 0])  # even absolute run, end of line
    s += bytes([w, 120, 0, 0, w // 2, 40, 0, 1])  # a full row, half a row, end of bitmap
    return bytes(s)


def _rle4_stream(w: int) -> bytes:
    """As ``_rle8_stream`` for 4-bit pixels (``w`` = 24): absolute runs of
    odd length, which drop their last pixel, and one padded to realign."""
    s = bytearray()
    s += bytes([7, 0x3A, 0, 5, 0x12, 0x34, w - 12, 0x9C, 0, 0])  # 7 + 4 + 12 pixels
    s += bytes([w, 0x71, 0, 0])
    s += bytes([3, 0xF0, 0, 6, 0xAB, 0xCD, 0xEF, 0, 0, 0])  # absolute run of 3 bytes, padded
    s += bytes([0, 3, 0x12, 0, 0, 2, 9, 9, 5, 1, 16, 0x44, 0, 0, 0, 1])  # delta, EOL, EOB
    return bytes(s)


def fixtures() -> dict[str, bytes]:
    rgb = _photo(29, 37, 1)
    idx = (np.add.outer(np.arange(29), np.arange(37)) // 3) % 10
    files = {
        "pil_rgb24": _pil_bmp(Image.fromarray(rgb)),
        "pil_rgba32": _pil_bmp(Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1), "RGBA")),
        "pil_l8": _pil_bmp(Image.fromarray(rgb[..., 1])),
        "pil_1bit": _pil_bmp(Image.fromarray(rgb[..., 0] > 128)),
        "pil_p8": _pil_bmp(Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=200)),
        "p4_37x29": bmp(37, 29, 4, _rows(idx, 4), palette=_palette(10, 2), colors=10),
        "p1_37x29": bmp(37, 29, 1, _rows(idx % 2, 1), palette=_palette(2, 3)),
        "p8_past_palette": bmp(37, 29, 8, _rows(idx * 25, 8), palette=_palette(100, 4), colors=100),
        "p8_offset_0": bmp(37, 29, 8, _rows(idx, 8), palette=_palette(10, 5), colors=10, offset=0),
        "rle8": bmp(24, 5, 8, _rle8_stream(24), compression=1, palette=_palette(256, 6)),
        "rle4": bmp(24, 5, 4, _rle4_stream(24), compression=2, palette=_palette(16, 7)),
        "rle8_top_down": bmp(24, 5, 8, _rle8_stream(24), compression=1, palette=_palette(256, 6),
                             top_down=True),
        "rgb24_top_down": bmp(37, 29, 24, _rows(rgb[..., ::-1], 24, True), top_down=True),
        "core_rgb24": bmp(37, 29, 24, _rows(rgb[..., ::-1], 24), header=12),
        "core_p8": bmp(37, 29, 8, _rows(idx, 8), header=12, palette=_palette(256, 8, 3)),
    }
    r5, g5, b5 = (rgb[..., 0] >> 3).astype(np.uint16), (rgb[..., 1] >> 3).astype(np.uint16), (rgb[..., 2] >> 3).astype(np.uint16)
    g6 = (rgb[..., 1] >> 2).astype(np.uint16)
    v555 = (r5 << 10) | (g5 << 5) | b5
    v565 = (r5 << 11) | (g6 << 5) | b5
    as_bytes = lambda v: v.astype("<u2").view(np.uint8).reshape(v.shape + (2,))  # noqa: E731
    files["rgb555"] = bmp(37, 29, 16, _rows(as_bytes(v555), 16))
    files["rgb565_bitfields"] = bmp(37, 29, 16, _rows(as_bytes(v565), 16), compression=3,
                                    masks=(0xF800, 0x7E0, 0x1F))
    files["rgb555_v4_bitfields"] = bmp(37, 29, 16, _rows(as_bytes(v555), 16), header=108,
                                       compression=3, masks=(0x7C00, 0x3E0, 0x1F))
    a = (np.arange(37)[None, :] * 7 % 256).repeat(29, 0).astype(np.uint8)[..., None]
    bgra = np.concatenate([rgb[..., ::-1], a], -1)
    files["bgra32_v5_bitfields"] = bmp(37, 29, 32, _rows(bgra, 32), header=124, compression=3,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    xbgr = np.concatenate([a, rgb[..., ::-1]], -1)
    files["xbgr32_v4_bitfields"] = bmp(37, 29, 32, _rows(xbgr, 32), header=108, compression=3,
                                       masks=(0xFF000000, 0xFF0000, 0xFF00, 0))
    rgba = np.concatenate([rgb, a], -1)
    files["rgba32_v5_bitfields"] = bmp(37, 29, 32, _rows(rgba, 32), header=124, compression=3,
                                       masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    files["bgrx32"] = bmp(37, 29, 32, _rows(bgra, 32))
    return files


def main() -> None:
    expected = {}
    for old in glob.glob(os.path.join(HERE, "*.bmp")):
        os.remove(old)
    for stem, data in sorted(fixtures().items()):
        path = os.path.join(HERE, stem + ".bmp")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            expected[stem] = np.asarray(im.convert("RGB"))
        print(f"{stem}: {len(data)} bytes, {expected[stem].shape}", file=sys.stderr)
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **expected)


if __name__ == "__main__":
    main()

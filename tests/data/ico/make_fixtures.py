"""Writes the committed ICO and CUR fixtures of this folder (run from the repo
root: ``python tests/data/ico/make_fixtures.py``; needs PIL).

Each fixture is a ``.ico`` or ``.cur`` file; ``expected.npz`` holds PIL's
decode of it, ``Image.open(p).convert("RGB")``, under the file's stem.
Files PIL refuses are written as ``refused_*`` and have no entry. PIL is
not a stated package of the card's machine: ``chip_smoke.py`` phase 37,
with PIL blocked, and
``tests/test_torch_ico.py`` read these files.

PIL writes icons of PNG and of BMP payloads at several sizes; the rest are
written byte by byte here (``icon``, ``dib``): DIBs of 1, 4, 8, 24 and 32
bits with their AND masks, entries of one size at several depths (the
lowest is read), a size byte of 0 (256) against a larger entry, a
directory size that disagrees with the payload's, a colour count in place
of a bit count, cursors of one and two entries (the one larger in both
sizes is read), and the refused: an AND mask past the file, 32-bit alpha
bytes cut short, a directory of no entries, a cursor whose payload is a
PNG.
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


def rows(arr: np.ndarray, bits: int) -> bytes:
    """(h, w) indices or (h, w, k) bytes → bottom-up rows padded to 4 bytes."""
    h, w = arr.shape[:2]
    out = []
    for y in range(h - 1, -1, -1):
        r = arr[y]
        if bits < 8:
            per = 8 // bits
            pad = np.zeros(-(-w // per) * per, np.uint8)
            pad[:w] = r
            b = np.zeros(len(pad) // per, np.uint8)
            for k in range(per):
                b |= pad[k::per] << (8 - bits * (k + 1))
            raw = b.tobytes()
        else:
            raw = np.ascontiguousarray(r, np.uint8).tobytes()
        out.append(raw + bytes(-len(raw) % 4))
    return b"".join(out)


def dib(pixels: np.ndarray, bits: int, mask: np.ndarray, palette: bytes = b"") -> bytes:
    """A DIB of twice the image's height: its 40-byte header, the palette
    (BGRX entries), the rows, then the AND mask's rows (none at 32 bits)."""
    h, w = pixels.shape[:2]
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, len(palette) // 4, 0)
    return head + palette + rows(pixels, bits) + (rows(mask, 1) if bits != 32 else b"")


def icon(entries: list, cursor: bool = False) -> bytes:
    """An ICO (or CUR) file of ``entries``: (width byte, height byte, colour
    count, bit count, payload, directory size or None for the payload's)."""
    head = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    at = 6 + 16 * len(entries)
    table, body = b"", b""
    for wb, hb, ncolor, bpp, payload, size in entries:
        table += struct.pack("<BBBBHHII", wb, hb, ncolor, 0, 1, bpp,
                             len(payload) if size is None else size, at + len(body))
        body += payload
    return head + table + body


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * yy // 3, 255 - xx * 5 + yy * 2], -1)
    return ((base % 256) + rs.integers(-20, 21, base.shape)).clip(0, 255).astype(np.uint8)


def _png(img: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "PNG")
    return b.getvalue()


def fixtures() -> dict[str, bytes]:
    rs = np.random.default_rng(3)
    rgba = np.dstack([_photo(48, 48, 1), (np.arange(48)[None, :] * 5 % 256).repeat(48, 0)])
    pil_icon = Image.fromarray(rgba.astype(np.uint8), "RGBA")
    files = {}
    for fmt in ("png", "bmp"):
        b = io.BytesIO()
        pil_icon.save(b, "ICO", sizes=[(16, 16), (32, 32), (48, 48)], bitmap_format=fmt)
        files[f"pil_{fmt}_sizes"] = b.getvalue()
    img = _photo(20, 24, 2)
    mask = rs.integers(0, 2, (20, 24))
    idx4, idx8 = rs.integers(0, 16, (20, 24)), rs.integers(0, 256, (20, 24))
    pal = lambda n, seed: np.concatenate(  # noqa: E731
        [np.random.default_rng(seed).integers(0, 256, (n, 3)), np.zeros((n, 1), int)], 1
    ).astype(np.uint8).tobytes()
    bgra = np.dstack([img[..., ::-1], mask * 255])
    d1 = dib(mask ^ 1, 1, mask, pal(2, 4))
    d4 = dib(idx4, 4, mask, pal(16, 5))
    d8 = dib(idx8, 8, mask, pal(256, 6))
    d24 = dib(img[..., ::-1], 24, mask)
    d32 = dib(bgra, 32, mask)
    files.update({
        "dib_1bit": icon([(24, 20, 2, 1, d1, None)]),
        "dib_4bit": icon([(24, 20, 16, 4, d4, None)]),
        "dib_8bit": icon([(24, 20, 0, 8, d8, None)]),
        "dib_24bit": icon([(24, 20, 0, 24, d24, None)]),
        "dib_32bit": icon([(24, 20, 0, 32, d32, None)]),
        "same_size_lowest_depth_first": icon([(24, 20, 0, 32, d32, None),
                                              (24, 20, 0, 24, d24, None),
                                              (24, 20, 16, 4, d4, None)]),
        "color_count_for_depth": icon([(24, 20, 0, 0, d24, None), (24, 20, 16, 0, d4, None)]),
        "size_byte_0_is_256": icon([(0, 1, 0, 24, d24, None), (64, 3, 0, 4, d4, None)]),
        "directory_size_disagrees": icon([(48, 48, 0, 32, _png(rgba[:30, :40].astype(np.uint8)),
                                           None), (16, 16, 0, 24, d24, None)]),
        "png_payload_gray": icon([(37, 29, 0, 8, _png(_photo(29, 37, 7)[..., 0]), None)]),
        "cursor_one": icon([(24, 20, 0, 24, d24, None)], cursor=True),
        "cursor_larger_second": icon([(16, 16, 0, 4, d4, None), (24, 20, 0, 24, d24, None)],
                                     cursor=True),
        "refused_mask_past_file": icon([(24, 20, 16, 4, d4, len(d4) + 500)]),
        "refused_alpha_cut": icon([(24, 20, 0, 32, d32[:-10], None)]),
        "refused_no_entries": icon([]) + d24,
        "refused_cursor_png": icon([(37, 29, 0, 8, _png(_photo(29, 37, 7)), None)], cursor=True),
    })
    return files


def main() -> None:
    expected = {}
    for old in glob.glob(os.path.join(HERE, "*.ico")) + glob.glob(os.path.join(HERE, "*.cur")):
        os.remove(old)
    for stem, data in sorted(fixtures().items()):
        path = os.path.join(HERE, f"{stem}.{'cur' if data[2] == 2 else 'ico'}")
        with open(path, "wb") as f:
            f.write(data)
        if stem.startswith("refused_"):
            continue
        with Image.open(path) as im:
            expected[stem] = np.asarray(im.convert("RGB"))
        print(f"{stem}: {len(data)} bytes, {expected[stem].shape}", file=sys.stderr)
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **expected)


if __name__ == "__main__":
    main()

"""Writes the committed PNM fixtures of this folder (run from the repo root:
``python tests/data/pnm/make_fixtures.py``; needs PIL).

Each fixture is a ``.pbm``, ``.pgm``, ``.ppm`` or ``.pfm`` file;
``expected.npz`` holds PIL's decode of it, ``Image.open(p).convert("RGB")``,
under the file's stem. Files PIL refuses are written as ``refused_*`` and
have no entry. PIL is not a stated package of the card's machine:
``chip_smoke.py`` phase 37, with PIL blocked, and ``tests/test_torch_pnm.py`` read these files.

PIL writes P4, P5 (8 and 16 bits), P6 and Pf; the rest are written byte by
byte here (``pnm``): the plain P1-P3, comments in the header (one inside a
token) and between plain values, every whitespace byte, maxvals that scale
(100: 50 reads 128; 1000 in 16-bit P6: 700 reads 178, Python's round to
even), a 16-bit P5 at maxval 65535 (clipped to 255) and at 1000 (PIL's mode
I, clipped), samples past maxval in raw files (clipped), a big-endian Pf,
a file of two images, and the refused: a plain value past maxval, maxval 0,
a token of 11 bytes, raw data cut short, an unknown magic.
"""
from __future__ import annotations

import glob
import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
EXT = {b"P1": "pbm", b"P4": "pbm", b"P2": "pgm", b"P5": "pgm", b"P3": "ppm", b"P6": "ppm",
       b"Pf": "pfm"}


def pnm(magic: bytes, w: int, h: int, body: bytes, maxval=None, sep: bytes = b"\n",
        comment: bytes = b"") -> bytes:
    """A header of ``magic``, the size and ``maxval`` (a scale for Pf),
    separated by ``sep`` with ``comment`` after the magic, then ``body``."""
    head = magic + sep + comment + str(w).encode() + b" " + str(h).encode()
    if maxval is not None:
        head += sep + str(maxval).encode()
    return head + b"\n" + body


def plain(values: np.ndarray, per_line: int = 12) -> bytes:
    tokens = [str(int(v)).encode() for v in values.ravel()]
    return b"\n".join(b" ".join(tokens[i:i + per_line]) for i in range(0, len(tokens), per_line))


def _pil(img: Image.Image) -> bytes:
    b = io.BytesIO()
    img.save(b, "PPM")
    return b.getvalue()


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * yy // 3, 255 - xx * 5 + yy * 2], -1)
    return ((base % 256) + rs.integers(-20, 21, base.shape)).clip(0, 255).astype(np.uint8)


def fixtures() -> dict[str, bytes]:
    rgb = _photo(29, 37, 1)
    rs = np.random.default_rng(2)
    bits = (rgb[..., 0] > 120).astype(int)
    files = {
        "pil_p4": _pil(Image.fromarray(rgb[..., 0] > 120)),
        "pil_p5": _pil(Image.fromarray(rgb[..., 1])),
        "pil_p5_16bit": _pil(Image.fromarray(rgb[..., 1].astype(np.uint16) * 300)),
        "pil_p6": _pil(Image.fromarray(rgb)),
        "pil_pf": _pil(Image.fromarray(rgb[..., 2].astype(np.float32) * 1.3 - 40.5)),
        "p1_plain": pnm(b"P1", 37, 29, plain(bits, 37)),
        "p1_no_spaces": pnm(b"P1", 37, 29, b"\n".join(
            b"".join(str(v).encode() for v in row) for row in bits)),
        "p2_plain_maxval_100": pnm(b"P2", 37, 29, plain(rgb[..., 0] * 100 // 255), 100),
        "p2_plain_maxval_300": pnm(b"P2", 37, 29, plain(rgb[..., 0].astype(int) + 40), 300),
        "p3_plain_comments": pnm(b"P3", 37, 29, plain(rgb).replace(b"\n", b" # a row\n", 5), 255,
                                 comment=b"# made by hand\n"),
        "p5_maxval_100": pnm(b"P5", 37, 29, (rgb[..., 0] * 100 // 255).astype(np.uint8)
                             .tobytes(), 100),
        "p5_maxval_100_half": pnm(b"P5", 1, 2, bytes([50, 51]), 100),
        "p5_maxval_1000_mode_i": pnm(b"P5", 37, 29, (rgb[..., 0].astype(">u2") * 3).tobytes(),
                                     1000),
        "p5_maxval_65535_clipped": pnm(b"P5", 37, 29, rs.integers(0, 600, (29, 37))
                                       .astype(">u2").tobytes(), 65535),
        "p5_past_maxval_clipped": pnm(b"P5", 37, 29, rgb[..., 0].tobytes(), 200),
        "p6_maxval_1000": pnm(b"P6", 37, 29, (rgb.astype(">u2") * 1000 // 255).tobytes(), 1000),
        "p6_maxval_1000_round_even": pnm(b"P6", 1, 1, np.array([700, 1, 999], ">u2").tobytes(),
                                         1000),
        "p6_maxval_65535": pnm(b"P6", 37, 29, (rgb.astype(">u2") * 257 + 100).tobytes(), 65535),
        "p6_whitespace": pnm(b"P6", 37, 29, rgb.tobytes(), 255, sep=b"\t\x0b\x0c\r\n "),
        "p6_comment_in_token": b"P6\n3#split\n7 29\n255\n" + rgb[:, :37].tobytes(),
        "p6_two_images": pnm(b"P6", 37, 29, rgb.tobytes(), 255)
        + pnm(b"P6", 37, 29, rgb[::-1].tobytes(), 255),
        "pf_big_endian": pnm(b"Pf", 37, 29, rs.normal(100, 90, (29, 37)).astype(">f4").tobytes(),
                             "1.0"),
        "refused_p2_past_maxval": pnm(b"P2", 2, 1, b"5 101", 100),
        "refused_maxval_0": pnm(b"P5", 2, 1, b"\0\0", 0),
        "refused_long_token": b"P5 12345678901 1 255\n" + bytes(20),
        "refused_p6_cut": pnm(b"P6", 37, 29, rgb.tobytes()[:-5], 255),
        "refused_unknown_magic": b"P6x 2 2 255\n" + bytes(12),
    }
    return files


def main() -> None:
    expected = {}
    for old in glob.glob(os.path.join(HERE, "*.p?m")):
        os.remove(old)
    for stem, data in sorted(fixtures().items()):
        path = os.path.join(HERE, f"{stem}.{EXT.get(data[:2], 'ppm')}")
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

"""Writes the committed GIF fixtures of this folder (run from the repo root:
``python tests/data/gif/make_fixtures.py``; needs PIL).

Each fixture is a ``.gif`` file; ``expected.npz`` holds PIL's decode of it,
``Image.open(p).convert("RGB")``, under the file's stem. Files PIL refuses
are written as ``refused_*.gif`` and have no entry. PIL is not a stated
package of the card's machine: ``chip_smoke.py`` phase 37, with PIL
blocked, and ``tests/test_torch_gif.py`` read
these files.

PIL writes the common layouts (an adaptive palette, gray, an animation,
interlaced rows); the rest are written byte by byte by ``gifkit.py``
(``gif``, with ``lzw_codes`` and ``pack``): first frames
smaller than the canvas, offset in it or past its edge, with and without a
transparency index; indices past a short palette; a gray-ramp palette
(which PIL drops); a local palette; every extension block and stray bytes
between blocks; minimum code sizes 2 to 8; a table filled to 4,096 codes
with the clear deferred; runs that need the KwKwK code; data past the EOI;
and the refused: an early EOI, data cut short, a code past the table.
"""
from __future__ import annotations

import glob
import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from gifkit import gce, gif, interlaced_order, lzw_codes, pack  # noqa: E402


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * yy // 3, 255 - xx * 5 + yy * 2], -1)
    return ((base % 256) + rs.integers(-20, 21, base.shape)).clip(0, 255).astype(np.uint8)


def _pil(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "GIF", **kw)
    return b.getvalue()


def _pal(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 3 * n).astype(np.uint8).tobytes()


def fixtures() -> dict[str, bytes]:
    photo = _photo(48, 64, 1)
    idx = np.add.outer(np.arange(29), np.arange(37)) // 3 % 16
    flat = idx.ravel().tolist()
    pal16 = _pal(16, 2)
    files = {
        "pil_adaptive_64x48": _pil(Image.fromarray(photo).quantize(200)),
        "pil_gray": _pil(Image.fromarray(photo[..., 1])),
        "pil_interlaced": _pil(Image.fromarray(photo).quantize(64), interlace=True),
        "pil_animation": _pil(Image.fromarray(photo).quantize(32), save_all=True, append_images=[
            Image.fromarray(photo[::-1]).quantize(32), Image.fromarray(photo[:, ::-1]).quantize(32)],
            duration=50, loop=0),
        "gif87a": gif(37, 29, flat, 4, palette=pal16, version=b"GIF87a"),
        "frame_offset": gif(50, 40, flat, 4, palette=pal16, box=(5, 7, 37, 29), bg=3),
        "frame_offset_transparency": gif(50, 40, flat, 4, palette=pal16, box=(5, 7, 37, 29), bg=3,
                                         ext=gce(transparency=9)),
        "frame_past_canvas": gif(30, 20, flat, 4, palette=pal16, box=(10, 4, 37, 29)),
        "index_past_palette": gif(37, 29, ((idx * 11) % 256).ravel().tolist(), 8,
                                  palette=_pal(5, 3)),
        "gray_ramp_palette": gif(37, 29, flat, 4, palette=bytes(v for i in range(16) for v in (i,) * 3)),
        "no_palette": gif(37, 29, ((idx * 13) % 256).ravel().tolist(), 8),
        "local_palette": gif(37, 29, flat, 4, palette=pal16, local=_pal(16, 4)),
        "local_gray_ramp_palette": gif(37, 29, flat, 4, palette=pal16,
                                       local=bytes(v for i in range(16) for v in (i,) * 3)),
        "extensions": gif(37, 29, flat, 4, palette=pal16, ext=(
            gce(transparency=2, disposal=2) + b"!\xfe\x05hello\x03abc\0"
            + b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\0" + b"!\x01\x0c" + bytes(12) + b"\x02xy\0"
            + b"\x00\x42")),  # stray bytes the plugin skips
        "interlaced_odd_height": gif(37, 29, idx[interlaced_order(29)].ravel().tolist(), 4,
                                     palette=pal16, interlace=True),
        "data_past_eoi": gif(37, 29, flat, 4, palette=pal16,
                             data=pack(lzw_codes(flat, 4)) + bytes(range(40))),
        "kwkwk_runs": gif(40, 20, [3] * 500 + [5] * 300, 4, palette=pal16),
    }
    for size in range(2, 9):
        v = ((idx.astype(int) * 37 + idx.T[:29, :29].sum() % 7) % (1 << size)).ravel().tolist()
        files[f"code_size_{size}"] = gif(37, 29, v, size, palette=_pal(1 << size, size))
    big = np.random.default_rng(6).integers(0, 256, 64 * 64).tolist()
    files["deferred_clear"] = gif(64, 64, big, 8, palette=_pal(256, 7),
                                  data=pack(lzw_codes(big, 8, deferred=True)))
    files["table_cleared"] = gif(64, 64, big, 8, palette=_pal(256, 7))
    codes = lzw_codes(flat, 4)
    files["refused_early_eoi"] = gif(37, 29, flat, 4, palette=pal16,
                                     data=pack(codes[:len(codes) // 2] + [(17, codes[-1][1])]))
    files["refused_cut_data"] = gif(37, 29, flat, 4, palette=pal16)[:60]
    files["refused_code_past_table"] = gif(37, 29, flat, 4, palette=pal16,
                                           data=pack(codes[:3] + [(30, 5)] + codes[3:]))
    files["refused_no_frame"] = gif(37, 29, flat, 4, palette=pal16)[:13 + 48] + b";"
    return files


def main() -> None:
    expected = {}
    for old in glob.glob(os.path.join(HERE, "*.gif")):
        os.remove(old)
    for stem, data in sorted(fixtures().items()):
        path = os.path.join(HERE, stem + ".gif")
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

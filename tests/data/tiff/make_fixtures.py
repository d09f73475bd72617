"""Writes the committed TIFF fixtures of this folder (run from the repo root:
``python tests/data/tiff/make_fixtures.py``; needs PIL).

Each fixture is a ``.tif`` file; ``expected.npz`` holds PIL's decode of it,
``Image.open(p).convert("RGB")``, under the file's stem. Files PIL refuses
are written as ``refused_*.tif``, and files the port leaves to PIL (JPEG
and CCITT compression) as ``pil_only_*.tif``, with PIL's decode in
``expected.npz``. PIL is not a stated package of the card's machine:
``chip_smoke.py`` phase 37, with PIL blocked, and ``tests/test_torch_tiff.py`` read these files.

PIL (through libtiff) writes the common layouts: RGB, gray, 1-bit,
palette, 16-bit gray, float gray, CMYK and RGBA, uncompressed, LZW,
Deflate and PackBits, with and without predictor 2; the rest are written
byte by byte by ``tiffkit.py``: 16-bit RGB and gray in both byte orders,
associated and unassociated alpha, WhiteIsZero, 4-bit palettes, FillOrder
2, the Orientation tag, tiles, planar files, extra samples, a BigTIFF,
strips of a few rows, a predictor on PackBits and uncompressed data (which
PIL ignores), and the refused: a big-endian BigTIFF, an unknown
compression, LZW data cut short, a predictor on 4-bit samples, and strip
offsets of -1 and minus the file's length (a signed tag) and of 2^63 - 1
(a BigTIFF's LONG8), uncompressed and LZW.
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
import tiffkit as K  # noqa: E402


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * yy // 3, 255 - xx * 5 + yy * 2], -1)
    return ((base % 256) + rs.integers(-20, 21, base.shape)).clip(0, 255).astype(np.uint8)


def _pil(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "TIFF", **kw)
    return b.getvalue()


def fixtures() -> dict[str, bytes]:
    rgb = _photo(40, 48, 1)
    small = rgb[:29, :37]
    rs = np.random.default_rng(2)
    gray = Image.fromarray(rgb[..., 1])
    files = {
        "pil_rgb_raw": _pil(Image.fromarray(rgb)),
        "pil_rgb_lzw": _pil(Image.fromarray(rgb), compression="tiff_lzw"),
        "pil_rgb_lzw_predictor": _pil(Image.fromarray(rgb), compression="tiff_lzw",
                                      tiffinfo={317: 2}),
        "pil_rgb_deflate": _pil(Image.fromarray(rgb), compression="tiff_adobe_deflate"),
        "pil_rgb_deflate_predictor": _pil(Image.fromarray(rgb), compression="tiff_deflate",
                                          tiffinfo={317: 2}),
        "pil_rgb_packbits": _pil(Image.fromarray(rgb), compression="packbits"),
        "pil_gray_lzw": _pil(gray, compression="tiff_lzw"),
        "pil_1bit_packbits": _pil(Image.fromarray(rgb[..., 0] > 120), compression="packbits"),
        "pil_palette_lzw": _pil(Image.fromarray(rgb).quantize(100), compression="tiff_lzw"),
        "pil_gray16_deflate": _pil(Image.fromarray(rgb[..., 0].astype(np.uint16) * 3),
                                   compression="tiff_adobe_deflate"),
        "pil_float_lzw": _pil(Image.fromarray(rgb[..., 2].astype(np.float32) * 1.5 - 60),
                              compression="tiff_lzw"),
        "pil_cmyk_lzw": _pil(Image.fromarray(rgb).convert("CMYK"), compression="tiff_lzw"),
        "pil_rgba_deflate": _pil(Image.fromarray(np.dstack([rgb, rgb[..., :1]]), "RGBA"),
                                 compression="tiff_adobe_deflate"),
        "pil_rgb_lzw_rows_8": _pil(Image.fromarray(rgb), compression="tiff_lzw",
                                   tiffinfo={278: 8}),
        "pil_only_jpeg": _pil(Image.fromarray(rgb), compression="jpeg"),
        "pil_only_group4": _pil(Image.fromarray(rgb[..., 0] > 120), compression="group4"),
    }
    rgb16 = (small.astype(np.uint16) * 257 + rs.integers(0, 256, small.shape)).astype(np.uint16)
    gray16 = rs.integers(0, 700, (29, 37, 1))
    alpha = (np.arange(37)[None, :, None] * 7 % 256).repeat(29, 0)
    assoc = np.concatenate([small * alpha // 255, alpha], -1)
    unassoc = np.concatenate([small, alpha], -1)
    idx4 = (np.add.outer(np.arange(29), np.arange(37)) // 3 % 16)[..., None]
    cmap16 = tuple(int(v) for v in rs.integers(0, 65536, 3 * 16))
    files.update({
        "rgb16_mm_lzw": K.image(rgb16, 16, order="MM", compression=5),
        "rgb16_ii_deflate_predictor": K.image(rgb16, 16, compression=8, predictor=2),
        "rgb16_mm_raw": K.image(rgb16, 16, order="MM"),
        "gray16_clipped_ii_packbits": K.image(gray16, 16, compression=32773),
        "gray16_clipped_mm_raw": K.image(gray16, 16, order="MM"),
        "float_gray_mm_raw": K.image(rs.normal(100, 120, (29, 37, 1)).astype(np.float32), 32,
                                     order="MM", sample_format=3),
        "signed16_gray_ii_lzw": K.image(rs.integers(-300, 400, (29, 37, 1)), 16, compression=5,
                                        sample_format=2),
        "rgba_associated_lzw": K.image(assoc, 8, compression=5, extra=(1,)),
        "rgba_unassociated_lzw": K.image(unassoc, 8, compression=5, extra=(2,)),
        "rgba_associated_raw": K.image(assoc, 8, extra=(1,)),
        "rgba16_associated_mm_deflate": K.image(
            np.concatenate([rgb16, (alpha * 257).astype(np.uint16)], -1), 16, order="MM",
            compression=8, extra=(1,)),
        "white_is_zero_1bit": K.image((small[..., :1] > 100).astype(int), 1, photometric=0),
        "white_is_zero_4bit_lzw": K.image(idx4, 4, photometric=0, compression=5),
        "white_is_zero_8bit": K.image(small[..., :1], 8, photometric=0),
        "gray_2bit_packbits": K.image(idx4 % 4, 2, compression=32773),
        "palette_4bit_lzw": K.image(idx4, 4, photometric=3, colormap=cmap16, compression=5),
        "palette_8bit_past_colormap": K.image(idx4 * 9, 8, photometric=3, colormap=cmap16),
        "fillorder2_gray_raw": K.image(small[..., :1], 8, fillorder=2),
        "fillorder2_1bit_lzw": K.image((small[..., :1] > 100).astype(int), 1, fillorder=2,
                                       compression=5),
        "fillorder2_rgb_deflate": K.image(small, 8, fillorder=2, compression=8),
        "tiled_rgb_lzw": K.image(small, 8, compression=5, tile=(16, 16)),
        "tiled_gray_raw": K.image(small[..., :1], 8, tile=(16, 16)),
        "tiled_rgb_raw_one_tile": K.image(small, 8, tile=(48, 32)),
        "planar_rgb_lzw_predictor": K.image(small, 8, compression=5, predictor=2, planar=2),
        "planar_rgb_raw": K.image(small, 8, planar=2, rows_per_strip=7),
        "planar_rgba_associated_deflate": K.image(assoc, 8, compression=8, planar=2, extra=(1,)),
        "planar_rgb16_mm_packbits": K.image(rgb16, 16, order="MM", compression=32773, planar=2),
        "extra_samples_rgbxx_lzw": K.image(np.concatenate([small, small[..., :2]], -1), 8,
                                           compression=5, extra=(0, 0)),
        "cmyk_raw": K.image(rs.integers(0, 256, (29, 37, 4)), 8, photometric=5),
        "cmyk16_mm_lzw": K.image(rs.integers(0, 65536, (29, 37, 4)), 16, photometric=5,
                                 order="MM", compression=5),
        "gray_a_lzw": K.image(np.concatenate([small[..., :1], alpha], -1), 8, compression=5,
                              extra=(2,)),
        "bigtiff_ii_lzw": K.image(small, 8, compression=5, big=True),
        "strips_of_5_rows_lzw": K.image(small, 8, compression=5, rows_per_strip=5),
        "strips_of_5_rows_raw": K.image(small, 8, rows_per_strip=5),
        "predictor_ignored_packbits": K.image(small, 8, compression=32773, predictor=2),
        "predictor_ignored_raw": K.image(small, 8, predictor=2),
        "mm_rgb_deflate_predictor": K.image(small, 8, order="MM", compression=8, predictor=2),
    })
    for o in (2, 3, 5, 6, 8):
        files[f"orientation_{o}_lzw"] = K.image(small, 8, compression=5, orientation=o)
    files["orientation_6_gray_raw"] = K.image(small[..., :1], 8, orientation=6)
    files.update({
        "refused_mm_bigtiff": K.image(small, 8, compression=5, big=True, order="MM"),
        "refused_compression_99": K.image(small, 8, more=((259, 3, (99,)),)),
        "refused_lzw_cut": _cut_strip(small),
        "refused_predictor_4bit": K.image(idx4, 4, compression=5, more=((317, 3, (2,)),)),
        "refused_no_dimensions": K.tiff([(258, 3, (8,)), (259, 3, (1,)), (262, 3, (1,))],
                                        [bytes(16)]),
    })
    for comp, codec in ((1, "raw"), (5, "lzw")):  # offsets before the file, and past it
        signed = dict(compression=comp, offsets_type=9)  # SLONG
        n = len(K.image(small, 8, offsets=(0,), **signed))
        files[f"refused_slong_offset_minus_1_{codec}"] = K.image(small, 8, offsets=(-1,), **signed)
        files[f"refused_slong_offset_minus_len_{codec}"] = K.image(small, 8, offsets=(-n,),
                                                                  **signed)
        files[f"refused_long8_offset_max_{codec}"] = K.image(
            small, 8, compression=comp, big=True, offsets_type=16, offsets=(2**63 - 1,))
    return files


def _cut_strip(img: np.ndarray) -> bytes:
    """An LZW file whose one strip holds the first half of its data."""
    h, w, _ = img.shape
    data = K.lzw(img.tobytes())
    half = data[:len(data) // 2]
    return K.tiff([(256, 4, (w,)), (257, 4, (h,)), (258, 3, (8, 8, 8)), (259, 3, (5,)),
                   (262, 3, (2,)), (277, 3, (3,)), (278, 4, (h,))], [half])


def main() -> None:
    expected = {}
    for old in glob.glob(os.path.join(HERE, "*.tif")):
        os.remove(old)
    for stem, data in sorted(fixtures().items()):
        path = os.path.join(HERE, stem + ".tif")
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

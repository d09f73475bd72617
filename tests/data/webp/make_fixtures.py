"""Writes the committed WebP fixtures of this folder (run from the repo root:
``python tests/data/webp/make_fixtures.py``; needs PIL with WebP and gcc).

Each fixture is a ``.webp`` file; ``expected.npz`` holds PIL's decode of it,
``Image.open(p).convert("RGB")`` under the file's stem, and for the files
with alpha also ``convert("RGBA")`` under ``<stem>__rgba``. The card's
machine has no PIL: ``chip_smoke.py`` phase 36 and
``tests/test_torch_webp.py`` read these files.

- Lossy (VP8) files from PIL's encoder at several qualities and methods, at
  odd sizes, 1x1, and LSUN's 256x341.
- Lossy files with encoder options PIL cannot set, written by ``encode.c``
  through the libwebp that PIL bundles (built here with ``gcc`` against the
  system's ``webp/encode.h``): the simple loop filter, eight token
  partitions, one segment and four with a segment map, sharpness 7, no loop
  filter, and raw (uncompressed) alpha.
- A lossy file of flat macroblocks at method 1, which codes skip flags.
- Lossy files with alpha: PIL's (a VP8L-compressed ALPH chunk; one with
  three alpha levels, which libwebp decodes on its 8-bit path), and ALPH
  chunks written here, raw and VP8L-compressed, with each of the four
  filters (none, horizontal, vertical, gradient) applied to the plane.
- Lossless (VP8L) files through each transform (predictor, cross-colour,
  subtract-green; colour indexing with 256, 16, 4 and 2-colour palettes, so
  pixels bundle 1, 2, 4 and 8 to a byte) and the colour cache, with alpha.
- VP8X files with ICC and EXIF chunks (and XMP).
- Animations whose first frame is smaller than the canvas and sits at an
  offset, lossy and lossless with alpha.
"""
from __future__ import annotations

import glob
import io
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
PIL_LIBS = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)), "pillow.libs")


def _photo(h: int, w: int, seed: int, channels: int = 3, noise: float = 2.0) -> np.ndarray:
    """Smooth shapes and gradients with a little noise."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = []
    for c in range(channels):
        p = 128 + 60 * np.sin(xx / (17 + 5 * c) + rs.uniform(0, 6)) * np.cos(yy / (23 + 3 * c))
        for _ in range(3):
            cy, cx, r = rs.uniform(0, h), rs.uniform(0, w), rs.uniform(3, max(4, min(h, w) / 3))
            p = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r, rs.uniform(0, 255), p)
        planes.append(p + rs.normal(0, noise, (h, w)))
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _alpha(h: int, w: int, seed: int) -> np.ndarray:
    """A plane with flat areas, a ramp and a disc: every filter has work."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = (xx * 255 // max(1, w - 1)).astype(np.int64)
    a[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 4) ** 2] = 255
    a[: h // 4] = 0
    a += rs.integers(-3, 4, a.shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def _pil_webp(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "WEBP", **kw)
    return b.getvalue()


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")


def _riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


def _image_chunk(webp: bytes, tag: bytes) -> bytes:
    """The ``VP8 ``/``VP8L`` chunk of a simple-format file, padding kept."""
    assert webp[12:16] == tag, webp[12:16]
    return webp[12:]


def _filtered(a: np.ndarray, method: int) -> np.ndarray:
    """The deltas of libwebp's alpha filter ``method`` (1 horizontal, 2
    vertical, 3 gradient); every first row is filtered horizontally, and
    each row's first sample from the sample above it."""
    a = a.astype(np.int64)
    d = a.copy()
    if method == 0:
        return a.astype(np.uint8)
    for y in range(a.shape[0]):
        if y == 0 or method == 1:
            pred = np.concatenate([[a[y - 1, 0] if y > 0 else 0], a[y, :-1]])
        elif method == 2:
            pred = a[y - 1]
        else:
            left = np.concatenate([[a[y - 1, 0]], a[y, :-1]])
            top_left = np.concatenate([[a[y - 1, 0]], a[y - 1, :-1]])
            pred = np.clip(left + a[y - 1] - top_left, 0, 255)
        d[y] = a[y] - pred
    return (d & 0xFF).astype(np.uint8)


def _alph_chunk(a: np.ndarray, method: int, compressed: bool) -> bytes:
    """An ALPH chunk for plane ``a``: raw, or the deltas as the green channel
    of a headerless VP8L stream (PIL's lossless file without its 5-byte
    image header)."""
    deltas = _filtered(a, method)
    header = bytes([(method << 2) | (1 if compressed else 0)])
    if not compressed:
        return _chunk(b"ALPH", header + deltas.tobytes())
    g = np.zeros(deltas.shape + (3,), np.uint8)
    g[..., 1] = deltas
    vp8l = _pil_webp(g, lossless=True, quality=100, method=4)
    stream = vp8l[20 + 5:20 + struct.unpack("<I", vp8l[16:20])[0]]
    return _chunk(b"ALPH", header + stream)


def _helper() -> str:
    """``encode.c`` built against the libwebp PIL bundles."""
    out = os.path.join(tempfile.mkdtemp(), "encode")
    libs = glob.glob(os.path.join(PIL_LIBS, "libwebp-*.so*")) + glob.glob(
        os.path.join(PIL_LIBS, "libsharpyuv-*.so*"))
    subprocess.run(["gcc", "-O2", "-o", out, os.path.join(HERE, "encode.c"), *libs], check=True)
    return out


def _helper_webp(exe: str, img: np.ndarray, *opts: str) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        raw, out = os.path.join(d, "in.raw"), os.path.join(d, "out.webp")
        h, w, c = img.shape
        with open(raw, "wb") as f:
            f.write(struct.pack("<3I", w, h, c) + np.ascontiguousarray(img).tobytes())
        env = dict(os.environ, LD_LIBRARY_PATH=PIL_LIBS)
        subprocess.run([exe, raw, out, *opts], check=True, env=env)
        with open(out, "rb") as f:
            return f.read()


def fixtures() -> dict[str, bytes]:
    exe = _helper()
    photo = _photo(64, 80, 1)
    tall = _photo(160, 96, 2)
    rgba = np.concatenate([_photo(48, 56, 3), _alpha(48, 56, 3)[..., None]], -1)
    mask = rgba.copy()  # three alpha levels: libwebp's 8-bit alpha path
    mask[..., 3] = np.array([0, 128, 255], np.uint8)[(np.arange(56)[None, :] // 9 + np.arange(48)[:, None] // 11) % 3]
    flat = np.full((96, 128, 3), 90, np.uint8)  # flat macroblocks: the skip flag
    flat[40:60, 50:90] = _photo(20, 40, 12)
    files = {
        "lossy_q10_37x29": _pil_webp(_photo(29, 37, 4), quality=10),
        "lossy_q50_m6": _pil_webp(photo, quality=50, method=6),
        "lossy_q95_m0": _pil_webp(photo, quality=95, method=0),
        "lossy_1x1": _pil_webp(_photo(1, 1, 5), quality=80),
        "lossy_3x200": _pil_webp(_photo(3, 200, 6), quality=70),
        "lossy_lsun_256x341": _pil_webp(_photo(256, 341, 7), quality=75),
        "lossy_simple_filter": _helper_webp(exe, photo, "filter_type=0", "filter_strength=60"),
        "lossy_8_partitions": _helper_webp(exe, tall, "partitions=3", "method=2"),
        "lossy_4_segments": _helper_webp(exe, tall, "segments=4", "sns_strength=100", "quality=40"),
        "lossy_1_segment": _helper_webp(exe, photo, "segments=1"),
        "lossy_sharpness_7": _helper_webp(exe, photo, "filter_sharpness=7", "filter_strength=80"),
        "lossy_no_filter": _helper_webp(exe, photo, "filter_strength=0"),
        "lossy_alpha_pil": _pil_webp(rgba, quality=60),
        "lossy_alpha_mask": _pil_webp(mask, quality=60),
        "lossy_flat_skip": _pil_webp(flat, quality=75, method=1),
        "lossy_alpha_libwebp_raw": _helper_webp(exe, rgba, "alpha_compression=0"),
        "lossless_photo_q75": _pil_webp(photo, lossless=True, quality=75),
        "lossless_q0_m0": _pil_webp(photo, lossless=True, quality=0, method=0),
        "lossless_q100_m6": _pil_webp(tall, lossless=True, quality=100, method=6),
        "lossless_near_60": _helper_webp(exe, photo, "lossless=1", "near_lossless=60"),
        "lossless_rgba": _pil_webp(rgba, lossless=True, quality=80),
        "vp8x_icc_exif": _pil_webp(photo, quality=70, icc_profile=b"\0" * 131,
                                   exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0"),
        "vp8x_lossless_xmp": _pil_webp(photo, lossless=True, xmp=b"<x:xmpmeta/>"),
    }
    rs = np.random.default_rng(8)
    for n in (200, 11, 3, 2):  # colour indexing with 8, 4, 2 and 1-bit indices
        palette = rs.integers(0, 256, (n, 3)).astype(np.uint8)
        idx = (np.add.outer(np.arange(41) // 5, np.arange(53) // 7) + rs.integers(0, 2, (41, 53))) % n
        files[f"lossless_palette_{n}"] = _pil_webp(palette[idx], lossless=True)
    # ALPH chunks written here: raw and VP8L-compressed, each filter
    base = _pil_webp(rgba[..., :3], quality=70)
    vp8 = _image_chunk(base, b"VP8 ")
    for compressed in (False, True):
        for method in range(4):
            name = f"lossy_alpha_{'vp8l' if compressed else 'raw'}_filter{method}"
            files[name] = _riff(_vp8x(0x10, 56, 48) + _alph_chunk(rgba[..., 3], method, compressed) + vp8)
    # animations: the first frame smaller than the canvas, at an offset
    def anmf(x: int, y: int, frame: bytes, w: int, h: int, flags: int = 0) -> bytes:
        return _chunk(b"ANMF", (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                      + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                      + (100).to_bytes(3, "little") + bytes([flags]) + frame)
    anim = _chunk(b"ANIM", struct.pack("<IH", 0xFF336699, 0))
    small = _photo(20, 30, 9)
    second = _image_chunk(_pil_webp(_photo(40, 48, 10), quality=60), b"VP8 ")
    files["anim_lossy_offset"] = _riff(
        _vp8x(0x02, 48, 40) + anim
        + anmf(6, 4, _image_chunk(_pil_webp(small, quality=60), b"VP8 "), 30, 20)
        + anmf(0, 0, second, 48, 40))
    small_rgba = np.concatenate([small, _alpha(20, 30, 11)[..., None]], -1)
    files["anim_lossless_alpha_offset"] = _riff(
        _vp8x(0x12, 48, 40) + anim
        + anmf(10, 14, _image_chunk(_pil_webp(small_rgba, lossless=True), b"VP8L"), 30, 20)
        + anmf(0, 0, second, 48, 40, flags=2))
    return files


def main() -> None:
    expected = {}
    for old in glob.glob(os.path.join(HERE, "*.webp")):
        os.remove(old)
    for stem, data in sorted(fixtures().items()):
        path = os.path.join(HERE, stem + ".webp")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            expected[stem] = np.asarray(im.convert("RGB"))
            if "A" in im.mode:
                expected[stem + "__rgba"] = np.asarray(im.convert("RGBA"))
        print(f"{stem}: {len(data)} bytes, {expected[stem].shape}", file=sys.stderr)
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **expected)


if __name__ == "__main__":
    main()

"""Writes the committed JPEG fixtures of this folder (run from the repo root:
``python tests/data/jpeg/make_fixtures.py``; needs PIL and the JAX package).

For each fixture ``<stem>.jpg`` (or a PNG under a ``.JPEG`` name) it writes
PIL's decode, ``Image.open(p).convert("RGB")``, as ``<stem>.png``, except
for the 500×375 photograph, whose decode (about 180 KB as a PNG) is held by
its SHA-256 instead. ``manifest.json`` lists them with an ImageNet-layout
tree over them (``data/<synset>/<synset>_<k>.JPEG``, five synsets, 66 files,
one of them the ignored ``n06596364_9591.JPEG``) and the ``filelist.txt``
the JAX package builds for it. ``imagenet_val_crops.npz`` holds the JAX
package's ``ImageNetValidation(size=32)`` items of that tree: one uint8 crop
a fixture (the item is ``crop / 127.5 - 1`` in float32), and for each item
its path, label and fixture.

The files PIL cannot write (``format_fixtures``), listed in the manifest
beside the others but not in the tree: arithmetic-coded sequential and
progressive files (SOF9, SOF10) at 4:2:0, 4:4:4 and gray, with restarts and
with DAC conditioning; lossless files (SOF3) with each predictor, point
transforms 0 and 2, RGB and gray, and one 4:2:0 frame; progressive
files whose scans leave coefficients unrefined, which libjpeg smooths; and
the 500×375 photograph as SOF9 and SOF3. ``transcode.c`` writes them
through the libjpeg that PIL bundles (built here with ``gcc`` against the
system's ``jpeglib.h``), except the 4:2:0 lossless frame, which that
libjpeg writes at 1x1 only and ``_lossless_420`` encodes here. PIL is not a
stated package of the card's machine:
``chip_smoke.py`` phase 34 and ``tests/test_torch_jpeg.py`` read these
files.
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SYNSETS = ["n01440764", "n01443537", "n01484850", "n01491361", "n01494475"]
CROP = 32


def _photo(h: int, w: int, seed: int, channels: int = 3, noise: float = 2.0) -> np.ndarray:
    """Smooth shapes and gradients with a little noise: a photograph's
    statistics, small as a PNG."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = []
    for c in range(channels):
        p = 128 + 60 * np.sin(xx / (17 + 5 * c) + rs.uniform(0, 6)) * np.cos(yy / (23 + 3 * c))
        for _ in range(3):  # a few discs with hard edges
            cy, cx, r = rs.uniform(0, h), rs.uniform(0, w), rs.uniform(3, max(4, min(h, w) / 3))
            p = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r, rs.uniform(0, 255), p)
        planes.append(p + rs.normal(0, noise, (h, w)))
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _jpeg(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "JPEG", **kw)
    return b.getvalue()


def _with_adobe_transform(data: bytes, transform: int) -> bytes:
    """The APP14 Adobe segment's transform byte set: 2 makes PIL's CMYK file
    a YCCK one (its data then reads as YCCK)."""
    i = data.index(b"Adobe") - 4  # the marker, then the 2-byte length
    length = int.from_bytes(data[i + 2:i + 4], "big")
    return data[:i + 2 + length - 1] + bytes([transform]) + data[i + 2 + length:]


def fixtures() -> dict[str, bytes]:
    rgb = lambda h, w, s: Image.fromarray(_photo(h, w, s))  # noqa: E731
    cmyk = Image.frombytes("CMYK", (80, 60), _photo(60, 80, 6, 4).tobytes())
    ycck = Image.frombytes("CMYK", (64, 48), _photo(48, 64, 7, 4).tobytes())
    png = io.BytesIO()
    Image.fromarray(_photo(70, 90, 12)).save(png, "PNG")
    return {
        # 4:2:0 (PIL's default), with a photograph's noise: the decode-rate fixture
        "photo_420_q90.jpg": _jpeg(Image.fromarray(_photo(375, 500, 1, noise=4.0)), quality=90),
        "photo_444_q95.jpg": _jpeg(rgb(64, 97, 2), quality=95, subsampling=0),
        "photo_422_q75_optimized.jpg": _jpeg(rgb(90, 120, 3), quality=75, subsampling=1,
                                             optimize=True),
        "progressive_420_q85.jpg": _jpeg(rgb(120, 160, 4), quality=85, progressive=True),
        "gray_q80.jpg": _jpeg(Image.fromarray(_photo(120, 90, 5)[..., 0]), quality=80),
        "cmyk_q90.jpg": _jpeg(cmyk, quality=90),
        "ycck_q90.jpg": _with_adobe_transform(_jpeg(ycck, quality=90), 2),
        "restart_rows_q75.jpg": _jpeg(rgb(77, 100, 8), quality=75, restart_marker_rows=1),
        "progressive_restart_blocks.jpg": _jpeg(rgb(100, 77, 9), quality=80, progressive=True,
                                                restart_marker_blocks=2),
        "exif_icc_q80.jpg": _jpeg(rgb(33, 47, 10), quality=80,
                                  exif=Image.Exif().tobytes(), icc_profile=bytes(range(256)) * 4),
        "odd_37x29_q10.jpg": _jpeg(rgb(29, 37, 11), quality=10),
        "tiny_1x1.jpg": _jpeg(rgb(1, 1, 13), quality=95),
        "png_named.JPEG": png.getvalue(),  # ImageNet's n02105855_2933.JPEG is a PNG
    }


def _transcoder(tmp: str) -> str:
    """``transcode.c`` built against PIL's own libjpeg(-turbo)."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs",
                                  "libjpeg-*.so*"))
    if not libs:
        raise RuntimeError("PIL's bundled libjpeg not found")
    exe = os.path.join(tmp, "transcode")
    subprocess.run(["gcc", "-O2", "-o", exe, os.path.join(HERE, "transcode.c"), libs[0],
                    f"-Wl,-rpath,{os.path.dirname(libs[0])}"], check=True)
    return exe


def _bits_writer():
    """(put(code, length), close() -> bytes): MSB first, 0xFF stuffed, the
    last byte padded with ones."""
    out, acc = bytearray(), [0, 0]

    def put(code: int, n: int) -> None:
        acc[0], acc[1] = (acc[0] << n) | code, acc[1] + n
        while acc[1] >= 8:
            acc[1] -= 8
            byte = (acc[0] >> acc[1]) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)

    def close() -> bytes:
        if acc[1]:
            put((1 << (8 - acc[1])) - 1, 8 - acc[1])
        return bytes(out)

    return put, close


def _lossless_420(rgb: np.ndarray, psv: int) -> bytes:
    """A lossless (SOF3) frame with 2x2 sampling of its first component:
    PIL's YCbCr of ``rgb``, the second and third planes averaged 2x2,
    Huffman-coded differences (T.81 Annex H) with the standard luminance DC
    table; MCUs past the image edge hold dummy samples of difference 0. With
    no JFIF or Adobe marker libjpeg-turbo reads the planes as R, G and B (it
    converts no colour in a lossless file, so PIL refuses a YCbCr one)."""
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr")).astype(np.int64)
    h, w = ycc.shape[:2]
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    pad = np.pad(ycc, ((0, 2 * h2 - h), (0, 2 * w2 - w), (0, 0)), mode="edge")
    chroma = (pad[0::2, 0::2] + pad[0::2, 1::2] + pad[1::2, 0::2] + pad[1::2, 1::2] + 2) // 4

    def differences(p: np.ndarray) -> np.ndarray:
        pred = np.zeros_like(p)
        pred[0, 0], pred[0, 1:], pred[1:, 0] = 128, p[0, :-1], p[:-1, 0]
        a, b, c = p[1:, :-1], p[:-1, 1:], p[:-1, :-1]
        pred[1:, 1:] = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
                        6: b + ((a - c) >> 1), 7: (a + b) >> 1}[psv]
        return p - pred

    luma = np.zeros((2 * h2, 2 * w2), np.int64)
    luma[:h, :w] = differences(ycc[..., 0])
    cb, cr = differences(chroma[..., 1]), differences(chroma[..., 2])
    bits = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]  # K.3's luminance DC table
    codes, code = {}, 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            codes[len(codes)] = (code, length)
            code += 1
        code <<= 1
    put, close = _bits_writer()

    def emit(d: int) -> None:
        cat = abs(int(d)).bit_length()
        put(*codes[cat])
        if cat:
            put(int(d) if d > 0 else int(d) + (1 << cat) - 1, cat)

    for my in range(h2):
        for mx in range(w2):
            for d in luma[2 * my:2 * my + 2, 2 * mx:2 * mx + 2].reshape(-1):
                emit(d)
            emit(cb[my, mx])
            emit(cr[my, mx])
    seg = lambda m, body: bytes([0xFF, m]) + (len(body) + 2).to_bytes(2, "big") + body  # noqa: E731
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([3, 1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
    dht = bytes([0]) + bytes(bits[1:]) + bytes(range(12))
    sos = bytes([3, 1, 0, 2, 0, 3, 0, psv, 0, 0])
    return b"\xff\xd8" + seg(0xC3, sof) + seg(0xC4, dht) + seg(0xDA, sos) + close() + b"\xff\xd9"


def _pnm(path: str, img: np.ndarray) -> str:
    Image.fromarray(img).save(path)
    return path


def format_fixtures(files: dict[str, bytes]) -> dict[str, bytes]:
    """The arithmetic-coded, lossless and block-smoothed fixtures, made from
    ``files`` (``fixtures()``) and two small images."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = _transcoder(tmp)

        def run(*args: str) -> bytes:
            dst = os.path.join(tmp, "out.jpg")
            subprocess.run([exe, *args[:1], *(os.path.join(tmp, a) if a in files else a
                                              for a in args[1:2]), dst, *args[2:]], check=True)
            with open(dst, "rb") as f:
                return f.read()

        for name, data in files.items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        out["arith_photo_420_q90.jpg"] = run("arith", "photo_420_q90.jpg")
        out["arith_444_restart.jpg"] = run("arith", "photo_444_q95.jpg", "restart", "2")
        out["arith_gray.jpg"] = run("arith", "gray_q80.jpg")
        out["arith_prog_420_dac.jpg"] = run("arith", "progressive_420_q85.jpg", "prog", "dac")
        out["arith_prog_444.jpg"] = run("arith", "photo_444_q95.jpg", "prog")
        out["arith_prog_gray_restart_dac.jpg"] = run("arith", "gray_q80.jpg", "prog", "restart",
                                                     "3", "dac")
        out["smooth_ac_unrefined.jpg"] = run("script", "progressive_420_q85.jpg", "ac_unrefined")
        out["smooth_dc_al1.jpg"] = run("script", "progressive_420_q85.jpg", "dc_al1")
        prog = files["progressive_420_q85.jpg"]
        out["smooth_cut.jpg"] = prog[:len(prog) * 2 // 3] + b"\xff\xd9"  # inside a scan
        with Image.open(io.BytesIO(files["photo_420_q90.jpg"])) as im:
            photo = np.asarray(im.convert("RGB"))
        rgb = _pnm(os.path.join(tmp, "rgb.ppm"), _photo(30, 41, 14))
        gray = _pnm(os.path.join(tmp, "gray.pgm"), _photo(27, 35, 15)[..., 0])
        for psv in range(1, 8):
            out[f"lossless_rgb_psv{psv}.jpg"] = run("lossless", rgb, str(psv), "0")
            out[f"lossless_gray_psv{psv}_pt2.jpg"] = run("lossless", gray, str(psv), "2")
        out["lossless_rgb_psv6_pt2_restart.jpg"] = run("lossless", rgb, "6", "2", "restart",
                                                       str(2 * 41))
        out["lossless_420_psv4.jpg"] = _lossless_420(_photo(31, 41, 16), 4)
        out["lossless_photo.jpg"] = run("lossless", _pnm(os.path.join(tmp, "photo.ppm"), photo),
                                        "1", "0")
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from vavae_tpu.data.ldm_datasets import ImageNetValidation

    files = fixtures()
    entries, tree, written = [], [], {}
    for name, data in {**files, **format_fixtures(files)}.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        stem = os.path.splitext(name)[0]
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        entry = {"file": name, "shape": list(rgb.shape)}
        if rgb.size > 100_000:
            entry["decode_sha256"] = hashlib.sha256(rgb.tobytes()).hexdigest()
        elif rgb.tobytes() in written:  # an arithmetic file decodes as its Huffman source
            entry["decode"] = written[rgb.tobytes()]
        else:
            Image.fromarray(rgb).save(os.path.join(HERE, stem + ".png"), optimize=True)
            entry["decode"] = written[rgb.tobytes()] = stem + ".png"
        entries.append(entry)
    names = list(files)
    for syn in SYNSETS:
        for k, name in enumerate(names):
            tree.append({"path": f"data/{syn}/{syn}_{k:02d}.JPEG", "file": name})
    tree.append({"path": "data/n06596364/n06596364_9591.JPEG", "file": names[0]})  # ignored
    with tempfile.TemporaryDirectory() as root:
        for t in tree:
            os.makedirs(os.path.dirname(os.path.join(root, t["path"])), exist_ok=True)
            shutil.copy(os.path.join(HERE, t["file"]), os.path.join(root, t["path"]))
        ds = ImageNetValidation(root, size=CROP)
        source = {t["path"]: names.index(t["file"]) for t in tree}
        crops = [None] * len(names)
        labels, paths, fixture = [], [], []
        for i in range(len(ds)):
            x, y = ds[i]
            crop = np.rint((x.astype(np.float64) + 1.0) * 127.5).astype(np.uint8)
            assert np.array_equal((crop / 127.5 - 1.0).astype(np.float32), x)
            rel = os.path.relpath(ds.items[i][0], root)
            k = source[rel]
            assert crops[k] is None or np.array_equal(crops[k], crop)
            crops[k] = crop
            labels.append(y)
            paths.append(rel)
            fixture.append(k)
        with open(os.path.join(root, "filelist.txt")) as f:
            filelist = f.read()
    np.savez_compressed(os.path.join(HERE, "imagenet_val_crops.npz"), crops=np.stack(crops),
                        labels=np.array(labels, np.int64), paths=np.array(paths),
                        fixture=np.array(fixture, np.int64))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"fixtures": entries, "tree": tree, "crop_size": CROP,
                   "filelist": filelist}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()

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
its path, label and fixture. The card's machine has no PIL:
``chip_smoke.py`` phase 34 and ``tests/test_torch_jpeg.py`` read these
files.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
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


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from vavae_tpu.data.ldm_datasets import ImageNetValidation

    files = fixtures()
    entries, tree = [], []
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        stem = os.path.splitext(name)[0]
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        entry = {"file": name, "shape": list(rgb.shape)}
        if rgb.size > 100_000:
            entry["decode_sha256"] = hashlib.sha256(rgb.tobytes()).hexdigest()
        else:
            Image.fromarray(rgb).save(os.path.join(HERE, stem + ".png"), optimize=True)
            entry["decode"] = stem + ".png"
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

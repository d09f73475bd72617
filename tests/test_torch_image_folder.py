"""Image loading, the datasets and the prefetch thread of the port against
the JAX package on the same PNG files: the crops and the [-1, 1] images bit
for bit, the same items, labels, batch order, shuffle and striping."""
import json
import time

import numpy as np
import pytest
from PIL import Image

from vavae_tpu.data import image_folder as jif
from vavae_tpu.tokenizer import center_crop_arr as jax_crop
from vavae_tpu.tokenizer import preprocess_images as jax_preprocess
from vavae_tpu_torch.data import image_folder as tif
from vavae_tpu_torch.data.prefetch import prefetch
from vavae_tpu_torch.tokenizer import center_crop_arr, preprocess_images
from vavae_tpu_torch.utils.png import decode_png, read_image_rgb
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

S = 32  # target size: 70-px sides and up take one BOX halving first


def _write(path, mode: str, h: int, w: int, seed: int) -> None:
    rs = np.random.default_rng(seed)
    rgb = rs.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgb[h // 3:, : w // 2] = rgb[h // 3:, : w // 2] // 16 * 16  # flat areas for the filters
    if mode == "RGB":
        im = Image.fromarray(rgb)
    elif mode == "RGBA":
        im = Image.fromarray(np.dstack([rgb, rs.integers(0, 256, (h, w, 1)).astype(np.uint8)]))
    elif mode == "L":
        im = Image.fromarray(rgb[..., 0])
    elif mode == "LA":
        im = Image.fromarray(rgb[..., :2].copy(), "LA")
    elif mode == "P":  # 8-bit palette with a tRNS entry
        im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=200)
        im.save(path, transparency=7)
        return
    elif mode == "P4":  # PIL writes a palette of at most 16 colours at 4 bits
        im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=12)
    im.save(path)


MODES = ["RGB", "RGBA", "L", "LA", "P", "P4"]
SIZES = [(40, 48), (33, 90), (150, 131)]  # (h, w): no halving, one, one (short side 131)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    paths = {}
    for m, mode in enumerate(MODES):
        for s, (h, w) in enumerate(SIZES):
            p = root / f"{mode}_{s}.png"
            _write(p, mode, h, w, seed=10 * m + s)
            paths[mode, s] = str(p)
    return paths


@pytest.mark.parametrize("mode", MODES)
def test_read_image_rgb_matches_pil_convert(pngs, mode):
    for s in range(len(SIZES)):
        with Image.open(pngs[mode, s]) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(read_image_rgb(pngs[mode, s]), want)


def test_palette_depths_decode(tmp_path):
    """1-, 2- and 4-bit palettes (rows padded to a byte) as PIL reads them."""
    rgb = np.random.default_rng(0).integers(0, 256, (7, 13, 3)).astype(np.uint8)
    for colors, bits in ((2, 1), (4, 2), (16, 4)):
        path = tmp_path / f"p{bits}.png"
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=colors).save(path)
        data = path.read_bytes()
        assert data[24] == bits  # IHDR bit depth
        with Image.open(path) as im:
            np.testing.assert_array_equal(decode_png(data), np.asarray(im.convert("RGB")))


def test_png_writer_rgba_roundtrip(tmp_path):
    """The port's writer takes RGBA too; PIL reads the file back exactly."""
    from vavae_tpu_torch.utils.png import write_pngs

    img = np.random.default_rng(2).integers(0, 256, (1, 9, 11, 4)).astype(np.uint8)
    write_pngs(img, [str(tmp_path / "a.png")])
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(im), img[0])
    np.testing.assert_array_equal(read_image_rgb(str(tmp_path / "a.png")), img[0, ..., :3])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", range(len(SIZES)))
def test_center_crop_arr_matches_jax(pngs, mode, size):
    with Image.open(pngs[mode, size]) as im:
        want = jax_crop(im.convert("RGB"), S)
    got = center_crop_arr(read_image_rgb(pngs[mode, size]), S)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (S, S, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hflip", [False, True])
def test_preprocess_images_matches_jax(pngs, hflip):
    paths = [pngs[m, s] for m in MODES for s in range(len(SIZES))]
    ims = [Image.open(p) for p in paths]
    try:
        want = jax_preprocess(ims, S, hflip=hflip)
    finally:
        for im in ims:
            im.close()
    got = preprocess_images([read_image_rgb(p) for p in paths], S, hflip=hflip)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_load_image_matches_jax(pngs, mode):
    for s in range(len(SIZES)):
        want = jif._load_image(pngs[mode, s], S)
        got = tif._load_image(pngs[mode, s], S)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# -- datasets ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two classes of 7 and 6 PNGs, one in a nested folder (the recursive
    scan), and a stray text file."""
    root = tmp_path_factory.mktemp("tree")
    for c, n in (("a", 7), ("b", 6)):
        (root / c / "nested").mkdir(parents=True)
        for i in range(n):
            sub = root / c / ("nested" if i == 0 else "")
            _write(sub / f"{i}.png", "RGB", 36 + i, 40, seed=100 * len(c) + i + n)
    (root / "a" / "notes.txt").write_text("not an image")
    return root


def _same_batches(jax_it, port_it):
    want, got = list(jax_it), list(port_it)
    assert len(got) == len(want) > 0
    for (xw, lw), (xg, lg) in zip(want, got):
        np.testing.assert_array_equal(lg, lw)
        assert lg.dtype == lw.dtype == np.int32
        np.testing.assert_array_equal(xg, xw)


@pytest.mark.parametrize("recursive", [True, False])
def test_image_folder_dataset_items_match_jax(tree, recursive):
    want = jif.ImageFolderDataset(str(tree), image_size=S, recursive=recursive)
    got = tif.ImageFolderDataset(str(tree), image_size=S, recursive=recursive)
    assert got.items == want.items and got.class_to_idx == want.class_to_idx
    x, y = got[3]
    np.testing.assert_array_equal(x, want[3][0])
    assert y == want[3][1]


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=7, epochs=2, workers=4),
    dict(shuffle=False, drop_last=False, epochs=1, workers=1),
    dict(seed=3, epochs=1, process_index=1, process_count=2, drop_last=False, workers=2),
    dict(seed=3, epochs=1, process_index=0, process_count=3, workers=1),
])
def test_image_folder_batches_match_jax(tree, kw):
    want = jif.ImageFolderDataset(str(tree), image_size=S)
    got = tif.ImageFolderDataset(str(tree), image_size=S)
    _same_batches(want.batches(4, **kw), got.batches(4, **kw))


def test_image_folder_batches_refuse_zero_batch_loops(tree):
    ds = tif.ImageFolderDataset(str(tree), image_size=S)
    with pytest.raises(ValueError, match="spin forever"):
        next(ds.batches(64, epochs=None, workers=1))
    with pytest.warns(UserWarning, match="zero batches"):
        assert list(ds.batches(64, epochs=1, workers=1)) == []


def test_parse_user_id_matches_jax():
    for name in ("ID_1", "ID_31", "User_5", "user_0", "7", "ID_x", "misc", "User_", "-3"):
        assert tif.parse_user_id(name) == jif.parse_user_id(name)


@pytest.fixture(scope="module")
def users(tmp_path_factory):
    """Real root with ID_1, ID_2 (6 images each) and User_0; a generated root."""
    base = tmp_path_factory.mktemp("users")
    for root, names, n in ((base / "real", ("ID_1", "ID_2", "User_0", "misc"), 6),
                           (base / "gen", ("ID_1", "ID_2"), 3)):
        for u, name in enumerate(names):
            (root / name).mkdir(parents=True)
            for i in range(n):
                _write(root / name / f"{i}.png", "RGB", 32, 34 + i, seed=7 * u + i + n)
    return base


def _split_files(users, tmp_path):
    real = users / "real"
    u1 = sorted((real / "ID_1").glob("*.png"))
    u2 = sorted((real / "ID_2").glob("*.png"))
    rel = lambda p: str(p.relative_to(real))
    layouts = {
        "flat": {"train": [{"path": str(u1[0]), "user_id": 0},
                           {"file": str(u2[1]), "label": 1},
                           {"path": str(real / "gone.png"), "user_id": 1}]},
        "pairs": {"train": [[str(u1[2]), 0], [str(u2[3]), 1]]},
        "per_user": {"train": {"ID_2": [rel(p) for p in u2[:2]], "ID_1": [rel(u1[1]), "missing.png"],
                               "misc": [rel(u1[0])]},
                     "val": {"ID_1": [rel(p) for p in u1[3:5]]}},
        "legacy": {"train": ["ID_1", rel(u2[0]), "ID_2/deleted.png", str(u2[1])]},
    }
    paths = {}
    for name, data in layouts.items():
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(data))
    return paths


@pytest.mark.parametrize("layout", ["flat", "pairs", "per_user", "legacy"])
@pytest.mark.parametrize("user_id", [None, 1])
def test_split_file_dataset_matches_jax(users, tmp_path, layout, user_id):
    sf = _split_files(users, tmp_path)[layout]
    real = str(users / "real")
    kw = dict(image_size=S, root=real, user_id=user_id)
    want = jif.SplitFileDataset(str(sf), "train", **kw)
    got = tif.SplitFileDataset(str(sf), "train", **kw)
    assert got.items == want.items
    if got.items:
        _same_batches(want.batches(2, seed=1, epochs=1, drop_last=False, workers=1),
                      got.batches(2, seed=1, epochs=1, drop_last=False, workers=2))
    with pytest.raises(ValueError, match="not found"):
        tif.SplitFileDataset(str(sf), "test", image_size=S)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("use_generated", [False, True])
def test_mixed_domain_dataset_matches_jax(users, split, use_generated):
    kw = dict(real_dir=str(users / "real"), generated_dirs=[str(users / "gen"), "/nonexistent"],
              split=split, image_size=S, use_generated=use_generated, verbose=True)
    want = jif.MixedDomainDataset(**kw)
    got = tif.MixedDomainDataset(**kw)
    assert got.items == want.items and got.sources == want.sources
    assert got.summary() == want.summary()
    _same_batches(want.batches(3, seed=2, epochs=1, workers=1),
                  got.batches(3, seed=2, epochs=1, workers=1))


def test_mixed_domain_presplit_matches_jax(users, tmp_path):
    sf = _split_files(users, tmp_path)
    for layout in ("flat", "pairs", "per_user"):
        for split in ("train", "val"):
            kw = dict(real_dir=str(users / "real"), split=split, image_size=S,
                      split_file=str(sf[layout]), verbose=False)
            try:
                want = jif.MixedDomainDataset(**kw)
            except ValueError as e:  # an empty split raises on both sides
                with pytest.raises(ValueError, match=str(e)):
                    tif.MixedDomainDataset(**kw)
                continue
            assert tif.MixedDomainDataset(**kw).items == want.items


# -- prefetch ---------------------------------------------------------------------


def test_prefetch_preserves_order():
    assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))


def test_prefetch_reraises_producer_exception():
    def gen():
        yield 1
        raise ValueError("corrupt image")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="corrupt image"):
        next(it)


def test_prefetch_abandonment_closes_source():
    """Closing the consumer (what a break or GC does) unblocks the producer,
    which closes the source from its own thread, so its ``finally`` runs."""
    import threading

    closed = []

    def gen():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.append(threading.current_thread().name)

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5.0
    while not closed and time.monotonic() < deadline:
        time.sleep(0.05)
    assert closed and closed[0] != threading.current_thread().name

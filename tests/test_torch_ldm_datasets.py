"""The port's LSUN and ImageNet datasets (``data/ldm_datasets.py``) against the
JAX package's on JPEG trees: under one ``random.seed`` each class gives the
same items (bit for bit) and labels, ``filelist.txt`` is byte-equal, the six
LSUN subclasses read their default filelists, batches through
``ImageFolderDataset.batches`` agree, and a missing tree raises in both."""
import io
import os
import random
import shutil

import numpy as np
import pytest
import yaml
from PIL import Image

from test_torch_common import one_thread  # noqa: F401
from vavae_tpu.data import ldm_datasets as jax_ldm
from vavae_tpu_torch.data import ldm_datasets as port_ldm

pytestmark = pytest.mark.usefixtures("one_thread")

SYNSETS = ["n01440764", "n01443537", "n02105855"]


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 5 + yy) % 256, (xx * yy // 4) % 256, (200 - yy * 3) % 256], -1)
    return (img + rs.integers(-25, 26, img.shape)).clip(0, 255).astype(np.uint8)


def _save(path, k: int, h: int, w: int) -> None:
    """JPEGs of every kind the trees hold: RGB 4:2:0 and 4:4:4, progressive,
    gray, CMYK; one PNG under a ``.JPEG`` name."""
    img = _photo(h, w, k)
    kind = k % 6
    if kind == 5:
        Image.fromarray(img).save(path, "PNG")
        return
    if kind == 3:
        im = Image.fromarray(img[..., 0])
    elif kind == 4:
        im = Image.frombytes("CMYK", (w, h), np.dstack([img, img[..., :1]]).tobytes())
    else:
        im = Image.fromarray(img)
    im.save(path, "JPEG", quality=80 + k % 15, subsampling=2 if kind != 1 else 0,
            progressive=kind == 2)


@pytest.fixture(scope="module")
def imagenet_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    k = 0
    for s, syn in enumerate(SYNSETS):
        (root / "data" / syn).mkdir(parents=True)
        for i in range(4):
            _save(root / "data" / syn / f"{syn}_{i}.JPEG", k, 30 + 7 * i, 41 + 5 * s)
            k += 1
    (root / "data" / "n06596364").mkdir()
    _save(root / "data" / "n06596364" / "n06596364_9591.JPEG", 0, 30, 30)  # the ignored file
    return root


def _copy(tree, dst):
    shutil.copytree(tree, dst)
    return str(dst)


def _items(ds, seed: int):
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32 and gx.shape == wx.shape
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy


@pytest.mark.parametrize("cls", ["ImageNetTrain", "ImageNetValidation"])
def test_imagenet_matches_jax(imagenet_tree, tmp_path, cls):
    port_root = _copy(imagenet_tree, tmp_path / "port")
    jax_root = _copy(imagenet_tree, tmp_path / "jax")
    ds = getattr(port_ldm, cls)(port_root, size=24)
    jds = getattr(jax_ldm, cls)(jax_root, size=24)
    with open(os.path.join(port_root, "filelist.txt"), "rb") as f, \
            open(os.path.join(jax_root, "filelist.txt"), "rb") as g:
        assert f.read() == g.read()
    assert [os.path.relpath(p, port_root) for p, _ in ds.items] == \
        [os.path.relpath(p, jax_root) for p, _ in jds.items]
    assert len(ds) == 12 and ds.class_to_idx == jds.class_to_idx
    assert ds.random_crop == jds.random_crop == (cls == "ImageNetTrain")
    for seed in (0, 1):
        _assert_items_equal(_items(ds, seed), _items(jds, seed))


def test_imagenet_options_match_jax(imagenet_tree, tmp_path):
    """``random_crop`` overridden, ``keep_orig_class_label`` through
    ``index_synset.yaml``, ``strict_length``, and an existing filelist read
    as it stands."""
    roots = {}
    for side in ("port", "jax"):
        roots[side] = _copy(imagenet_tree, tmp_path / side)
        with open(os.path.join(roots[side], "index_synset.yaml"), "w") as f:
            yaml.safe_dump({7: SYNSETS[0], 3: SYNSETS[1], 900: SYNSETS[2]}, f)
    ds = port_ldm.ImageNetValidation(roots["port"], size=16, random_crop=True,
                                     keep_orig_class_label=True)
    jds = jax_ldm.ImageNetValidation(roots["jax"], size=16, random_crop=True,
                                     keep_orig_class_label=True)
    assert sorted({y for _, y in ds.items}) == [3, 7, 900]
    _assert_items_equal(_items(ds, 5), _items(jds, 5))
    with pytest.raises(ValueError, match="12 files, expected 50000"):
        port_ldm.ImageNetValidation(roots["port"], strict_length=True)
    with open(os.path.join(roots["port"], "filelist.txt"), "w") as f:
        f.write(f"{SYNSETS[1]}/{SYNSETS[1]}_0.JPEG\n")
    assert len(port_ldm.ImageNetTrain(roots["port"], size=16)) == 1


def test_imagenet_batches_match_jax(imagenet_tree, tmp_path):
    ds = port_ldm.ImageNetValidation(_copy(imagenet_tree, tmp_path / "port"), size=24)
    jds = jax_ldm.ImageNetValidation(_copy(imagenet_tree, tmp_path / "jax"), size=24)
    got = list(ds.batches(5, seed=3, epochs=2, workers=4))
    want = list(jds.batches(5, seed=3, epochs=2, workers=4))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_missing_tree_raises(tmp_path):
    for mod in (port_ldm, jax_ldm):
        with pytest.raises(FileNotFoundError, match="not found"):
            mod.ImageNetTrain(str(tmp_path / "nowhere"))


@pytest.fixture(scope="module")
def lsun_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lsun")
    names = []
    for k in range(6):
        name = f"img_{k}.jpg" if k % 6 != 5 else f"img_{k}.webp.jpg"
        _save(root / name, k, 40 + 9 * k, 52 - 3 * k)
        names.append(name)
    (root / "list.txt").write_text("\n".join(names) + "\n\n")
    return root


@pytest.mark.parametrize("interpolation", ["bicubic", "linear", "bilinear", "lanczos"])
@pytest.mark.parametrize("size,flip_p", [(24, 0.5), (None, 0.0), (24, 1.0)])
def test_lsun_matches_jax(lsun_tree, interpolation, size, flip_p):
    kw = dict(txt_file=str(lsun_tree / "list.txt"), data_root=str(lsun_tree), size=size,
              interpolation=interpolation, flip_p=flip_p)
    ds, jds = port_ldm.LSUNBase(**kw), jax_ldm.LSUNBase(**kw)
    assert ds.items == jds.items and len(ds) == 6
    _assert_items_equal(_items(ds, 11), _items(jds, 11))
    random.seed(2)
    ex = ds.example(3)
    random.seed(2)
    jex = jds.example(3)
    assert ex.keys() == jex.keys() and ex["file_path_"] == jex["file_path_"]
    np.testing.assert_array_equal(ex["image"], jex["image"])


LSUN_DEFAULTS = {
    "LSUNChurchesTrain": ("data/lsun/church_outdoor_train.txt", "data/lsun/churches", 0.5),
    "LSUNChurchesValidation": ("data/lsun/church_outdoor_val.txt", "data/lsun/churches", 0.0),
    "LSUNBedroomsTrain": ("data/lsun/bedrooms_train.txt", "data/lsun/bedrooms", 0.5),
    "LSUNBedroomsValidation": ("data/lsun/bedrooms_val.txt", "data/lsun/bedrooms", 0.0),
    "LSUNCatsTrain": ("data/lsun/cat_train.txt", "data/lsun/cats", 0.5),
    "LSUNCatsValidation": ("data/lsun/cat_val.txt", "data/lsun/cats", 0.0),
}


@pytest.mark.parametrize("name", sorted(LSUN_DEFAULTS))
def test_lsun_subclasses_read_their_default_filelists(lsun_tree, tmp_path, monkeypatch, name):
    txt, root, flip_p = LSUN_DEFAULTS[name]
    shutil.copytree(lsun_tree, tmp_path / root)
    shutil.copy(lsun_tree / "list.txt", tmp_path / txt)
    monkeypatch.chdir(tmp_path)
    ds, jds = getattr(port_ldm, name)(size=16), getattr(jax_ldm, name)(size=16)
    assert ds.flip_p == jds.flip_p == flip_p
    assert ds.items == jds.items and ds.items[0][0] == os.path.join(root, "img_0.jpg")
    _assert_items_equal(_items(ds, 4), _items(jds, 4))

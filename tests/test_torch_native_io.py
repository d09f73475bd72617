"""The shard reader (``data/native_loader.py`` over C++), its build
(``native/build.py``), and the threaded PNG writer (``utils/png.py``).

The reader's batches equal the port's Python reference
(``ImgLatentDataset.reference_batch``) and the JAX package's Python path bit
for bit, and lie within 2 ulp of the JAX package's native reader (which
normalises as (x − μ)·(m/σ)). The writer's files are byte-equal to the JAX
package's native writer's (Python's zlib and the one that writer links are
the same library here) and decode to their input. Shards the reader does not
take, a file the writer cannot write and a failed build each raise; nothing
falls back. The stats cache needs no reader.
"""
import os
import shutil

import numpy as np
import pytest

from test_torch_common import one_thread  # noqa: F401
from vavae_tpu.data.latent_dataset import ImgLatentDataset as JaxDataset
from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
from vavae_tpu_torch.data.native_loader import NativeShardReader
from vavae_tpu_torch.native import build as native_build
from vavae_tpu_torch.utils.png import encode_png, read_png, write_pngs
from vavae_tpu_torch.utils.safetensors_io import write_safetensors

pytestmark = pytest.mark.usefixtures("one_thread")


def _shards(d, sizes=(7, 5, 9), C=4, H=3, W=5, label_dtype=np.int64, seed=0):
    rs = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i, n in enumerate(sizes):
        lat = (3.0 * rs.standard_normal((n, C, H, W)) + 1.0).astype(np.float32)
        write_safetensors(os.path.join(d, f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 1000, (n,)).astype(label_dtype)})
    return str(d)


def _batches(ds, n=6, **kw):
    return [b for _, b in zip(range(n), ds.batches(4, seed=5, **kw))]


def _reference(ds, n=6, **kw):
    """The port's Python assembly of the batches ``_batches`` reads."""
    return [ds.reference_batch(i, f) for _, (i, f) in zip(range(n), ds.index_batches(4, seed=5, **kw))]


@pytest.mark.parametrize("label_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("latent_norm,multiplier", [(True, 1.0), (True, 0.9), (False, 1.5)])
def test_reader_matches_python_paths(tmp_path, monkeypatch, latent_norm, multiplier, label_dtype):
    port = _shards(tmp_path / "port", label_dtype=label_dtype)
    jax_dir = str(tmp_path / "jax")
    shutil.copytree(port, jax_dir)
    native = ImgLatentDataset(port, latent_norm=latent_norm, latent_multiplier=multiplier)
    assert native._native is None  # opened by the first batch
    got = _batches(native)
    assert native._native is not None
    monkeypatch.setenv("VAVAE_NATIVE_LOADER", "0")  # the JAX package's switch
    jax_python = JaxDataset(jax_dir, latent_norm=latent_norm, latent_multiplier=multiplier)
    monkeypatch.setenv("VAVAE_NATIVE_LOADER", "1")
    jax_native = JaxDataset(jax_dir, latent_norm=latent_norm, latent_multiplier=multiplier)
    assert jax_native._native is not None
    for want in (_reference(native), _batches(jax_python)):
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype == np.float32 and gx.shape == wx.shape == (4, 3, 5, 4)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert gy.dtype == np.int32
    for (gx, gy), (wx, wy) in zip(got, _batches(jax_native)):
        np.testing.assert_array_max_ulp(gx, wx, maxulp=2)
        np.testing.assert_array_equal(gy, wy)


def test_reader_rows_and_threads_match_python(tmp_path):
    """Each process's rows of a batch (``rows``), and any thread count."""
    d = _shards(tmp_path, sizes=(16, 11))
    native = ImgLatentDataset(d)
    for rows in ((0, 2), (1, 2)):
        for (gx, gy), (wx, wy) in zip(_batches(native, rows=rows), _reference(native, rows=rows)):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    reader = NativeShardReader(native.files, threads=3)
    idx = np.arange(len(reader))[::-1].copy()
    flips = idx % 3 == 0
    x1, y1 = reader.batch(idx, flips, native._mean, native._std, 0.7)
    x8, y8 = native._native.batch(idx, flips, native._mean, native._std, 0.7)
    np.testing.assert_array_equal(x1, x8)
    np.testing.assert_array_equal(y1, y8)
    with pytest.raises(ValueError, match="index 27 out of range"):
        reader.batch(np.array([27]), np.array([False]), None, None)
    reader.close()
    with pytest.raises(ValueError, match="closed"):
        reader.batch(idx, flips, None, None)


def _one_shard(path, **tensors):
    rs = np.random.default_rng(1)
    lat = rs.standard_normal((3, 2, 2, 2)).astype(np.float32)
    base = {"latents": lat, "latents_flip": lat[..., ::-1].copy(),
            "labels": np.arange(3, dtype=np.int64)}
    base.update(tensors)
    write_safetensors(str(path), {k: v for k, v in base.items() if v is not None})
    return str(path)


def _kind_shards(d, kind, seed=0):
    """Shards of one kind the JAX package reads: latents of another dtype,
    no flips, or labels of another dtype."""
    rs = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i, n in enumerate((7, 6)):
        lat = 3.0 * rs.standard_normal((n, 4, 3, 5)) + 1.0
        labels = rs.integers(-200, 1000, (n,))
        dtype = {"F16": np.float16, "F64": np.float64, "I32": np.int32, "BOOL": np.bool_}.get(
            kind, np.float32)
        lat = (lat > 1.0) if dtype is np.bool_ else (8 * lat if kind == "I32" else lat)
        lat = lat.astype(dtype)
        tensors = {"latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
                   "labels": labels.astype(np.int64)}
        if kind == "no_flip":
            del tensors["latents_flip"]
        elif kind == "labels_F32":  # cut toward zero, as np.asarray(label, np.int32) cuts
            tensors["labels"] = (labels + rs.choice([0.0, 0.3, 0.7], n)).astype(np.float32)
        elif kind == "labels_I16":
            tensors["labels"] = labels.astype(np.int16)
        elif kind == "labels_U8":
            tensors["labels"] = (labels % 256).astype(np.uint8)
        write_safetensors(os.path.join(d, f"shard_{i:03d}.safetensors"), tensors)
    return str(d)


@pytest.mark.parametrize("latent_norm", [True, False])
@pytest.mark.parametrize("kind", ["F16", "F64", "I32", "BOOL", "no_flip", "labels_F32",
                                  "labels_I16", "labels_U8"])
def test_reader_reads_what_jax_reads(tmp_path, kind, latent_norm):
    """Every shard kind the JAX dataset reads: its labels exactly, its
    latents bit for bit where it took its Python path and within 2 ulp where
    its native reader ran; and ``reference_batch`` bit for bit."""
    port = _kind_shards(tmp_path / "port", kind)
    jax_dir = str(tmp_path / "jax")
    shutil.copytree(port, jax_dir)
    ds = ImgLatentDataset(port, latent_norm=latent_norm, latent_multiplier=0.9)
    got = _batches(ds, n=3)
    jax = JaxDataset(jax_dir, latent_norm=latent_norm, latent_multiplier=0.9)
    # the JAX package's native reader takes F32 latents with I64, I32 or F32 labels
    assert (jax._native is not None) == (kind in ("no_flip", "labels_F32"))
    for (gx, gy), (wx, wy), (rx, ry) in zip(got, _batches(jax, n=3), _reference(ds, n=3)):
        assert gx.dtype == np.float32 and gy.dtype == np.int32 and gx.shape == (4, 3, 5, 4)
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
        np.testing.assert_array_equal(gy, wy)
        if jax._native is None:
            np.testing.assert_array_equal(gx, wx)
        else:
            np.testing.assert_array_max_ulp(gx, wx, maxulp=2)


def _raw_shard(path, tensors):
    """A safetensors file of (dtype name, shape, bytes) entries, for dtypes
    numpy has no type for."""
    import json
    import struct

    header, blobs, at = {}, [], 0
    for name, (dtype, shape, blob) in tensors.items():
        header[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": [at, at + len(blob)]}
        blobs.append(blob)
        at += len(blob)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text + b"".join(blobs))
    return str(path)


@pytest.mark.parametrize("tensors,match", [
    ({"latents": np.zeros((3, 8), np.float32)}, "latents is F32 \\[3, 8\\]"),
    ("BF16", "latents is BF16"),
    ({"labels": np.zeros(4, np.int64)}, "4 labels for 3 latents"),
    ({"latents_flip": np.zeros((3, 2, 2, 3), np.float32)}, "does not match latents"),
    ({"latents": np.zeros((3, 2, 2, 2, 1), np.float32)}, "latents is F32 \\[3, 2, 2, 2, 1\\]"),
])
def test_reader_refuses_shards_it_does_not_take(tmp_path, tensors, match):
    """What the JAX package cannot read either (BF16 latents, which numpy
    cannot load; latents that are not (N, C, H, W)) and malformed shards:
    the dataset opens, and its first batch raises, naming the file."""
    path = tmp_path / "bad.safetensors"
    if tensors == "BF16":
        bits = np.zeros((3, 2, 2, 2), np.uint16).tobytes()
        path = _raw_shard(path, {"latents": ("BF16", (3, 2, 2, 2), bits),
                                 "labels": ("I64", (3,), np.arange(3, dtype=np.int64).tobytes())})
    else:
        path = _one_shard(path, **tensors)
    ds = ImgLatentDataset(str(tmp_path), latent_norm=False)
    with pytest.raises(ValueError, match=f"{path}: .*{match}"):
        next(ds.batches(2))


def test_stats_need_no_reader(tmp_path, monkeypatch):
    """``load_latent_stats`` and the stats cache that extraction builds read
    a folder whose shards the reader refuses (no ``latents_flip``), and build
    no library."""
    from vavae_tpu_torch.pipelines.sample import load_latent_stats
    from vavae_tpu_torch.utils.config import Config

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(native_build, "build", no_build)
    lat = np.random.default_rng(4).standard_normal((5, 3, 2, 2)).astype(np.float32)
    write_safetensors(str(tmp_path / "a.safetensors"), {"latents": lat,
                                                        "labels": np.arange(5, dtype=np.int32)})
    want = ImgLatentDataset(str(tmp_path), latent_norm=True).compute_latent_stats()
    mean, std = load_latent_stats(Config({"data": {"latent_norm": True,
                                                   "data_path": str(tmp_path)}}))
    np.testing.assert_allclose(mean, want[0], rtol=1e-6)
    np.testing.assert_allclose(std, want[1], rtol=1e-6)
    assert (tmp_path / "latents_stats.safetensors").exists()


def test_reader_refuses_mixed_shapes_and_short_files(tmp_path):
    a = _one_shard(tmp_path / "a.safetensors")
    b = _one_shard(tmp_path / "b.safetensors",
                   latents=np.zeros((3, 2, 2, 3), np.float32),
                   latents_flip=np.zeros((3, 2, 2, 3), np.float32))
    with pytest.raises(ValueError, match=f"{b}: latents of shape"):
        NativeShardReader([a, b])
    data = open(a, "rb").read()
    with open(a, "wb") as f:
        f.write(data[:-8])  # the header still promises the last bytes
    with pytest.raises(OSError, match=f"{a}: tensors run past the end of the file"):
        NativeShardReader([a])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; no library
    is left behind and nothing is loaded in its place."""
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native_build, "SRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native_build.LINK, "broken", [])
    with pytest.raises(RuntimeError, match="g[+][+] failed for broken.cpp"):
        native_build.load_library("broken")
    assert not list((tmp_path / "build").glob("*.so"))
    assert "broken" not in native_build._LOADED


def test_build_is_named_by_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / "ok.cpp").write_text('extern "C" int answer() { return 42; }\n')
    monkeypatch.setattr(native_build, "SRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native_build.LINK, "ok", [])
    first = native_build.build("ok")
    assert first.name.startswith("libok.") and native_build.build("ok") == first
    (tmp_path / "ok.cpp").write_text('extern "C" int answer() { return 43; }\n')
    second = native_build.build("ok")
    assert second != first and second.exists()
    import ctypes

    assert ctypes.CDLL(str(second)).answer() == 43


@pytest.mark.parametrize("shape", [(5, 17, 23, 3), (1, 1, 1, 3), (3, 64, 48, 3)])
def test_writer_matches_jax_and_decodes_to_its_input(tmp_path, shape):
    """On a pool of threads or one: the JAX package's native writer's bytes
    (one zlib here), and the input again when read back."""
    from vavae_tpu.utils.png_native import write_pngs_native as jax_write

    imgs = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    imgs[:, : shape[1] // 2] //= 16  # flat areas: deflate has something to find
    port = [str(tmp_path / f"p{i}.png") for i in range(shape[0])]
    jax = [str(tmp_path / f"j{i}.png") for i in range(shape[0])]
    jax_write(imgs, jax)
    for threads in (0, 1, 3):
        write_pngs(imgs, port, threads=threads)
        for p, j, im in zip(port, jax, imgs):
            data = open(p, "rb").read()
            assert data == open(j, "rb").read() == encode_png(im)
            np.testing.assert_array_equal(read_png(p), im)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    """A file that does not open raises once the others are written; a bad
    shape or count raises."""
    imgs = np.zeros((3, 4, 4, 3), np.uint8)
    paths = [str(tmp_path / "a.png"), str(tmp_path / "no" / "b.png"), str(tmp_path / "c.png")]
    with pytest.raises(FileNotFoundError, match="b.png"):
        write_pngs(imgs, paths, threads=2)
    np.testing.assert_array_equal(read_png(paths[2]), imgs[2])
    with pytest.raises(ValueError, match="expected"):
        write_pngs(np.zeros((1, 4, 4, 2), np.uint8), [str(tmp_path / "a.png")])
    with pytest.raises(ValueError, match="3 images for 1 paths"):
        write_pngs(imgs, [str(tmp_path / "a.png")])

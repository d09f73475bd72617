"""FID against the JAX package: random JAX InceptionV3-FID variables carried
into the port (pool3 activations within 1e-4 relative), the Fréchet
distance (1e-8), the FID of two PNG folders through both packages' entry
points with the same weights file, the sampling pipeline's ``FID:`` line,
and the port's PNG decoder against PIL on files of every colour type and
scanline filter.
"""
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _random_inception_variables(seed: int):
    """JAX InceptionV3FID variables drawn with numpy (the flax init runs
    op by op for half a minute): He-normal kernels, batch norms away from
    the identity so every statistic matters."""
    from vavae_tpu.eval.inception import InceptionV3FID

    shapes = jax.eval_shape(lambda: InceptionV3FID().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    rs = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            return (rs.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.7, 1.3, shape).astype(np.float32)
        return (0.05 * rs.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def inception_pair():
    """(JAX model, its variables, the port's model with the same weights)."""
    from vavae_tpu.eval.inception import InceptionV3FID as JaxInception
    from vavae_tpu_torch.eval.inception import InceptionV3FID
    from vavae_tpu_torch.utils.weights import inception_state_from_jax

    variables = _random_inception_variables(0)
    tm = InceptionV3FID()
    tm.load_state_dict(inception_state_from_jax(variables), strict=True)
    return JaxInception(), variables, tm.eval()


def test_inception_pool3_matches_jax(inception_pair):
    jm, variables, tm = inception_pair
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    assert np.abs(want).max() > 0
    assert max_rel(got, want) < 1e-4


def test_inception_loads_a_pytorch_fid_checkpoint(tmp_path, inception_pair):
    """A pytorch-fid checkpoint carries the classifier (``fc.*``): the loader
    drops it and loads the rest strictly, by name; a missing tensor
    raises."""
    from vavae_tpu_torch.eval.inception import load_inception

    _, _, tm = inception_pair
    sd = dict(tm.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    path = str(tmp_path / "pt_inception.pth")
    torch.save(sd, path)
    loaded = load_inception(path, device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_inception(path, device="cpu")


def test_load_inception_needs_weights_or_allow_random(monkeypatch):
    from vavae_tpu_torch.eval.inception import load_inception

    monkeypatch.delenv("VAVAE_FID_WEIGHTS", raising=False)
    monkeypatch.delenv("VAVAE_FID_ALLOW_RANDOM", raising=False)
    with pytest.raises(FileNotFoundError, match="VAVAE_FID_WEIGHTS"):
        load_inception(device="cpu")
    a = load_inception(allow_random=True, device="cpu")
    monkeypatch.setenv("VAVAE_FID_ALLOW_RANDOM", "1")
    b = load_inception(device="cpu")
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k  # the random weights come from a fixed seed


@pytest.mark.parametrize("dim,n", [(8, 40), (64, 20)])
def test_frechet_distance_matches_jax(dim, n):
    """Full-rank and rank-deficient covariances (n < dim), and the
    statistics of the activations."""
    from vavae_tpu.eval import fid as jfid
    from vavae_tpu_torch.eval import fid

    rs = np.random.default_rng(dim)
    a = rs.standard_normal((n, dim)).astype(np.float32)
    b = (rs.standard_normal((n, dim)) * 1.3 + 0.2).astype(np.float32)
    sa, sb = fid.activation_statistics(a), fid.activation_statistics(b)
    for got, want in zip(sa + sb, jfid.activation_statistics(a) + jfid.activation_statistics(b)):
        np.testing.assert_array_equal(got, want)
    got = fid.frechet_distance(*sa, *sb)
    assert abs(got - jfid.frechet_distance(*sa, *sb)) <= 1e-8
    assert got > 0


def _png_folder(path, seed, n=3, size=24):
    from vavae_tpu_torch.utils.png import write_pngs

    os.makedirs(path)
    imgs = np.random.default_rng(seed).integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    write_pngs(imgs, [os.path.join(path, f"{i:06d}.png") for i in range(n)])
    return imgs


def test_fid_of_two_folders_matches_jax(tmp_path, inception_pair):
    """Both packages' ``fid_given_paths`` on the same PNG folders with the
    same weights file (the port's decoder against PIL on the way); the
    npz packer makes a file with the folder's statistics. (Each FID takes
    a 2048² matrix square root, seconds on the CPU.)"""
    from vavae_tpu.eval import fid as jfid
    from vavae_tpu_torch.eval import fid

    _, _, tm = inception_pair
    weights = str(tmp_path / "w.pth")
    torch.save(tm.state_dict(), weights)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _png_folder(a, 1)
    _png_folder(b, 2)
    want = jfid.fid_given_paths(a, b, weights_path=weights, batch_size=3)
    got = fid.fid_given_paths(a, b, weights_path=weights, batch_size=3, device="cpu")
    assert got > 0 and abs(got - want) <= 1e-4 * abs(want)
    npz = fid.create_npz_from_sample_folder(a, num=3)
    assert npz == f"{a}.npz"
    np.testing.assert_array_equal(np.load(npz)["arr_0"], np.load(
        jfid.create_npz_from_sample_folder(a, num=3, out=str(tmp_path / "j.npz")))["arr_0"])
    ex = fid.FIDExtractor(weights, batch_size=2, device="cpu")
    for x, y in zip(fid.compute_statistics_of_path(a, ex), fid.compute_statistics_of_path(npz, ex)):
        np.testing.assert_array_equal(x, y)


def test_fid_main_and_precomputed_stats(tmp_path, capsys, inception_pair):
    """``--save_stats`` writes a folder's statistics; a FID of two stats
    files needs no weights; ``--save_npz``."""
    from vavae_tpu_torch.eval import fid

    _, _, tm = inception_pair
    weights = str(tmp_path / "w.pth")
    torch.save(tm.state_dict(), weights)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _png_folder(a, 3)
    _png_folder(b, 4)
    for src, out in ((a, "sa.npz"), (b, "sb.npz")):
        fid.main([src, "--save_stats", str(tmp_path / out), "--weights", weights,
                  "--batch_size", "3", "--device", "cpu"])
    ex = fid.FIDExtractor(weights, batch_size=3, device="cpu")
    for src, out in ((a, "sa.npz"), (b, "sb.npz")):
        with np.load(str(tmp_path / out)) as f:
            for x, y in zip((f["mu"], f["sigma"]), fid.compute_statistics_of_path(src, ex)):
                np.testing.assert_array_equal(x, y)
    # two small stats files (a 2048² square root takes seconds)
    rs = np.random.default_rng(5)
    stats = []
    for name in ("ta.npz", "tb.npz"):
        acts = rs.standard_normal((30, 6))
        np.savez(str(tmp_path / name), mu=acts.mean(0), sigma=np.cov(acts, rowvar=False))
        stats += list(fid.activation_statistics(acts))
    fid.main([str(tmp_path / "ta.npz"), str(tmp_path / "tb.npz"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"FID: {fid.frechet_distance(*stats):.6f}"
    fid.main([a, "--save_npz", str(tmp_path / "p.npz"), "--num", "3"])
    assert np.load(str(tmp_path / "p.npz"))["arr_0"].shape == (3, 24, 24, 3)


def test_sample_main_prints_fid(tmp_path, capsys, monkeypatch):
    """``python -m vavae_tpu_torch.pipelines.sample`` with
    ``data.fid_reference_file`` samples the folder and prints ``FID: x``
    as the JAX ``main`` does (random Inception weights, allowed by the
    environment, on a DiT-S/2 checkpoint and a tiny VAE config)."""
    import yaml

    from test_torch_common import tiny_vae_config
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines import sample
    from vavae_tpu_torch.utils.safetensors_io import flatten, write_safetensors
    from vavae_tpu_torch.utils.weights import dit_state_to_jax, randomize_

    model_cfg = {"model_type": "LightningDiT-S/2", "use_swiglu": True, "use_rope": True,
                 "use_rmsnorm": True, "in_chans": 4}
    dit = create_dit(model_cfg, 8, 10)
    randomize_(dit, 0)
    ckpt = str(tmp_path / "dit.safetensors")
    write_safetensors(ckpt, flatten(dit_state_to_jax(dit.state_dict()), "params"))
    ref = str(tmp_path / "ref.npz")
    np.savez(ref, arr_0=np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3)).astype(np.uint8))
    cfg = {
        "ckpt_path": ckpt, "sample_folder": str(tmp_path / "samples"),
        "data": {"image_size": 16, "num_classes": 10, "latent_norm": False,
                 "fid_reference_file": ref},
        "vae": {"downsample_ratio": 2, "config": tiny_vae_config(tmp_path)},
        "model": model_cfg,
        "transport": {"path_type": "Linear", "prediction": "velocity"},
        "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 3,
                   "cfg_scale": 4.0, "cfg_interval_start": 0.11, "timestep_shift": 0.3,
                   "per_proc_batch_size": 2, "fid_num": 4},
        "train": {"global_seed": 0, "exp_name": "t", "output_dir": str(tmp_path)},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("VAVAE_FID_ALLOW_RANDOM", "1")
    monkeypatch.delenv("VAVAE_FID_WEIGHTS", raising=False)
    sample.main(["--config", str(path), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("FID: ") and len(lines[-1].split(".")[-1]) == 4
    assert np.isfinite(float(lines[-1][5:]))
    assert sorted(os.listdir(tmp_path / "samples")) == [f"{i:06d}.png" for i in range(4)]


# -- PNG decoder -----------------------------------------------------------------------


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """(H, W, C) uint8 → a PNG whose every scanline uses filter ``ftype``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), written here as the PNG
    specification defines the filters."""
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        line, prev = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(line)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(ftype)
        out += ((line - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("mode", list(MODES))
def test_png_decoder_matches_pil_on_pil_files(tmp_path, mode):
    """Files PIL writes (its own filter choice), read by both; with
    ``rgb`` as PIL's ``convert("RGB")``."""
    from PIL import Image

    from vavae_tpu_torch.utils.png import decode_png, read_png

    c = MODES[mode]
    rs = np.random.default_rng(c)
    img = rs.integers(0, 256, (19, 23, c)).astype(np.uint8)
    img[5:12, 3:20] = 40  # flat areas, where PIL's filters differ from the noise's
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img[..., 0] if c == 1 else img, mode).save(path)
    with Image.open(path) as im:
        want = np.asarray(im)
        want_rgb = np.asarray(im.convert("RGB"))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()).reshape(want.shape), want)
    np.testing.assert_array_equal(read_png(path), want_rgb)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_png_decoder_every_filter(tmp_path, mode, ftype):
    """Every scanline filter on every colour type: PIL reads the file as
    the image, and so does the port."""
    from PIL import Image

    from vavae_tpu_torch.utils.png import decode_png

    c = MODES[mode]
    img = np.random.default_rng(10 * c + ftype).integers(0, 256, (7, 9, c)).astype(np.uint8)
    data = _filtered_png(img, ftype)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(img.shape), img)
    np.testing.assert_array_equal(decode_png(data), img)


def test_png_decoder_refuses_what_it_does_not_read(tmp_path):
    """A file that is not a PNG, a bit depth its colour type does not allow
    and an unknown interlace method raise, naming the bit depth, colour type
    and interlace (and, from ``read_png``, the path); PIL refuses such files
    too. A 16-bit file, which the reader once refused, reads as PIL reads
    it."""
    import struct

    from PIL import Image

    from vavae_tpu_torch.utils.png import _chunk, decode_png, read_png

    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    path = tmp_path / "p.png"
    gray16 = (np.arange(16, dtype=np.uint16) * 4099).reshape(4, 4)
    Image.fromarray(gray16).save(path)  # PIL writes uint16 as 16-bit gray
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_png(str(path)), np.asarray(im.convert("RGB")))
    # an 8-bit RGB file whose IHDR claims 4 bits, then interlace method 2
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    data = path.read_bytes()
    for depth, interlace in ((4, 0), (8, 2)):
        ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, 2, 0, 0, interlace))
        path.write_bytes(data[:8] + ihdr + data[8 + len(ihdr):])
        with pytest.raises(ValueError, match=f"bit depth {depth}, colour type 2"):
            decode_png(path.read_bytes())
        with pytest.raises(ValueError, match=f"{path}: .*colour type 2, interlace {interlace}"):
            read_png(str(path))
        with pytest.raises(OSError):
            with Image.open(path) as im:
                im.convert("RGB")


def test_non_png_images_need_pil(tmp_path, monkeypatch):
    """A folder's GIF (a type the port does not decode) goes through PIL, and
    without PIL the error names it; a JPEG, a WebP and a BMP go through the
    port's decoders, which need no PIL."""
    import builtins

    from PIL import Image

    from vavae_tpu_torch.utils.png import read_image_rgb

    img = Image.fromarray(np.full((8, 8, 3), 128, np.uint8))
    gif = str(tmp_path / "x.gif")
    img.save(gif)
    assert read_image_rgb(gif).shape == (8, 8, 3)
    want = {}
    for ext in ("jpg", "webp", "bmp"):
        path = str(tmp_path / f"x.{ext}")
        img.save(path)
        want[path] = np.asarray(Image.open(path).convert("RGB"))
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match=f"{gif}: .*needs PIL"):
        read_image_rgb(gif)
    for path, w in want.items():
        np.testing.assert_array_equal(read_image_rgb(path), w)

"""Latent extraction of the port against the JAX package's on one PNG
folder, with the tiny VA-VAE (ch 32, ch_mult (1, 1), embed_dim 4, 32²
images, random non-zero weights through the bridge).

The JAX key stream cannot be replayed by a torch.Generator, so the parity
runs replace ``encode_images`` by the posterior mode on both sides (in the
test only). Latents agree within 1e-4 (fp32 on both sides, TF32 off), the
stats cache within 1e-5. The port's own posterior draw is checked by its
standardised residual.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from test_torch_common import one_thread, randomize  # noqa: F401
from test_torch_image_folder import _write
from vavae_tpu.data.latent_dataset import ImgLatentDataset as JaxLatents
from vavae_tpu.pipelines import extract_features as jext
from vavae_tpu.tokenizer import VA_VAE as JaxVAE
from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
from vavae_tpu_torch.pipelines import extract_features as text
from vavae_tpu_torch.tokenizer import VA_VAE
from vavae_tpu_torch.utils.safetensors_io import read_safetensors
from vavae_tpu_torch.utils.weights import vae_state_from_jax

pytestmark = pytest.mark.usefixtures("one_thread")

S = 32
TINY = {"embed_dim": 4, "ddconfig": dict(ch=32, ch_mult=[1, 1], num_res_blocks=1,
                                         attn_resolutions=[16], z_channels=4, double_z=True,
                                         out_ch=3)}


def tiny_config(root) -> str:
    path = os.path.join(root, "tiny_vae.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"ckpt_path": None, "model": {"params": TINY}}, f)
    return path


@pytest.fixture(scope="module")
def vaes(tmp_path_factory):
    """(JAX VA_VAE, port VA_VAE on the CPU, config path), same weights."""
    cfg = tiny_config(str(tmp_path_factory.mktemp("cfg")))
    jv = JaxVAE(cfg, img_size=S)
    jv.params = randomize(jv.params, 4)
    tv = VA_VAE(cfg, img_size=S, device="cpu")
    tv.model.load_state_dict(vae_state_from_jax(jv.params), strict=True)
    return jv, tv, cfg


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two classes, 10 PNGs: RGB 40×48 and RGBA 70×80 (one BOX halving)."""
    root = tmp_path_factory.mktemp("images")
    for c, (mode, h, w) in enumerate((("RGB", 40, 48), ("RGBA", 80, 70))):
        (root / f"class_{c}").mkdir()
        for i in range(5):
            _write(root / f"class_{c}" / f"{i:02d}.png", mode, h + i, w, seed=31 * c + i)
    return root


@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    """An ImageNet-layout tree of JPEGs: RGB 4:2:0, progressive, gray and
    CMYK, and one PNG under a ``.JPEG`` name."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    for c, syn in enumerate(("n01440764", "n01443537")):
        (root / syn).mkdir()
        for i in range(5):
            rs = np.random.default_rng(17 * c + i)
            rgb = rs.integers(0, 256, (36 + 4 * i, 44 + 6 * c, 3)).astype(np.uint8)
            rgb[:, ::2] //= 8  # stripes: real DCT content
            path = root / syn / f"{syn}_{i}.JPEG"
            if i == 4:
                Image.fromarray(rgb).save(path, "PNG")
            elif i == 3:
                Image.frombytes("CMYK", rgb.shape[1::-1],
                                np.dstack([rgb, rgb[..., :1]]).tobytes()).save(path, "JPEG")
            else:
                im = Image.fromarray(rgb[..., 0]) if i == 2 else Image.fromarray(rgb)
                im.save(path, "JPEG", quality=85, progressive=i == 1)
    return root


@pytest.fixture()
def posterior_mode(monkeypatch):
    """Both packages' ``encode_images`` replaced by the posterior mode."""
    monkeypatch.setattr(JaxVAE, "encode_images",
                        lambda self, images, rng=None: self.encode_moments(images).mean)
    monkeypatch.setattr(VA_VAE, "encode_images",
                        lambda self, images, generator=None: self.encode_moments(images).mode())


def _read_dir(path):
    out = {}
    for name in sorted(os.listdir(path)):
        out[name] = read_safetensors(os.path.join(path, name))[0]
    return out


def _assert_same_output(port_dir, jax_dir):
    got, want = _read_dir(port_dir), _read_dir(jax_dir)
    assert list(got) == list(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        for key, w in want[name].items():
            g = got[name][key]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, key)
            if key == "labels":
                np.testing.assert_array_equal(g, w)
            else:
                tol = 1e-5 if name == "latents_stats.safetensors" else 1e-4
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{name}:{key}")


def test_extract_matches_jax(vaes, folder, tmp_path, posterior_mode):
    """batch 3, shard 4: batches of 3, 3, 3, 1 flush shards of 6 and 4."""
    jv, tv, _ = vaes
    kw = dict(batch_size=3, image_size=S, shard_size=4, seed=0)
    jext.extract(str(folder), str(tmp_path / "jax"), jv, **kw)
    text.extract(str(folder), str(tmp_path / "port"), tv, **kw)
    _assert_same_output(tmp_path / "port", tmp_path / "jax")
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["latents_rank00_shard000.safetensors", "latents_rank00_shard001.safetensors",
                     "latents_stats.safetensors"]
    shard = read_safetensors(str(tmp_path / "port" / names[0]))[0]
    assert shard["latents"].shape == (6, 4, 16, 16) and shard["latents"].dtype == np.float32
    assert shard["labels"].dtype == np.int32
    np.testing.assert_array_equal(shard["labels"], [0, 0, 0, 0, 0, 1])


def test_extract_jpeg_tree_matches_jax(vaes, jpeg_folder, tmp_path, posterior_mode):
    """The same parity on an ImageNet-layout JPEG tree: the port decodes with
    its own decoder, the JAX package with PIL."""
    jv, tv, _ = vaes
    kw = dict(batch_size=4, image_size=S, shard_size=8, seed=0)
    jext.extract(str(jpeg_folder), str(tmp_path / "jax"), jv, **kw)
    text.extract(str(jpeg_folder), str(tmp_path / "port"), tv, **kw)
    _assert_same_output(tmp_path / "port", tmp_path / "jax")
    assert len(text.list_image_folder(str(jpeg_folder))) == 10


def test_extract_lists_refused_jpegs_before_encoding(vaes, tmp_path):
    """The JPEGs the port's decoder refuses (an arithmetic-coded lossless one
    and a 12-bit one, which PIL refuses too) are named in one error before
    anything is encoded; a block-smoothed progressive file is not."""
    from test_torch_jpeg import _encode, _image, _sof_as

    _, tv, _ = vaes
    prog = _encode(_image(40, 40, 9), quality=80, progressive=True)
    files = {"class_0/a.png": None, "class_0/b.jpg": _sof_as(_encode(_image(24, 24, 1)), 0xCB),
             "class_1/c.JPEG": _sof_as(_encode(_image(24, 24, 3)), 0xC1, 12),
             "class_1/d.jpg": _encode(_image(24, 24, 2)),
             "class_1/e.jpg": prog[:len(prog) * 2 // 3] + b"\xff\xd9"}
    root = tmp_path / "images"
    for name, data in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        if data is None:
            _write(root / name, "RGB", 40, 40, seed=3)
        else:
            (root / name).write_bytes(data)
    with pytest.raises(ValueError, match="2 of 5 images are JPEGs") as e:
        text.extract(str(root), str(tmp_path / "out"), tv, batch_size=2, image_size=S)
    assert f"{root / 'class_0/b.jpg'}: unsupported JPEG: SOF marker 0xCB" in str(e.value)
    assert f"{root / 'class_1/c.JPEG'}: unsupported JPEG: SOF marker 0xC1 with 12-bit" in str(e.value)
    assert "e.jpg" not in str(e.value)
    assert not list((tmp_path / "out").glob("*.safetensors"))


def test_extract_split_file_matches_jax(vaes, folder, tmp_path, posterior_mode):
    """``--split_file``: user ids as labels, paths relative to the data root."""
    import json

    jv, tv, _ = vaes
    split = {"train": {"User_3": [f"class_1/{i:02d}.png" for i in (4, 0, 2)],
                       "ID_1": ["class_0/01.png", "class_0/missing.png"]},
             "val": {"ID_2": ["class_0/00.png"]}}
    sf = tmp_path / "split.json"
    sf.write_text(json.dumps(split))
    kw = dict(batch_size=2, image_size=S, shard_size=10, split_file=str(sf), split="train")
    jext.extract(str(folder), str(tmp_path / "jax"), jv, **kw)
    text.extract(str(folder), str(tmp_path / "port"), tv, **kw)
    _assert_same_output(tmp_path / "port", tmp_path / "jax")
    labels = read_safetensors(str(tmp_path / "port" / "latents_rank00_shard000.safetensors"))[0]
    np.testing.assert_array_equal(labels["labels"], [0, 3, 3, 3])


@pytest.mark.parametrize("native", ["0", "1"])
def test_jax_dataset_reads_port_shards(vaes, folder, tmp_path, posterior_mode, monkeypatch, native):
    """The JAX ImgLatentDataset reads the port's shards and stats cache as
    they are, and gives the batches the port's reader gives: bit for bit
    through its Python reader, to rounding through its C++ one (which
    normalises in its own order)."""
    _, tv, _ = vaes
    monkeypatch.setenv("VAVAE_NATIVE_LOADER", native)
    text.extract(str(folder), str(tmp_path), tv, batch_size=4, image_size=S, shard_size=6)
    want = JaxLatents(str(tmp_path), latent_norm=True)
    got = ImgLatentDataset(str(tmp_path), latent_norm=True)
    assert len(want) == len(got) == 10
    for a, b in zip(want.latent_stats, got.latent_stats):
        np.testing.assert_array_equal(a, b)
    batches = list(zip(want.batches(4, seed=1, epochs=1), got.batches(4, seed=1, epochs=1)))
    assert len(batches) == 2
    for (xw, yw), (xg, yg) in batches:
        np.testing.assert_array_equal(yg, yw)
        if native == "0":
            np.testing.assert_array_equal(xg, xw)
        else:
            np.testing.assert_allclose(xg, xw, rtol=1e-6, atol=1e-6)


def test_port_posterior_draw_is_standard_normal(vaes, folder, tmp_path):
    """The port's own draw: (z − mean) / std over both passes of the 10
    images (20,480 values) has mean 0 and std 1 within 0.05, and the seed
    fixes it."""
    _, tv, _ = vaes
    text.extract(str(folder), str(tmp_path / "a"), tv, batch_size=4, image_size=S, seed=5)
    text.extract(str(folder), str(tmp_path / "b"), tv, batch_size=4, image_size=S, seed=5)
    shard = "latents_rank00_shard000.safetensors"
    got = read_safetensors(str(tmp_path / "a" / shard))[0]
    np.testing.assert_array_equal(got["latents"], read_safetensors(str(tmp_path / "b" / shard))[0]["latents"])
    items = text.list_image_folder(str(folder))
    (x, x_flip, _), = text.iter_batches(items, len(items), S)
    res = []
    for imgs, key in ((x, "latents"), (x_flip, "latents_flip")):
        post = tv.encode_moments(imgs)
        mean = post.mean.permute(0, 3, 1, 2).numpy()
        std = post.std.permute(0, 3, 1, 2).numpy()
        res.append((got[key] - mean) / std)
    res = np.concatenate(res).ravel()
    assert res.size >= 4096
    assert abs(res.mean()) < 0.05 and abs(res.std() - 1.0) < 0.05, (res.mean(), res.std())


def test_extract_main_on_the_cpu(vaes, folder, tmp_path):
    """The CLI: ``--device cpu`` and ``--dtype bf16`` write the shards and
    the stats cache."""
    _, _, cfg = vaes
    out = tmp_path / "latents"
    text.main(["--config", cfg, "--data_path", str(folder), "--output_path", str(out),
               "--batch_size", "4", "--image_size", str(S), "--dtype", "bf16", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["latents_rank00_shard000.safetensors",
                                       "latents_stats.safetensors"]
    shard = read_safetensors(str(out / "latents_rank00_shard000.safetensors"))[0]
    assert shard["latents"].dtype == np.float32 and np.isfinite(shard["latents"]).all()


def test_bf16_encode_deviation_below_posterior_std(vaes):
    """``dtype=torch.bfloat16``: fp32 moments whose mean deviates from the
    fp32 encode far below the posterior's own std (the JAX package's bounds,
    tests/test_vae.py: rel-L2 < 2%, deviation < 0.1× std)."""
    jv, tv, cfg = vaes
    t16 = VA_VAE(cfg, img_size=S, dtype=torch.bfloat16, device="cpu")
    t16.model.load_state_dict(vae_state_from_jax(jv.params), strict=True)
    assert next(t16.model.parameters()).dtype == torch.bfloat16
    x = np.random.default_rng(1).uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    p32, p16 = tv.encode_moments(x), t16.encode_moments(x)
    assert p16.mean.dtype == torch.float32 and p16.logvar.dtype == torch.float32
    m32 = p32.mean.numpy()
    dev = p16.mean.numpy() - m32
    rel = np.linalg.norm(dev) / np.linalg.norm(m32)
    ratio = np.sqrt(np.mean(dev**2)) / np.sqrt(np.mean(p32.std.numpy() ** 2))
    assert rel < 0.02, f"bf16 mean rel-L2 {rel:.3%}"
    assert ratio < 0.1, f"bf16 deviation {ratio:.3f}× the posterior's own std"
    assert t16.decode(p16.mode()).dtype == torch.bfloat16

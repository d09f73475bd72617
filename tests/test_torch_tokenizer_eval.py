"""Tokenizer evaluation of the port against the JAX package: PSNR and SSIM
(1e-5), LPIPS with the same random weights (1e-4; through the bridge and
through torch-layout weight files), ``evaluate_tokenizer`` end to end with
the posterior mode (metrics within 1e-4, the same PNGs) and the latent
visualisation functions (exactly: the same numpy code)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_common import max_rel, one_thread_test  # noqa: F401
from test_torch_extract import folder, vaes  # noqa: F401  (module fixtures)
from vavae_tpu.eval import latent_vis as jvis
from vavae_tpu.eval import metrics as jmetrics
from vavae_tpu.models import lpips as jlpips
from vavae_tpu.pipelines import evaluate_tokenizer as jeval
from vavae_tpu_torch.eval import latent_vis as tvis
from vavae_tpu_torch.eval import metrics as tmetrics
from vavae_tpu_torch.models import lpips as tlpips
from vavae_tpu_torch.pipelines import evaluate_tokenizer as teval
from vavae_tpu_torch.utils.weights import lpips_state_from_jax

S = 32


def _pair(seed: int, shape=(3, 40, 44, 3)):
    rs = np.random.default_rng(seed)
    a = rs.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rs.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_psnr_matches_jax(data_range):
    a, b = _pair(0)
    a, b = a * data_range, b * data_range
    want = np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), data_range=data_range))
    got = tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b), data_range=data_range).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 40, 44, 3), (2, 11, 16, 1)])
def test_ssim_matches_jax(shape):
    a, b = _pair(1, shape)
    want = np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), data_range=1.0))
    got = tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b), data_range=1.0).numpy()
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ones = tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(ones, 1.0, atol=1e-5)


def _jax_lpips_params(seed: int) -> dict:
    """Random JAX LPIPS params drawn with numpy: He-normal convolutions with
    non-zero biases, non-negative lin heads."""
    rs = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlpips.LPIPS().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3))))["params"]

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return (0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        w = rs.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)
        return np.abs(w).astype(np.float32) if path[0].key.startswith("lin") else w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def lpips_pair():
    params = _jax_lpips_params(3)
    model = tlpips.LPIPS()
    model.load_state_dict(lpips_state_from_jax(params), strict=True)
    return params, model.eval()


def _images(seed: int, n: int = 3):
    rs = np.random.default_rng(seed)
    a = rs.uniform(-1, 1, (n, S, S, 3)).astype(np.float32)
    return a, np.clip(a + 0.3 * rs.standard_normal(a.shape), -1, 1).astype(np.float32)


def test_lpips_matches_jax(lpips_pair):
    params, model = lpips_pair
    a, b = _images(4)
    want = np.asarray(jlpips.LPIPS().apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = model(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert got.shape == (3,) and (want > 0).all()
    assert max_rel(got, want) < 1e-4
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_lpips_torch_files_match_jax(lpips_pair, tmp_path):
    """The genuine layout pair (taming ``vgg.pth``: lin heads only, plus a
    torchvision ``vgg16`` state dict, ``features.N``) and a full-module
    dump, each loaded by both packages."""
    _, model = lpips_pair
    sd = model.state_dict()
    lins = {k: v for k, v in sd.items() if k.startswith("lin")}
    vgg = {f"features.{k.split('.')[2]}.{k.split('.')[3]}": v
           for k, v in sd.items() if k.startswith("net.")}
    vgg["classifier.0.weight"] = torch.zeros(2, 2)  # what the rest of vgg16 carries
    paths = {name: str(tmp_path / f"{name}.pth") for name in ("vgg", "vgg16", "full")}
    torch.save(lins, paths["vgg"])
    torch.save(vgg, paths["vgg16"])
    torch.save(sd, paths["full"])
    a, b = _images(5, n=2)
    for weights, vgg16 in ((paths["vgg"], paths["vgg16"]), (paths["full"], None)):
        jm, jvars = jlpips.load_lpips(weights, vgg16)
        want = np.asarray(jm.apply(jvars, jnp.asarray(a), jnp.asarray(b)))
        port = tlpips.load_lpips(weights, vgg16, device="cpu")
        with torch.no_grad():
            got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert max_rel(got, want) < 1e-4
    with pytest.raises(KeyError, match="VAVAE_VGG16_WEIGHTS"):
        tlpips.load_lpips(paths["vgg"], None, device="cpu")


def test_load_lpips_without_weights_names_both_variables(monkeypatch, tmp_path):
    monkeypatch.delenv("VAVAE_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("VAVAE_VGG16_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="VAVAE_LPIPS_WEIGHTS.*VAVAE_VGG16_WEIGHTS"):
        tlpips.load_lpips(str(tmp_path / "absent.pth"), device="cpu")


@pytest.fixture()
def no_fid_weights(monkeypatch):
    monkeypatch.delenv("VAVAE_FID_WEIGHTS", raising=False)
    monkeypatch.delenv("VAVAE_FID_ALLOW_RANDOM", raising=False)


def _pngs(path):
    names = sorted(os.listdir(path))
    return names, [np.asarray(Image.open(os.path.join(path, n))) for n in names]


def test_evaluate_tokenizer_matches_jax(vaes, folder, lpips_pair, tmp_path, no_fid_weights):  # noqa: F811
    """Posterior mode on both sides, LPIPS from one full-module dump, no
    Inception weights (rFID skipped by both). The reference PNGs are equal;
    a decoded pixel may sit one level apart where fp32 rounding meets the
    uint8 truncation."""
    jv, tv, _ = vaes
    _, model = lpips_pair
    weights = str(tmp_path / "lpips.pth")
    torch.save(model.state_dict(), weights)
    kw = dict(max_images=9, batch_size=4, image_size=S, lpips_weights=weights,
              sample_posterior=False)
    want = jeval.evaluate_tokenizer(jv, str(folder), output_path=str(tmp_path / "jax"), **kw)
    got = teval.evaluate_tokenizer(tv, str(folder), output_path=str(tmp_path / "port"), **kw)
    assert sorted(got) == sorted(want) == ["lpips", "num_images", "psnr", "ssim"]
    assert got["num_images"] == want["num_images"] == 9
    for k in ("psnr", "ssim", "lpips"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    for sub in ("ref", "dec"):
        names_w, imgs_w = _pngs(tmp_path / "jax" / sub)
        names_g, imgs_g = _pngs(tmp_path / "port" / sub)
        assert names_g == names_w and names_g[0] == "00_000000.png" and len(names_g) == 9
        diff = np.abs(np.stack(imgs_g).astype(int) - np.stack(imgs_w).astype(int))
        if sub == "ref":
            assert diff.max() == 0
    # the decoded PNGs differ only where a value within the metrics' 1e-4 of
    # the JAX one lies that close to a uint8 truncation step
    assert diff.max() <= 1
    items = teval.list_image_folder(str(folder))[:9]
    levels = []
    for x, _, _ in teval.iter_batches(items, 4, S):
        dec = tv.decode(tv.encode_moments(x).mode()).numpy()
        levels.append(np.clip((dec + 1.0) / 2.0, 0, 1) * 255)
    frac = np.concatenate(levels) % 1.0
    near_step = np.minimum(frac, 1.0 - frac) < 1e-4 * 255
    assert near_step[diff > 0].all()


def test_evaluate_tokenizer_rfid_wiring(vaes, folder, tmp_path, monkeypatch):  # noqa: F811
    """rFID is taken between the ref and dec folders on the VAE's device;
    it is skipped when the Inception weights are missing, and so is LPIPS."""
    from vavae_tpu_torch.eval import fid

    _, tv, _ = vaes
    calls = []
    monkeypatch.setattr(fid, "fid_given_paths", lambda *a, **k: calls.append((a, k)) or 1.5)
    monkeypatch.delenv("VAVAE_LPIPS_WEIGHTS", raising=False)
    out = str(tmp_path / "out")
    got = teval.evaluate_tokenizer(tv, str(folder), output_path=out, max_images=2, image_size=S)
    assert got["rfid"] == 1.5 and "lpips" not in got
    (args, kw), = calls
    assert args == (os.path.join(out, "ref"), os.path.join(out, "dec"))
    assert kw["device"] == tv.device

    def missing(*a, **k):
        raise FileNotFoundError("no Inception weights")

    monkeypatch.setattr(fid, "fid_given_paths", missing)
    got = teval.evaluate_tokenizer(tv, str(folder), output_path=out, max_images=2, image_size=S)
    assert "rfid" not in got and got["num_images"] == 2


def test_evaluate_tokenizer_main_on_the_cpu(vaes, folder, tmp_path, no_fid_weights, monkeypatch):  # noqa: F811
    import json

    _, _, cfg = vaes
    monkeypatch.delenv("VAVAE_LPIPS_WEIGHTS", raising=False)
    out = tmp_path / "m.json"
    teval.main(["--config", cfg, "--data_path", str(folder), "--max_images", "3",
                "--image_size", str(S), "--metrics_json", str(out), "--device", "cpu"])
    res = json.loads(out.read_text())
    assert res["num_images"] == 3 and np.isfinite(res["psnr"]) and -1 <= res["ssim"] <= 1


@pytest.mark.usefixtures("one_thread_test")  # t-SNE's OpenMP threads
def test_latent_vis_matches_jax(tmp_path):
    lat = np.random.default_rng(6).standard_normal((3, 8, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(tvis.sample_latent_pixels(lat, 100, seed=2),
                                  jvis.sample_latent_pixels(lat, 100, seed=2))
    emb2d = np.random.default_rng(7).standard_normal((500, 2))
    assert tvis.calculate_uniformity_metrics(emb2d, 20) == jvis.calculate_uniformity_metrics(emb2d, 20)
    emb, metrics = tvis.plot_tsne_visualization(lat, str(tmp_path / "t.png"), num_samples=120, seed=1)
    want_emb, want_metrics = jvis.plot_tsne_visualization(lat, None, num_samples=120, seed=1)
    np.testing.assert_array_equal(emb, want_emb)
    assert metrics == want_metrics and (tmp_path / "t.png").stat().st_size > 0

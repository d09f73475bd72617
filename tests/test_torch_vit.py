"""The frozen foundation ViTs of the port against the JAX package, on the CPU
in fp32: ``dinov2-tiny`` and ``mae-tiny`` features at 32 and 256 px (the
pos-embed resample included; 1e-4 relative), the two resizes
``F.interpolate`` takes where the JAX package keeps
``vavae_tpu/utils/interp.py:torch_resize_2d`` (1e-6; the fp32 bilinear
resize 1e-4, see its test), a timm-layout state dict in both packages, and
``FoundationModel.load``'s file and errors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_common import max_rel, one_thread, randomize  # noqa: F401
from vavae_tpu.models import vit as jvit
from vavae_tpu.utils.interp import torch_resize_2d
from vavae_tpu_torch.models import vit as tvit
from vavae_tpu_torch.utils.weights import vit_state_from_jax

pytestmark = pytest.mark.usefixtures("one_thread")

KINDS = ("dinov2-tiny", "mae-tiny")


@pytest.fixture(scope="module")
def pairs():
    """Each tiny kind in both packages with the same random weights (drawn
    by ``randomize`` over the JAX init's shapes; no init is run)."""
    out = {}
    for i, kind in enumerate(KINDS):
        jm = jvit.FoundationModel(kind=kind)
        jm.params = randomize(jax.eval_shape(lambda: jm.model.init(
            {"params": jax.random.PRNGKey(i)}, jnp.zeros((1, 224, 224, 3)))["params"]), 10 + i)
        tm = tvit.FoundationModel(kind, device="cpu")
        tm.model.load_state_dict(vit_state_from_jax(jm.params), strict=True)
        out[kind] = (jm, tm)
    return out


def _images(size: int, seed: int = 0, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [32, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_features_match_jax(pairs, kind, size):
    """DiNOv2 resizes to 224 (16×16 tokens, the 37-grid pos-embed
    resampled); MAE keeps the input (32 px: 2×2 from its 14-grid; 256 px:
    16×16)."""
    jm, tm = pairs[kind]
    x = _images(size)
    want = np.asarray(jm.feature_fn()(jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    grid = 16 if kind.startswith("dinov2") else size // 16
    assert got.shape == want.shape == (2, grid, grid, 64)
    assert not got.requires_grad
    assert max_rel(got.numpy(), want) <= 1e-4, max_rel(got.numpy(), want)


@pytest.mark.parametrize("size", [32, 256, 224])
def test_bilinear_resize_is_jax_interp(size):
    """DINOv2's input resize: F.interpolate bilinear, align_corners=False,
    no antialias, against the JAX package's weight matrices (float64
    coordinates): within 1e-6 when F.interpolate runs in float64. The port
    runs it in fp32, as the reference does, where torch's kernel rounds the
    source coordinate to fp32 (an ulp of 1.5e-5 at x = 255): 7.0e-6 (32 px)
    and 5.2e-5 (256 px) max-abs from the JAX matrices
    (scripts/vae_train_spread.py), held to 1e-4."""
    x = _images(size, 1)
    want = np.asarray(torch_resize_2d(jnp.asarray(x), (224, 224), "bilinear", antialias=False))
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-4)):
        got = F.interpolate(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2), size=(224, 224),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("grids", [(37, 16), (14, 2), (14, 16)])
def test_pos_embed_resample_is_jax_interp(grids):
    """timm's pos-embed resample (bicubic, antialias) at the grids the
    kinds meet, against the JAX package's weight matrices."""
    g, n = grids
    pos = np.random.default_rng(2).normal(0, 0.02, (1, g * g, 64)).astype(np.float32)
    want = np.asarray(torch_resize_2d(jnp.asarray(pos.reshape(1, g, g, 64)), (n, n), "bicubic",
                                      antialias=True)).reshape(1, n * n, 64)
    got = tvit.resample_pos_embed(torch.from_numpy(pos), (n, n)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _timm_state_dict(seed: int, depth: int = 2, dim: int = 64, patch: int = 14,
                     grid: int = 37, layerscale: bool = True) -> dict:
    """A random state dict in timm's layout (with a head the ViT lacks)."""
    rs = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return (scale * rs.standard_normal(shape)).astype(np.float32)

    sd = {"cls_token": w(1, 1, dim), "pos_embed": w(1, 1 + grid * grid, dim),
          "patch_embed.proj.weight": w(dim, 3, patch, patch), "patch_embed.proj.bias": w(dim),
          "norm.weight": 1 + w(dim), "norm.bias": w(dim), "head.weight": w(10, dim)}
    for i in range(depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + w(dim), f"{p}.norm1.bias": w(dim),
                   f"{p}.norm2.weight": 1 + w(dim), f"{p}.norm2.bias": w(dim),
                   f"{p}.attn.qkv.weight": w(3 * dim, dim), f"{p}.attn.qkv.bias": w(3 * dim),
                   f"{p}.attn.proj.weight": w(dim, dim), f"{p}.attn.proj.bias": w(dim),
                   f"{p}.mlp.fc1.weight": w(4 * dim, dim), f"{p}.mlp.fc1.bias": w(4 * dim),
                   f"{p}.mlp.fc2.weight": w(dim, 4 * dim), f"{p}.mlp.fc2.bias": w(dim)})
        if layerscale:
            sd[f"{p}.ls1.gamma"] = 1 + w(dim)
            sd[f"{p}.ls2.gamma"] = 1 + w(dim)
    return sd


def test_timm_state_dict_loads_in_both(tmp_path, monkeypatch):
    """A timm-layout file (under ``model``, with a head) through
    ``FoundationModel.load`` (the DINOv2 kind at the tiny width, its
    variable naming the file) gives the JAX package's features from
    ``vit_params_from_timm`` of the same dict."""
    sd = _timm_state_dict(3)
    path = tmp_path / "dinov2.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    monkeypatch.setenv("VAVAE_DINOV2_WEIGHTS", str(path))
    tiny = tvit._kind_config("dinov2-tiny")
    monkeypatch.setattr(tvit, "_kind_config", lambda kind: tiny)
    tm = tvit.FoundationModel("dinov2", device="cpu").load()
    jm = jvit.FoundationModel(kind="dinov2-tiny")
    jm.params = jvit.vit_params_from_timm({k: v for k, v in sd.items() if k != "head.weight"})
    x = _images(256, 4)
    want = np.asarray(jm.feature_fn()(jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).numpy()
    assert max_rel(got, want) <= 1e-4, max_rel(got, want)


def test_load_errors(monkeypatch):
    with pytest.raises(FileNotFoundError, match="smoke testbed"):
        tvit.FoundationModel("mae-tiny", device="cpu").load("/nonexistent")
    monkeypatch.delenv("VAVAE_MAE_WEIGHTS", raising=False)
    tiny = tvit._kind_config("mae-tiny")
    monkeypatch.setattr(tvit, "_kind_config", lambda kind: tiny)
    with pytest.raises(FileNotFoundError, match="VAVAE_MAE_WEIGHTS"):
        tvit.FoundationModel("mae", device="cpu").load()
    monkeypatch.undo()
    with pytest.raises(ValueError):
        tvit.FoundationModel("dinov2-nano", device="cpu")
    with pytest.raises(ValueError):
        tvit.FoundationModel("clip", device="cpu")


def test_full_kinds_are_vit_l():
    """The shipped kinds are ViT-L (width 1024, depth 24, 16 heads): DINOv2
    patch 14 with LayerScale on a 37 grid, MAE patch 16 on a 14 grid."""
    d, m = tvit._kind_config("dinov2"), tvit._kind_config("mae")
    assert d == dict(patch_size=14, use_layerscale=True, pretrain_grid=37)
    assert m == dict(patch_size=16, use_layerscale=False, pretrain_grid=14)
    with torch.device("meta"):
        vit = tvit.TimmViT(**d)
    assert (vit.embed_dim, len(vit.blocks), vit.blocks[0].attn.num_heads) == (1024, 24, 16)


def test_init_random_is_seeded_and_the_jax_rules():
    a = tvit.FoundationModel("dinov2-tiny", device="cpu").init_random(0)
    b = tvit.FoundationModel("dinov2-tiny", device="cpu").init_random(0)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert torch.all(a.model.blocks[0].ls1.gamma == 1e-5)
    assert torch.all(a.model.cls_token == 0) and abs(a.model.pos_embed.std().item() - 0.02) < 2e-3
    assert all(not p.requires_grad for p in a.parameters())

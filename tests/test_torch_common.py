"""Shared helpers for the PyTorch port's parity tests, and tests of the
port's small utilities (config, safetensors reader, PNG writer, package
boundary).

Parity tests hand the same numpy inputs and weights to the JAX package and
to ``vavae_tpu_torch``. TF32 is off on the torch side and the JAX side runs
at ``highest`` matmul precision (tests/conftest.py), so fp32 results agree
to rounding.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def _single_threaded():
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_thread():
    """torch, BLAS (numpy, scipy) and OpenMP (scikit-learn) on one thread
    for the importing module's tests: their tensors are small, and the
    suite's workers share the host's cores, where threads that spin-wait for
    one another multiply a test's time (a 2048² ``sqrtm`` or a t-SNE takes
    several times as long as alone). Import it and name it in ``pytestmark``
    (``usefixtures``)."""
    with _single_threaded():
        yield


@pytest.fixture
def one_thread_test():
    """``one_thread`` for one test."""
    with _single_threaded():
        yield


def randomize(tree, seed: int):
    """Re-draw every leaf of a flax param tree with numpy: norm weights and
    scales around 1, everything else N(0, 0.05²), so no layer is zero (the
    JAX init zeroes adaLN and the final layer)."""
    rs = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        shape = np.shape(leaf)
        if name in ("weight", "scale"):
            return (1.0 + 0.1 * rs.standard_normal(shape)).astype(np.float32)
        return (0.05 * rs.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def tiny_dit_pair(seed: int = 0, **kw):
    """A tiny JAX LightningDiT with random non-zero params, and the port's
    DiT with the same weights through the bridge. Returns
    (jax_model, jax_params, torch_model)."""
    from vavae_tpu.models.dit import LightningDiT as JaxDiT
    from vavae_tpu_torch.models.dit import LightningDiT
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    cfg = dict(input_size=8, patch_size=1, in_channels=4, hidden_size=144, depth=2,
               num_heads=2, num_classes=10, use_swiglu=True, use_rmsnorm=True,
               use_rope=True)
    cfg.update(kw)
    jm = JaxDiT(**cfg)
    s = cfg["input_size"]
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, s, s, cfg["in_channels"])),
                     jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    params = randomize(params, seed)
    tm = LightningDiT(**cfg)
    tm.load_state_dict(dit_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


TINY_DDCONFIG = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                     z_channels=4, double_z=True, out_ch=3)


def tiny_vae_config(tmp_path) -> str:
    """A VA-VAE yaml for a 16-px, f2d4 VAE whose attention runs at 8x8."""
    import yaml

    path = tmp_path / "tiny_vae.yaml"
    path.write_text(yaml.safe_dump(
        {"ckpt_path": None, "model": {"params": {"embed_dim": 4, "ddconfig": TINY_DDCONFIG}}}
    ))
    return str(path)


def tiny_vae_pair(tmp_path, seed: int = 0, img_size: int = 16):
    """JAX VA_VAE and the port's VA_VAE (CPU) sharing random weights. At an
    ``img_size`` other than 16 the 8x8 attention level is gone and only the
    mid-block attention runs, as in the f16d32 VAE at 1024²."""
    from vavae_tpu.tokenizer import VA_VAE as JaxVAE
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.utils.weights import vae_state_from_jax

    cfg = tiny_vae_config(tmp_path)
    jv = JaxVAE(cfg, img_size=img_size)
    jv.params = randomize(jv.params, seed)
    tv = VA_VAE(cfg, img_size=img_size, device="cpu")
    tv.model.load_state_dict(vae_state_from_jax(jv.params), strict=True)
    return jv, tv


# -- tests of the port's utilities ---------------------------------------------


def test_safetensors_reader_matches_package(tmp_path):
    """The numpy reader returns what the safetensors package wrote, and
    load_tree undoes the JAX train-state encoding (``|`` keys, bf16 bits)."""
    from safetensors.numpy import save_file
    import json

    from vavae_tpu_torch.utils.safetensors_io import load_tree, read_safetensors

    rs = np.random.default_rng(0)
    a = rs.standard_normal((3, 5)).astype(np.float32)
    b = rs.integers(0, 9, (4,)).astype(np.int64)
    bf = np.array([1.0, -2.5, 3.0], np.float32)
    bits = (bf.view(np.uint32) >> 16).astype(np.uint16)
    path = tmp_path / "s.safetensors"
    meta = {"tree": json.dumps({"dtypes": {"params|x|b16": "bfloat16"}})}
    save_file({"params|x|a": a, "params|y": b, "params|x|b16": bits}, str(path), metadata=meta)
    tensors, got_meta = read_safetensors(str(path))
    np.testing.assert_array_equal(tensors["params|x|a"], a)
    np.testing.assert_array_equal(tensors["params|y"], b)
    assert got_meta == meta
    tree = load_tree(str(path))
    np.testing.assert_array_equal(tree["params"]["x"]["b16"], bf)
    np.testing.assert_array_equal(tree["params"]["x"]["a"], a)


def test_png_writer_roundtrip(tmp_path):
    """The zlib/struct PNG writer produces a file PIL reads back exactly."""
    from PIL import Image

    from vavae_tpu_torch.utils.png import write_pngs

    img = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    paths = [str(tmp_path / f"{i}.png") for i in range(2)]
    write_pngs(img, paths)
    for im, p in zip(img, paths):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), im)
    assert zlib.crc32(Path(paths[0]).read_bytes()[:8]) == zlib.crc32(b"\x89PNG\r\n\x1a\n")


def test_config_matches_jax_config(tmp_path):
    from vavae_tpu.utils.config import load_config as jax_load
    from vavae_tpu_torch.utils.config import load_config

    path = str(REPO / "vavae_tpu/configs/lightningdit_xl_vavae_f16d32.yaml")
    over = ["sample.num_sampling_steps=10", "data.extra.k=[1,2]"]
    assert load_config(path, overrides=over) == jax_load(path, overrides=over)
    cfg = load_config(path)
    assert cfg.sample.cfg_scale == 10.0 and cfg.model.model_type == "LightningDiT-XL/1"


def test_config_overrides_parse_as_yaml(tmp_path):
    """Override values parse as YAML whatever else is installed, as in the
    JAX package, also over a ``.json`` base (which loads without PyYAML)."""
    from vavae_tpu.utils.config import load_config as jax_load
    from vavae_tpu_torch.utils.config import load_config

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"model": {"base_learning_rate": 1e-4, "params": {"ch": 128}}}))
    over = ["model.base_learning_rate=1e-4", "train.flag=yes", "data.extra.k=[1,2]"]
    got = load_config(str(path), overrides=over)
    assert got == jax_load(str(path), overrides=over)
    assert got.model.base_learning_rate == "1e-4" and got.train.flag is True
    assert got.model.params.ch == 128


APP_LAYER = ("ops.quant", "apps.quantize_dit", "apps.select_users", "apps.analyze_metrics",
             "apps.generation_evaluator", "apps.iterative_finetune", "utils.kmeans",
             "apps.domain_adaptation")


def _port_sources():
    return sorted((REPO / "vavae_tpu_torch").rglob("*.py"))


def test_port_imports_nothing_of_jax():
    """No source of the port, and not ``chip_smoke.py``, names jax, flax,
    msgpack or the JAX package, and the whole package imports with those
    made unimportable, and with PIL, sklearn, matplotlib and PyYAML too (the
    card's machine lacks them: the port imports the first three only inside
    the functions that need them, and never PyYAML)."""
    bad = ("import jax", "from jax", "import flax", "from flax", "import msgpack",
           "from msgpack", "vavae_tpu.", "import vavae_tpu\n")
    for path in _port_sources() + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        for word in bad:
            assert word not in text, f"{path.relative_to(REPO)} contains {word!r}"
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_sources()
    ]
    # the VA-VAE training and micro-Doppler app modules are among those imported
    assert {f"vavae_tpu_torch.{m}" for m in (
        "models.discriminator", "models.vit", "train.vae_loss", "train.vae_trainer",
        "utils.image_grid", "pipelines.train_vavae", "utils.msgpack_io", "train.lora",
        "train.lora_trainer", "models.resnet", "apps.lora_finetune", "apps.regularization",
        "apps.train_classifier", "apps.classifier_eval", "apps.generate_and_filter")
        + APP_LAYER} <= set(mods)
    # the rest of the application layer runs on the card's machine whole: no
    # sklearn and no PIL, not even imported lazily
    for m in APP_LAYER:
        text = (REPO / "vavae_tpu_torch" / (m.replace(".", "/") + ".py")).read_text()
        for word in ("import sklearn", "from sklearn", "import PIL", "from PIL"):
            assert word not in text, f"{m} contains {word!r}"
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vavae_tpu', 'PIL',\n"
        "                                  'sklearn', 'matplotlib', 'msgpack', 'yaml'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr



def test_port_needs_no_pyyaml_and_no_jax_configs():
    """No source of the port, and not ``chip_smoke.py``, imports PyYAML (the
    port reads and writes YAML with ``utils/yaml_io.py``), and no file of the
    port's package names a path under the JAX package's configs: the port
    ships its own (``vavae_tpu_torch/configs``)."""
    imports_yaml = re.compile(r"^\s*(import|from)\s+yaml\b", re.M)
    for path in _port_sources() + [REPO / "chip_smoke.py"]:
        assert not imports_yaml.search(path.read_text()), f"{path.relative_to(REPO)} imports yaml"
    files = [p for p in (REPO / "vavae_tpu_torch").rglob("*")
             if p.is_file() and p.suffix in (".py", ".yaml", ".cu", ".cuh", ".cpp", ".md")]
    assert len([p for p in files if p.suffix == ".yaml"]) == 10
    for path in files + [REPO / "chip_smoke.py"]:
        assert "vavae_tpu/configs" not in path.read_text(), f"{path.relative_to(REPO)}"

def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """Without a GPU the entry points raise unless device='cpu' is passed."""
    from vavae_tpu_torch.pipelines.sample import build_sample_fn
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VA_VAE(embed_dim=4)
    cfg = Config({"sample": {}, "data": {"num_classes": 2, "image_size": 16},
                  "transport": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sample_fn(cfg, model=None)

    # the tokenizer side: the model loaders (before they look for weights)
    # and both pipelines' CLIs
    from vavae_tpu_torch.eval.inception import load_inception
    from vavae_tpu_torch.models.lpips import load_lpips
    from vavae_tpu_torch.pipelines import evaluate_tokenizer, extract_features

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_inception(allow_random=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_lpips()
    images = str(tmp_path / "images")
    (tmp_path / "images" / "a").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features.main(["--data_path", images, "--output_path", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_tokenizer.main(["--data_path", images])
    assert not (tmp_path / "out").exists()

"""The whole-workflow tools of the port on the CPU: ``apps/e2e_onchip.py``
against ``scripts/e2e_onchip.py`` (its dataset pixel for pixel, its gauge
against the JAX package's FID functions) and end to end at the smoke size;
``apps/golden_numbers.py`` (``--check`` on synthetic artifacts in the real
key layouts, the rFID leg rehearsed at 32 px); the learning check's code at
a tiny size; and the refusal of both commands to run on the CPU unless
asked."""
import glob
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchvision_stub
from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.apps import e2e_onchip, golden_numbers, learning_check
from vavae_tpu_torch.utils import yaml_io
from vavae_tpu_torch.utils.png import write_pngs

pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pil_pixels(root) -> dict:
    from PIL import Image

    return {os.path.relpath(p, root): np.asarray(Image.open(p).convert("RGB"))
            for p in sorted(glob.glob(os.path.join(root, "**", "*.png"), recursive=True))}


# -- e2e_onchip -------------------------------------------------------------------------


def test_dataset_equals_jax_script(tmp_path):
    """The smoke-size dataset, read back through PIL, pixel-equal to the JAX
    script's (PIL-written) at every file."""
    sz = e2e_onchip.sizes(smoke=True)
    args = (sz["n_classes"], sz["train_per_class"], sz["val_per_class"], sz["image_size"])
    _jax_script("e2e_onchip").make_dataset(str(tmp_path / "jax"), *args)
    e2e_onchip.make_dataset(str(tmp_path / "port"), *args)
    want, got = _pil_pixels(tmp_path / "jax"), _pil_pixels(tmp_path / "port")
    assert len(want) == 2 * (8 + 4) and list(got) == list(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def test_gauge_matches_jax_fid():
    """The gauge's statistics and distances against ``vavae_tpu.eval.fid``
    on the JAX script's features of the same seeded arrays (1e-6 relative)."""
    from vavae_tpu.eval.fid import activation_statistics, frechet_distance

    rs = np.random.default_rng(5)
    real = rs.uniform(-1, 1, (128, 32, 32, 3)).astype(np.float32)
    fake = np.clip(real[::-1] + 0.3 * rs.standard_normal(real.shape), -1, 1).astype(np.float32)
    # the JAX script's projection (scripts/e2e_onchip.py:374-382)
    P, D = 4, (32 // 4) * (32 // 4) * 3
    proj = np.random.default_rng(43).normal(size=(D, 192)).astype(np.float32) / np.sqrt(D)

    def feats(x):
        B, H, W, C = x.shape
        return x.reshape(B, H // P, P, W // P, P, C).mean((2, 4)).reshape(B, -1) @ proj

    assert np.array_equal(e2e_onchip.gauge_features(real), feats(real))
    mu, sigma = activation_statistics(feats(real))
    from vavae_tpu_torch.eval.fid import activation_statistics as port_stats

    pmu, psigma = port_stats(e2e_onchip.gauge_features(real))
    assert np.abs(pmu - mu).max() <= 1e-6 * np.abs(mu).max()
    assert np.abs(psigma - sigma).max() <= 1e-6 * np.abs(sigma).max()

    def jax_distance(a, b):
        return float(frechet_distance(*activation_statistics(feats(a)),
                                      *activation_statistics(feats(b))))

    got = e2e_onchip.gauge_fid(real, fake)
    want = {"gauge_fid_vs_real": jax_distance(real, fake),
            "real_split_floor": jax_distance(real[0::2], real[1::2]),
            "gauge_fid_matched_n": jax_distance(fake[0::2], real[1::2])}
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-6 * abs(value), (key, got[key], value)
    assert got["n"] == 128 and got["n_matched"] == 64
    assert got["matched_over_floor"] == got["gauge_fid_matched_n"] / got["real_split_floor"]


def test_e2e_smoke_on_the_cpu(tmp_path):
    """``e2e_onchip --smoke --device cpu`` end to end: every stage in the
    record with finite metrics, the commit and the sources' hash; a rerun on
    the kept workdir runs no CLI stage again."""
    work, out = tmp_path / "work", tmp_path / "record.json"
    argv = ["--smoke", "--device", "cpu", "--workdir", str(work), "--out", str(out),
            "--sha", "0" * 40]  # git's HEAD wins where the checkout has one
    assert e2e_onchip.main(argv) == 0
    doc = json.loads(out.read_text())
    assert list(doc["stages"]) == list(e2e_onchip.STAGES)
    assert doc["sha"] and doc["source_sha256"] == e2e_onchip.source_hash()
    assert doc["device"] == {"smi": None, "name": "cpu"} and doc["smoke"] is True
    stages = doc["stages"]
    for name, stage in stages.items():
        assert np.isfinite(stage["wall_s"]) and stage["wall_s"] >= 0, name
    for name in ("train_vavae", "extract_features", "train_dit", "sample",
                 "evaluate_tokenizer"):
        assert stages[name]["cmd"].split()[1:4] == ["-m", "vavae_tpu_torch", name]
        assert "--device cpu" in stages[name]["cmd"]
    numbers = [stages["train_vavae"]["metrics"]["val"],
               stages["train_dit"]["metrics"]["final_train_loss"],
               stages["evaluate_tokenizer"]["metrics"]["psnr"],
               stages["evaluate_tokenizer"]["metrics"]["ssim"]]
    numbers += [v for k, v in stages["gauge_fid"]["metrics"].items() if k != "note"]
    assert all(np.isfinite(numbers)), stages
    assert stages["sample"]["metrics"]["images"] == 4
    assert stages["train_vavae"]["metrics"]["step"] == 4  # 16 images at batch 4, 1 epoch
    golden_numbers.check_e2e_record(str(out))
    # the generator export loads as the VAE the later stages used
    from vavae_tpu_torch.tokenizer import VA_VAE

    VA_VAE(str(work / "vae.yaml"), ckpt_path=str(work / "vae_trained_params.safetensors"),
           img_size=32, device="cpu")

    assert e2e_onchip.main(argv) == 0
    again = json.loads(out.read_text())["stages"]
    for name in ("train_vavae", "extract_features", "train_dit", "sample", "evaluate_tokenizer"):
        assert again[name]["reused"] and again[name]["wall_s"] == stages[name]["wall_s"], name
    assert again["gauge_fid"]["metrics"] == stages["gauge_fid"]["metrics"]


def test_commands_refuse_the_cpu_unless_asked(monkeypatch, tmp_path, golden_env):
    """Without a GPU both commands raise unless ``--device cpu`` is passed,
    before they write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e_onchip.main(["--smoke", "--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_numbers.main(["--config", golden_env["dit_config"], "--tokenizer_config",
                             golden_env["tokenizer_config"], "--workdir", str(tmp_path / "g"),
                             "--skip_extraction", "--skip_sampling"])
    assert not (tmp_path / "g").exists()


def test_new_modules_need_no_jax_pil_or_yaml(tmp_path):
    """With jax, the JAX package, PyYAML and PIL unimportable, the new
    modules import, the dataset is made and read back, and ``--check``
    without artifacts reports them missing."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vavae_tpu', 'PIL', 'yaml'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import os\n"
        "from vavae_tpu_torch.apps import e2e_onchip, golden_numbers, learning_check\n"
        "import vavae_tpu_torch.__main__\n"
        f"root = {str(tmp_path)!r}\n"
        "e2e_onchip.make_dataset(root, 2, 2, 1, 16)\n"
        "x = e2e_onchip.load_folder(os.path.join(root, 'train'), 4, 16)\n"
        "assert x.shape == (4, 16, 16, 3) and -1 <= x.min() and x.max() <= 1\n"
        "for var in golden_numbers.REQUIRED:\n"
        "    os.environ.pop(var, None)\n"
        "assert golden_numbers.check() is False\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(REPO),
                                           "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.splitlines()[-1] == "ok", out.stderr
    assert all(f"MISSING {var}" in out.stdout for var in golden_numbers.REQUIRED)


# -- golden_numbers -----------------------------------------------------------------------

TINY_TOKENIZER = {"model": {"params": {"embed_dim": 4, "ddconfig": {
    "z_channels": 4, "resolution": 32, "ch": 128, "ch_mult": [1, 2], "num_res_blocks": 2,
    "attn_resolutions": []}}}}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Synthetic artifacts in the released files' key layouts: the VA-VAE
    and DiT through the port's exporters (``utils/torch_export.py``), the
    FID Inception and VGG16 from ``tests/torchvision_stub.py``, LPIPS as the
    genuine ``vgg.pth`` (lin heads only) and as a full-module dump; a tiny
    ImageNet-val tree and a reference npz. Returns the environment and the
    configs."""
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.models.lpips import LPIPS, init_lpips_weights
    from vavae_tpu_torch.models.vae import vae_from_ddconfig
    from vavae_tpu_torch.utils.config import load_config
    from vavae_tpu_torch.utils.torch_export import dit_state_to_reference, vae_state_to_reference

    root = tmp_path_factory.mktemp("golden_artifacts")
    torch.manual_seed(0)
    tok_cfg = root / "vavae_tiny.yaml"
    tok_cfg.write_text(yaml_io.safe_dump(TINY_TOKENIZER))
    p = TINY_TOKENIZER["model"]["params"]
    vae = vae_from_ddconfig(p["embed_dim"], p["ddconfig"])
    torch.save({"state_dict": vae_state_to_reference(vae.state_dict())}, root / "vavae.pt")

    dit_cfg = root / "dit_tiny.yaml"
    dit_cfg.write_text(yaml_io.safe_dump({
        "data": {"image_size": 64, "num_classes": 2}, "vae": {"downsample_ratio": 16},
        "model": {"model_type": "LightningDiT-S/2", "use_swiglu": True, "use_rope": True,
                  "use_rmsnorm": True, "in_chans": 4}}))
    cfg = load_config(str(dit_cfg))
    dit = create_dit(cfg.model, 4, 2, device="cpu")
    sd = dit_state_to_reference(dit.state_dict(), dit.patch_size, dit.num_heads, dit.use_rope,
                                dit.input_size)
    torch.save({"model": sd, "ema": sd, "steps": 0}, root / "dit.pt")

    inc = torchvision_stub.inception_v3(num_classes=1008, aux_logits=False)
    torch.save(inc.state_dict(), root / "pt_inception.pth")
    torch.save(torchvision_stub.vgg16().state_dict(), root / "vgg16.pth")
    lp = LPIPS()
    init_lpips_weights(lp, torch.Generator().manual_seed(1))
    torch.save({k: v for k, v in lp.state_dict().items() if k.startswith("lin")},
               root / "vgg.pth")
    torch.save(lp.state_dict(), root / "vgg_full.pth")

    rs = np.random.default_rng(0)
    for synset in ("n01440764", "n01443537"):
        d = root / "val" / synset
        d.mkdir(parents=True)
        write_pngs(rs.integers(0, 255, (3, 32, 32, 3), dtype=np.uint8),
                   [str(d / f"img{i}.png") for i in range(3)])
    np.savez(root / "ref.npz", arr_0=np.zeros((1, 4), np.float32))
    env = {"VAVAE_GN_VAE_CKPT": root / "vavae.pt", "VAVAE_GN_DIT_CKPT": root / "dit.pt",
           "VAVAE_GN_IMAGENET_VAL": root / "val", "VAVAE_GN_FID_NPZ": root / "ref.npz",
           "VAVAE_FID_WEIGHTS": root / "pt_inception.pth",
           "VAVAE_LPIPS_WEIGHTS": root / "vgg.pth", "VAVAE_VGG16_WEIGHTS": root / "vgg16.pth"}
    return {"env": {k: str(v) for k, v in env.items()}, "root": root,
            "dit_config": str(dit_cfg), "tokenizer_config": str(tok_cfg)}


@pytest.fixture
def golden_env(monkeypatch, artifacts):
    for var, path in artifacts["env"].items():
        monkeypatch.setenv(var, path)
    return artifacts


def test_check_fails_naming_each_missing_artifact(monkeypatch, capsys):
    for var in golden_numbers.REQUIRED:
        monkeypatch.delenv(var, raising=False)
    assert golden_numbers.check() is False
    printed = capsys.readouterr().out
    assert all(f"MISSING {var}" in printed for var in golden_numbers.REQUIRED)
    assert golden_numbers.main(["--check"]) == 1


def test_check_passes_with_synthetic_artifacts(golden_env, monkeypatch, capsys):
    """Each loader probe passes on the real layouts, and fails naming the
    artifact on a wrong one."""
    cfgs = {"config": golden_env["dit_config"], "tokenizer_config": golden_env["tokenizer_config"]}
    assert golden_numbers.check(**cfgs) is True
    assert golden_numbers.main(["--check", "--config", cfgs["config"], "--tokenizer_config",
                                cfgs["tokenizer_config"]]) == 0
    # a full-module LPIPS dump needs no VGG16 file
    monkeypatch.setenv("VAVAE_LPIPS_WEIGHTS", str(golden_env["root"] / "vgg_full.pth"))
    monkeypatch.delenv("VAVAE_VGG16_WEIGHTS")
    assert golden_numbers.check(**cfgs) is True
    # the genuine vgg.pth without the VGG16 convolutions, and a DiT of another width
    monkeypatch.setenv("VAVAE_LPIPS_WEIGHTS", golden_env["env"]["VAVAE_LPIPS_WEIGHTS"])
    capsys.readouterr()
    assert golden_numbers.check(**cfgs) is False
    assert "BAD     LPIPS weights load" in capsys.readouterr().out
    monkeypatch.setenv("VAVAE_VGG16_WEIGHTS", golden_env["env"]["VAVAE_VGG16_WEIGHTS"])
    other = golden_env["root"] / "dit_b.yaml"
    tree = yaml_io.safe_load(open(cfgs["config"]))
    tree["model"]["model_type"] = "LightningDiT-B/2"
    other.write_text(yaml_io.safe_dump(tree))
    assert golden_numbers.check(str(other), cfgs["tokenizer_config"]) is False
    assert "BAD     DiT checkpoint loads" in capsys.readouterr().out


def test_rfid_leg_rehearsed_on_the_cpu(golden_env, tmp_path):
    """The tokenizer leg of the runbook at 32 px through ``python -m
    vavae_tpu_torch evaluate_tokenizer``: the reconstructions dumped and
    finite PSNR, SSIM, LPIPS and rFID (random stub Inception weights)."""
    workdir = tmp_path / "golden"
    assert golden_numbers.main([
        "--config", golden_env["dit_config"], "--tokenizer_config",
        golden_env["tokenizer_config"], "--workdir", str(workdir), "--image_size", "32",
        "--max_images", "6", "--skip_extraction", "--skip_sampling", "--device", "cpu"]) == 0
    metrics = json.loads((workdir / "tokenizer_metrics.json").read_text())
    assert metrics["num_images"] == 6
    for key in ("psnr", "ssim", "lpips", "rfid"):
        assert key in metrics and np.isfinite(metrics[key]), (key, metrics)
    for folder in ("ref", "dec"):
        assert len(glob.glob(str(workdir / "tokenizer" / folder / "*.png"))) == 6


def test_sampling_legs_fail_fast_without_latents(golden_env, tmp_path):
    with pytest.raises(SystemExit, match="latents dir not found"):
        golden_numbers.main(["--config", golden_env["dit_config"], "--tokenizer_config",
                             golden_env["tokenizer_config"], "--skip_tokenizer",
                             "--latents", str(tmp_path / "none"), "--device", "cpu"])


# -- the learning check ----------------------------------------------------------------------


def test_learning_check_runs_on_the_cpu():
    """The learning check's code at a tiny width, a few steps: its record,
    and no kernel launched on the CPU (the card's counts are held in
    ``chip_smoke.py`` phase 38 and ``tests/test_torch_cuda.py``)."""
    res = learning_check.run("cpu", steps=12, depth=1, hidden=64, heads=2, dtype=torch.float32)
    assert res["steps"] == 12 and res["batch"] == 64 and res["sample_model_calls"] == 49
    assert res["losses_finite"] and res["samples_finite"] and 0 <= res["accuracy"] <= 1
    assert res["train_launches"] == [0, 0] and res["sample_launches"] == [0, 0]
    assert np.isfinite(res["ms_per_step"]) and learning_check.passed(res) in (True, False)

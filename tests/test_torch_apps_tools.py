"""The port's small apps and tools against the JAX package: the dataset
split, the legacy latent conversion (every layout, files byte-equal), the
scale-factor VAE facade, the preflight doctor (the same checks for good and
broken configs, and its exit codes), the VA-VAE validation tools (with the
antialiased resize of the VF check) and the encoder export (byte-equal to
flax's), and the command index."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import REPO, max_rel, one_thread, randomize, tiny_vae_config  # noqa: F401
from vavae_tpu_torch.utils.png import write_pngs

pytestmark = pytest.mark.usefixtures("one_thread")


def _user_tree(root, n_users=3, per_user=5, size=16, seed=0):
    """User folders of seeded PNGs (and one non-image file)."""
    rs = np.random.default_rng(seed)
    for u in range(n_users):
        d = os.path.join(root, f"ID_{u + 1}", "sub" if u == 1 else "")
        os.makedirs(d, exist_ok=True)
        imgs = rs.integers(0, 256, (per_user, size, size, 3)).astype(np.uint8)
        imgs[:, : size // 2] //= (u + 2)  # a user signature in the top half
        write_pngs(imgs, [os.path.join(d, f"{i:02d}.png") for i in range(per_user)])
    open(os.path.join(root, "ID_1", "notes.txt"), "w").close()
    return str(root)


# -- split -------------------------------------------------------------------------------


def test_dataset_split_matches_jax(tmp_path):
    from vavae_tpu.apps import prepare_dataset_split as jax_split
    from vavae_tpu_torch.apps import prepare_dataset_split as split

    root = _user_tree(tmp_path / "users")
    jax_split.create_dataset_split(root, str(tmp_path / "jax.json"), seed=7)
    split.main(["--data_root", root, "--output", str(tmp_path / "port.json"), "--seed", "7"])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert split.validate_split(str(tmp_path / "port.json")) == \
        jax_split.validate_split(str(tmp_path / "jax.json"))
    leak = json.loads((tmp_path / "port.json").read_text())
    leak["val"].append(leak["train"][0])
    (tmp_path / "leak.json").write_text(json.dumps(leak))
    with pytest.raises(ValueError, match="both train and val"):
        split.validate_split(str(tmp_path / "leak.json"))


# -- legacy latent conversion ----------------------------------------------------------------


def _layouts(rs):
    lat = torch.from_numpy(rs.standard_normal((7, 4, 2, 2)).astype(np.float32))
    uids = [3, 1, 4, 1, 5, 2, 6]
    items = [{"latent": lat[i], "user_id": uids[i]} for i in range(7)]
    items[1] = {"tensor": lat[1], "user_id": uids[1]}
    items[2] = {"latents": lat[2], "user_id": uids[2]}
    items[3] = {"z": lat[3].half(), "user_id": uids[3]}
    return {
        "dict_ids": {"latents": lat, "user_ids": uids},
        "dict": {"latents": lat.double()},
        "dicts": items + [{"note": "no tensor"}],
        "list": list(lat),
        "stacked": lat,
        "one_chw": lat[0],
    }


@pytest.mark.parametrize("use_labels", [False, True])
def test_convert_latents_matches_jax_byte_for_byte(tmp_path, use_labels):
    """Every layout through both converters (shards of 3): the shards, the
    stats caches (.safetensors and .pt) byte-equal; the port's dataset reads
    the shards back."""
    from vavae_tpu.apps import convert_latents as jax_conv
    from vavae_tpu_torch.apps import convert_latents as conv
    from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset

    for name, data in _layouts(np.random.default_rng(0)).items():
        src = tmp_path / name
        src.mkdir()
        torch.save(data, src / "train_latents.pt")
        jax_conv.convert_split(str(src), str(src / "jax"), "train", 3, use_labels)
        conv.main(["--input_dir", str(src), "--output_dir", str(src / "port"), "--splits",
                   "train", "--shard_size", "3"] + (["--use_labels"] if use_labels else []))
        names = sorted(os.listdir(src / "jax"))
        assert sorted(os.listdir(src / "port" / "train")) == names and len(names) >= 3
        for f in names:
            assert (src / "port" / "train" / f).read_bytes() == (src / "jax" / f).read_bytes(), \
                (name, f)
        ds = ImgLatentDataset(str(src / "port" / "train"), latent_norm=True)
        x, y = next(ds.batches(1, shuffle=False, epochs=1))
        assert x.shape == (1, 2, 2, 4) and np.isfinite(x).all()
        assert int(y[0]) == (3 if use_labels and name in ("dict_ids", "dicts") else 0)
    bad = tmp_path / "bad"
    bad.mkdir()
    torch.save({"latents": torch.zeros(2, 4, 2, 2), "user_ids": [1]}, bad / "train_latents.pt")
    with pytest.raises(ValueError, match="user_ids"):
        conv.convert_split(str(bad), str(bad / "out"), "train")


# -- the scale-factor facade --------------------------------------------------------------------


def test_simplified_vavae_matches_jax(tmp_path):
    """Both facades on one reference .ckpt carrying scale_factor 0.5:
    encode is the posterior draw times the factor, decode of the same
    latents maps to [0, 1] alike; an explicit factor wins."""
    from vavae_tpu.apps.simplified_vavae import SimplifiedVAVAE as JaxSimplified
    from vavae_tpu.tokenizer import VA_VAE as JaxVAE
    from vavae_tpu.utils.torch_export import vae_params_to_torch
    from vavae_tpu_torch.apps.simplified_vavae import SimplifiedVAVAE

    cfg = tiny_vae_config(tmp_path)
    jv = JaxVAE(cfg, img_size=16)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in vae_params_to_torch(randomize(jv.params, 3)).items()}
    ckpt = str(tmp_path / "vae.ckpt")
    torch.save({"state_dict": sd, "scale_factor": 0.5}, ckpt)
    js = JaxSimplified(ckpt, cfg, img_size=16)
    ts = SimplifiedVAVAE(ckpt, cfg, img_size=16, device="cpu")
    assert ts.scale_factor == js.scale_factor == 0.5
    assert SimplifiedVAVAE(ckpt, cfg, img_size=16, scale_factor=2.0, device="cpu").scale_factor == 2.0
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    got = ts.decode(z).numpy()
    assert got.min() >= 0 and got.max() <= 1
    assert max_rel(got, np.asarray(js.decode(z))) < 1e-5
    imgs = ts.decode_to_images(z)
    assert imgs.dtype == np.uint8 and np.abs(imgs.astype(int) - np.asarray(
        js.decode_to_images(z)).astype(int)).max() <= 1
    x = torch.from_numpy(2 * got - 1)
    g = torch.Generator().manual_seed(0)
    want = ts.vae.encode_images(x, torch.Generator().manual_seed(0)) * 0.5
    assert torch.equal(ts.encode(x, g), want)


# -- preflight -------------------------------------------------------------------------------


def _preflight_case(tmp_path, name):
    """A tiny config (DiT S/1 cut to depth 1) and what ``name`` breaks."""
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    data = tmp_path / "latents"
    if not data.exists():
        rs = np.random.default_rng(0)
        lat = rs.standard_normal((4, 4, 8, 8)).astype(np.float32)
        write_safetensors(str(data / "s.safetensors"), {
            "latents": lat, "latents_flip": lat, "labels": np.array([1, 0, 2, 1], np.int64)})
        write_safetensors(str(tmp_path / "w.safetensors"), {"a": np.zeros(3, np.float32)})
        (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 12)
        outs, blank = tmp_path / "outs", tmp_path / "blank"
        outs.mkdir(), blank.mkdir()
        write_pngs(rs.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8),
                   [str(outs / "a.png"), str(outs / "b.png")])
        write_pngs(np.zeros((1, 8, 8, 3), np.uint8), [str(blank / "z.png")])
        bad_out = tmp_path / "bad_out"
        bad_out.mkdir()
        (bad_out / "broken.png").write_bytes(b"not a png")
    cfg = {"data": {"image_size": 16, "num_classes": 3, "data_path": str(data)},
           "vae": {"downsample_ratio": 2},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4},
           "train": {"weight_init": str(tmp_path / "w.safetensors")},
           "ckpt_path": str(tmp_path / "missing.safetensors")}
    outputs = None
    if name == "not_divisible":
        cfg["data"]["image_size"] = 15
    elif name == "patch":
        cfg["model"]["model_type"] = "LightningDiT-S/2"
        cfg["data"]["image_size"] = 6
    elif name == "no_patch_no_classes":
        cfg["model"]["model_type"] = "custom"
        cfg["data"]["num_classes"] = 0
    elif name == "shape":
        cfg["model"]["in_chans"] = 8
    elif name == "labels":
        cfg["data"]["num_classes"] = 1
    elif name == "no_data_bad_weights":
        cfg["data"]["data_path"] = str(tmp_path / "nowhere")
        cfg["train"]["weight_init"] = str(tmp_path / "bad.safetensors")
        cfg.pop("ckpt_path")
    elif name == "no_weights":
        cfg.pop("train"), cfg.pop("ckpt_path")
    elif name.startswith("outputs"):
        outputs = str(tmp_path / {"outputs": "outs", "outputs_blank": "blank",
                                  "outputs_bad": "bad_out", "outputs_missing": "none"}[name])
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path), outputs


PREFLIGHT_CASES = ["good", "not_divisible", "patch", "no_patch_no_classes", "shape", "labels",
                   "no_data_bad_weights", "no_weights", "outputs", "outputs_blank",
                   "outputs_bad", "outputs_missing"]


@pytest.mark.parametrize("case", PREFLIGHT_CASES)
def test_preflight_checks_match_jax(tmp_path, monkeypatch, case):
    """The same (status, name) list from both doctors; the port's CLI exits
    1 exactly when a check FAILed."""
    import vavae_tpu_torch.models.dit as dit
    from vavae_tpu.apps import preflight as jax_pf
    from vavae_tpu.models import dit as jax_dit
    from vavae_tpu.utils.config import load_config as jax_load
    from vavae_tpu_torch.apps import preflight as pf
    from vavae_tpu_torch.utils.config import load_config

    for mod in (dit, jax_dit):
        monkeypatch.setitem(mod._VARIANTS, "S", dict(depth=1, hidden_size=64, num_heads=2))
    monkeypatch.delenv("VAVAE_VAE_WEIGHTS", raising=False)
    path, outputs = _preflight_case(tmp_path, case)
    want = jax_pf.run_preflight(jax_load(path), outputs)
    got = pf.run_preflight(load_config(path), outputs, device="cpu")
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    argv = ["--config", path, "--device", "cpu"] + (["--verify_outputs", outputs] if outputs else [])
    if any(s == "FAIL" for s, _, _ in want):
        with pytest.raises(SystemExit) as e:
            pf.main(argv)
        assert e.value.code == 1
    else:
        pf.main(argv)  # returns: exit code 0


# -- validation and export ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_pair(tmp_path_factory):
    """JAX and port tiny VAEs (f2, 4 channels) from one reference .ckpt, and
    a split file over three users' seeded 16-px images."""
    from vavae_tpu.tokenizer import VA_VAE as JaxVAE
    from vavae_tpu.utils.torch_export import vae_params_to_torch
    from vavae_tpu_torch.apps.prepare_dataset_split import create_dataset_split
    from vavae_tpu_torch.tokenizer import VA_VAE

    w = tmp_path_factory.mktemp("validate")
    cfg = tiny_vae_config(w)
    params = randomize(JaxVAE(cfg, img_size=16).params, 5)
    ckpt = str(w / "vae.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in vae_params_to_torch(params).items()}}, ckpt)
    split = str(w / "split.json")
    create_dataset_split(_user_tree(w / "users"), split)
    return {"cfg": cfg, "ckpt": ckpt, "split": split, "w": w,
            "jax": JaxVAE(cfg, ckpt_path=ckpt, img_size=16),
            "port": VA_VAE(cfg, ckpt_path=ckpt, img_size=16, device="cpu")}


def test_validate_export_main_matches_jax(vae_pair, monkeypatch):
    """Both CLIs on the split: per-user PSNR and SSIM, the discrimination
    scores and the latent statistics agree; the exported encoders are the
    same bytes (flax's msgpack)."""
    from vavae_tpu.apps import validate_export as jax_ve
    from vavae_tpu_torch.apps import validate_export as ve

    w = vae_pair["w"]
    common = ["--split_file", vae_pair["split"], "--split", "train", "--vae_config",
              vae_pair["cfg"], "--vae_ckpt", vae_pair["ckpt"], "--num_users", "3",
              "--image_size", "16"]
    monkeypatch.setattr(sys, "argv", ["validate_export"] + common + [
        "--out", str(w / "jax.json"), "--export_encoder", str(w / "jax_enc.msgpack")])
    jax_ve.main()
    want = json.load(open(w / "jax.json"))
    got = ve.main(common + ["--out", str(w / "port.json"), "--export_encoder",
                            str(w / "port_enc.msgpack"), "--device", "cpu"])
    assert json.load(open(w / "port.json")) == json.loads(json.dumps(got))
    recon = {int(k): v for k, v in want["per_user_reconstruction"].items()}
    assert set(got["per_user_reconstruction"]) == set(recon) == {0, 1, 2}
    for uid, row in got["per_user_reconstruction"].items():
        assert row["n"] == recon[uid]["n"]
        assert abs(row["psnr"] - recon[uid]["psnr"]) < 1e-4
        assert abs(row["ssim"] - recon[uid]["ssim"]) < 1e-5
    for key, v in want["latent_user_discrimination"].items():
        assert abs(got["latent_user_discrimination"][key] - v) <= 1e-5 * max(1.0, abs(v)), key
    stats = got["latent_stats"]
    assert abs(stats["global_mean"] - want["latent_stats"]["global_mean"]) < 1e-5
    assert abs(stats["global_std"] - want["latent_stats"]["global_std"]) < 1e-5
    np.testing.assert_allclose(stats["channel_mean_first8"],
                               want["latent_stats"]["channel_mean_first8"], atol=1e-5)
    assert (w / "port_enc.msgpack").read_bytes() == (w / "jax_enc.msgpack").read_bytes()


def test_discrimination_and_statistics_equal_jax():
    from vavae_tpu.apps import validate_export as jax_ve
    from vavae_tpu_torch.apps import validate_export as ve

    rs = np.random.default_rng(0)
    lat = rs.standard_normal((12, 4, 4, 3)).astype(np.float32)
    lab = np.repeat(np.arange(3), 4)
    lat += lab[:, None, None, None]
    assert ve.latent_user_discrimination(lat, lab) == jax_ve.latent_user_discrimination(lat, lab)
    got, want = ve.latent_statistics(lat), jax_ve.latent_statistics(lat)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("size, grid", [(32, 8), (32, 16), (16, 8)])
def test_linear_resize_matches_jax(size, grid):
    """The VF check's resize against ``jax.image.resize(method="linear")``,
    antialiased when it shrinks, at the tiny ViT's 16² grid and others."""
    from vavae_tpu_torch.apps.validate_export import linear_resize

    x = np.random.default_rng(0).standard_normal((2, size, size + 4, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, grid, grid + 2, 5), method="linear")
    got = linear_resize(torch.from_numpy(x), (grid, grid + 2))
    assert max_rel(got.numpy(), np.asarray(want)) < 1e-6


@pytest.mark.parametrize("img_size", [16, 32])
def test_vf_alignment_matches_jax(tmp_path, img_size):
    """The VF check on both packages' VAEs and tiny DINOv2s with the same
    weights and projector: at 32 px the latent and ViT grids are both 16²;
    at 16 px the 16² features shrink to the 8² latent grid (antialiased)."""
    from test_torch_common import tiny_vae_pair
    from vavae_tpu.apps import validate_export as jax_ve
    from vavae_tpu.models import vit as jvit
    from vavae_tpu_torch.apps import validate_export as ve
    from vavae_tpu_torch.models import vit as tvit
    from vavae_tpu_torch.utils.weights import vit_state_from_jax

    jm = jvit.FoundationModel(kind="dinov2-tiny")
    jm.params = randomize(jax.eval_shape(lambda: jm.model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 224, 3)))["params"]), 11)
    tm = tvit.FoundationModel("dinov2-tiny", device="cpu")
    tm.model.load_state_dict(vit_state_from_jax(jm.params), strict=True)
    feat = jm.feature_fn_p()
    kernel = np.random.default_rng(2).standard_normal((1, 1, 4, tm.feature_dim)).astype(np.float32)
    images = np.random.default_rng(3).uniform(-1, 1, (3, img_size, img_size, 3)).astype(np.float32)
    jv, tv = tiny_vae_pair(tmp_path, seed=4, img_size=img_size)
    want = jax_ve.vf_alignment_check(jv, {"kernel": jnp.asarray(kernel)},
                                     lambda im: feat(jm.params, im), images)
    got = ve.vf_alignment_check(tv, kernel, tm, images)
    assert set(got) == set(want)
    assert abs(got["mean_cosine"] - want["mean_cosine"]) < 1e-5
    assert abs(got["min_cosine"] - want["min_cosine"]) < 1e-5
    assert got["frac_above_0.5"] == want["frac_above_0.5"]


def test_validate_main_vf_from_a_training_checkpoint(vae_pair, tmp_path):
    """The port's CLI with a train_vavae checkpoint: the VF projector read
    from gen_params|proj|kernel, the trained generator rebuilt from its
    training config, the check run with the random tiny foundation."""
    from test_torch_train_vavae import tiny_cfg
    from vavae_tpu_torch.apps import validate_export as ve
    from vavae_tpu_torch.pipelines.train_vavae import build_vae_trainer
    from vavae_tpu_torch.train import checkpoint as ckpt_lib

    cfg = tiny_cfg("dinov2-tiny")
    trainer = build_vae_trainer(cfg, vf_dim=64, device="cpu")
    train_ckpt = ckpt_lib.save_checkpoint(str(tmp_path), 1, trainer.init_state(0))
    (tmp_path / "train.json").write_text(json.dumps(cfg))
    rep = ve.main(["--split_file", vae_pair["split"], "--vae_config", vae_pair["cfg"],
                   "--vae_ckpt", vae_pair["ckpt"], "--num_users", "3", "--image_size", "16",
                   "--train_ckpt", train_ckpt, "--train_config", str(tmp_path / "train.json"),
                   "--vf_kind", "dinov2-tiny", "--allow_random_foundation", "--device", "cpu"])
    vf = rep["vf_alignment"]
    assert -1 <= vf["min_cosine"] <= vf["mean_cosine"] <= 1 and 0 <= vf["frac_above_0.5"] <= 1
    enc = ve.load_trained_vae(str(tmp_path / "train.json"), train_ckpt, "cpu")
    assert torch.equal(next(enc.model.parameters()), trainer.gen.vae.encoder.conv_in.weight)


# -- the command index ---------------------------------------------------------------------------


def test_commands_cover_jax_and_import_port_modules():
    import importlib

    from vavae_tpu.__main__ import COMMANDS as JAX_COMMANDS
    from vavae_tpu_torch.__main__ import COMMANDS

    assert set(JAX_COMMANDS) <= set(COMMANDS)
    assert set(COMMANDS) - set(JAX_COMMANDS) == {"profile_sample", "profile_train",
                                                 "profile_attention_fwd"}
    for name, (module, _) in COMMANDS.items():
        assert module.startswith("vavae_tpu_torch."), name
        assert callable(importlib.import_module(module).main), name


def test_dispatcher_exit_codes_and_dispatch(tmp_path, monkeypatch):
    from vavae_tpu_torch import __main__ as cli

    run = lambda *a: subprocess.run([sys.executable, "-m", "vavae_tpu_torch", *a], cwd=REPO,  # noqa: E731
                                    capture_output=True, text=True, timeout=120)
    listed = run("--help")
    assert listed.returncode == 0 and "autotune_sampler" in listed.stdout
    assert run().returncode == 1
    unknown = run("no_such_command")
    assert unknown.returncode == 2 and "unknown command" in unknown.stderr
    root = _user_tree(tmp_path / "users")
    out = tmp_path / "split.json"
    monkeypatch.setattr(sys, "argv", ["vavae_tpu_torch", "prepare_dataset_split",
                                      "--data_root", root, "--output", str(out)])
    assert cli.main() == 0
    assert len(json.loads(out.read_text())["train"]) == 12
    monkeypatch.setattr(sys, "argv", ["vavae_tpu_torch", "preflight", "--config",
                                      _preflight_case(tmp_path, "not_divisible")[0]])
    with pytest.raises(SystemExit) as e:
        cli.main()
    assert e.value.code == 1

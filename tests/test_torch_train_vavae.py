"""The port's VA-VAE training pipeline on the CPU at a tiny size: the staged
recipe through ``main`` (stage directories, ``epoch.json``,
``best/metric.json``, image grids, chained steps) and its relaunch (complete
stages skipped, a partial one resumed), best-validation chaining, the
``--no_resume`` refusal, SIGTERM mid-epoch, ``weight_init`` (weights only,
shape-checked; a reference ``.ckpt``), the refusal to run without CUDA
unless asked, and the image grid against the JAX package's."""
import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

from test_torch_common import one_thread  # noqa: F401
from vavae_tpu.utils.image_grid import make_grid as jax_make_grid
from vavae_tpu_torch.pipelines import train_vavae as tv
from vavae_tpu_torch.train import checkpoint as ckpt
from vavae_tpu_torch.utils.config import Config
from vavae_tpu_torch.utils.image_grid import make_grid
from vavae_tpu_torch.utils.png import read_png, write_pngs

pytestmark = pytest.mark.usefixtures("one_thread")

DDCONFIG = {"double_z": True, "z_channels": 4, "resolution": 32, "in_channels": 3, "out_ch": 3,
            "ch": 32, "ch_mult": [1, 1], "num_res_blocks": 1, "attn_resolutions": [],
            "dropout": 0.0}


def tiny_cfg(use_vf=None, **loss) -> Config:
    params = {"embed_dim": 4, "lossconfig": {"params": {"disc_start": 10_000, **loss}},
              "ddconfig": DDCONFIG}
    if use_vf:
        params["use_vf"] = use_vf
    return Config({"model": {"base_learning_rate": 1e-4, "params": params}})


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Two class folders of 4 seeded 40×40 PNGs."""
    root = tmp_path_factory.mktemp("images")
    rs = np.random.default_rng(0)
    for c in ("a", "b"):
        os.makedirs(root / c)
        write_pngs(rs.integers(0, 256, (4, 40, 40, 3)).astype(np.uint8),
                   [str(root / c / f"{i}.png") for i in range(4)])
    return str(root)


def _write_cfg(path, stages) -> str:
    cfg = tiny_cfg("dinov2-tiny", adaptive_vf=False)
    cfg["stages"] = stages
    cfg["train"] = {"log_images_every": 1}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


MICRO_STAGES = [  # vavae_microdoppler_finetune.yaml's stages at one epoch each
    {"epochs": 1, "vf_weight": 0.5, "distmat_margin": 0.0, "cos_margin": 0.0, "disc_start": 5001,
     "lr": 1.0e-4},
    {"epochs": 1, "vf_weight": 0.1, "distmat_margin": 0.0, "cos_margin": 0.0, "disc_start": 1,
     "lr": 5.0e-5},
    {"epochs": 1, "vf_weight": 0.1, "distmat_margin": 0.25, "cos_margin": 0.5, "disc_start": 1,
     "lr": 2.0e-5},
]


def _main(cfg_path, images, out, *extra):
    return tv.main(["--base", cfg_path, "--data_path", images, "--val_path", images,
                    "--output_dir", str(out), "--batch_size", "4", "--allow_random_foundation",
                    "--device", "cpu", *extra])


@pytest.fixture()
def log(caplog):
    caplog.set_level(logging.INFO, logger="vavae_tpu_torch")
    return caplog


def test_main_runs_the_stages_then_resumes(tmp_path, images, log):
    """Three stages of one epoch (2 steps each): each stage's checkpoint,
    epoch.json, best/ with metric.json and grids, steps chained 2, 4, 6;
    then stage 3 raised to 2 epochs: stages 1-2 skipped, stage 3 resumed at
    epoch 1, step 8."""
    out = tmp_path / "out"
    state = _main(_write_cfg(tmp_path / "cfg.json", MICRO_STAGES), images, out)
    assert state.step == 6
    for k, step in ((1, 2), (2, 4), (3, 6)):
        d = out / f"stage{k}"
        assert json.load(open(d / "epoch.json")) == {"epochs_done": 1}
        assert ckpt.latest_checkpoint(str(d)).endswith(f"{step:07d}.safetensors")
        assert json.load(open(d / "best" / "metric.json"))["step"] == step
        assert os.path.exists(d / "best" / f"{step:07d}.safetensors")
        for kind in ("inputs", "recon"):
            grid = read_png(str(d / "images" / f"{kind}_{step:07d}.png"))
            assert grid.shape == (64, 64, 3)  # 4 images, 2 × 2
        lines = [json.loads(x) for x in open(d / "tb" / "metrics.jsonl")]
        assert any("val/rec_loss" in x for x in lines) and any("epoch/duration_s" in x for x in lines)
    assert log.text.count("=== stage") == 3
    log.clear()

    raised = [dict(s) for s in MICRO_STAGES]
    raised[2]["epochs"] = 2
    state = _main(_write_cfg(tmp_path / "cfg2.json", raised), images, out)
    text = log.text
    assert "stage 1: resumed 1/1" in text and "stage 2: resumed 1/1" in text
    assert "stage 3: resumed 1/2" in text and text.count("=== stage") == 1
    assert state.step == 8
    assert json.load(open(out / "stage3" / "epoch.json")) == {"epochs_done": 2}

    with pytest.raises(RuntimeError, match="--no_resume"):
        _main(_write_cfg(tmp_path / "cfg3.json", raised), images, out, "--no_resume")


def test_run_stages_chains_best_val_checkpoint(tmp_path):
    """A completed stage hands its best-validation checkpoint, not its last,
    to the next stage (as tests/test_end_to_end.py for the JAX package)."""
    cfg = tiny_cfg()
    out = tmp_path / "out"
    trainer = tv.build_vae_trainer(cfg, device="cpu")
    latest = trainer.init_state(1)
    latest.step = 20
    ckpt.save_checkpoint(str(out / "stage1"), 20, latest)
    best = trainer.init_state(2)
    best.step = 10
    ckpt.save_checkpoint(str(out / "stage1" / "best"), 10, best)
    want = [p.clone() for p in best.gen_params]
    json.dump({"epochs_done": 1}, open(out / "stage1" / "epoch.json", "w"))
    json.dump({"val": 0.1, "step": 10}, open(out / "stage1" / "best" / "metric.json", "w"))
    state = tv.run_stages(cfg, dataset=None, stages=[{"epochs": 1}], output_dir=str(out),
                          batch_size=4, device="cpu")
    assert state.step == 10
    for a, b in zip(state.gen_params, want):
        assert torch.equal(a, b)


def test_stage_epochs_done_prefers_epoch_json(tmp_path):
    d = tmp_path / "stage1"
    os.makedirs(d)
    assert tv.stage_epochs_done(str(d)) == 0
    for step in (5, 10):
        open(d / f"{step:07d}.safetensors", "wb").close()
    open(d / "0000010.msgpack", "wb").close()  # the same step in the legacy format
    assert tv.stage_epochs_done(str(d)) == 2 == ckpt.checkpoint_count(str(d))
    json.dump({"epochs_done": 3}, open(d / "epoch.json", "w"))
    assert tv.stage_epochs_done(str(d)) == 3


def test_weight_init_is_weights_only(tmp_path):
    """A long-trained run's checkpoint as ``weight_init``: its weights and
    BN stats, a fresh step and fresh optimizers."""
    cfg = tiny_cfg("dinov2-tiny")
    tr = tv.build_vae_trainer(cfg, vf_dim=64, device="cpu")
    old = tr.init_state(1)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tr.train_step(old, x)
    old.step = 80_000
    path = ckpt.save_checkpoint(str(tmp_path), old.step, old)
    want = [t.clone() for t in old.gen_params + old.disc_params + old.disc_stats]

    tr2 = tv.build_vae_trainer(cfg, vf_dim=64, device="cpu")
    fresh = tr2.init_state(2)
    tv._load_pretrained(tr2, fresh, path, logging.getLogger("t"))
    for a, b in zip(fresh.gen_params + fresh.disc_params + fresh.disc_stats, want):
        assert torch.equal(a, b)
    assert fresh.step == 0 and fresh.gen_opt.count == 0 and fresh.disc_opt.count == 0
    assert all(m.abs().max() == 0 for m in fresh.gen_opt.mu + fresh.disc_opt.nu)


def test_lenient_restore_shape_checked_finetune_init(tmp_path, capsys):
    """A checkpoint whose projector has another width: every other leaf
    loads, the projector keeps its init, the skip is reported; the strict
    restore refuses the same file."""
    src = tv.build_vae_trainer(tiny_cfg("dinov2-tiny"), vf_dim=16, device="cpu")
    s = src.init_state(1)
    path = ckpt.save_checkpoint(str(tmp_path), 3, s)
    dst = tv.build_vae_trainer(tiny_cfg("dinov2-tiny"), vf_dim=64, device="cpu")
    d = dst.init_state(2)
    proj0 = dst.gen.proj.weight.clone()
    loaded, skipped = ckpt.restore_weights(path, d)
    out = capsys.readouterr().out
    assert "shape mismatch for gen_params|proj|kernel" in out
    assert f"loaded {loaded} leaves, skipped 1" in out and skipped == 1
    assert torch.equal(dst.gen.proj.weight, proj0)
    for name, a, b in zip(d.gen_names, d.gen_params, s.gen_params):
        if name != "proj.weight":
            assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_checkpoint(path, d)


def test_weight_init_from_reference_ckpt(tmp_path):
    """A reference ``.ckpt``: the AutoencoderKL under its own names (the
    loss's and the foundation model's tensors dropped), ``linear_proj`` →
    the projector."""
    tr = tv.build_vae_trainer(tiny_cfg("dinov2-tiny"), vf_dim=64, device="cpu")
    state = tr.init_state(0)
    gen = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in tr.vae.state_dict().items()}
    sd["linear_proj.weight"] = torch.randn(64, 4, 1, 1, generator=gen)
    sd["loss.discriminator.main.0.weight"] = torch.zeros(3)
    sd["foundation_model.x"] = torch.zeros(3)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd}, path)
    tv._load_pretrained(tr, state, path, logging.getLogger("t"))
    for k, v in tr.vae.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert torch.equal(tr.gen.proj.weight, sd["linear_proj.weight"])


class _Preempting:
    """A dataset stand-in whose second batch arrives after a SIGTERM."""

    def __init__(self, n: int):
        rs = np.random.default_rng(1)
        self.x = rs.uniform(-1, 1, (n, 4, 32, 32, 3)).astype(np.float32)

    def batches(self, batch_size, seed=0, epochs=1):
        for i, x in enumerate(self.x):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield x


def test_sigterm_mid_epoch_checkpoints_and_stops(tmp_path, log):
    """SIGTERM during an epoch: the step in flight finishes, a checkpoint is
    written, epoch.json keeps the completed epochs only, and the later stages
    do not start."""
    out = tmp_path / "out"
    state = tv.run_stages(tiny_cfg(), _Preempting(5), stages=[{"epochs": 3}, {"epochs": 1}],
                          output_dir=str(out), batch_size=4, device="cpu")
    assert state.step in (1, 2) and f"preempted at step {state.step}" in log.text
    assert json.load(open(out / "stage1" / "epoch.json")) == {"epochs_done": 0}
    assert ckpt.latest_checkpoint(str(out / "stage1")).endswith(f"{state.step:07d}.safetensors")
    assert not (out / "stage2").exists()
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the guard handed it back


def test_main_refuses_cpu_fallback(monkeypatch, tmp_path, images):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.main(["--base", _write_cfg(tmp_path / "cfg.json", MICRO_STAGES[:1]),
                 "--data_path", images, "--output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_tiny_foundation_sizes_the_projector():
    fm, dim = tv.make_aux_feature_fn("dinov2-tiny", allow_random=True, device="cpu")
    assert dim == 64
    assert fm(torch.zeros(1, 32, 32, 3)).shape == (1, 16, 16, 64)
    tr = tv.build_vae_trainer(tiny_cfg("dinov2-tiny"), foundation=fm, vf_dim=dim, device="cpu")
    assert tr.gen.proj.weight.shape == (64, 4, 1, 1)
    with pytest.raises(FileNotFoundError):
        tv.make_aux_feature_fn("dinov2", device="cpu")


def test_build_vae_trainer_reads_the_config():
    cfg = tiny_cfg(None, kl_weight=2e-6, disc_weight=0.25)
    cfg.model.params["compute_dtype"] = "bf16"
    tr = tv.build_vae_trainer(cfg, stage_overrides={"lr": 5e-5, "vf_weight": 0.5, "epochs": 3},
                              device="cpu")
    assert tr.lr == 5e-5 and tr.loss_cfg.vf_weight == 0.5 and tr.loss_cfg.kl_weight == 2e-6
    assert tr.loss_cfg.disc_weight == 0.25 and tr.compute_dtype == torch.bfloat16
    assert not tr.use_vf and tr.loss_cfg.perceptual_weight == 0.0
    assert len(tr.vae.encoder.down) == 2 and len(tr.vae.encoder.down[0].block) == 1
    cfg.model.params["compute_dtype"] = "bf61"
    with pytest.raises(ValueError, match="compute_dtype"):
        tv.build_vae_trainer(cfg, device="cpu")


@pytest.mark.parametrize("n", [1, 3, 8])
def test_image_grid_matches_jax(n):
    x = np.random.default_rng(n).uniform(-1, 1, (n, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(make_grid(x), jax_make_grid(x))
    u8 = (127.5 * (x + 1)).astype(np.uint8)
    np.testing.assert_array_equal(make_grid(u8, cols=2), jax_make_grid(u8, cols=2))

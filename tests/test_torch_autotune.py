"""The port's sampler autotune (``apps/autotune_sampler.py``) against the
JAX package's CLI on the same JAX-written checkpoint, the JAX noise fed to
the port: the labels, costs (so the adaptive cache's ``cfg_evals``) and
recommendation equal; rel-L2 p50/p99, latent FID and the noise floor within
the tolerances below. Then the impossible-budget fallback, the accel gate,
the missing-checkpoint exit, the full ladder (built without sampling) and
the hand-written YAML against PyYAML.

Tolerances: rel-L2 and the noise floor are fp32 results of two DiT
implementations through up to 16 steps (measured: rel-L2 within 3.3e-8
absolute of values of 5e-5 to 3e-3; the floor, a ratio of small velocity
differences, within 1.8e-3 relative); the latent FID is a ``sqrtm`` of
rank-deficient 192² covariances of 8 samples, which amplifies rounding
(measured within 8.8e-5 relative where it is 2e-3, and 1.2e-6 absolute
where it is rounding noise about 0)"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from test_torch_common import one_thread, randomize  # noqa: F401
from vavae_tpu_torch.apps import autotune_sampler as port_at
from vavae_tpu_torch.utils import yaml_io

pytestmark = pytest.mark.usefixtures("one_thread")

REL_L2_TOL = 1e-4   # relative (plus 1e-7 absolute)
FLOOR_TOL = 1e-2    # relative: the controller's calibrated floor, ratios of fp32 differences
FID_TOL = 1e-3      # relative (plus 5e-6 absolute)
LATENT_SHAPE = (2, 2, 8)


@pytest.fixture(scope="module", autouse=True)
def tiny_s():
    """LightningDiT-S cut to depth 2, width 64 in both packages."""
    from vavae_tpu.models import dit as jax_dit
    from vavae_tpu_torch.models import dit

    with pytest.MonkeyPatch.context() as mp:
        for mod in (dit, jax_dit):
            mp.setitem(mod._VARIANTS, "S", dict(depth=2, hidden_size=64, num_heads=2))
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory, tiny_s):
    """A tiny DiT config and a JAX train-state checkpoint of random
    non-zero weights (the JAX init's zero adaLN would make every method
    exact)."""
    w = tmp_path_factory.mktemp("autotune")
    from vavae_tpu.models.dit import create_dit
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.checkpoint import save_checkpoint
    from vavae_tpu.train.dit_trainer import DiTTrainer
    from vavae_tpu.transport import create_transport
    from vavae_tpu.utils.config import Config

    cfg = {
        "ckpt_path": None,
        "data": {"image_size": 32, "num_classes": 2, "latent_norm": False,
                 "latent_multiplier": 1.0},
        "vae": {"downsample_ratio": 16},
        "model": {"model_type": "LightningDiT-S/2", "use_swiglu": True, "use_rope": True,
                  "use_rmsnorm": True, "in_chans": 8, "use_checkpoint": False},
        "transport": {"path_type": "Linear", "prediction": "velocity"},
        "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 8,
                   "cfg_scale": 3.0, "cfg_interval_start": 0.11, "timestep_shift": 0.2},
    }
    model = create_dit(Config(cfg["model"]), 2, 2)
    trainer = DiTTrainer(model, create_transport("Linear", "velocity"),
                         make_mesh(devices=jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0), (2, 2, 2, 8))
    params = randomize(state.params, 1)
    state = state.replace(params=params, ema_params=params)
    save_checkpoint(str(w / "ckpts"), 1, state)
    cfg_path = str(w / "dit.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path, str(w / "ckpts" / "0000001.safetensors"), w


def _jax_noise(n_batches: int, B: int):
    return [np.array(jax.random.normal(jax.random.PRNGKey(1000 + b), (B,) + LATENT_SHAPE,
                                         jnp.float32)) for b in range(n_batches)]


def _port_doc(cfg_path, ckpt, noise, **kw):
    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines.sample import load_dit_params
    from vavae_tpu_torch.utils.config import load_config

    cfg = load_config(cfg_path)
    model = create_dit(cfg.model, 2, cfg.data.num_classes, device="cpu").eval()
    load_dit_params(model, ckpt)
    return port_at.autotune(cfg, model, noise, config_path=cfg_path, ckpt=ckpt, **kw)


def _close(got, want, rel, abs_=0.0):
    return abs(got - want) <= abs_ + rel * abs(want)


def test_smoke_evidence_matches_jax(setup, budget=0.05):
    from vavae_tpu.apps.autotune_sampler import main as jax_main

    cfg_path, ckpt, w = setup
    out = str(w / f"jax_{budget}.json")
    assert jax_main(["--config", cfg_path, "--ckpt", ckpt, "--smoke", "--budget", str(budget),
                     "--batch", "4", "--n", "8", "--out", out]) == 0
    want = json.load(open(out))
    got = _port_doc(cfg_path, ckpt, _jax_noise(2, 4), budget=budget, ref_steps=16, smoke=True)
    assert list(got["methods"]) == list(want["methods"]) and len(got["methods"]) == 5
    for key in ("reference", "reference_cost", "n_samples", "accel_exercised_by_production_path",
                "cfg_scale", "timestep_shift", "cfg_interval_start", "reverse"):
        assert got[key] == want[key], key
    assert want["noise_floor"] and _close(got["noise_floor"], want["noise_floor"], FLOOR_TOL)
    for label, w_row in want["methods"].items():
        g_row = got["methods"][label]
        assert g_row["rec"] == w_row["rec"]
        assert g_row["cost"] == w_row["cost"] and g_row["cost_pct"] == w_row["cost_pct"], label
        for key in ("rel_l2_p50", "rel_l2_p99"):
            assert _close(g_row[key], w_row[key], REL_L2_TOL, 1e-7), (label, key)
        assert _close(g_row["latent_fid"], w_row["latent_fid"], FID_TOL, 5e-6), label
    adaptive = [r for r in got["methods"].values() if r["rec"]["kind"] == "vcacheA"]
    assert adaptive and all(len(r["cfg_evals"]) == 2 for r in adaptive)
    assert got["recommendation"]["winner"] == want["recommendation"]["winner"]
    assert got["recommendation"]["sample_block"] == want["recommendation"]["sample_block"]


def test_main_recommends_and_overlay_loads(setup, tmp_path):
    """The port's CLI (its own noise) on the JAX checkpoint: every method
    gauged; the overlay, merged by load_config, drives build_sample_fn."""
    import torch

    from vavae_tpu_torch.models.dit import create_dit
    from vavae_tpu_torch.pipelines.sample import build_sample_fn, load_dit_params
    from vavae_tpu_torch.utils.config import load_config

    cfg_path, ckpt, _ = setup
    out, overlay = str(tmp_path / "ev.json"), str(tmp_path / "overlay.yaml")
    assert port_at.main(["--config", cfg_path, "--ckpt", ckpt, "--smoke", "--budget", "0.5",
                         "--batch", "4", "--n", "4", "--out", out, "--emit_yaml", overlay,
                         "--device", "cpu"]) == 0
    doc = json.load(open(out))
    assert len(doc["methods"]) == 5 and doc["platform"] == "cpu"
    for rec in doc["methods"].values():
        assert np.isfinite(rec["cost"]) and rec["cost"] > 0 and np.isfinite(rec["latent_fid"])
    block = doc["recommendation"]["sample_block"]
    assert block["cfg_scale"] == 3.0 and block["timestep_shift"] == 0.2
    merged = load_config(cfg_path, overlay)
    assert dict(merged.sample) == {**yaml.safe_load(open(cfg_path))["sample"], **block}
    model = create_dit(merged.model, 2, merged.data.num_classes, device="cpu").eval()
    load_dit_params(model, ckpt)
    s = build_sample_fn(merged, model, device="cpu")(torch.zeros(2, dtype=torch.long),
                                                     generator=torch.Generator().manual_seed(0))
    assert s.shape == (2, 2, 2, 8) and torch.isfinite(s).all()


def test_impossible_budget_falls_back_to_exact(setup, tmp_path):
    cfg_path, ckpt, _ = setup
    out = str(tmp_path / "strict.json")
    port_at.main(["--config", cfg_path, "--ckpt", ckpt, "--smoke", "--budget", "-1",
                  "--batch", "4", "--n", "4", "--out", out, "--device", "cpu"])
    rec = json.load(open(out))["recommendation"]
    block = rec["sample_block"]
    assert rec["winner"] == "euler_16" and block["num_sampling_steps"] == 16
    assert block["multistep_order"] == 1 and block["velocity_cache_interval"] == 1
    assert not block["velocity_cache_adaptive"]


def _gated_config(cfg_path, tmp_path):
    cfg = yaml.safe_load(open(cfg_path))
    cfg["sample"]["cfg_interval_start"] = 0.0
    gated = tmp_path / "dit_nostart.yaml"
    gated.write_text(yaml.safe_dump(cfg))
    return str(gated)


def test_gates_accel_on_production_path(setup, tmp_path):
    cfg_path, ckpt, _ = setup
    out = str(tmp_path / "gated.json")
    port_at.main(["--config", _gated_config(cfg_path, tmp_path), "--ckpt", ckpt, "--smoke",
                  "--budget", "0.5", "--batch", "4", "--n", "4", "--out", out, "--device", "cpu"])
    doc = json.load(open(out))
    assert doc["accel_exercised_by_production_path"] is False and doc["noise_floor"] is None
    assert list(doc["methods"]) == ["euler_8"]
    assert doc["recommendation"]["sample_block"]["multistep_order"] == 1


def test_requires_checkpoint(setup):
    with pytest.raises(SystemExit, match="trained checkpoint"):
        port_at.main(["--config", setup[0], "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("floor", [0.004, 0.0001, None])
@pytest.mark.parametrize("gated", [False, True])
def test_full_ladder_matches_jax(setup, tmp_path, monkeypatch, floor, gated):
    """The production ladder (not --smoke) of the JAX CLI, its sampler
    replaced by the identity so nothing is sampled, against the port's
    ``ladder`` for the same noise floor."""
    from vavae_tpu.apps.autotune_sampler import main as jax_main
    from vavae_tpu.transport import Sampler

    def fake(self, **kw):
        def fn(zz, cond, cfgf):
            if kw.get("return_stats"):
                return zz, {"cfg_evals": jnp.int32(1),
                            "noise_floor": jnp.float32(np.nan if floor is None else floor)}
            return zz
        return fn

    monkeypatch.setattr(Sampler, "sample_ode_cfg", fake)
    cfg_path, ckpt, _ = setup
    if gated:
        cfg_path = _gated_config(cfg_path, tmp_path)
    out = str(tmp_path / "ladder.json")
    jax_main(["--config", cfg_path, "--ckpt", ckpt, "--n", "8", "--batch", "8", "--out", out])
    doc = json.load(open(out))
    jax_floor = doc["noise_floor"]
    assert (jax_floor is None) == (floor is None or gated)
    want = [(label, row["rec"]) for label, row in doc["methods"].items()]
    got = port_at.ladder(False, not gated, 250, port_at.tolerance_candidates(jax_floor))
    assert got == want and len(got) == (3 if gated else 9 + len({r["tol"] for _, r in got[9:]}))


@pytest.mark.parametrize("block", [
    {"sampling_method": "euler", "num_sampling_steps": 250, "multistep_order": 1,
     "velocity_cache_interval": 1, "velocity_cache_adaptive": False, "mode": "ODE",
     "cfg_scale": 10.0, "timestep_shift": 0.3, "cfg_interval_start": 0.11, "cfg_channels": None},
    {"sampling_method": "heun", "num_sampling_steps": 83, "velocity_cache_adaptive": True,
     "velocity_cache_tol": 1e-05, "velocity_cache_max_interval": 8, "reverse": True,
     "null_class": 31, "cfg_scale": 4, "timestep_shift": 1e20, "mode": "yes", "a": "y",
     "b": "No", "c": "Null", "d": "nan",
     "x": 0.0001, "y": 2.5e-08, "z": -3.0},
])
def test_sample_block_yaml_matches_pyyaml(block):
    """The overlay's ``sample:`` block, as ``autotune_sampler.main`` writes it."""
    text = yaml_io.safe_dump({"sample": block})
    assert text == yaml.safe_dump({"sample": block}, sort_keys=False)
    assert yaml.safe_load(text) == {"sample": block} == yaml_io.safe_load(text)

"""Real worlds of two processes over gloo (mirrors tests/test_multihost.py
and tests/multihost_worker.py, at their small sizes).

Two launches through ``multihost_init``'s environment contract
(``tests/torch_dist_worker.py``): one with torchrun's variables runs a DiT
step and a VA-VAE GAN step on rank shards, the process-indexed names and a
checkpoint by rank 0; one with the JAX package's variables runs the
pipelines as a user runs them (``do_train`` under DP, FSDP and TP,
``sample``, ``extract_features``, ``evaluate_tokenizer``). Each result is
held against the same work done in this process, a world of 1.
"""
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from test_torch_common import one_thread, tiny_vae_config  # noqa: F401
from vavae_tpu_torch.utils.safetensors_io import read_safetensors

pytestmark = pytest.mark.usefixtures("one_thread")

LR = W.TRAIN_OPT["lr"]


# -- the DiT and VA-VAE steps ----------------------------------------------------------


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The world of 2's results, and one process's on the global batch,
    computed while the world runs."""
    out = tmp_path_factory.mktemp("multihost")
    world = W.Launch(["multihost", "classifier"], 2, out)
    model = W.tiny_dit(hidden_size=32, num_heads=2, num_classes=4, class_dropout_prob=0.0)
    tr = W.dit_trainer(model)
    dit_loss = W.run_dit_steps(tr, tr.init_state(), W.dit_batches(1, seed=7, classes=4))[0][0]
    vtr, vst = W.tiny_vae_trainer()
    vae = {"metrics": {k: v.item() for k, v in vtr.train_step(vst, W.vae_images()).items()},
           "state": W.vae_state_dict(vst), "bn_mean": vtr.disc.bn1.batch_moments[0].clone()}
    classifier = {mode: W.run_classifier(kw) for mode, kw in W.CLASSIFIER_CASES.items()}
    world.wait()
    load = lambda case: [torch.load(out / f"{case}_{r}.pt", weights_only=False) for r in range(2)]  # noqa: E731
    return {"out": out, "multihost": load("multihost"), "classifier": load("classifier"),
            "one": {"dit_loss": dit_loss, "vae": vae, "classifier": classifier}}


def test_dit_step_matches_single_process(steps):
    """Both ranks report the same global loss, within 1e-5 of the single
    process's step on the global batch (tests/test_multihost.py:90)."""
    r0, r1 = steps["multihost"]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], steps["one"]["dit_loss"], rtol=1e-5)


def test_vae_gan_step_matches_single_process(steps):
    """The two-optimizer GAN step with the global d_weight and the
    synchronised batch norm: every loss and weight equal on both ranks; the
    losses within 1e-5 of the single process's step on the global batch,
    the batch-norm moments and running stats too, both optimizers' moments
    (the gradients) within 1e-5 relative; the weights within 1e-4 relative,
    each element within 2·lr (Adam's first step moves a weight by ±lr
    whatever its gradient's size, so one near-zero gradient of opposite
    rounding flips it)."""
    r0, r1 = steps["multihost"]
    one = steps["one"]["vae"]
    assert r0["vae"] == r1["vae"]
    for k in r0["vae_state"]:
        assert torch.equal(r0["vae_state"][k], r1["vae_state"][k]), k
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["vae"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert r0["vae"]["d_weight"] > 0
    torch.testing.assert_close(r0["bn_mean"], one["bn_mean"], rtol=1e-5, atol=1e-7)
    want, got = one["state"], r0["vae_state"]
    for prefix in ("gen_opt.mu.", "disc_opt.nu."):
        keys = [k for k in want if k.startswith(prefix)]
        assert W.rel([got[k] for k in keys], [want[k] for k in keys]) < 1e-5, prefix
    stats = [k for k in want if "running" in k]
    assert W.rel([got[k] for k in stats], [want[k] for k in stats]) < 1e-5
    weights = [k for k in want if not k.startswith(("gen_opt", "disc_opt", "step")) and k not in stats]
    assert W.rel([got[k] for k in weights], [want[k] for k in weights]) < 1e-4
    assert max((got[k] - want[k]).abs().max().item() for k in weights) <= 2 * 1e-4 + 1e-7


@pytest.mark.parametrize("mode", list(W.CLASSIFIER_CASES))
def test_classifier_step_matches_single_process(steps, mode):
    """The user classifier, data-parallel (synchronised batch norm; mixup
    over the gathered batch; the global dropout masks; the contrastive term
    and the memory and prototype banks on the gathered batch), against one
    process on the global batch: both ranks equal; the first step's loss
    and accuracy within 1e-5, its gradient (Adam's first moment), batch-norm
    stats and banks within 1e-4 relative (5e-3 under mixup: there, merely
    permuting the batch's rows, with the mixing permutation to match, moves
    one process's first gradient by 1.1e-3 in fp32), its weights within
    2·lr; the second step's loss within 1e-2 (the first Adam step moves a
    weight by ±lr whatever its gradient's size, so a near-zero gradient of
    opposite rounding flips it, and the second step starts from such
    weights: 0.47% under mixup, whose soft targets leave many gradients
    near zero)."""
    (l0, a0, t0), (l1, a1, t1) = (res[mode] for res in steps["classifier"])
    assert (l0, a0) == (l1, a1)
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k
    losses, accs, want = steps["one"]["classifier"][mode]
    np.testing.assert_allclose(l0[0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(l0[1], losses[1], rtol=1e-2)
    np.testing.assert_allclose(a0[0], accs[0], rtol=1e-6)
    assert sorted(t0) == sorted(want)
    exact = [k for k in want if k == "mu" or "running" in k or k.startswith("extras")]
    tol = 5e-3 if W.CLASSIFIER_CASES[mode].get("use_mixup") else 1e-4
    for k in exact:
        assert W.rel([t0[k]], [want[k]]) < tol or torch.equal(t0[k], want[k]), k
    lr = 1e-3
    assert max((t0[k] - want[k]).abs().max().item() for k in want if k not in exact) <= 2 * lr


def test_names_and_checkpoint_by_rank_zero(steps):
    """Rank-distinct process_fname; the checkpoint is written by rank 0 only
    and holds the step's state."""
    out, (r0, r1) = steps["out"], steps["multihost"]
    assert r0["fname"] == "latents_rank00_shard000.safetensors"
    assert r1["fname"] == "latents_rank01_shard000.safetensors"
    assert r0["ckpt"].endswith("0000001.safetensors") and r1["ckpt"] == ""
    assert sorted(os.listdir(out / "mh_ckpt")) == ["0000001.safetensors"]
    assert int(read_safetensors(r0["ckpt"])[0]["step"]) == 1


# -- the pipelines, as a user runs them ------------------------------------------------------


VARIANTS = {"S": dict(depth=2, hidden_size=144, num_heads=2)}


def _train_cfg(root, data, name, parallel=None):
    from vavae_tpu_torch.utils.config import Config

    cfg = {
        "data": {"data_path": data, "valid_path": data, "image_size": 16, "num_classes": 10,
                 "latent_norm": True, "latent_multiplier": 1.0},
        "vae": {"downsample_ratio": 2},
        "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                  "use_rmsnorm": True, "in_chans": 4},
        "transport": {"path_type": "Linear", "prediction": "velocity", "use_cosine_loss": True,
                      "use_lognorm": True},
        "train": {"max_steps": 4, "global_batch_size": 4, "output_dir": str(root / name),
                  "exp_name": "tiny", "log_every": 2, "ckpt_every": 2, "ema_decay": 0.9,
                  "patience": 5, "sample_every": 2},
        "sample": {"num_sampling_steps": 2, "cfg_scale": 1.0},
        "optimizer": {"lr": LR, "max_grad_norm": 1.0},
    }
    if parallel:
        cfg["parallel"] = parallel
    return Config(cfg)


def _write_inputs(root):
    from vavae_tpu_torch.utils.png import write_pngs
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    rs = np.random.default_rng(0)
    data = root / "latents"
    data.mkdir()
    for i, n in enumerate((10, 10)):
        lat = (3.0 * rs.standard_normal((n, 4, 8, 8)) + 1.0).astype(np.float32)
        write_safetensors(str(data / f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 10, (n,)).astype(np.int32)})
    images = root / "images"
    for c in range(2):
        (images / f"class_{c}").mkdir(parents=True)
        imgs = rs.integers(0, 256, (5, 20 + 4 * c, 18, 3), dtype=np.uint8)
        write_pngs(imgs, [str(images / f"class_{c}" / f"{i:02d}.png") for i in range(5)])
    return str(data), str(images)


def _app_inputs(root, data, vae_cfg, ckpt):
    """The micro-Doppler apps' config (two users, the world-1 DiT checkpoint)
    and a fresh baseline classifier file."""
    import yaml

    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, save_classifier

    clf = ClassifierTrainer(num_classes=10, device="cpu")
    clf_path = save_classifier(str(root / "clf.safetensors"), clf, clf.init_state(0))
    cfg = {"ckpt_path": str(ckpt),
           "data": {"image_size": 16, "num_classes": 10, "num_users": 2, "latent_norm": True,
                    "data_path": data},
           "vae": {"downsample_ratio": 2, "config": vae_cfg},
           "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                     "use_rmsnorm": True, "in_chans": 4},
           "transport": {"path_type": "Linear", "prediction": "velocity"},
           "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 2,
                      "cfg_scale": 4.0},
           "train": {"global_seed": 0}}
    path = root / "app.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), clf_path


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The world of 2 (JAX's variables) and a world of 1 in this process,
    on the same files, run side by side."""
    import vavae_tpu_torch.models.dit as dit
    from vavae_tpu_torch.apps import generate_and_filter, iterative_finetune
    from vavae_tpu_torch.apps.lora_finetune import export_merged
    from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset
    from vavae_tpu_torch.pipelines.evaluate_tokenizer import evaluate_tokenizer
    from vavae_tpu_torch.pipelines.extract_features import extract
    from vavae_tpu_torch.pipelines.sample import do_sample
    from vavae_tpu_torch.pipelines.train_dit import do_train
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.utils.config import Config

    root = tmp_path_factory.mktemp("pipelines")
    data, images = _write_inputs(root)
    vae_cfg = tiny_vae_config(root)
    train = {"dp": _train_cfg(root, data, "w2_dp", {"data": -1}),
             "fsdp": _train_cfg(root, data, "w2_fsdp", {"fsdp": 2}),
             "tp": _train_cfg(root, data, "w2_tp", {"tensor": 2})}
    ImgLatentDataset(data, latent_norm=True)  # the stats cache, before both worlds read it
    old = dict(dit._VARIANTS)
    dit._VARIANTS.update(VARIANTS)
    torch.manual_seed(3)
    model = dit.create_dit(train["dp"].model, 8, 10, device="cpu")
    dit._VARIANTS.clear()
    dit._VARIANTS.update(old)
    ckpt = export_merged(str(root), 5, model.state_dict())  # the samplers' DiT
    sample = Config({
        "ckpt_path": str(ckpt), "data": {"image_size": 16, "num_classes": 10,
                                         "latent_norm": False},
        "vae": {"downsample_ratio": 2, "config": vae_cfg},
        "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                  "use_rmsnorm": True, "in_chans": 4},
        "transport": {"path_type": "Linear", "prediction": "velocity"},
        "sample": {"mode": "ODE", "sampling_method": "euler", "num_sampling_steps": 2,
                   "cfg_scale": 1.0, "per_proc_batch_size": 1, "fid_num": 4},
        "train": {"global_seed": 0}, "sample_folder": str(root / "samples_w2"),
    })
    spec = {"variants": VARIANTS, "train": train, "sample": sample, "vae_config": vae_cfg,
            "image_size": 16, "images": images, "posterior_mode": True,
            "extract_kw": dict(batch_size=2, image_size=16, shard_size=100),
            "eval_kw": dict(max_images=8, batch_size=2, image_size=16, sample_posterior=False)}
    app_cfg, clf_path = _app_inputs(root, data, vae_cfg, ckpt)

    def apps(tag):  # generate_and_filter.run's and iterative_finetune.main's arguments
        from vavae_tpu_torch.apps.generate_and_filter import FilterConfig

        return (dict(config_path=app_cfg, user_ids=list(range(10)), classifier_ckpt=clf_path,
                     filter_cfg=FilterConfig(confidence_threshold=0.0, target_per_user=100,
                                             batch_size=2, max_batches=1, pixel_range=None),
                     save_dir=str(root / f"filtered_{tag}"), device="cpu"),
                ["--config", app_cfg, "--classifier_ckpt", clf_path, "--iterations", "2",
                 "--steps_per_iteration", "2", "--samples_per_user", "2", "--confidence", "0",
                 "--batch_size", "4", "--out_dir", str(root / f"iter_{tag}"), "--device", "cpu"])

    spec["filter_kw"], spec["iterative_argv"] = apps("w2")
    spec["preempt"] = _train_cfg(root, data, "w2_preempt", {"fsdp": 2}).merged_with(
        {"train": {"max_steps": 8}})

    torch.save(spec, root / "pipelines.pt")
    world = W.Launch(["pipelines", "preempt"], 2, root, env_style="jax",
                     extra_env={"VAVAE_FID_WEIGHTS": "", "VAVAE_LPIPS_WEIGHTS": ""})
    dit._VARIANTS.update(VARIANTS)
    orig_encode = VA_VAE.encode_images
    try:
        one = {"train": do_train(_train_cfg(root, data, "w1"), device="cpu").step}
        one["sample"] = sorted(os.listdir(do_sample(
            sample.merged_with({"sample_folder": str(root / "samples_w1")}), device="cpu")))
        VA_VAE.encode_images = lambda self, images, generator=None: (
            self.encode_moments(images).mode())
        vae = VA_VAE(vae_cfg, img_size=16, device="cpu")
        extract(images, str(root / "latents_1"), vae, **spec["extract_kw"])
        one["eval"] = evaluate_tokenizer(vae, images, output_path=str(root / "eval_1"),
                                         **spec["eval_kw"])
        VA_VAE.encode_images = orig_encode
        filter_kw, iterative_argv = apps("w1")
        one["filter"] = generate_and_filter.run(**filter_kw)
        _, one["history"], _ = iterative_finetune.main(iterative_argv)
    finally:
        VA_VAE.encode_images = orig_encode
        dit._VARIANTS.clear()
        dit._VARIANTS.update(old)
    world.wait()
    two = [torch.load(root / f"pipelines_{r}.pt", weights_only=False)
           | torch.load(root / f"preempt_{r}.pt", weights_only=False) for r in range(2)]
    return root, one, two


@pytest.mark.parametrize("layout", ["dp", "fsdp", "tp"])
def test_do_train_world_two_writes_world_one_checkpoint(pipelines, layout):
    """do_train over two processes (data-parallel, FSDP, tensor-parallel)
    writes, once, the checkpoints a single process writes on the same global
    batches: every tensor of the last one (params, EMA, Adam moments) within
    1e-4 relative, each weight within 2·lr a step of it."""
    root, one, two = pipelines
    assert two[0][layout] == two[1][layout] == one["train"] == 4
    w2 = root / f"w2_{layout}" / "tiny" / "checkpoints"
    w1 = root / "w1" / "tiny" / "checkpoints"
    assert sorted(os.listdir(w2)) == sorted(os.listdir(w1))
    got, _ = read_safetensors(str(w2 / "0000004.safetensors"))
    want, _ = read_safetensors(str(w1 / "0000004.safetensors"))
    assert sorted(got) == sorted(want)
    for group in ("params|", "ema_params|", "opt_state|torch_adamw|mu|",
                  "opt_state|torch_adamw|nu|"):
        keys = [k for k in want if k.startswith(group)]
        assert W.rel([got[k] for k in keys], [want[k] for k in keys]) < 1e-4, group
    keys = [k for k in want if k.startswith("params|")]
    assert max(np.abs(got[k] - want[k]).max() for k in keys) <= 4 * 2 * LR
    assert int(got["step"]) == 4


@pytest.mark.parametrize("layout", ["dp", "fsdp", "tp"])
def test_do_train_samples_under_every_layout(pipelines, layout):
    """do_train's in-training EMA samples (sample_every 2) under DP, FSDP
    and tensor parallelism: every rank gathers the EMA, process 0 samples
    from it in an unsharded model and writes world 1's files, the latents
    within 1e-4 relative of world 1's."""
    root, _, _ = pipelines
    w2 = root / f"w2_{layout}" / "tiny" / "train_samples"
    w1 = root / "w1" / "tiny" / "train_samples"
    assert sorted(os.listdir(w1)) == ["step0000002_latents.npy", "step0000004_latents.npy"]
    assert sorted(os.listdir(w2)) == sorted(os.listdir(w1))
    for name in os.listdir(w1):
        assert W.rel([np.load(w2 / name)], [np.load(w1 / name)]) < 1e-4, name


def test_preemption_reaching_one_rank_stops_every_rank(pipelines):
    """A preemption signal that reaches rank 1 alone, after step 3 of an
    FSDP do_train: both ranks agree to stop at step 3 and write the
    checkpoint of that step, gathered, once."""
    root, _, two = pipelines
    assert two[0]["step"] == two[1]["step"] == 3
    ckpts = root / "w2_preempt" / "tiny" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0000002.safetensors", "0000003.safetensors",
                                         "config.json"]
    assert int(read_safetensors(str(ckpts / "0000003.safetensors"))[0]["step"]) == 3


def test_sample_writes_rank_interleaved_names(pipelines):
    """Two processes write the JAX package's rank-interleaved names
    ((i·world + rank)·per_batch + j), which together are world 1's set."""
    root, one, two = pipelines
    per_batch, world, iters = 1, 2, 2
    want = sorted(f"{(i * world + r) * per_batch + j:06d}.png"
                  for i in range(iters) for r in range(world) for j in range(per_batch))
    assert two[0]["sample"] == two[1]["sample"] == want == one["sample"]


def test_extract_rank_shards_union_is_world_one(pipelines):
    """extract_features over two processes writes rank00 and rank01 shards,
    item i on rank i % 2; interleaved again they are world 1's shard, and
    the statistics over both equal world 1's."""
    root, _, _ = pipelines
    w2, w1 = root / "latents_w", root / "latents_1"
    assert sorted(os.listdir(w2)) == ["latents_rank00_shard000.safetensors",
                                      "latents_rank01_shard000.safetensors",
                                      "latents_stats.safetensors"]
    ranks = [read_safetensors(str(w2 / f"latents_rank{r:02d}_shard000.safetensors"))[0]
             for r in range(2)]
    one = read_safetensors(str(w1 / "latents_rank00_shard000.safetensors"))[0]
    for key in ("latents", "latents_flip", "labels"):
        inter = np.empty_like(one[key])
        inter[0::2], inter[1::2] = ranks[0][key], ranks[1][key]
        np.testing.assert_allclose(inter, one[key], rtol=1e-5, atol=1e-6, err_msg=key)
    s2 = read_safetensors(str(w2 / "latents_stats.safetensors"))[0]
    s1 = read_safetensors(str(w1 / "latents_stats.safetensors"))[0]
    for key in ("mean", "std"):
        np.testing.assert_allclose(s2[key], s1[key], rtol=1e-5, atol=1e-6)


def test_evaluate_tokenizer_sums_over_ranks(pipelines):
    """evaluate_tokenizer over two processes: the summed metrics equal world
    1's on both ranks; the PNGs carry the rank's tag."""
    root, one, two = pipelines
    assert two[0]["eval"] == two[1]["eval"]
    assert two[0]["eval"]["num_images"] == one["eval"]["num_images"] == 8
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(two[0]["eval"][key], one["eval"][key], rtol=1e-5)
    names = sorted(os.listdir(root / "eval_w" / "dec"))
    assert names == sorted(f"{r:02d}_{i:06d}.png" for r in range(2) for i in range(4))


def test_generate_and_filter_stripes_users(pipelines):
    """generate_and_filter over two processes: rank r takes users r, r + 2,
    …; together their results and files are world 1's."""
    root, one, two = pipelines
    assert sorted(two[0]["filter"]) == [0, 2, 4, 6, 8]
    assert sorted(two[1]["filter"]) == [1, 3, 5, 7, 9]
    assert {**two[0]["filter"], **two[1]["filter"]} == one["filter"]
    assert sum(s["accepted"] for s in one["filter"].values()) > 0

    def tree(path):
        return sorted(os.path.relpath(os.path.join(d, f), path)
                      for d, _, files in os.walk(path) for f in files)

    assert tree(root / "filtered_w2") == tree(root / "filtered_w1")


def test_iterative_finetune_data_parallel(pipelines):
    """iterative_finetune over two processes, each on its rows of the real
    and synthetic batches: both ranks report world 1's rounds (accepted
    counts equal, final losses within 1e-4), and the state written once is
    world 1's within 1e-4 relative."""
    root, one, two = pipelines
    assert two[0]["history"] == two[1]["history"]
    for got, want in zip(two[0]["history"], one["history"]):
        assert got["accepted"] == want["accepted"]
        np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    (name,) = [n for n in os.listdir(root / "iter_w1") if n.endswith(".safetensors")]
    assert sorted(os.listdir(root / "iter_w2")) == sorted(os.listdir(root / "iter_w1"))
    got = read_safetensors(str(root / "iter_w2" / name))[0]
    want = read_safetensors(str(root / "iter_w1" / name))[0]
    keys = [k for k in want if k.startswith(("params|", "ema_params|"))]
    assert W.rel([got[k] for k in keys], [want[k] for k in keys]) < 1e-4

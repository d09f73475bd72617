"""The micro-Doppler user classifiers of the port against the JAX package,
on the CPU: the ResNet-18 and domain-adaptive fp32 forwards in eval and
train mode against the JAX modules in float64 (1e-4 relative; each running
stat after a train forward 1e-5, relative Frobenius),
the prototype bank, every regularisation function on the same inputs and
draws (1e-5), one fp32 ``ClassifierTrainer`` step per mode from the JAX state against
the JAX trainer's step in float64 (weights, batch-norm stats, Adam moments
and extras within 1e-4 relative),
freeze tiers, classifier files across the two packages, the torch weight
bridges, and ``classifier_eval`` against its JAX original."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import one_thread, randomize  # noqa: F401
from test_torch_train import _frob_rel
from vavae_tpu.apps import classifier_eval as jeval
from vavae_tpu.apps import regularization as jreg
from vavae_tpu.models import resnet as jres
from vavae_tpu_torch.apps import classifier_eval as teval
from vavae_tpu_torch.apps import regularization as treg
from vavae_tpu_torch.models import resnet as tres
from vavae_tpu_torch.utils.weights import resnet_state_from_jax, resnet_state_to_jax

pytestmark = pytest.mark.usefixtures("one_thread")

S = 32  # image size
TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _variables(module, seed, **kw):
    """The JAX module's variables: params redrawn by ``randomize``, running
    stats moved off 0/1."""
    variables = jax.device_get(jax.jit(lambda k: module.init(
        {"params": k}, jnp.zeros((1, S, S, 3)), train=False, return_all=True, **kw))(
            jax.random.PRNGKey(0)))
    rs = np.random.default_rng(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rs.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
                      else 0.1 * rs.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": randomize(variables["params"], seed), "batch_stats": stats}


def _images(seed, B=4):
    return np.random.default_rng(seed).uniform(-1, 1, (B, S, S, 3)).astype(np.float32)


MODELS = {
    "resnet18": lambda dtype=jnp.float32: (jres.ResNet18(num_classes=5, dtype=dtype),
                                           tres.ResNet18(5)),
    "improved": lambda dtype=jnp.float32: (
        jres.ResNet18(num_classes=5, head_dim=256, proj_dim=64, dtype=dtype),
        tres.ResNet18(5, head_dim=256, proj_dim=64)),
    "domain_adaptive": lambda dtype=jnp.float32: (
        jres.DomainAdaptiveClassifier(num_classes=5, dropout_rate=0.3, dtype=dtype),
        tres.DomainAdaptiveClassifier(5, dropout_rate=0.3)),
}


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


def _dropout_masks(inter):
    """The keep masks of flax's two Dropout modules from a forward's captured
    outputs: where an output is non-zero the unit was kept (a zero input
    gives 0 either way)."""
    return [torch.from_numpy(np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(2)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_classifier_forward_matches_jax(name, train):
    """The port's fp32 forward against the JAX module's in float64 (under
    ``jax.enable_x64``; the JAX fp32 forward itself lands about 1e-5 from it
    in the heads' running stats): outputs 1e-4, each running stat after a
    train forward 1e-5 (relative Frobenius; 2e-5 for the domain-adaptive
    heads, whose batch norms average four 1-d samples). The domain-adaptive backbone
    has no ``fc`` (the trees match); in train mode the port takes flax's
    dropout masks."""
    jm, tm = MODELS[name]()
    variables = _variables(jm, 1)
    if name == "domain_adaptive":
        assert "fc" not in variables["params"]["backbone"]
    tm.load_state_dict(resnet_state_from_jax(variables), strict=True)
    x = _images(2)
    masks = None
    with jax.enable_x64(True):
        jm64 = MODELS[name](jnp.float64)[0]
        v64, x64 = _float64(variables), x.astype(np.float64)
        if train:
            out, upd = jm64.apply(v64, x64, train=True, return_all=True,
                                  mutable=["batch_stats", "intermediates"],
                                  capture_intermediates=True,
                                  rngs={"dropout": jax.random.PRNGKey(9)})
            if name == "domain_adaptive":
                masks = _dropout_masks(upd["intermediates"])
                assert 0 < float(masks[0].float().mean()) < 1
        else:
            out, upd = jm64.apply(v64, x64, train=False, return_all=True), None
        out = jax.device_get(out)
        upd = jax.device_get(upd)
    kw = {"dropout_masks": masks} if name == "domain_adaptive" else {}
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train, return_all=True, **kw)
    for g, w in zip(got, out):
        if w is None:
            assert g is None
        else:
            assert _rel(g.numpy(), w) < TOL
    if train:
        sd = resnet_state_to_jax(tm.state_dict())["batch_stats"]
        flat_w = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]}
        flat_g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(sd)[0]}
        assert sorted(flat_g) == sorted(flat_w)
        for k in flat_w:
            # the heads' batch norms average 4 samples of a 1-d feature: fp32
            # lands 1.4e-5 from exact there (ROADMAP, recorded deviations)
            tol = 2e-5 if k.startswith(("['proj_bn']", "['cls_bn']")) else 1e-5
            assert _rel(flat_g[k], flat_w[k]) < tol, k


def test_feature_bank_and_similarity_match_jax():
    rs = np.random.default_rng(5)
    bank = rs.standard_normal((4, 16)).astype(np.float32)
    feats = rs.standard_normal((6, 16)).astype(np.float32)
    labels = np.array([1, 1, 3, 0, 1, 3], np.int32)
    want = np.asarray(jres.update_feature_bank(jnp.asarray(bank), feats, labels))
    got = tres.update_feature_bank(torch.from_numpy(bank.copy()), torch.from_numpy(feats),
                                   torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tres.feature_similarity(torch.from_numpy(got), torch.from_numpy(feats)).numpy(),
        np.asarray(jres.feature_similarity(want, feats)), rtol=1e-5, atol=1e-6)


def test_torch_bridges_match_jax():
    """``resnet18_state_from_torch`` / ``domain_adaptive_state_from_torch``
    give the weights the JAX package's ``*_params_from_torch`` give."""
    from vavae_tpu_torch.utils.weights import (
        domain_adaptive_state_from_torch,
        resnet18_state_from_torch,
    )

    tm = tres.ResNet18(7)
    with torch.no_grad():
        for p in list(tm.parameters()) + list(tm.buffers()):
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    tv = {}  # the torchvision names of the same weights
    for k, v in tm.state_dict().items():
        k = k.replace(".down_conv.", ".downsample.0.").replace(".down_bn.", ".downsample.1.")
        tv[k[:5] + k[5:].replace("_", ".", 1) if k.startswith("layer") else k] = v
    tv["layer1.0.bn1.num_batches_tracked"] = torch.tensor(3)
    got = resnet18_state_from_torch(tv)
    want = resnet_state_from_jax(jres.resnet18_params_from_torch(
        {k: v.numpy() for k, v in tv.items()}))
    assert sorted(got) == sorted(want) == sorted(tm.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = {f"backbone.{k}": v for k, v in tv.items()}
    for new, old in (("proj_fc", "feature_projector.0"), ("cls_fc1", "classifier.0"),
                     ("cls_fc2", "classifier.4")):
        ref[f"{old}.weight"] = torch.randn(8, 8)
        ref[f"{old}.bias"] = torch.randn(8)
    for old in ("feature_projector.1", "classifier.1"):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            ref[f"{old}.{leaf}"] = torch.randn(8)
    ref["feature_bank"] = torch.randn(5, 8)
    got, bank = domain_adaptive_state_from_torch(ref)
    jax_tree = jres.domain_adaptive_params_from_torch({k: v.numpy() for k, v in ref.items()})
    want = resnet_state_from_jax(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(bank.numpy(), jax_tree["feature_bank"])


# -- regularization -----------------------------------------------------------------


def _reg_inputs(seed=0, B=8, K=5):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((B, K)).astype(np.float32), rs.integers(0, K, (B,)).astype(np.int32),
            rs.standard_normal((B, 6, 6, 3)).astype(np.float32),
            rs.standard_normal((B, 16)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _case_losses():
    logits, labels, _, _ = _reg_inputs()
    lg, lb = _t(logits, labels)
    return [(treg.smooth_labels(lb, 5, 0.1), jreg.smooth_labels(labels, 5, 0.1)),
            (treg.label_smoothing_loss(lg, lb, 0.1), jreg.label_smoothing_loss(logits, labels, 0.1)),
            (treg.focal_loss(lg, lb), jreg.focal_loss(logits, labels))]


def _case_mixup():
    _, labels, x, _ = _reg_inputs(1)
    rng = jax.random.PRNGKey(4)
    lam_rng, perm_rng = jax.random.split(rng)  # mixup's own draws
    lam = float(jax.random.beta(lam_rng, 0.2, 0.2))
    perm = torch.from_numpy(np.array(jax.random.permutation(perm_rng, x.shape[0])))
    want = jreg.mixup(rng, x, labels, 5, alpha=0.2)
    got = treg.mixup(*_t(x, labels), 5, 0.2, lam=lam, perm=perm)
    return list(zip(got, want))


def _case_cutmix():
    _, labels, x, _ = _reg_inputs(2)
    rng = jax.random.PRNGKey(6)
    lam_rng, perm_rng, pos_rng = jax.random.split(rng, 3)
    lam = float(jax.random.beta(lam_rng, 1.0, 1.0))
    perm = torch.from_numpy(np.array(jax.random.permutation(perm_rng, x.shape[0])))
    cy = int(jax.random.randint(pos_rng, (), 0, 6))
    cx = int(jax.random.randint(jax.random.fold_in(pos_rng, 1), (), 0, 6))
    want = jreg.cutmix(rng, x, labels, 5, alpha=1.0)
    got = treg.cutmix(*_t(x, labels), 5, 1.0, lam=lam, perm=perm, cy=cy, cx=cx)
    return list(zip(got, want))


def _case_label_noise():
    _, labels, _, _ = _reg_inputs(3, B=64)
    rng = jax.random.PRNGKey(8)
    flip_rng, new_rng = jax.random.split(rng)
    flip = jax.random.uniform(flip_rng, labels.shape) < 0.3
    rand = jax.random.randint(new_rng, labels.shape, 0, 5)
    want = jreg.add_label_noise(rng, labels, 5, 0.3)
    got = treg.add_label_noise(*_t(labels), 5, 0.3, flip=torch.from_numpy(np.array(flip)),
                               random_labels=torch.from_numpy(np.array(rand)))
    assert (np.asarray(want) != labels).any()
    return [(got, want)]


def _case_contrastive():
    _, labels, _, feats = _reg_inputs(4, B=12)
    labels = labels % 4
    norm = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    f, lb, fn = _t(feats, labels, norm)
    return [(treg.supcon_loss(fn, lb), jreg.supcon_loss(norm, labels)),
            (treg.interuser_contrastive_loss(f, lb), jreg.interuser_contrastive_loss(feats, labels))]


def _case_memory_bank():
    """The bank's update (a class over memory_size times in the batch: the
    last samples win) and the global-negative loss against it."""
    rs = np.random.default_rng(5)
    bank = rs.standard_normal((3, 4, 16)).astype(np.float32)
    memory = {"bank": bank, "ptr": np.array([0, 3, 1], np.int32)}
    feats = rs.standard_normal((9, 16)).astype(np.float32)
    labels = np.array([1, 1, 2, 1, 0, 1, 1, 1, 2], np.int32)
    jm = jreg.update_memory_bank(memory, feats, labels)
    tm = treg.update_memory_bank({"bank": torch.from_numpy(bank), "ptr": torch.from_numpy(
        memory["ptr"])}, *_t(feats, labels))
    out = [(tm["bank"], jm["bank"]), (tm["ptr"], jm["ptr"])]
    for margin in (0.5, 50.0):  # with hard negatives, and without any
        out.append((treg.global_negative_contrastive(*_t(feats, labels), tm, margin=margin,
                                                     bank_pos=3, bank_neg=2),
                    jreg.global_negative_contrastive(feats, labels, jm, margin=margin,
                                                     bank_pos=3, bank_neg=2)))
    return out


def _case_calibration():
    logits, labels, _, _ = _reg_inputs(6, B=64)
    probs = np.asarray(jax.nn.softmax(logits * 3))
    sched_t = treg.warmup_cosine_schedule(1e-3, 5, 50, 1e-5)
    sched_j = jreg.warmup_cosine_schedule(1e-3, 5, 50, 1e-5)
    return [(treg.expected_calibration_error(*_t(probs, labels)),
             jreg.expected_calibration_error(probs, labels)),
            (np.array([sched_t(c) for c in range(0, 60, 7)]),
             np.array([float(sched_j(c)) for c in range(0, 60, 7)])),
            (treg.dropout_schedule(30, 100), jreg.dropout_schedule(30, 100))]


@pytest.mark.parametrize("case", ["losses", "mixup", "cutmix", "label_noise", "contrastive",
                                  "memory_bank", "calibration"])
def test_regularization_matches_jax(case):
    for got, want in globals()[f"_case_{case}"]():
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_memory_bank_init_is_normalised():
    memory = treg.init_memory_bank(3, 8, 5, torch.Generator().manual_seed(0))
    assert memory["bank"].shape == (3, 5, 8) and memory["ptr"].dtype == torch.int32
    np.testing.assert_allclose(torch.linalg.vector_norm(memory["bank"], dim=-1).numpy(), 1.0,
                               rtol=1e-6)


# -- the trainer ---------------------------------------------------------------------


STEP_MODES = {
    "baseline": dict(mode="baseline"),
    "improved_supcon": dict(mode="improved"),
    "improved_global": dict(mode="improved", contrastive_type="global", memory_size=8),
    "calibrated_mixup": dict(mode="calibrated", use_mixup=True),
    "domain_adaptive": dict(mode="domain_adaptive", contrastive_type="interuser"),
}


def _jax_trainer(**kw):
    from vavae_tpu.apps.train_classifier import ClassifierTrainer as JaxTrainer
    from vavae_tpu.parallel.mesh import make_mesh

    return JaxTrainer(num_classes=4, lr=1e-3, mesh=make_mesh(devices=jax.devices("cpu")[:1]), **kw)


def _port_state(tmp_path, jt, js, **kw):
    """The port trainer and a state read from the JAX state's file."""
    from vavae_tpu.train.checkpoint import save_state_file
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier

    path = save_state_file(str(tmp_path / "jax.safetensors"), js)
    pt = ClassifierTrainer(num_classes=4, lr=1e-3, device="cpu", **kw)
    return pt, restore_classifier(path, pt, pt.init_state(7))


GRAD_FLOOR = 1e-5  # |g| above fp32 noise, where Adam's first update is sign-stable


def _flat_moments(tree):
    from vavae_tpu_torch.train.checkpoint import find_adam
    from flax import serialization

    return find_adam(serialization.to_state_dict(tree))


@pytest.mark.parametrize("name", list(STEP_MODES))
def test_trainer_step_matches_jax(tmp_path, name):
    """One fp32 step of the port from the JAX init (its file read by the
    port) against the JAX trainer's step in float64 (its modules built with
    ``dtype=float64`` under ``jax.enable_x64``): the JAX package's own fp32
    gradients of the lower stages lie about 8e-3 from exact on this input,
    the port's 4e-6 (ROADMAP, recorded deviations). The JAX draws are handed
    to the port (mixup's λ and permutation); domain-adaptive dropout is off
    (flax's masks are taken in test_domain_adaptive_forward_matches_jax)."""
    kw = dict(STEP_MODES[name])
    if kw["mode"] == "domain_adaptive":
        kw["dropout_rate"] = 0.0
    jt = _jax_trainer(**kw)
    rng = jax.random.PRNGKey(1)
    js = jax.device_get(jt.init_state(rng, S))
    pt, state = _port_state(tmp_path, jt, js, **kw)
    x = _images(6, B=8)
    y = (np.arange(8) % 4).astype(np.int32)
    draws = {}
    with jax.enable_x64(True):
        m = jt.model
        jt.model = (jres.DomainAdaptiveClassifier(m.num_classes, m.feature_dim, m.dropout_rate,
                                                  dtype=jnp.float64)
                    if kw["mode"] == "domain_adaptive" else
                    jres.ResNet18(m.num_classes, m.head_dim, m.proj_dim, dtype=jnp.float64))
        if kw.get("use_mixup"):
            mix_rng, _ = jax.random.split(jax.random.fold_in(rng, 0))
            lam_rng, perm_rng = jax.random.split(mix_rng)
            draws["mixup"] = (float(jax.random.beta(lam_rng, 0.2, 0.2)),
                              torch.from_numpy(np.array(jax.random.permutation(perm_rng, 8))))
        jnew, jm = jax.jit(jt._train_step)(_float64(js), rng, x.astype(np.float64), y)
        jnew = jax.device_get(jnew)
    m = pt.train_step(state, (x, y), draws)
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert m["acc"].item() == float(jm["acc"])
    got, _, _ = pt.state_tensors(state)
    want = resnet_state_from_jax({"params": jnew.params, "batch_stats": jnew.batch_stats})
    sd = dict(zip(state.names + state.stat_names, state.params + state.stats))
    assert _frob_rel([sd[n].numpy() for n in state.stat_names],
                     [want[n].numpy() for n in state.stat_names]) < TOL
    adam = _flat_moments(jnew.opt_state)
    train = [n for n, t in zip(state.names, state.trainable) if t]
    moments = {}
    for group, mine in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        moments[group] = resnet_state_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, adam[group])})
        assert sorted(moments[group]) == sorted(train)
        assert _frob_rel([t.numpy() for t in mine],
                         [moments[group][n].numpy() for n in train]) < TOL
    # Adam's first update is ±lr·g/(|g| + eps): where |g| sits at fp32 noise
    # its sign is noise on either side, so those elements are held to 2·lr
    # only; the rest to TOL
    g = [sd[n].detach().numpy() for n in train]
    w = [want[n].numpy() for n in train]
    stable = [np.abs(moments["mu"][n].numpy()) / 0.1 > GRAD_FLOOR for n in train]
    assert _frob_rel([a[m] for a, m in zip(g, stable)], [b[m] for b, m in zip(w, stable)]) < TOL
    assert max(np.abs(a - b).max() for a, b in zip(g, w)) <= 2 * 1e-3 * 1.001
    frozen = [n for n in state.names if n not in train]
    for n in frozen:
        assert np.array_equal(sd[n].detach().numpy(), want[n].numpy()), n
    if kw["mode"] == "domain_adaptive":
        assert not all(state.trainable)
        assert _rel(state.extras.numpy(), jnew.extras) < TOL
    elif kw.get("contrastive_type") == "global":
        assert _rel(state.extras["bank"].numpy(), jnew.extras["bank"]) < TOL
        assert state.extras["ptr"].tolist() == np.asarray(jnew.extras["ptr"]).tolist() == [2] * 4
    else:
        assert state.extras is None and jnew.extras is None


def test_freeze_stages_keep_the_stem_and_stages():
    """freeze_stages=2: the stem and stages 1-2 bit-identical after two
    steps, block-internal conv1/bn1 of the later stages and the head train,
    batch-norm stats of the frozen stages still move."""
    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer

    pt = ClassifierTrainer(num_classes=3, lr=1e-2, freeze_stages=2, device="cpu")
    state = pt.init_state(0)
    before = {n: t.detach().clone() for n, t in zip(state.names + state.stat_names,
                                                     state.params + state.stats)}
    x = _images(1, B=8)
    y = np.random.default_rng(1).integers(0, 3, (8,)).astype(np.int32)
    for _ in range(2):
        pt.train_step(state, (x, y))
    after = dict(zip(state.names + state.stat_names, state.params + state.stats))

    def delta(prefix):
        return max((after[n] - before[n]).abs().max().item() for n in after
                   if n.startswith(prefix) and "running" not in n)

    assert delta("layer1_") == delta("layer2_") == delta("conv1.") == delta("bn1.") == 0.0
    assert delta("layer4_") > 1e-6 and delta("layer4_0.conv1") > 1e-8
    assert delta("layer3_0.bn1") > 1e-9 and delta("fc") > 1e-6
    assert (after["layer1_0.bn1.running_mean"] - before["layer1_0.bn1.running_mean"]).abs().max() > 0
    assert len(state.opt.mu) == sum(state.trainable) < len(state.names)


@pytest.mark.parametrize("mode", ["baseline", "domain_adaptive"])
def test_classifier_files_cross_packages(tmp_path, mode):
    """A port file (after a step) restores in the JAX ``restore_checkpoint``
    into the JAX ``init_state`` target, leaf for leaf, with optax's tree;
    the JAX file of that state reads back into the port equal."""
    from vavae_tpu.train.checkpoint import restore_checkpoint, save_state_file
    from vavae_tpu_torch.apps.train_classifier import (
        ClassifierTrainer,
        restore_classifier,
        save_classifier,
    )

    pt = ClassifierTrainer(num_classes=4, mode=mode, device="cpu")
    state = pt.init_state(3)
    pt.train_step(state, (_images(2, B=8), (np.arange(8) % 4).astype(np.int32)))
    path = save_classifier(str(tmp_path / "port.safetensors"), pt, state)
    jt = _jax_trainer(mode=mode)
    target = jt.init_state(jax.random.PRNGKey(0), S)
    restored = jax.device_get(restore_checkpoint(path, target))
    from flax import serialization, traverse_util

    got = traverse_util.flatten_dict(serialization.to_state_dict(restored.replace(extras=None)),
                                     sep="|")
    want, empty, none = pt.state_tensors(state, extras=False)
    leaves = {k: v for k, v in got.items() if v is not None and not isinstance(v, dict)}
    assert sorted(leaves) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(leaves[k]), want[k], err_msg=k)
    jpath = save_state_file(str(tmp_path / "jax.safetensors"), restored)
    again = restore_classifier(jpath, pt, pt.init_state(9))
    for a, b in zip(again.params + again.stats, state.params + state.stats):
        assert torch.equal(a, b)
    assert again.step == 1 and again.opt.count == 1


# -- classifier_eval ------------------------------------------------------------------


def test_classifier_eval_matches_jax():
    rs = np.random.default_rng(0)
    images = rs.integers(0, 256, (40, 4, 4, 3)).astype(np.uint8)
    labels = rs.integers(0, 6, (40,)).astype(np.int64)
    W = rs.standard_normal((48, 6)).astype(np.float32)

    def classifier_fn(x):
        z = np.asarray(x, np.float32).reshape(len(x), -1) @ W
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    got = teval.evaluate_classifier(classifier_fn, images, labels, 6, batch_size=16)
    want = jeval.evaluate_classifier(classifier_fn, images, labels, 6, batch_size=16)
    assert got == want
    for acc, hc in ((0.97, 0.99), (0.9, 0.7), (0.75, 0.8), (0.3, 0.3)):
        users = [acc - 0.3, acc + 0.1]
        assert teval.reliability_verdict(acc, hc, users) == jeval.reliability_verdict(acc, hc, users)

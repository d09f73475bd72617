"""The training slice of the port against the JAX package, on the CPU, fp32:
t sampling, the training losses, label dropout, the EMA, the optimizer
chain, DiT gradients under each remat policy, three whole train steps, the
checkpoint format, the latent dataset and the training pipeline.

Where the JAX package draws from a key, the test reproduces the draw from
the same key split and hands it to the port. Tolerances are stated where
they are used; fp32 with TF32 off on the torch side and ``highest`` matmul
precision on the JAX side (tests/conftest.py), so mostly summation order
differs.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from test_torch_common import max_rel, one_thread, tiny_dit_pair  # noqa: F401
from vavae_tpu_torch.transport import create_transport

pytestmark = pytest.mark.usefixtures("one_thread")

N_DRAWS = 20000


def _logit(t: torch.Tensor) -> np.ndarray:
    t = t.double().numpy()
    return np.log(t / (1.0 - t))


# -- t sampling ---------------------------------------------------------------


SAMPLE_T = {
    # name: (create_transport kwargs, sample_t kwargs, check(t) -> KS p-value)
    "uniform": ({}, {}, lambda t: scipy.stats.kstest(t.numpy(), "uniform").pvalue),
    "sp_timesteps": ({}, {"sp_timesteps": (0.2, 0.5)},
                     lambda t: scipy.stats.kstest(t.numpy(), "uniform", args=(0.2, 0.3)).pvalue),
    "partial_gate_on": ({"partial_train": (0.3, 0.7), "partial_ratio": 1.0}, {},
                        lambda t: scipy.stats.kstest(t.numpy(), "uniform", args=(0.3, 0.4)).pvalue),
    "partial_gate_off": ({"partial_train": (0.3, 0.7), "partial_ratio": 0.0}, {},
                         lambda t: scipy.stats.kstest(t.numpy(), "uniform").pvalue),
    "logit_normal": ({"use_lognorm": True}, {},
                     lambda t: scipy.stats.kstest(_logit(t), "norm").pvalue),
    "shifted": ({"use_lognorm": True, "shift_lg": True}, {"shifted_mu": 0.7},
                lambda t: scipy.stats.kstest(_logit(t), "norm", args=(0.7, 1.0)).pvalue),
    "truncated_logit_normal": (
        {"use_lognorm": True, "partial_train": (0.2, 0.6)}, {},
        lambda t: scipy.stats.kstest(
            _logit(t), "truncnorm",
            args=(np.log(0.2 / 0.8), np.log(0.6 / 0.4))).pvalue),
}


@pytest.mark.parametrize("name", list(SAMPLE_T))
def test_sample_t_distribution(name):
    """Each branch of sample_t draws from its distribution (KS test on 20k
    draws from a fixed seed; the bound 1e-3 fails a wrong distribution at
    this size by orders of magnitude)."""
    kw, call_kw, check = SAMPLE_T[name]
    tr = create_transport(**kw)
    t = tr.sample_t(N_DRAWS, torch.Generator().manual_seed(0), **call_kw)
    assert t.shape == (N_DRAWS,) and t.dtype == torch.float32
    assert check(t) > 1e-3


def test_sample_t_refuses_shifted_partial():
    tr = create_transport(use_lognorm=True, shift_lg=True, partial_train=(0.2, 0.6))
    with pytest.raises(ValueError, match="shift_lg is not compatible"):
        tr.sample_t(4, torch.Generator().manual_seed(0))


# -- the training losses ----------------------------------------------------------


LOSS_CASES = {
    "velocity_cosine_lognorm": dict(use_lognorm=True, use_cosine_loss=True),
    "velocity_gvp": dict(path_type="GVP"),
    "noise_vp_velocity_weight": dict(path_type="VP", prediction="noise", loss_weight="velocity"),
    "score_linear_likelihood": dict(prediction="score", loss_weight="likelihood"),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_losses_match_jax_training_losses(name):
    """The port's deterministic loss core, fed the t and x0 that JAX's
    training_losses draws from its key (split at transport.py:158-160),
    against JAX's per-sample loss terms (fp32: 1e-5 relative)."""
    from vavae_tpu.transport import create_transport as jax_create_transport

    kw = LOSS_CASES[name]
    jtr, ptr = jax_create_transport(**kw), create_transport(**kw)
    rs = np.random.default_rng(1)
    x1 = rs.standard_normal((3, 4, 4, 5)).astype(np.float32)
    w = rs.standard_normal((5,)).astype(np.float32)

    def jmodel(xt, t):
        return jnp.tanh(xt * w + t[:, None, None, None])

    def pmodel(xt, t):
        return torch.tanh(xt * torch.from_numpy(w) + t[:, None, None, None])

    rng = jax.random.PRNGKey(3)
    want = jtr.training_losses(rng, jmodel, jnp.asarray(x1))
    t_rng, x0_rng = jax.random.split(rng)
    t = np.array(jtr.sample_t(t_rng, 3))
    x0 = np.array(jax.random.normal(x0_rng, x1.shape, jnp.float32))
    got = ptr.losses_at(pmodel, torch.from_numpy(t), torch.from_numpy(x0), torch.from_numpy(x1))
    assert set(got) == set(want)
    for key in want:
        assert max_rel(got[key].numpy(), np.asarray(want[key])) < 1e-5, key
    drawn = ptr.training_losses(pmodel, torch.from_numpy(x1), torch.Generator().manual_seed(0))
    assert drawn["loss"].shape == (3,) and torch.isfinite(drawn["loss"]).all()


# -- label dropout ------------------------------------------------------------------


def test_label_dropout_rate_and_null_row():
    from vavae_tpu_torch.models.layers import LabelEmbedder

    emb = LabelEmbedder(10, 8, dropout_prob=0.25)
    labels = torch.randint(0, 10, (N_DRAWS,), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = emb(labels, train=True, generator=torch.Generator().manual_seed(1))
        table = emb.embedding_table.weight
        dropped = (out == table[10]).all(dim=-1)
        # 4 standard deviations of the binomial rate at 20k draws
        assert abs(dropped.float().mean().item() - 0.25) < 4 * (0.25 * 0.75 / N_DRAWS) ** 0.5
        assert torch.equal(out[~dropped], table[labels[~dropped]])
        assert torch.equal(emb(labels), table[labels])  # no dropout outside training
        forced = emb(labels[:4], force_drop_ids=torch.tensor([1, 0, 1, 0]))
        assert torch.equal(forced[0], table[10]) and torch.equal(forced[1], table[labels[1]])


def test_dit_label_dropout_is_the_generator_draw():
    """In the DiT forward, train=True drops exactly where the generator's
    uniform draw is below the rate: the same as forcing those labels."""
    _, _, tm = tiny_dit_pair(seed=2, class_dropout_prob=0.5)
    rs = np.random.default_rng(0)
    x = torch.from_numpy(rs.standard_normal((6, 8, 8, 4)).astype(np.float32))
    t = torch.from_numpy(rs.uniform(0, 1, (6,)).astype(np.float32))
    y = torch.from_numpy(rs.integers(0, 10, (6,)))
    mask = (torch.rand((6,), generator=torch.Generator().manual_seed(5)) < 0.5).long()
    assert 0 < mask.sum() < 6
    with torch.no_grad():
        dropped = tm(x, t, y, train=True, generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(dropped, tm(x, t, y, force_drop_ids=mask), rtol=0, atol=0)
        assert not torch.equal(dropped, tm(x, t, y))


# -- EMA -----------------------------------------------------------------------------


@pytest.mark.parametrize("param_dtype", [np.float32, "bfloat16"])
def test_update_ema_matches_jax(param_dtype):
    from vavae_tpu.train.ema import update_ema as jax_update_ema
    from vavae_tpu_torch.train.ema import update_ema

    rs = np.random.default_rng(0)
    ema = [rs.standard_normal(s).astype(np.float32) for s in [(4, 3), (5,)]]
    params = [rs.standard_normal(s).astype(np.float32) for s in [(4, 3), (5,)]]
    jparams = [jnp.asarray(p).astype(param_dtype) for p in params]
    want = jax_update_ema([jnp.asarray(e) for e in ema], jparams, 0.99)
    got = [torch.from_numpy(e.copy()) for e in ema]
    tparams = [torch.from_numpy(np.asarray(p.astype(jnp.float32))) for p in jparams]
    if param_dtype == "bfloat16":
        tparams = [p.bfloat16() for p in tparams]
    update_ema(got, tparams, 0.99)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_update_ema_refuses_bf16_at_high_decay():
    from vavae_tpu.train.ema import update_ema as jax_update_ema
    from vavae_tpu_torch.train.ema import update_ema

    with pytest.raises(ValueError, match="bf16-stored EMA"):
        jax_update_ema([jnp.zeros(3, jnp.bfloat16)], [jnp.zeros(3)], 0.9999)
    with pytest.raises(ValueError, match="bf16-stored EMA"):
        update_ema([torch.zeros(3, dtype=torch.bfloat16)], [torch.zeros(3)], 0.9999)
    update_ema([torch.zeros(3, dtype=torch.bfloat16)], [torch.ones(3)], 0.9)  # allowed


# -- optimizer chain -------------------------------------------------------------------


OPT_CASES = {
    # name: (trainer kwargs, micro-steps)
    "adamw": (dict(lr=1e-2, weight_decay=0.01), 4),
    "clip_active": (dict(lr=1e-2, max_grad_norm=0.5), 3),
    "clip_inactive": (dict(lr=1e-2, max_grad_norm=1e3), 3),
    "bf16_mu": (dict(lr=1e-2, adam_mu_dtype="bfloat16"), 4),
    "cosine": (dict(lr=1e-2, lr_schedule="cosine", warmup_steps=2, total_steps=5,
                    min_lr=1e-3), 6),
    "multisteps": (dict(lr=1e-2, grad_accum=3, weight_decay=0.01), 7),
}


def _optax_chain(kw):
    lr = kw["lr"]
    if kw.get("lr_schedule") == "cosine":
        lr = optax.warmup_cosine_decay_schedule(0.0, kw["lr"], max(kw["warmup_steps"], 1),
                                                kw["total_steps"], kw["min_lr"])
    chain = [optax.clip_by_global_norm(kw["max_grad_norm"])] if kw.get("max_grad_norm") else []
    chain.append(optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=kw.get("weight_decay", 0.0),
                             mu_dtype=kw.get("adam_mu_dtype")))
    tx = optax.chain(*chain)
    return optax.MultiSteps(tx, every_k_schedule=kw["grad_accum"]) if kw.get("grad_accum") else tx


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_optimizer_matches_optax(name):
    """DiTTrainer.apply_gradients against the JAX trainer's optax chain
    (dit_trainer.py:83-103) on random parameters and gradients: params to
    1e-6 relative (fp32 rounding of the same operations)."""
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer

    kw, steps = OPT_CASES[name]
    rs = np.random.default_rng(0)
    shapes = [(6, 5), (7,), (2, 3, 4)]
    params = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rs.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(steps)]

    tx = _optax_chain(kw)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    model = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    trainer = DiTTrainer(model, transport=None, beta2=0.95, **kw)
    state = trainer.init_state()
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        trainer.apply_gradients(state, [torch.from_numpy(x) for x in g])
        for got, want in zip(state.params, jparams):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not np.allclose(np.asarray(jparams[0]), params[0])  # the optimizer moved them
    if name == "bf16_mu":
        assert state.opt.mu[0].dtype == torch.bfloat16


def test_cosine_schedule_matches_optax():
    from vavae_tpu_torch.train.dit_trainer import warmup_cosine_decay

    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-4, 3, 10, 1e-5)
    for count in range(13):
        np.testing.assert_allclose(warmup_cosine_decay(count, 2e-4, 3, 10, 1e-5),
                                   float(sched(count)), rtol=1e-6, atol=1e-12)


# -- DiT gradients and whole steps -------------------------------------------------------


def create_jax_transport(**kw):
    from vavae_tpu.transport import create_transport as jax_create_transport

    return jax_create_transport(**kw)


def _jax_draws(jtransport, rng, x_shape):
    """The t and x0 that JAX's _loss_fn draws from ``rng``
    (dit_trainer.py:199, transport.py:158-160)."""
    _, t_rng = jax.random.split(rng)
    t_rng, x0_rng = jax.random.split(t_rng)
    t = jtransport.sample_t(t_rng, x_shape[0])
    x0 = jax.random.normal(x0_rng, x_shape, jnp.float32)
    return np.asarray(t), np.asarray(x0)


def _batch(seed: int, B: int = 4):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((B, 8, 8, 4)).astype(np.float32),
            rs.integers(0, 10, (B,)).astype(np.int32))


def _frob_rel(got: list, want: list) -> float:
    g = np.concatenate([np.ravel(x) for x in got]).astype(np.float64)
    w = np.concatenate([np.ravel(x) for x in want]).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


# remat policy × attention branch; the fused-qkv cases keep their old ids
REMAT_CASES = [pytest.param(remat, qknorm, id=("qknorm-" if qknorm else "") + str(remat))
               for qknorm in (False, True) for remat in (None, "nothing", "dots")]


@pytest.mark.parametrize("remat,qknorm", REMAT_CASES)
def test_dit_loss_gradients_match_jax_grad(remat, qknorm, monkeypatch):
    """Gradients of the training loss of the tiny DiT (head dim 72, RoPE,
    SwiGLU, RMSNorm; with qknorm, RMSNorm q/k norms and the separate-q/k/v
    attention op) against jax.grad of the JAX trainer's loss, through the
    weight bridge; the port with remat off, "nothing" and "dots". Every
    gradient tensor to 1e-4 of its largest element (fp32 summation order).
    With remat, the attention op runs again in the backward."""
    from vavae_tpu.train.dit_trainer import DiTTrainer as JaxTrainer
    from vavae_tpu_torch.models import layers
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    jm, params, tm = tiny_dit_pair(seed=3, class_dropout_prob=0.0, use_qknorm=qknorm)
    if remat:
        tm.use_checkpoint, tm.checkpoint_policy = True, remat
    kw = dict(use_lognorm=True, use_cosine_loss=True)
    jtr = create_jax_transport(**kw)
    x, y = _batch(0)
    rng = jax.random.PRNGKey(7)
    jtrainer = JaxTrainer(jm, jtr, mesh=None)
    (_, _), jgrads = jax.value_and_grad(jtrainer._loss_fn, has_aux=True)(
        params, rng, jnp.asarray(x), jnp.asarray(y))
    want = dit_state_from_jax(jgrads)

    calls = []
    op = "dot_product_attention" if qknorm else "fused_qkv_attention"
    original = getattr(layers, op)
    monkeypatch.setattr(layers, op, lambda *a, **k: calls.append(1) or original(*a, **k))
    t, x0 = _jax_draws(jtr, rng, x.shape)
    terms = create_transport(**kw).losses_at(
        lambda xt, tt: tm(xt, tt, torch.from_numpy(y).long(), train=True),
        torch.from_numpy(t), torch.from_numpy(x0), torch.from_numpy(x))
    loss = terms["loss"].mean() + terms["cos_loss"].mean()
    names, tparams = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, tparams)
    assert len(calls) == tm.depth * (2 if remat else 1)
    for name, g in zip(names, grads):
        assert max_rel(g.numpy(), want[name].numpy()) < 1e-4, name


@pytest.mark.parametrize("remat,qknorm", REMAT_CASES)
def test_kernel_autograd_function_under_remat(remat, qknorm, monkeypatch):
    """The CUDA path's wiring, run on the CPU: ``_FusedQKVAttention`` (with
    qknorm, ``_FlashAttention`` behind the q/k norms) with its two launchers
    stood in by the plain versions, inside the DiT under each remat policy.
    The gradients equal those of plain autograd (fp32, 1e-5 of each tensor's
    largest element), the backward runs once per block, and the forward once
    more per block under remat: "dots" saves only matmul outputs, so the q/k
    norms and the attention forward are recomputed."""
    from vavae_tpu_torch.models import layers
    from vavae_tpu_torch.ops import flash_attention as fa

    _, _, tm = tiny_dit_pair(seed=6, class_dropout_prob=0.0, use_qknorm=qknorm)
    tm.use_checkpoint, tm.checkpoint_policy = remat is not None, remat or "nothing"
    x, y = _batch(1)
    rs = np.random.default_rng(2)
    t = torch.from_numpy(rs.uniform(0, 1, (4,)).astype(np.float32))
    x0 = torch.from_numpy(rs.standard_normal(x.shape).astype(np.float32))
    tr = create_transport(use_lognorm=True, use_cosine_loss=True)
    names, params = zip(*tm.named_parameters())

    def grads():
        terms = tr.losses_at(lambda xt, tt: tm(xt, tt, torch.from_numpy(y).long(), train=True),
                             t, x0, torch.from_numpy(x))
        return torch.autograd.grad(terms["loss"].mean() + terms["cos_loss"].mean(), params)

    want = grads()

    # the forward launchers take the raw (cos, sin), as the plain versions do;
    # the backward launchers sign-folded tables (folding is its own inverse)
    def fwd(qkv5, tables):
        fa.fused_qkv_attention.launches += 1
        return fa.fused_qkv_attention_reference(qkv5, tables)

    def bwd(qkv5, g, tables):
        fa.fused_qkv_attention.bwd_launches += 1
        return fa.fused_qkv_attention_bwd_reference(qkv5, g, fa.fold_sin(tables))

    def flash_fwd(q, k, v, tables):
        fa.flash_attention.rope_launches += 1
        return fa.flash_attention_reference(q, k, v, tables)

    def flash_bwd(q, k, v, g, tables):
        fa.flash_attention.bwd_launches += 1
        return fa.flash_attention_bwd_reference(q, k, v, g, fa.fold_sin(tables))

    if qknorm:
        counter, attr = fa.flash_attention, "rope_launches"
        monkeypatch.setattr(fa, "_launch_flash_fwd", flash_fwd)
        monkeypatch.setattr(fa, "_launch_flash_bwd", flash_bwd)
        monkeypatch.setattr(layers, "dot_product_attention", lambda q, k, v, rope: (
            fa._FlashAttention.apply(q, k, v, *rope)))
    else:
        counter, attr = fa.fused_qkv_attention, "launches"
        monkeypatch.setattr(fa, "_launch_fwd", fwd)
        monkeypatch.setattr(fa, "_launch_bwd", bwd)
        monkeypatch.setattr(layers, "fused_qkv_attention",
                            lambda qkv5, rope: fa._FusedQKVAttention.apply(qkv5, *rope))
    monkeypatch.setattr(counter, attr, 0)
    monkeypatch.setattr(counter, "bwd_launches", 0)
    got = grads()
    assert getattr(counter, attr) == tm.depth * (2 if remat else 1)
    assert counter.bwd_launches == tm.depth
    for name, g, w in zip(names, got, want):
        assert max_rel(g.numpy(), w.numpy()) < 1e-5, (name, max_rel(g.numpy(), w.numpy()))


def test_three_train_steps_match_jax_trainer():
    """The slice as a whole: three DiTTrainer.train_steps of the port against
    the JAX DiTTrainer on a one-CPU mesh, the port fed JAX's draws (fold_in
    of the step, dit_trainer.py:219). Loss and grad norm per step, and the
    params and EMA after three steps, to 1e-4 relative (Frobenius over all
    tensors). Label dropout cannot be replayed outside flax, so it is off
    here; test_dit_label_dropout_is_the_generator_draw covers it. A parameter
    whose gradient is within fp32 rounding of 0 may see Adam's update flip
    sign on one side, so each element is also bounded by 2·lr per step."""
    from vavae_tpu.parallel.mesh import make_mesh
    from vavae_tpu.train.dit_trainer import DiTTrainer as JaxTrainer
    from vavae_tpu.train.dit_trainer import TrainState as JaxState
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    jm, params, tm = tiny_dit_pair(seed=4, class_dropout_prob=0.0)
    kw = dict(use_lognorm=True, use_cosine_loss=True)
    opt = dict(lr=1e-3, beta2=0.95, weight_decay=0.01, max_grad_norm=1.0, ema_decay=0.9)
    jtr = create_jax_transport(**kw)
    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    jt = JaxTrainer(jm, jtr, mesh, **opt)
    jstate = jt.replicate(JaxState(step=jnp.zeros((), jnp.int32), params=params,
                                   ema_params=jax.tree_util.tree_map(jnp.copy, params),
                                   opt_state=jt.tx.init(params)))
    pt = DiTTrainer(tm, create_transport(**kw), **opt)
    state = pt.init_state()
    rng = jax.random.PRNGKey(0)
    for step in range(3):
        x, y = _batch(10 + step)
        t, x0 = _jax_draws(jtr, jax.random.fold_in(rng, step), x.shape)
        jstate, jm_ = jt.train_step(jstate, rng, jt.shard_batch((x, y)))
        m = pt.train_step(state, (x, y), draws=(t, x0, None))
        for key in ("loss", "grad_norm"):
            assert max_rel(m[key].item(), float(jm_[key])) < 1e-4, (step, key)
    assert state.step == 3
    for got, want in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        want = dit_state_from_jax(jax.device_get(want))
        g = [t.detach().numpy() for t in got]
        w = [want[n].numpy() for n in state.names]
        assert _frob_rel(g, w) < 1e-4
        assert max(np.abs(a - b).max() for a, b in zip(g, w)) <= 3 * 2 * opt["lr"]


# -- checkpoints -------------------------------------------------------------------------------


def _trained_state(tmp_path):
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer

    _, params, tm = tiny_dit_pair(seed=5)
    trainer = DiTTrainer(tm, create_transport(use_lognorm=True), lr=1e-3,
                         adam_mu_dtype="bfloat16", grad_accum=2, ema_decay=0.9)
    state = trainer.init_state()
    for step in range(3):
        trainer.train_step(state, _batch(step))
    return params, tm, trainer, state


def test_checkpoint_round_trip(tmp_path):
    """save → latest_checkpoint picks the highest step (not the largest
    file) → a strict restore gives back every tensor and counter; the JAX
    package's sampler loader reads the same file, and the JAX LightningDiT
    applied to the saved params gives the port model's output (fp32, 1e-5)."""
    from vavae_tpu.pipelines.sample import load_dit_params as jax_load_dit_params
    from vavae_tpu.utils.config import Config as JaxConfig
    from vavae_tpu_torch.pipelines.sample import load_dit_params
    from vavae_tpu_torch.train import checkpoint as ck

    _, tm, _, state = _trained_state(tmp_path)
    path = ck.save_checkpoint(str(tmp_path), 3, state, {"train": {"max_steps": 3}})
    (tmp_path / "0000002.safetensors").write_bytes(b"\0" * (2 * os.path.getsize(path)))
    assert ck.latest_checkpoint(str(tmp_path)) == path
    assert (tmp_path / "config.json").exists()

    _, _, _, fresh = _trained_state(tmp_path)  # same shapes; its counters are reset below
    fresh.step, fresh.opt.count = 0, 0
    ck.restore_checkpoint(path, fresh)
    assert (fresh.step, fresh.opt.count, fresh.mini_step) == (state.step, state.opt.count,
                                                             state.mini_step)
    for group in ("params", "ema_params", "acc_grads"):
        for a, b in zip(getattr(fresh, group), getattr(state, group)):
            assert torch.equal(a, b), group
    for a, b in zip(fresh.opt.mu + fresh.opt.nu, state.opt.mu + state.opt.nu):
        assert torch.equal(a, b) and a.dtype == b.dtype

    broken = dict(ck.state_tensors(state)[0])
    broken.pop("opt_state|torch_adamw|count")
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    write_safetensors(str(tmp_path / "broken.safetensors"), broken)
    with pytest.raises(ValueError, match="does not match"):
        ck.restore_checkpoint(str(tmp_path / "broken.safetensors"), fresh)

    jm, _, _ = tiny_dit_pair(seed=5)
    jparams = jax_load_dit_params(JaxConfig({}), jm, path, prefer_ema=False)
    rs = np.random.default_rng(0)
    x = rs.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = rs.uniform(0, 1, (2,)).astype(np.float32)
    y = np.array([1, 7], np.int32)
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long()).numpy()
    assert max_rel(got, want) < 1e-5
    load_dit_params(tm, path)  # the port's sampler loader: the EMA weights
    for p, e in zip(tm.parameters(), state.ema_params):
        assert torch.equal(p.detach(), e)


# -- dataset --------------------------------------------------------------------------------------


def _write_shards(d, sizes=(7, 5), C=4, S=4):
    from vavae_tpu_torch.utils.safetensors_io import write_safetensors

    rs = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    for i, n in enumerate(sizes):
        lat = (3.0 * rs.standard_normal((n, C, S, S)) + 1.0).astype(np.float32)
        write_safetensors(os.path.join(d, f"shard_{i:03d}.safetensors"), {
            "latents": lat, "latents_flip": np.ascontiguousarray(lat[..., ::-1]),
            "labels": rs.integers(0, 10, (n,)).astype(np.int32)})


@pytest.mark.parametrize("latent_norm", [True, False])
def test_dataset_batches_match_jax_bit_for_bit(tmp_path, monkeypatch, latent_norm):
    """ImgLatentDataset on shards the port's writer made: the stats the port
    computes and caches, and batches() over four epochs, equal the JAX
    dataset's bit for bit, with its Python reader (VAVAE_NATIVE_LOADER=0) and
    with its native reader. The native reader normalises as
    (x − μ)·(m/σ), whose two roundings can differ from those of
    (x − μ)/σ·m (ROADMAP Queue 3), so with latent_norm it is held to 2 ulp."""
    from vavae_tpu.data.latent_dataset import ImgLatentDataset as JaxDataset
    from vavae_tpu_torch.data.latent_dataset import ImgLatentDataset

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _write_shards(port_dir)
    shutil.copytree(port_dir, jax_dir)  # each side computes and caches its own stats
    ds = ImgLatentDataset(port_dir, latent_norm=latent_norm, latent_multiplier=0.9)
    got = [b for _, b in zip(range(8), ds.batches(5, seed=3))]
    for native in ("0", "1"):
        monkeypatch.setenv("VAVAE_NATIVE_LOADER", native)
        jds = JaxDataset(jax_dir, latent_norm=latent_norm, latent_multiplier=0.9)
        assert (jds._native is not None) == (native == "1")
        if latent_norm:
            np.testing.assert_array_equal(ds.latent_stats[0], jds.latent_stats[0])
            np.testing.assert_array_equal(ds.latent_stats[1], jds.latent_stats[1])
        want = [b for _, b in zip(range(8), jds.batches(5, seed=3))]
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gy, wy)
            assert gx.dtype == wx.dtype and gx.shape == wx.shape == (5, 4, 4, 4)
            if native == "1" and latent_norm:
                np.testing.assert_array_max_ulp(gx, wx, maxulp=2)
            else:
                np.testing.assert_array_equal(gx, wx)


# -- the pipeline ----------------------------------------------------------------------------------


def _tiny_train_config(tmp_path, max_steps: int):
    from vavae_tpu_torch.utils.config import Config

    data = str(tmp_path / "latents")
    if not os.path.isdir(data):
        _write_shards(data, sizes=(10, 10), S=8)
    return Config({
        "data": {"data_path": data, "valid_path": data, "image_size": 16, "num_classes": 10,
                 "latent_norm": True, "latent_multiplier": 1.0},
        "vae": {"downsample_ratio": 2},
        "model": {"model_type": "LightningDiT-S/1", "use_swiglu": True, "use_rope": True,
                  "use_rmsnorm": True, "in_chans": 4, "use_checkpoint": True,
                  "checkpoint_policy": "dots"},
        "transport": {"path_type": "Linear", "prediction": "velocity", "use_cosine_loss": True,
                      "use_lognorm": True},
        "train": {"max_steps": max_steps, "global_batch_size": 4,
                  "output_dir": str(tmp_path / "out"), "exp_name": "tiny", "log_every": 2,
                  "ckpt_every": 2, "sample_every": 4, "ema_decay": 0.9, "patience": 5},
        "sample": {"num_sampling_steps": 3, "cfg_scale": 1.0},
        "optimizer": {"lr": 1e-3},
    })


def test_do_train_writes_checkpoints_and_resumes(tmp_path, monkeypatch):
    """do_train end to end on the CPU (tiny DiT standing in for S/1): step
    checkpoints, validation, EMA sample latents; a second run with a higher
    max_steps resumes from the last checkpoint and continues from its step."""
    import vavae_tpu_torch.models.dit as dit
    from vavae_tpu_torch.pipelines.train_dit import do_train
    from vavae_tpu_torch.utils.safetensors_io import read_safetensors

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    state = do_train(_tiny_train_config(tmp_path, 4), device="cpu")
    ckpts = tmp_path / "out" / "tiny" / "checkpoints"
    assert state.step == 4
    assert sorted(os.listdir(ckpts)) == ["0000002.safetensors", "0000004.safetensors",
                                         "config.json"]
    assert os.listdir(tmp_path / "out" / "tiny" / "train_samples") == ["step0000004_latents.npy"]
    assert (tmp_path / "out" / "tiny" / "best").is_dir()
    resumed = do_train(_tiny_train_config(tmp_path, 6), device="cpu")
    assert resumed.step == 6 and (ckpts / "0000006.safetensors").exists()
    assert int(read_safetensors(str(ckpts / "0000006.safetensors"))[0]["step"]) == 6
    lines = (tmp_path / "out" / "tiny" / "tb" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) >= 3  # train/loss at steps 2, 4, 6 and validation


def test_do_train_checkpoints_on_preemption(tmp_path, monkeypatch):
    """A preemption signal mid-run (SIGUSR1 standing in for SIGTERM) ends
    do_train after the step in flight, with a checkpoint at that step, and
    puts the previous signal handler back."""
    import signal

    import vavae_tpu_torch.models.dit as dit
    from vavae_tpu_torch.pipelines import train_dit
    from vavae_tpu_torch.train.dit_trainer import DiTTrainer
    from vavae_tpu_torch.utils.preemption import PreemptionGuard

    monkeypatch.setitem(dit._VARIANTS, "S", dict(depth=2, hidden_size=144, num_heads=2))
    monkeypatch.setattr(train_dit, "PreemptionGuard",
                        lambda: PreemptionGuard(signals=(signal.SIGUSR1,)))
    step = DiTTrainer.train_step

    def train_step(self, state, batch):
        out = step(self, state, batch)
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    monkeypatch.setattr(DiTTrainer, "train_step", train_step)
    before = signal.getsignal(signal.SIGUSR1)
    state = train_dit.do_train(_tiny_train_config(tmp_path, 8), device="cpu")
    assert state.step == 3
    assert sorted(os.listdir(tmp_path / "out" / "tiny" / "checkpoints")) == [
        "0000002.safetensors", "0000003.safetensors", "config.json"]
    assert signal.getsignal(signal.SIGUSR1) is before


def test_train_main_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    import json

    from vavae_tpu_torch.pipelines.train_dit import main

    path = tmp_path / "cfg.yaml"  # JSON is YAML
    path.write_text(json.dumps(_tiny_train_config(tmp_path, 1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(path)])

"""VA-VAE training of the port against the JAX package, on the CPU in fp32:
the discriminator (logits in train and eval mode, the BN running stats of
the fake → real → fake chain; 1e-5), the loss pieces (1e-6), three trainer
steps in both gate regimes with adaptive and fixed VF weights (every loss
part, both adaptive weights, the updated weights, BN stats and Adam moments;
1e-4 relative), two steps with LPIPS in the loss, eval_step, the steps'
fp32 pinning, bf16 modes against fp32 (the JAX package's own tolerances),
and train-state checkpoints read across the two packages.

The trainer is the tiny one of ``tests/test_vae_trainer.py``
(``AutoencoderKL(embed_dim=4, ch=32, ch_mult=(1, 2))``, 32 px,
``disc_layers=2``) with ``dinov2-tiny`` features; the port's steps take
the JAX steps' own noise, ``jax.random.normal(fold_in(rng, step), zshape)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import max_rel, one_thread, randomize  # noqa: F401
from test_torch_tokenizer_eval import _jax_lpips_params
from vavae_tpu.models import discriminator as jdisc
from vavae_tpu.models.lpips import LPIPS as JaxLPIPS
from vavae_tpu.models.vae import AutoencoderKL as JaxVAE
from vavae_tpu.models.vae import DiagonalGaussian as JaxGaussian
from vavae_tpu.models.vit import FoundationModel as JaxFoundation
from vavae_tpu.parallel.mesh import make_mesh
from vavae_tpu.train import checkpoint as jckpt
from vavae_tpu.train import vae_loss as jloss
from vavae_tpu.train.vae_trainer import VAETrainer as JaxTrainer
from vavae_tpu_torch.models import discriminator as tdisc
from vavae_tpu_torch.models.lpips import LPIPS
from vavae_tpu_torch.models.vae import AutoencoderKL
from vavae_tpu_torch.models.vit import FoundationModel
from vavae_tpu_torch.train import checkpoint as tckpt
from vavae_tpu_torch.train import vae_loss as tloss
from vavae_tpu_torch.train.vae_trainer import VAETrainer
from vavae_tpu_torch.utils.safetensors_io import flatten
from vavae_tpu_torch.utils.weights import (
    disc_state_from_jax,
    lpips_state_from_jax,
    vae_state_from_jax,
    vae_state_to_jax,
    vit_state_from_jax,
)

pytestmark = pytest.mark.usefixtures("one_thread")

B, S, STEPS = 4, 32, 3
TOL = 1e-4
VAE_KW = dict(embed_dim=4, ch=32, ch_mult=(1, 2), resolution=S)
# the runs: fixed VF weight, gate open from step 1; adaptive VF weight, gate
# open from step 2; and two steps with LPIPS (random VGG16 weights) in the
# loss, adaptive VF weight, gate open from step 1.
RUNS = {
    "fixed_vf": dict(adaptive_vf=False, disc_start=1, lpips=False, steps=STEPS),
    "adaptive_vf": dict(adaptive_vf=True, disc_start=2, lpips=False, steps=STEPS),
    "lpips": dict(adaptive_vf=True, disc_start=1, lpips=True, steps=2),
}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


# -- discriminator -------------------------------------------------------------


@pytest.fixture(scope="module")
def disc_pair():
    jm = jdisc.NLayerDiscriminator(ndf=16, n_layers=3)
    variables = jax.device_get(jax.jit(lambda k: jm.init(k, jnp.zeros((1, S, S, 3)), train=True))(
        jax.random.PRNGKey(0)))
    variables = {"params": randomize(variables["params"], 1),
                 "batch_stats": jax.tree_util.tree_map(
                     lambda v: np.abs(randomize({"v": v}, 2)["v"]) + 0.5, variables["batch_stats"])}
    tm = tdisc.NLayerDiscriminator(ndf=16, n_layers=3)
    tm.load_state_dict(disc_state_from_jax(variables), strict=True)
    return jm, variables, tm


def test_discriminator_eval_logits_match_jax(disc_pair):
    jm, variables, tm = disc_pair
    x = np.random.default_rng(0).normal(size=(3, S, S, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False).numpy()
    assert got.shape == want.shape == (3, 2, 2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_discriminator_train_chain_matches_jax(disc_pair):
    """Three train-mode forwards, fake → real → fake, each normalised by its
    batch, the running stats (biased variance, momentum 0.9) chained."""
    jm, variables, tm = disc_pair
    tm = tdisc.NLayerDiscriminator(ndf=16, n_layers=3)
    tm.load_state_dict(disc_state_from_jax(variables), strict=True)
    rs = np.random.default_rng(1)
    fake, real = (rs.normal(size=(4, S, S, 3)).astype(np.float32) for _ in range(2))
    stats = variables["batch_stats"]
    for x in (fake, real, fake):
        want, upd = jm.apply({"params": variables["params"], "batch_stats": stats},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    sd = tm.state_dict()
    for name, s in jax.device_get(stats).items():
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(), s["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), s["var"], rtol=1e-5, atol=1e-6)


def test_discriminator_init_is_tamings():
    tm = tdisc.NLayerDiscriminator()
    tdisc.init_discriminator_weights(tm, torch.Generator().manual_seed(0))
    assert abs(tm.conv1.weight.std().item() - 0.02) < 1e-3
    assert abs(tm.bn2.weight.mean().item() - 1.0) < 0.01 and tm.bn2.weight.std().item() < 0.03
    assert tm.conv0.bias.abs().max() == 0 and tm.conv1.bias is None


# -- loss pieces -----------------------------------------------------------------


@pytest.mark.parametrize("perceptual", [True, False])
def test_nll_loss_matches_jax(perceptual):
    rs = np.random.default_rng(0)
    x, dec = (rs.normal(size=(3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    p = rs.random(3).astype(np.float32) if perceptual else None
    kw = dict(perceptual_weight=1.0, pixelloss_weight=0.7, logvar_init=0.3)
    want = jloss.nll_loss(jnp.asarray(x), jnp.asarray(dec), None if p is None else jnp.asarray(p),
                          jloss.VAELossConfig(**kw))
    got = tloss.nll_loss(torch.from_numpy(x), torch.from_numpy(dec),
                         None if p is None else torch.from_numpy(p), tloss.VAELossConfig(**kw))
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-6 * max(1.0, abs(float(w)))


@pytest.mark.parametrize("margins", [(0.0, 0.0), (0.25, 0.5)])
def test_vf_loss_matches_jax(margins):
    rs = np.random.default_rng(1)
    z, aux = (rs.normal(size=(2, 4, 4, 16)).astype(np.float32) for _ in range(2))
    kw = dict(distmat_margin=margins[0], cos_margin=margins[1], distmat_weight=0.7, cos_weight=1.3)
    want = jloss.vf_loss(jnp.asarray(z), jnp.asarray(aux), jloss.VAELossConfig(**kw))
    got = tloss.vf_loss(torch.from_numpy(z), torch.from_numpy(aux), tloss.VAELossConfig(**kw))
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-6


def test_gan_pieces_match_jax():
    rs = np.random.default_rng(2)
    lr, lf = (rs.normal(size=(4, 5, 5, 1)).astype(np.float32) for _ in range(2))
    for jf, tf in ((jdisc.hinge_d_loss, tdisc.hinge_d_loss),
                   (jdisc.vanilla_d_loss, tdisc.vanilla_d_loss)):
        want = float(jf(jnp.asarray(lr), jnp.asarray(lf)))
        assert abs(tf(torch.from_numpy(lr), torch.from_numpy(lf)).item() - want) <= 1e-6
    for step in (9, 10, 11):
        assert tloss.adopt_weight(1.0, step, 10) == float(jloss.adopt_weight(1.0, jnp.asarray(step), 10))
    for a, b, clip in ((3.0, 0.01, 1e4), (1e-3, 2.0, 1e4), (5.0, 1e-9, 10.0)):
        want = float(jloss.adaptive_weight(jnp.float32(a), jnp.float32(b), 0.5, clip))
        got = tloss.adaptive_weight(torch.tensor(a), torch.tensor(b), 0.5, clip).item()
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_kl_matches_jax():
    rs = np.random.default_rng(3)
    mean, logvar = (rs.normal(size=(3, 2, 2, 8)).astype(np.float32) for _ in range(2))
    want = np.asarray(JaxGaussian(jnp.asarray(mean), jnp.asarray(logvar)).kl())
    from vavae_tpu_torch.models.vae import DiagonalGaussian

    got = DiagonalGaussian(torch.from_numpy(mean), torch.from_numpy(logvar)).kl().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the trainer, three steps ------------------------------------------------------


def _batches():
    rs = np.random.default_rng(7)
    return [(0.5 * rs.normal(size=(B, S, S, 3))).astype(np.float32) for _ in range(STEPS)]


def jax_aux():
    """The JAX ``dinov2-tiny`` feature fn, its params drawn by ``randomize``
    over the init's shapes (no init run), and its width."""
    fm = JaxFoundation(kind="dinov2-tiny")
    shapes = jax.eval_shape(lambda: fm.model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 224, 3)))["params"])
    return fm.feature_fn_p(), randomize(shapes, 5), fm.feature_dim


def _jax_trainer(run: str, aux, lpips_params):
    spec = RUNS[run]
    fn_p, aux_params, dim = aux
    cfg = jloss.VAELossConfig(disc_start=spec["disc_start"], vf_weight=0.1,
                              adaptive_vf=spec["adaptive_vf"], distmat_margin=0.25,
                              cos_margin=0.5, perceptual_weight=1.0 if spec["lpips"] else 0.0)
    lp = JaxLPIPS()
    return JaxTrainer(
        JaxVAE(**VAE_KW), make_mesh(devices=jax.devices("cpu")[:1]), loss_cfg=cfg, lr=1e-4,
        use_vf=True, vf_dim=dim, aux_feature_fn=fn_p, aux_params=aux_params,
        lpips_fn=(lambda v, a, b: lp.apply(v, a, b)) if spec["lpips"] else None,
        lpips_params={"params": lpips_params} if spec["lpips"] else None,
        disc_layers=2, frozen_bf16=False)


def _port_trainer(run: str, aux_params, lpips_params, **kw) -> VAETrainer:
    spec = RUNS[run]
    fm = FoundationModel("dinov2-tiny", device="cpu")
    fm.model.load_state_dict(vit_state_from_jax(aux_params), strict=True)
    lp = None
    if spec["lpips"]:
        lp = LPIPS()
        lp.load_state_dict(lpips_state_from_jax(lpips_params), strict=True)
    cfg = tloss.VAELossConfig(disc_start=spec["disc_start"], vf_weight=0.1,
                              adaptive_vf=spec["adaptive_vf"], distmat_margin=0.25,
                              cos_margin=0.5, perceptual_weight=1.0 if spec["lpips"] else 0.0)
    kw = {"frozen_bf16": False, **kw}
    return VAETrainer(AutoencoderKL(**VAE_KW), loss_cfg=cfg, lr=1e-4, use_vf=True, vf_dim=64,
                      foundation=fm, lpips=lp, disc_layers=2, **kw)


def _load_jax_state(trainer: VAETrainer, js):
    """A fresh port state holding the JAX state's weights and stats."""
    state = trainer.fresh_state()
    gen = {f"vae.{k}": v for k, v in vae_state_from_jax(js.gen_params["vae"]).items()}
    gen["proj.weight"] = _t(np.transpose(js.gen_params["proj"]["kernel"], (3, 2, 0, 1)))
    disc = disc_state_from_jax({"params": js.disc_params, "batch_stats": js.disc_batch_stats})
    with torch.no_grad():
        for names, tensors, sd in ((state.gen_names, state.gen_params, gen),
                                   (state.disc_names, state.disc_params, disc),
                                   (state.stat_names, state.disc_stats, disc)):
            for n, t in zip(names, tensors):
                t.copy_(sd[n])
    return state


def _jax_flat(js) -> dict:
    """A JAX VAETrainState as the flat ``|``-keyed tree of the files."""
    return flatten(jax.tree_util.tree_map(np.asarray, {
        "step": js.step, "gen_params": js.gen_params, "disc_params": js.disc_params,
        "disc_batch_stats": js.disc_batch_stats,
        "gen_opt": {"0": js.gen_opt[0]._asdict()}, "disc_opt": {"0": js.disc_opt[0]._asdict()}}))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runs, one jit each, from one initial state (the JAX init,
    jitted): the state before and after each step, each step's noise and
    metrics, and the eval metrics at the end (one eval jit: it does not read
    the loss settings)."""
    aux = jax_aux()
    lpips_params = _jax_lpips_params(4)
    rng = jax.random.PRNGKey(11)
    down = 2 ** (len(VAE_KW["ch_mult"]) - 1)
    zshape = (B, S // down, S // down, VAE_KW["embed_dim"])
    out, host0, evaluator = {}, None, None
    for run, spec in RUNS.items():
        tr = _jax_trainer(run, aux, lpips_params)
        host0 = host0 or jax.device_get(jax.jit(tr.init_state)(jax.random.PRNGKey(3)))
        evaluator = evaluator or tr
        state = tr.replicate(host0)
        states, noises, metrics = [host0], [], []
        for s, x in enumerate(_batches()[:spec["steps"]]):
            noises.append(np.asarray(jax.random.normal(jax.random.fold_in(rng, s), zshape)))
            state, m = tr.train_step(state, rng, x)
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
            states.append(jax.device_get(state))
        ev = evaluator.eval_step(state, rng, _batches()[0])
        out[run] = dict(states=states, noises=noises, metrics=metrics,
                        eval={k: float(v) for k, v in jax.device_get(ev).items()})
    return aux[1], lpips_params, out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """Each port step from the JAX state before it (the whole state, moments
    included, through the JAX file and the port's reader), so every step is
    held on its own: Adam's first steps normalise each gradient element, so
    two fp32 trajectories drift apart where a gradient sits near eps."""
    aux_params, lpips_params, runs = jax_runs
    out = {}
    for run, ref in runs.items():
        tr = _port_trainer(run, aux_params, lpips_params)
        state = tr.init_state(0)
        d = str(tmp_path_factory.mktemp(run))
        metrics, after = [], []
        for s, (x, n) in enumerate(zip(_batches(), ref["noises"])):
            tckpt.restore_checkpoint(jckpt.save_checkpoint(d, s, ref["states"][s]), state)
            metrics.append({k: v.item() for k, v in tr.train_step(state, x, noise=n).items()})
            after.append({k: np.array(v) for k, v in tckpt.vae_state_tensors(state)[0].items()})
        ev = {k: v.item() for k, v in tr.eval_step(state, _batches()[0]).items()}
        out[run] = dict(trainer=tr, state=state, metrics=metrics, after=after, eval=ev)
    return out


METRICS = ("rec_loss", "kl_loss", "g_loss", "vf_loss", "vf_distmat", "vf_cos", "total_loss",
           "nll_loss", "vf_weight", "disc_factor", "disc_loss", "logits_real", "logits_fake")
# The GAN term's gradient: ‖∇g‖ is the small residual of cancelling terms
# (g = −mean(D(x̂)) through train-mode batch norm), scaled by d_weight ≈ 10³,
# and the discriminator's hinges and leaky ReLUs put kinks in the way. From
# the same inputs torch's two CPU convolution paths give d_weight 3.6e-4
# apart and, in a gate-open step, the generator's moments 5.8e-3 apart
# (relative Frobenius; scripts/vae_train_spread.py, which measures the
# packages 3.6e-4 and 1.9e-3 apart there): d_weight is held to
# D_WEIGHT_TOL and the gate-open moments to GAN_TOL, every other field to
# TOL. With LPIPS in the loss (summed over every pixel, so it dominates the
# gradient) the gate-closed generator moments land 3.5e-4 apart, because the
# JAX package's fp32 step lies 3.6e-4 from an fp64 evaluation of the port's
# step and the port's 6.8e-5 (relative Frobenius, same script): they are
# held to LPIPS_TOL over each optimizer.
D_WEIGHT_TOL, GAN_TOL, LPIPS_TOL = 1e-3, 1e-2, 1e-3


def _null(key: str) -> bool:
    """Parameters whose exact gradient is zero, so both packages return
    rounding noise: attention key biases (softmax over keys ignores them),
    level-0 biases feeding only a one-channel-per-group GroupNorm (ch 32),
    and the decoder's level-0 residual-stream biases (removed by its
    one-channel ``norm_out``)."""
    return ("|k|bias" in key or ("down_0_block" in key and key.endswith("conv1|bias"))
            or ("up_0_block" in key and key.endswith("bias")
                and ("|conv" in key or "nin_shortcut" in key)))


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_metrics_match_jax(run, jax_runs, port_runs):
    ref, got = jax_runs[2][run], port_runs[run]
    gates = [m["disc_factor"] for m in ref["metrics"]]
    assert 0.0 in gates and 1.0 in gates  # both regimes ran
    for s, (w, g) in enumerate(zip(ref["metrics"], got["metrics"])):
        for k in METRICS:
            assert abs(g[k] - w[k]) <= TOL * max(abs(w[k]), 1e-3), (run, s, k, g[k], w[k])
        assert abs(g["d_weight"] - w["d_weight"]) <= D_WEIGHT_TOL * w["d_weight"], (run, s, g, w)
        assert w["d_weight"] > 0 and w["vf_weight"] > 0
    for k, w in ref["eval"].items():
        assert abs(got["eval"][k] - w) <= TOL * abs(w), (k, got["eval"][k], w)


def _fro(got: dict, want: dict, keys) -> float:
    err = sum(float(np.square(got[k].astype(np.float64) - want[k]).sum()) for k in keys)
    ref = sum(float(np.square(want[k].astype(np.float64)).sum()) for k in keys)
    return (err / max(ref, 1e-30)) ** 0.5


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_state_matches_jax(run, jax_runs, port_runs):
    """After each step: step and counts equal; BN stats within TOL per
    tensor (max-abs over max|ref|); the updated weights within TOL over each
    module (relative Frobenius) and no element more than one Adam step of
    sign (2·lr) apart (Adam's first steps normalise every element, so one
    whose gradient sits near eps may flip); the moments within TOL per
    tensor with the gate closed, within GAN_TOL over each optimizer with it
    open, within LPIPS_TOL over each optimizer in the LPIPS run with it
    closed; the null directions at rounding size in both packages."""
    ref = jax_runs[2][run]
    lr = 1e-4
    for s, got in enumerate(port_runs[run]["after"]):
        want, before = _jax_flat(ref["states"][s + 1]), _jax_flat(ref["states"][s])
        gate_open = ref["metrics"][s]["disc_factor"] > 0
        assert sorted(want) == sorted(got)
        mu_max = max(np.abs(v).max() for k, v in want.items() if "|mu|" in k)
        groups = {}
        for key, w in want.items():
            g = got[key]
            if key == "step" or key.endswith("count"):
                assert int(g) == int(w) == s + 1, key
            elif key.startswith("disc_batch_stats"):
                assert max_rel(g, w) <= TOL, (s, key, max_rel(g, w))
                assert np.abs(w - before[key]).max() > 0, key  # the stats moved
            elif _null(key):
                if "|mu|" in key:
                    assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * mu_max, key
                elif key.startswith("gen_params"):
                    assert np.abs(g - w).max() <= 2 * lr * 1.01, key
            elif key.startswith(("gen_params", "disc_params")):
                assert np.abs(g - w).max() <= 2 * lr * 1.01, (s, key)
                groups.setdefault(key.split("|")[0], []).append(key)
            elif gate_open or RUNS[run]["lpips"]:
                groups.setdefault(key.rsplit("|", key.count("|") - 2)[0], []).append(key)
            else:
                assert max_rel(g, w) <= TOL, (s, key, max_rel(g, w))
        for group, keys in groups.items():
            tol = (GAN_TOL if gate_open else LPIPS_TOL) if "_opt" in group else TOL
            assert _fro(got, want, keys) <= tol, (s, group, _fro(got, want, keys))


def test_one_forward_per_step(jax_runs):
    """The adaptive weights come from the step's one graph: one encoder and
    one decoder forward a step, three discriminator forwards (fake, real,
    fake), and no gradient left on any parameter."""
    aux_params, lpips_params, runs = jax_runs
    tr = _port_trainer("lpips", aux_params, lpips_params)
    state = _load_jax_state(tr, runs["lpips"]["states"][0])
    calls = {"encoder": 0, "decoder": 0, "disc": 0, "foundation": 0, "lpips": 0}
    for name, mod in (("encoder", tr.vae.encoder), ("decoder", tr.vae.decoder),
                      ("disc", tr.disc), ("foundation", tr.foundation), ("lpips", tr.lpips)):
        mod.register_forward_hook(lambda *a, name=name: calls.__setitem__(name, calls[name] + 1))
    tr.train_step(state, _batches()[0])
    assert calls == {"encoder": 1, "decoder": 1, "disc": 3, "foundation": 1, "lpips": 1}
    assert all(p.grad is None for p in state.disc_params + state.gen_params)


def test_steps_pin_fp32():
    """``train_step``, ``eval_step`` and ``reconstruct`` run with TF32 off in
    cuDNN and cuBLAS whatever the caller set (fp32 compute is fp32 on the
    card), and hand the caller's flags back."""
    tr = VAETrainer(AutoencoderKL(**VAE_KW), use_vf=False, disc_layers=2)
    state, x = tr.init_state(0), _batches()[0]
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)  # noqa: E731
    seen = []
    tr.vae.encoder.register_forward_hook(lambda *a: seen.append(flags()))
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tr.train_step(state, x)
        tr.eval_step(state, x)
        tr.reconstruct(state, x)
        assert seen == [(False, False)] * 3 and flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_reconstruct_is_the_posterior_mean_decode(port_runs):
    tr, state = port_runs["fixed_vf"]["trainer"], port_runs["fixed_vf"]["state"]
    x = torch.from_numpy(_batches()[1])
    with torch.no_grad():
        want = tr.vae.decode(tr.vae.encode(x).mean)
    torch.testing.assert_close(tr.reconstruct(state, x), want, rtol=0, atol=0)


def test_frozen_bf16_close_to_fp32(jax_runs):
    """The frozen nets, the foundation model and LPIPS, in bf16 change one
    step's losses at bf16 noise only (the JAX package's tolerance,
    tests/test_vae_trainer.py)."""
    aux_params, lpips_params, runs = jax_runs
    metrics = {}
    for mode in (True, False):
        tr = _port_trainer("lpips", aux_params, lpips_params, frozen_bf16=mode)
        state = _load_jax_state(tr, runs["lpips"]["states"][0])
        m = tr.train_step(state, _batches()[0], noise=runs["lpips"]["noises"][0])
        metrics[mode] = {k: v.item() for k, v in m.items()}
        want = torch.bfloat16 if mode else torch.float32
        assert tr.foundation.model.norm.weight.dtype == tr.lpips.lin0.model[1].weight.dtype == want
        assert not tr.lpips.training and metrics[mode]["rec_loss"] > 0
    for k in ("total_loss", "rec_loss", "vf_loss", "nll_loss"):
        a, b = metrics[True][k], metrics[False][k]
        assert abs(a - b) <= 0.03 * max(abs(b), 1.0), (k, a, b)


def test_bf16_compute_close_to_fp32(jax_runs):
    """``compute_dtype`` bf16: autocast around the VAE, fp32 master weights
    that move, losses within the JAX package's bf16 tolerance."""
    aux_params, lpips_params, runs = jax_runs
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tr = _port_trainer("adaptive_vf", aux_params, lpips_params, compute_dtype=dt)
        state = _load_jax_state(tr, runs["adaptive_vf"]["states"][0])
        p0 = tr.vae.encoder.conv_in.weight.detach().clone()
        m = tr.train_step(state, _batches()[0], noise=runs["adaptive_vf"]["noises"][0])
        p1 = tr.vae.encoder.conv_in.weight
        assert p1.dtype == torch.float32 and (p1 - p0).abs().max() > 0
        out[dt] = {k: v.item() for k, v in m.items()}
    for k in ("rec_loss", "kl_loss", "nll_loss"):
        a, b = out[torch.bfloat16][k], out[torch.float32][k]
        assert abs(a - b) <= 0.05 * max(abs(b), 1.0), (k, a, b)
    with pytest.raises(ValueError, match="compute_dtype"):
        _port_trainer("adaptive_vf", aux_params, lpips_params, compute_dtype=torch.float16)


def test_noise_stream_is_per_step():
    """Without explicit noise each step draws from (seed, step): a state
    resumed at step s draws what the unbroken run drew."""
    tr = VAETrainer(AutoencoderKL(**VAE_KW), use_vf=False, disc_layers=2)
    x = _batches()[0]
    a = tr.init_state(0)
    tr.train_step(a, x)
    m_a = tr.train_step(a, x)
    b = tr.init_state(0)
    tr.train_step(b, x)
    saved = [t.clone() for t in b.gen_params]
    m_b = tr.train_step(b, x)
    assert m_a["rec_loss"].item() == m_b["rec_loss"].item()
    assert any((s != t).any() for s, t in zip(saved, b.gen_params))


# -- checkpoints across the packages -------------------------------------------------


def test_port_checkpoint_restores_in_jax(tmp_path, jax_runs, port_runs):
    """A port checkpoint restores in the JAX package into an equal tree."""
    state = port_runs["fixed_vf"]["state"]
    path = tckpt.save_checkpoint(str(tmp_path), state.step, state)
    target = jax_runs[2]["fixed_vf"]["states"][0]
    restored = jckpt.restore_checkpoint(path, target)
    want, _ = tckpt.vae_state_tensors(state)
    got = flatten(jax.tree_util.tree_map(np.asarray, {
        "step": restored.step, "gen_params": restored.gen_params,
        "disc_params": restored.disc_params, "disc_batch_stats": restored.disc_batch_stats,
        "gen_opt": {"0": restored.gen_opt[0]._asdict()},
        "disc_opt": {"0": restored.disc_opt[0]._asdict()}}))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert type(restored.gen_opt[1]).__name__ == "EmptyState"


def test_jax_checkpoint_restores_in_port(tmp_path, jax_runs, port_runs):
    """A JAX checkpoint restores strictly into a fresh port state, leaf for
    leaf; a file of another architecture is refused."""
    ref = jax_runs[2]["adaptive_vf"]["states"][-1]
    path = jckpt.save_checkpoint(str(tmp_path), int(ref.step), ref)
    tr = port_runs["adaptive_vf"]["trainer"]
    fresh = VAETrainer(AutoencoderKL(**VAE_KW), loss_cfg=tr.loss_cfg, use_vf=True, vf_dim=64,
                       disc_layers=2, frozen_bf16=False)
    state = fresh.init_state(9)
    tckpt.restore_checkpoint(path, state)
    got, _ = tckpt.vae_state_tensors(state)
    want = flatten(jax.tree_util.tree_map(np.asarray, {
        "step": ref.step, "gen_params": ref.gen_params, "disc_params": ref.disc_params,
        "disc_batch_stats": ref.disc_batch_stats,
        "gen_opt": {"0": ref.gen_opt[0]._asdict()}, "disc_opt": {"0": ref.disc_opt[0]._asdict()}}))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    other = VAETrainer(AutoencoderKL(**VAE_KW), use_vf=True, vf_dim=16, disc_layers=2)
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_checkpoint(path, other.init_state(0))


def test_vae_bridge_round_trip():
    """``vae_state_to_jax`` inverts ``vae_state_from_jax`` on the f16d32
    layout (every level kind: attention, down/up-sampling, shortcuts)."""
    m = AutoencoderKL(embed_dim=4, ch=32, ch_mult=(1, 2, 2), resolution=32,
                      attn_resolutions=(16,))
    sd = {k: torch.randn(v.shape) for k, v in m.state_dict().items()}
    back = vae_state_from_jax(vae_state_to_jax(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    jm = JaxVAE(embed_dim=4, ch=32, ch_mult=(1, 2, 2), resolution=32, attn_resolutions=(16,))
    jp = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                        jnp.zeros((1, 32, 32, 3)), sample=False))["params"]
    mine = flatten(vae_state_to_jax(sd))
    theirs = flatten(jax.tree_util.tree_map(lambda s: s.shape, jp))
    assert sorted(mine) == sorted(theirs)
    assert all(mine[k].shape == theirs[k] for k in mine)

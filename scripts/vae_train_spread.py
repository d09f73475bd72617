"""How far apart two correct fp32 computations of the VA-VAE train step land,
on the CPU: the tolerances of ``tests/test_torch_vae_train.py`` rest on it.

For each run and step of that file's tiny trainer, from the JAX state before
the step (carried through the JAX file and the port's reader), it prints the
relative error of the port against the JAX package, of the port with
oneDNN on against the port with it off (torch's two CPU convolution paths),
and of the JAX package and of the port against the port's step computed in
fp64: d_weight, and the relative Frobenius error of each state group. Then the
projector's first moment after the fixed_vf run's first step from the
port's init instead of the JAX init, with the VF loss's relu gates that
flip between the port's fp32 and fp64 steps; the same two spreads as above
for LPIPS's input gradient at 32 px; and the fp32 bilinear resize of
``models/vit.py`` against ``vavae_tpu/utils/interp.py``.

Each list is [port vs JAX, oneDNN on vs off, JAX vs fp64, port vs fp64].

    JAX_PLATFORMS=cpu python scripts/vae_train_spread.py   (about 2 minutes)
"""
import contextlib
import json
import os
import sys
import tempfile

sys.path[:0] = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", d)
                for d in ("", "tests")]

import conftest  # noqa: E402,F401  (fp32 JAX matmuls, as the tests run)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_vae_train as T  # noqa: E402
from vavae_tpu.models.lpips import LPIPS as JaxLPIPS  # noqa: E402
from vavae_tpu.train import checkpoint as jckpt  # noqa: E402
from vavae_tpu.utils.interp import torch_resize_2d  # noqa: E402
from vavae_tpu_torch.models.lpips import LPIPS  # noqa: E402
from vavae_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from vavae_tpu_torch.utils.weights import lpips_state_from_jax  # noqa: E402


def group(key: str) -> str:
    return key.split("|")[0] + ("|mu" if "|mu|" in key else "|nu" if "|nu|" in key else "")


def fro(a: dict, b: dict, keys) -> float:
    err = sum(float(np.square(a[k].astype(np.float64) - b[k]).sum()) for k in keys)
    return (err / max(sum(float(np.square(b[k].astype(np.float64)).sum()) for k in keys),
                      1e-30)) ** 0.5


@contextlib.contextmanager
def fp64_casts():
    """The port's fp32 casts (images, noise, the posterior, the
    discriminator's batch norm, Adam's moments) keep fp64 tensors fp64."""
    to, flt = torch.Tensor.to, torch.Tensor.float

    def to64(self, *a, **k):
        if self.dtype == torch.float64:
            a = tuple(torch.float64 if v is torch.float32 else v for v in a)
            k = {n: torch.float64 if v is torch.float32 else v for n, v in k.items()}
        return to(self, *a, **k)

    torch.Tensor.to = to64
    torch.Tensor.float = lambda self: self if self.dtype == torch.float64 else flt(self)
    try:
        yield
    finally:
        torch.Tensor.to, torch.Tensor.float = to, flt


def port_step(run, aux_params, lpips_params, path, x, noise, onednn: bool, fp64: bool = False):
    torch.backends.mkldnn.enabled = onednn
    try:
        tr = T._port_trainer(run, aux_params, lpips_params)
        state = tr.init_state(0)
        if fp64:
            for net in (tr.gen, tr.disc, tr.foundation, tr.lpips):
                if net is not None:
                    net.double()
            state = tr.fresh_state()
            x, noise = torch.from_numpy(x).double(), torch.from_numpy(noise).double()
        tckpt.restore_checkpoint(path, state)
        with fp64_casts() if fp64 else contextlib.nullcontext():
            m = tr.train_step(state, x, noise=noise)
        return m["d_weight"].item(), {k: np.array(v) for k, v in
                                      tckpt.vae_state_tensors(state)[0].items()}
    finally:
        torch.backends.mkldnn.enabled = True


def trainer_spread() -> list:
    aux = T.jax_aux()
    lpips_params = T._jax_lpips_params(4)
    d, rows = tempfile.mkdtemp(), []
    for run, spec in T.RUNS.items():
        tr = T._jax_trainer(run, aux, lpips_params)
        rng = jax.random.PRNGKey(11)
        host = jax.device_get(jax.jit(tr.init_state)(jax.random.PRNGKey(3)))  # as the tests
        state = tr.replicate(host)
        for s, x in enumerate(T._batches()[:spec["steps"]]):
            noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, s), (T.B, 16, 16, 4)))
            path = jckpt.save_checkpoint(d, s, host)
            dw_on, on = port_step(run, aux[1], lpips_params, path, x, noise, True)
            dw_off, off = port_step(run, aux[1], lpips_params, path, x, noise, False)
            dw_64, f64 = port_step(run, aux[1], lpips_params, path, x, noise, True, fp64=True)
            state, m = tr.train_step(state, rng, x)
            host = jax.device_get(state)
            want = T._jax_flat(host)
            keys: dict = {}
            for k in want:
                if k != "step" and not k.endswith("count") and not T._null(k):
                    keys.setdefault(group(k), []).append(k)
            dw = float(m["d_weight"])
            rows.append({"run": run, "step": s, "gate": float(m["disc_factor"]),
                         "d_weight": [abs(dw_on - dw) / dw, abs(dw_on - dw_off) / dw,
                                      abs(dw - dw_64) / dw_64, abs(dw_on - dw_64) / dw_64],
                         **{g: [fro(on, want, ks), fro(on, off, ks), fro(want, f64, ks),
                                fro(on, f64, ks)] for g, ks in keys.items()}})
    return rows


def vf_gate_flips() -> dict:
    """The fixed_vf run's first step from another start, the port's
    ``init_state(3)`` read by the JAX package: the projector's first moment
    (max-abs over max|ref|) of the port against the JAX package, of each
    against the port's fp64 step, and the VF loss's relu gates (distance
    matrix at its margin, cosine at its margin) that the port's fp32 and
    fp64 steps set differently."""
    aux, lpips_params = T.jax_aux(), T._jax_lpips_params(4)
    tr = T._jax_trainer("fixed_vf", aux, lpips_params)
    init = T.VAETrainer(T.AutoencoderKL(**T.VAE_KW), use_vf=True, vf_dim=aux[2], disc_layers=2)
    path = tckpt.save_checkpoint(tempfile.mkdtemp(), 0, init.init_state(3))
    host = jckpt.restore_checkpoint(path, jax.eval_shape(tr.init_state, jax.random.PRNGKey(3)))
    rng, x = jax.random.PRNGKey(11), T._batches()[0]
    noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 0), (T.B, 16, 16, 4)))
    state, _ = tr.train_step(tr.replicate(host), rng, x)
    want = T._jax_flat(jax.device_get(state))
    feats, states = {}, {}
    hook = T.VAETrainer.train_step

    def grab(trainer, st, images, noise):  # the projected latents and the features
        got = feats.setdefault(torch.is_tensor(images), {})  # the fp64 step takes tensors
        trainer.gen.proj.register_forward_hook(
            lambda m, i, o: got.__setitem__("z", o.detach().permute(0, 2, 3, 1)))
        trainer.foundation.register_forward_hook(lambda m, i, o: got.__setitem__("a", o))
        return hook(trainer, st, images, noise=noise)

    T.VAETrainer.train_step = grab
    try:
        for fp64 in (False, True):
            states[fp64] = port_step("fixed_vf", aux[1], lpips_params, path, x, noise, True, fp64)[1]
    finally:
        T.VAETrainer.train_step = hook

    def gates(z, a):
        B, H, W, C = z.shape
        zn, an = (F.normalize(t.reshape(B, H * W, C).double(), dim=-1) for t in (z, a))
        dist = (zn @ zn.transpose(1, 2) - an @ an.transpose(1, 2)).abs() > 0.25
        return dist, (zn * an).sum(-1) < 0.5

    (d32, c32), (d64, c64) = (gates(feats[fp64]["z"], feats[fp64]["a"]) for fp64 in (False, True))
    key = "gen_opt|0|mu|proj|kernel"
    rel = lambda g, w: float(np.abs(g - w).max() / np.abs(w).max())  # noqa: E731
    return {"port_vs_jax": rel(states[False][key], want[key]),
            "jax_vs_fp64": rel(want[key], states[True][key]),
            "port_vs_fp64": rel(states[False][key], states[True][key]),
            "distmat_gate_flips": int((d32 != d64).sum()), "cos_gate_flips": int((c32 != c64).sum())}


def lpips_spread() -> dict:
    params = T._jax_lpips_params(4)
    tm = LPIPS()
    tm.load_state_dict(lpips_state_from_jax(params))
    tm.eval()  # dropout off before the lin heads, as the trainer runs it
    rs = np.random.default_rng(0)
    a, b = ((0.5 * rs.normal(size=(4, 32, 32, 3))).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.grad(lambda bb: jnp.sum(JaxLPIPS().apply(
        {"params": params}, jnp.asarray(a), bb)))(jnp.asarray(b)))
    grads = []
    for onednn in (True, False):
        torch.backends.mkldnn.enabled = onednn
        bt = torch.from_numpy(b).requires_grad_()
        grads.append(torch.autograd.grad(tm(torch.from_numpy(a), bt).sum(), bt)[0].numpy())
    torch.backends.mkldnn.enabled = True
    rel = lambda g, w: float(np.linalg.norm(g - w) / np.linalg.norm(w))  # noqa: E731
    return {"jax_vs_port": rel(grads[0], want), "onednn_on_vs_off": rel(grads[0], grads[1])}


def resize_spread() -> dict:
    out = {}
    for size in (32, 256):
        x = np.random.default_rng(1).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        want = np.asarray(torch_resize_2d(jnp.asarray(x), (224, 224), "bilinear"))
        for dtype in (torch.float32, torch.float64):
            got = F.interpolate(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2), (224, 224),
                                mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
            out[f"{size}px_{str(dtype)[6:]}"] = float(np.abs(got.float().numpy() - want).max())
    return out


if __name__ == "__main__":
    for row in trainer_spread():
        print(json.dumps({k: v if not isinstance(v, list) else [f"{e:.2e}" for e in v]
                          for k, v in row.items()}))
    print(json.dumps({"proj_moment_from_the_port_init": vf_gate_flips()}))
    print(json.dumps({"lpips_input_grad": lpips_spread()}))
    print(json.dumps({"bilinear_resize_max_abs": resize_spread()}))

"""The port's long route (N > 1024 tokens) against the TPU kernel's own body
and the JAX entry points.

``_flash_kernel`` runs here through ``pl.pallas_call(..., interpret=True)``,
fed as ``_forward`` feeds it for N > ``SMALL_SEQ_MAX``: q and k rotated by
``apply_rope`` with the fp32 tables uncast, each input folded to (B·H, N,
128) with ``_pad_to``, grid ``(B·H, N // 256)``, the BlockSpecs of
``_forward`` without a TPU memory space. The CUDA kernel ``flash_fwd.cu`` is
held against the plain version by tests/test_torch_emulation_first.py and
tests/test_torch_emulation_long_wgmma.py (its source on the CPU),
tests/test_torch_cuda.py and chip_smoke.py (on the card).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vavae_tpu.models.layers import apply_rope as jax_apply_rope
from vavae_tpu.models.posembed import rope_2d_freqs
from vavae_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from vavae_tpu.ops.pallas import flash_attention as jfa
from vavae_tpu_torch.ops import flash_attention as fa
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False


def _pallas_flash(q, k, v) -> np.ndarray:
    """(B, N, H, D) q̃, k̃, v through the interpreted ``_flash_kernel`` with
    ``_forward``'s layout, grid and blocks (block_q = block_k = 256)."""
    B, N, H, D = q.shape

    def to_bh(x):
        return jfa._pad_to(jnp.swapaxes(x, 1, 2).reshape(B * H, N, D), 2, 128)

    qb, kb, vb = to_bh(q), to_bh(k), to_bh(v)
    BH, _, Dp = qb.shape
    bq = min(jfa.DEFAULT_BLOCK_Q, N)
    out = pl.pallas_call(
        functools.partial(jfa._flash_kernel, scale=D ** -0.5,
                          block_k=min(jfa.DEFAULT_BLOCK_K, N), kv_len=N),
        grid=(BH, N // bq),
        in_specs=[pl.BlockSpec((1, bq, Dp), lambda b, i: (b, i, 0)),
                  pl.BlockSpec((1, N, Dp), lambda b, i: (b, 0, 0)),
                  pl.BlockSpec((1, N, Dp), lambda b, i: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, Dp), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((BH, N, Dp), q.dtype), interpret=True,
    )(qb, kb, vb)
    assert out.dtype == q.dtype
    out = out[:, :, :D].reshape(B, H, N, D)
    return np.asarray(jnp.swapaxes(out, 1, 2).astype(jnp.float32))


def _inputs(N: int, D: int, seed: int = 0, B: int = 1, H: int = 2):
    rs = np.random.default_rng(seed)
    qkv = rs.standard_normal((B, N, 3, H, D)).astype(np.float32)
    g = rs.standard_normal((B, N, H, D)).astype(np.float32)
    return qkv, g, rope_2d_freqs(D, int(np.ceil(N ** 0.5)))


def _tables(tables, N):
    return tuple(t[:N] for t in tables)


@pytest.mark.parametrize("v_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 72])
@pytest.mark.parametrize("N", [1280, 2304])
def test_long_reference_matches_pallas_flash_kernel(N, D, v_dtype):
    """The rotation (fp32 tables uncast) and the plain version against JAX
    ``apply_rope`` and the interpreted ``_flash_kernel``. fp32 throughout:
    summation order only, 1e-5 max-abs. fp32 q̃, k̃ with bf16 v (a bf16 RoPE
    model: bf16 q, k promote to fp32 in the rotation): P rounds to bf16
    against the running max in the kernel and the final max in the plain
    version, 2e-3 max-abs."""
    qkv, _, tables = _inputs(N, D)
    tables = _tables(tables, N)
    jdt = jnp.dtype(v_dtype)
    q, k, v = (jnp.asarray(qkv[:, :, i], jdt) for i in range(3))
    cos, sin = (jnp.asarray(t)[None, :, None, :] for t in tables)
    qr, kr = jax_apply_rope(q, cos, sin), jax_apply_rope(k, cos, sin)
    assert qr.dtype == jnp.float32  # bf16 × fp32 tables promote
    want = _pallas_flash(qr, kr, v)

    tq, tk, tv = (torch.from_numpy(qkv[:, :, i]).to(getattr(torch, v_dtype)) for i in range(3))
    got = fa.long_attention_reference(tq, tk, tv, tables)
    assert got.dtype == torch.float32 and got.shape == (1, N, 2, D)
    tol = 1e-5 if v_dtype == "float32" else 2e-3
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("N", [1100, 1280])
def test_cpu_entry_points_match_jax(N, rope):
    """The port's CPU ``flash_attention`` and ``fused_qkv_attention`` at
    N > 1024 (the long route, N = 1100 not a multiple of 256) against the
    JAX ``flash_attention``'s and ``fused_qkv_attention``'s CPU path
    (``dot_product_attention``: RoPE, XLA attention), fp32, 1e-5 max-abs."""
    qkv, _, tables = _inputs(N, 72, seed=1)
    tables = _tables(tables, N) if rope else None
    jrope = None if tables is None else tuple(jnp.asarray(t) for t in tables)
    jq = jnp.asarray(qkv)
    want_sep = np.asarray(jax_dot_product_attention(*jnp.moveaxis(jq, 2, 0), rope=jrope))
    want_fused = np.asarray(jfa.fused_qkv_attention(jq, rope=jrope))
    x = torch.from_numpy(qkv)
    got_sep = fa.flash_attention(*x.unbind(dim=2), rope=tables)
    got_fused = fa.fused_qkv_attention(x, rope=tables)
    np.testing.assert_allclose(got_sep.numpy(), want_sep, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_fused.numpy(), want_fused, atol=1e-5, rtol=0)


@pytest.mark.parametrize("entry", ["flash_attention", "fused_qkv_attention"])
@pytest.mark.parametrize("rope", [True, False])
def test_long_route_backward_matches_jax_vjp(rope, entry):
    """torch.autograd.grad through the long route (``_LongAttention``, whose
    backward is autograd of ``xla_rope_attention``) against ``jax.vjp`` of
    ``_xla_rope_attention``, the op the JAX ``_bwd`` differentiates for
    N > 1024, at N = 1280, fp32, 1e-5 max-abs for q, k and v."""
    N = 1280
    qkv, g, tables = _inputs(N, 72, seed=2)
    tables = _tables(tables, N) if rope else None
    jrope = None if tables is None else tuple(jnp.asarray(t) for t in tables)
    _, vjp = jax.vjp(lambda q, k, v: jfa._xla_rope_attention(q, k, v, jrope),
                     *jnp.moveaxis(jnp.asarray(qkv), 2, 0))
    want = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_(True)
    if entry == "flash_attention":
        out = fa.flash_attention(*x.unbind(dim=2), rope=tables)
    else:
        out = fa.fused_qkv_attention(x, rope=tables)
    assert out.grad_fn is not None and "LongAttention" in type(out.grad_fn).__name__
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    for i in range(3):
        np.testing.assert_allclose(got[:, :, i].numpy(), np.asarray(want[i]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("N,long", [(1024, False), (1025, True)])
def test_routing_threshold(N, long, monkeypatch):
    """N ≤ SMALL_SEQ_MAX keeps the small kernels' route, N > SMALL_SEQ_MAX
    takes the long one, for both entry points (CPU tensors; on the card the
    same branch picks the kernel)."""
    calls = []
    original = fa._long_forward
    monkeypatch.setattr(fa, "_long_forward", lambda *a: calls.append(1) or original(*a))
    x = torch.from_numpy(_inputs(N, 8, seed=3, H=1)[0])
    fa.fused_qkv_attention(x)
    fa.flash_attention(*x.unbind(dim=2))
    assert len(calls) == (2 if long else 0)


@pytest.mark.parametrize("qknorm", [False, True])
@pytest.mark.parametrize("remat", [None, "dots"])
def test_dit_gradients_through_long_route_match_jax_grad(remat, qknorm, monkeypatch):
    """A tiny DiT (depth 2, hidden 64, 2 heads, patch 1) at 33×33 latents,
    N = 1089 > 1024: parameter gradients of sum(velocity · w) through the
    long route against jax.grad of the JAX model (CPU: plain attention),
    fp32, 1e-4 of each tensor's largest element. With the qk-norm branch the
    port's ``dot_product_attention`` is replaced by ``flash_attention``,
    which it calls on the card. Under remat "dots" the long route's forward
    runs again in the backward: twice per block."""
    from test_torch_common import max_rel, tiny_dit_pair
    from vavae_tpu_torch.models import layers
    from vavae_tpu_torch.utils.weights import dit_state_from_jax

    jm, params, tm = tiny_dit_pair(seed=4, input_size=33, hidden_size=64, num_heads=2,
                                   use_qknorm=qknorm)
    tm.use_checkpoint, tm.checkpoint_policy = remat is not None, remat or "nothing"
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 33, 33, 4)).astype(np.float32)
    t = rs.uniform(0, 1, (2,)).astype(np.float32)
    y = rs.integers(0, 10, (2,)).astype(np.int32)
    w = rs.standard_normal((2, 33, 33, 4)).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(out * jnp.asarray(w))

    want = dit_state_from_jax(jax.grad(jloss)(params))
    calls = []
    original = fa._long_forward
    monkeypatch.setattr(fa, "_long_forward", lambda *a: calls.append(1) or original(*a))
    if qknorm:
        monkeypatch.setattr(layers, "dot_product_attention", fa.flash_attention)
    names, tparams = zip(*tm.named_parameters())
    out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tparams)
    assert len(calls) == tm.depth * (2 if remat else 1)
    for name, g in zip(names, got):
        assert max_rel(g.numpy(), want[name].numpy()) < 1e-4, name

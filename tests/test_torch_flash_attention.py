"""The port's separate-q/k/v attention (the qk-norm branch) against the TPU
kernels' own bodies and the JAX entry points.

``_attn_kernel_small_rope``, ``_attn_kernel_small`` and
``_attn_bwd_kernel_small`` run here through ``pl.pallas_call(...,
interpret=True)`` with the JAX package's ``_pad_halves``, ``_pad_to``,
``_unpad_halves`` and ``_heads_per_program`` and the BlockSpecs of
``_forward`` and ``_bwd_pallas`` without a TPU memory space, so the port's
plain versions are held against the Pallas kernels themselves. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vavae_tpu.models.posembed import rope_2d_freqs
from vavae_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from vavae_tpu.ops.pallas import flash_attention as jfa
from vavae_tpu_torch.ops.attention import dot_product_attention
from vavae_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False


def _to_bh(x, halves: bool):
    """(B, N, H, D) → (B·H, N, 128) as ``_forward``/``_bwd_pallas`` lay it out."""
    B, N, H, D = x.shape
    x = jnp.swapaxes(x, 1, 2).reshape(B * H, N, D)
    return jfa._pad_halves(x, 128) if halves else jfa._pad_to(x, 2, 128)


def _from_bh(x, shape, halves: bool):
    B, N, H, D = shape
    x = jfa._unpad_halves(x, D) if halves else x[..., :D]
    return np.asarray(jnp.swapaxes(x.reshape(B, H, N, D), 1, 2).astype(jnp.float32))


def _padded_tables(rope, N, Dp):
    if rope is None:  # _bwd_pallas hands the no-RoPE kernel ones/zeros tables
        return jnp.ones((N, Dp), jnp.float32), jnp.zeros((N, Dp), jnp.float32)
    return tuple(jfa._pad_halves(jnp.asarray(t, jnp.float32), 128) for t in rope)


def _pallas_fwd(q, k, v, rope, dtype=jnp.float32) -> np.ndarray:
    """(B, N, H, D) through ``_attn_kernel_small_rope`` (``rope`` given) or
    ``_attn_kernel_small``, interpreted, with ``_forward``'s layout."""
    q, k, v = (jnp.asarray(t, dtype) for t in (q, k, v))
    B, N, H, D = q.shape
    use_rope = rope is not None
    qb, kb, vb = _to_bh(q, use_rope), _to_bh(k, use_rope), _to_bh(v, False)
    BH, _, Dp = qb.shape
    G = jfa._heads_per_program(BH, N, Dp, itemsize=qb.dtype.itemsize)
    spec = pl.BlockSpec((G, N, Dp), lambda b: (b, 0, 0))
    tspec = pl.BlockSpec((N, Dp), lambda b: (0, 0))
    if use_rope:
        kernel = functools.partial(jfa._attn_kernel_small_rope, scale=D ** -0.5)
        in_specs, args = [spec] * 3 + [tspec] * 2, (qb, kb, vb, *_padded_tables(rope, N, Dp))
    else:
        kernel = functools.partial(jfa._attn_kernel_small, scale=D ** -0.5)
        in_specs, args = [spec] * 3, (qb, kb, vb)
    out = pl.pallas_call(
        kernel, grid=(BH // G,), in_specs=in_specs, out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((BH, N, Dp), q.dtype), interpret=True,
    )(*args)
    return _from_bh(out, q.shape, False)


def _pallas_bwd(q, k, v, g, rope, dtype=jnp.float32):
    """(dq, dk, dv) through ``_attn_bwd_kernel_small``, interpreted, with
    ``_bwd_pallas``'s layout and heads per program."""
    q, k, v, g = (jnp.asarray(t, dtype) for t in (q, k, v, g))
    B, N, H, D = q.shape
    use_rope = rope is not None
    qb, kb = _to_bh(q, use_rope), _to_bh(k, use_rope)
    vb, gb = _to_bh(v, False), _to_bh(g, False)
    BH, _, Dp = qb.shape
    per_head = 3 * N * N * 4 + 7 * N * Dp * qb.dtype.itemsize  # _bwd_pallas's budget
    G = max(1, min(16, 8 * 1024 * 1024 // per_head))
    while BH % G:
        G -= 1
    spec = pl.BlockSpec((G, N, Dp), lambda b: (b, 0, 0))
    tspec = pl.BlockSpec((N, Dp), lambda b: (0, 0))
    dq, dk, dv = pl.pallas_call(
        functools.partial(jfa._attn_bwd_kernel_small, scale=D ** -0.5, use_rope=use_rope),
        grid=(BH // G,), in_specs=[spec] * 4 + [tspec] * 2, out_specs=[spec] * 3,
        out_shape=[jax.ShapeDtypeStruct((BH, N, Dp), q.dtype)] * 3, interpret=True,
    )(qb, kb, vb, gb, *_padded_tables(rope, N, Dp))
    return (_from_bh(dq, q.shape, use_rope), _from_bh(dk, q.shape, use_rope),
            _from_bh(dv, q.shape, False))


def _inputs(N: int, D: int, rope: bool, seed: int = 0, B: int = 2, H: int = 4):
    """q, k, v as slices of one (B, N, 3, H, D) array (v strided, as on the
    qk-norm path), the output gradient, and the tables."""
    rs = np.random.default_rng(seed)
    qkv = rs.standard_normal((B, N, 3, H, D)).astype(np.float32)
    g = rs.standard_normal((B, N, H, D)).astype(np.float32)
    tables = rope_2d_freqs(D, int(round(N ** 0.5))) if rope else None
    return qkv, g, tables


def _torch_qkv(qkv: np.ndarray, dtype=torch.float32):
    return torch.from_numpy(qkv).to(dtype).unbind(dim=2)


def _max_rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("D", [72, 64])
@pytest.mark.parametrize("N", [64, 256])
def test_flash_reference_matches_pallas_kernel_fp32(N, D, rope):
    # fp32 end to end: only summation order differs
    qkv, _, tables = _inputs(N, D, rope)
    want = _pallas_fwd(*np.moveaxis(qkv, 2, 0), tables)
    got = flash_attention_reference(*_torch_qkv(qkv), tables).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_flash_reference_matches_pallas_kernel_bf16(rope):
    # bf16 operands: the RoPE products and P round at slightly different
    # places in XLA's fusions; 2e-2 max-abs is the TPU kernel's own tolerance
    # (tests/test_ops.py:99)
    qkv, _, tables = _inputs(64, 72, rope, seed=1)
    want = _pallas_fwd(*np.moveaxis(qkv, 2, 0), tables, jnp.bfloat16)
    got = flash_attention_reference(*_torch_qkv(qkv, torch.bfloat16), tables)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("D", [72, 64])
@pytest.mark.parametrize("N", [64, 256])
def test_flash_bwd_reference_matches_pallas_kernel_fp32(N, D, rope):
    # fp32 end to end: only summation order differs
    qkv, g, tables = _inputs(N, D, rope, seed=2)
    want = _pallas_bwd(*np.moveaxis(qkv, 2, 0), g, tables)
    got = flash_attention_bwd_reference(*_torch_qkv(qkv), torch.from_numpy(g), tables)
    for a, b in zip(got, want):
        assert a.shape == (2, N, 4, D)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_flash_bwd_reference_matches_pallas_kernel_bf16(rope):
    # bf16: P and dS round at slightly different places in XLA's fusions;
    # 3e-2 of max|ref| is the TPU backward kernel's own tolerance
    # (tests/test_ops.py:188-190)
    qkv, g, tables = _inputs(64, 72, rope, seed=3)
    want = _pallas_bwd(*np.moveaxis(qkv, 2, 0), g, tables, jnp.bfloat16)
    got = flash_attention_bwd_reference(*_torch_qkv(qkv, torch.bfloat16),
                                        torch.from_numpy(g).bfloat16(), tables)
    for a, b in zip(got, want):
        assert _max_rel(a, b) <= 3e-2


@pytest.mark.parametrize("rope", [True, False])
def test_cpu_entry_points_match_jax_dot_product_attention(rope):
    """The port's ``flash_attention`` and ``dot_product_attention`` on CPU
    tensors against the JAX ``dot_product_attention`` (its CPU path: RoPE by
    rotate_half, XLA attention), fp32."""
    qkv, _, tables = _inputs(256, 72, rope, seed=4)
    jrope = None if tables is None else tuple(jnp.asarray(t) for t in tables)
    want = np.asarray(jax_dot_product_attention(*jnp.moveaxis(jnp.asarray(qkv), 2, 0), rope=jrope))
    trope = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    for fn in (flash_attention, dot_product_attention):
        got = fn(*_torch_qkv(qkv), trope).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_cpu_autograd_matches_jax_grad(rope):
    """torch.autograd.grad of the port's CPU ``flash_attention`` against
    jax.grad of ``_xla_rope_attention`` (the exact op the JAX custom VJP
    falls back to), fp32, for q, k and v."""
    qkv, g, tables = _inputs(64, 72, rope, seed=5)
    jrope = None if tables is None else tuple(jnp.asarray(t) for t in tables)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jfa._xla_rope_attention(q, k, v, jrope) * jnp.asarray(g)),
        argnums=(0, 1, 2))(*jnp.moveaxis(jnp.asarray(qkv), 2, 0))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = flash_attention(*x.unbind(dim=2), tables)
    (got,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), x)
    for i in range(3):
        np.testing.assert_allclose(got[:, :, i].numpy(), np.asarray(want[i]), atol=1e-5, rtol=0)

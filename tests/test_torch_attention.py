"""The port's fused-qkv attention against the TPU kernels' own bodies.

``_nat_fwd_kernel`` and ``_nat_bwd_kernel`` run here through
``pl.pallas_call(..., interpret=True)`` with the JAX package's ``_fold_sin``
/ ``_nat_group`` (the BlockSpecs of ``_nat_forward`` and ``_nat_bwd_rule``
without a TPU memory space), so the port's plain versions are held against
the Pallas kernels themselves, not only against the XLA fallback. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vavae_tpu.models.posembed import rope_2d_freqs
from vavae_tpu.ops.pallas import flash_attention as jfa
from vavae_tpu_torch.ops.flash_attention import (
    fused_qkv_attention,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
)
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False


def _pallas_nat_fwd(qkv5: np.ndarray, rope, dtype=jnp.float32) -> np.ndarray:
    """(B, N, 3, H, D) → (B, N, H, D) through the Pallas kernel, interpreted,
    with the layout transposes of ``fused_qkv_attention``."""
    B, N, _, H, D = qkv5.shape
    qkv3 = jnp.asarray(qkv5, dtype).transpose(0, 2, 3, 1, 4)
    gh = jfa._nat_group(H, N, D, bwd=False, itemsize=qkv3.dtype.itemsize)
    if rope is not None:
        cos, sinf = jfa._fold_sin(rope, N, D)
    else:
        cos = sinf = jnp.zeros((N, D), jnp.float32)
    spec = pl.BlockSpec((1, 3, gh, N, D), lambda b, h: (b, 0, h, 0, 0))
    tspec = pl.BlockSpec((N, D), lambda b, h: (0, 0))
    out = pl.pallas_call(
        functools.partial(jfa._nat_fwd_kernel, scale=D ** -0.5, use_rope=rope is not None),
        grid=(B, H // gh),
        in_specs=[spec, tspec, tspec],
        out_specs=pl.BlockSpec((1, gh, N, D), lambda b, h: (b, h, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, H, N, D), qkv3.dtype),
        interpret=True,
    )(qkv3, cos, sinf)
    return np.asarray(out.transpose(0, 2, 1, 3).astype(jnp.float32))


def _inputs(N: int, D: int, rope: bool, seed: int = 0, B: int = 2, H: int = 4):
    x = np.random.default_rng(seed).standard_normal((B, N, 3, H, D)).astype(np.float32)
    tables = rope_2d_freqs(D, int(round(N ** 0.5))) if rope else None
    return x, tables


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("D", [72, 64])
@pytest.mark.parametrize("N", [64, 256])
def test_reference_matches_pallas_kernel_fp32(N, D, rope):
    # fp32 end to end: only summation order differs (measured ≤ 7e-7)
    x, tables = _inputs(N, D, rope)
    want = _pallas_nat_fwd(x, tables)
    got = fused_qkv_attention_reference(torch.from_numpy(x), tables).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_reference_matches_pallas_kernel_bf16():
    # bf16 operands: the RoPE products and P round at slightly different
    # places in XLA's fusions; 2e-2 is the TPU kernel's own tolerance
    # (tests/test_ops.py:99)
    x, tables = _inputs(64, 72, True)
    want = _pallas_nat_fwd(x, tables, jnp.bfloat16)
    got = fused_qkv_attention_reference(torch.from_numpy(x).bfloat16(), tables)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_cpu_entry_point_matches_jax_entry_point(rope):
    """The port's ``fused_qkv_attention`` on CPU tensors against the JAX
    ``fused_qkv_attention`` (its CPU path: RoPE by rotate_half, XLA attention)."""
    x, tables = _inputs(64, 72, rope, seed=1)
    jrope = None if tables is None else tuple(jnp.asarray(t) for t in tables)
    want = np.asarray(jfa.fused_qkv_attention(jnp.asarray(x), rope=jrope))
    got = fused_qkv_attention(torch.from_numpy(x), rope=tables).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _pallas_nat_bwd(qkv5: np.ndarray, g: np.ndarray, rope, dtype=jnp.float32) -> np.ndarray:
    """dqkv (B, N, 3, H, D) through ``_nat_bwd_kernel``, interpreted, with the
    layout transposes around ``_natural_attention``."""
    B, N, _, H, D = qkv5.shape
    qkv3 = jnp.asarray(qkv5, dtype).transpose(0, 2, 3, 1, 4)
    g4 = jnp.asarray(g, dtype).transpose(0, 2, 1, 3)  # (B, H, N, D)
    gh = jfa._nat_group(H, N, D, bwd=True, itemsize=qkv3.dtype.itemsize)
    if rope is not None:
        cos, sinf = jfa._fold_sin(rope, N, D)
    else:
        cos = sinf = jnp.zeros((N, D), jnp.float32)
    qkv_spec = pl.BlockSpec((1, 3, gh, N, D), lambda b, h: (b, 0, h, 0, 0))
    g_spec = pl.BlockSpec((1, gh, N, D), lambda b, h: (b, h, 0, 0))
    tspec = pl.BlockSpec((N, D), lambda b, h: (0, 0))
    dqkv = pl.pallas_call(
        functools.partial(jfa._nat_bwd_kernel, scale=D ** -0.5, use_rope=rope is not None),
        grid=(B, H // gh),
        in_specs=[qkv_spec, g_spec, tspec, tspec],
        out_specs=qkv_spec,
        out_shape=jax.ShapeDtypeStruct((B, 3, H, N, D), qkv3.dtype),
        interpret=True,
    )(qkv3, g4, cos, sinf)
    return np.asarray(dqkv.transpose(0, 3, 1, 2, 4).astype(jnp.float32))


def _bwd_inputs(N: int, D: int, rope: bool, seed: int = 0):
    x, tables = _inputs(N, D, rope, seed)
    g = np.random.default_rng(seed + 100).standard_normal((2, N, 4, D)).astype(np.float32)
    return x, g, tables


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("D", [72, 64])
@pytest.mark.parametrize("N", [64, 256])
def test_bwd_reference_matches_pallas_kernel_fp32(N, D, rope):
    # fp32 end to end: only summation order differs (measured 4.2e-7 against
    # gradients of magnitude ~1.5)
    x, g, tables = _bwd_inputs(N, D, rope)
    want = _pallas_nat_bwd(x, g, tables)
    got = fused_qkv_attention_bwd_reference(torch.from_numpy(x), torch.from_numpy(g), tables)
    assert got.shape == (2, N, 3, 4, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_bwd_reference_matches_pallas_kernel_bf16(rope):
    # bf16 operands: P and dS round at slightly different places in XLA's
    # fusions; 3e-2 of max|ref| is the TPU backward kernel's own tolerance
    # (tests/test_ops.py:188-190)
    x, g, tables = _bwd_inputs(64, 72, rope, seed=2)
    want = _pallas_nat_bwd(x, g, tables, jnp.bfloat16)
    got = fused_qkv_attention_bwd_reference(torch.from_numpy(x).bfloat16(),
                                            torch.from_numpy(g).bfloat16(), tables)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 3e-2


@pytest.mark.parametrize("rope", [True, False])
def test_cpu_autograd_matches_jax_grad(rope):
    """torch.autograd.grad of the port's CPU ``fused_qkv_attention`` against
    jax.grad of the JAX ``fused_qkv_attention`` (its CPU path), fp32."""
    x, g, tables = _bwd_inputs(64, 72, rope, seed=3)
    jrope = None if tables is None else tuple(jnp.asarray(t) for t in tables)
    want = np.asarray(jax.grad(
        lambda q: jnp.sum(jfa.fused_qkv_attention(q, rope=jrope) * jnp.asarray(g)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((fused_qkv_attention(xt, rope=tables) * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)

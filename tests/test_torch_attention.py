"""The port's fused-qkv attention against the TPU kernel's own body.

``_nat_fwd_kernel`` runs here through ``pl.pallas_call(..., interpret=True)``
with the JAX package's ``_fold_sin`` / ``_nat_group`` (BlockSpecs without a
TPU memory space), so the port's plain version is held against the Pallas
kernel itself, not only against the XLA fallback. The CUDA kernel is held
against the plain version on the card by tests/test_torch_cuda.py.
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
    fused_qkv_attention_reference,
)

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

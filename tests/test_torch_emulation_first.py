"""The first (mma.sync and fp32) bodies of the attention kernels' CUDA
sources, run on the CPU against their plain versions: the fused-qkv and the
separate-q/k/v forwards (fp32, and bf16 calls the wgmma body does not take)
and the long route's mma.sync and FMA bodies, with the faults planted in the
long one. The fp32 cases with D <= 128 reach the 3xTF32 body
(``attention_tf32.cuh``, its own file: ``test_torch_emulation_tf32.py``),
those at D = 250 and 256 and the long route's all-fp32 pair the FMA body.
The emulation and helpers are ``tests/torch_emulation.py``."""
import pytest
import torch

from torch_emulation import *  # noqa: F401,F403
from torch_emulation import _run, _small_bwd_error, _tables  # noqa: F401
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    specs = {"nat_fwd": (expand_includes(SOURCE), FWD_LAUNCHES),
             "small_fwd": (expand_includes(SMALL_SOURCE), FWD_LAUNCHES),
             "long": (expand_includes(LONG_SOURCE), LONG_LAUNCHES),
             "long_kt_column": (mutated(LONG_SOURCE, LONG_KT_COLUMN, "__float_as_uint(kt[0])"),
                                LONG_LAUNCHES)}
    for name, (old, new) in LONG_MUTATIONS.items():
        specs[f"long_{name}"] = (mutated(LONG_SOURCE, old, new), LONG_LAUNCHES)
    return build_libraries(tmp_path_factory, specs)


@pytest.fixture(scope="module")
def kernel(libs):
    return nat_fwd_function(libs["nat_fwd"])


@pytest.fixture(scope="module")
def small_kernel(libs):
    return small_fwd_function(libs["small_fwd"])


@pytest.fixture(scope="module")
def long_kernel(libs):
    return long_function(libs["long"])


LONG_KT_COLUMN = "__float_as_uint(kt[4])"



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", [
    (2, 64, 2, 72, True),    # the XL head dim, one full tile
    (1, 100, 1, 64, False),  # a ragged second key tile
    (1, 130, 2, 8, True),    # three query tiles, a tiny head dim
    (1, 1, 1, 72, True),     # one token
    (1, 70, 1, 256, True),   # the widest head dim
    (1, 33, 1, 250, True),   # D % 8 != 0: scalar loads, odd D/2
])
def test_kernel_source_matches_plain_version(kernel, B, N, H, D, rope, dtype):
    # fp32: summation order only. bf16: at most two bf16 steps of the output
    # where the online softmax rounds P against a running instead of the
    # final row max (2e-2 max-abs is the TPU kernel's tolerance)
    qkv = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(N)).to(dtype)
    tables = _tables(N, D) if rope else None
    got = _run(kernel, qkv, tables)
    want = fused_qkv_attention_reference(qkv, tables)
    assert not torch.isnan(got.float()).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_source_misaligned_input(kernel):
    """A bf16 view that is not 16-byte aligned takes the scalar-load path."""
    B, N, H, D = 1, 70, 2, 72
    buf = torch.randn(B * N * 3 * H * D + 1, generator=torch.Generator().manual_seed(0))
    qkv = buf.bfloat16()[1:].view(B, N, 3, H, D)
    assert qkv.data_ptr() % 16 != 0
    tables = _tables(N, D)
    got = _run(kernel, qkv, tables)
    want = fused_qkv_attention_reference(qkv, tables)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", SMALL_CASES)
def test_small_kernel_source_matches_plain_version(small_kernel, B, N, H, D, rope, dtype):
    # as test_kernel_source_matches_plain_version: fp32 1e-5, bf16 2e-2 max-abs
    q, k, v, _, tables = small_case(B, N, H, D, rope, dtype)
    assert not v.is_contiguous()
    got = run_small(small_kernel, q, k, v, tables)
    want = flash_attention_reference(q, k, v, tables)
    assert not torch.isnan(got.float()).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_small_kernel_source_misaligned_input(small_kernel):
    """A strided bf16 v whose rows are not 16-byte aligned takes the
    scalar-load path."""
    q, k, v, _, tables = small_case(1, 70, 2, 72, True, torch.bfloat16, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_small(small_kernel, q, k, v, tables)
    want = flash_attention_reference(q, k, v, tables)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("B,N,H,D,qk_dtype,v_dtype", [
    (1, 100, 2, 72, F32, BF16),   # the RoPE models' pair, N not a multiple of 64
    (2, 130, 1, 16, F32, BF16),   # three query tiles, a ragged last key tile
    (1, 100, 2, 72, BF16, BF16),  # use_rope: false, q and k strided views
    (1, 70, 3, 72, F32, F32),     # fp32 models: the FMA kernel
])
def test_long_kernel_source_matches_plain_version(long_kernel, B, N, H, D, qk_dtype, v_dtype):
    q, k, v = long_case(B, N, H, D, qk_dtype, v_dtype)
    got = run_long(long_kernel, q, k, v)
    want = flash_attention_long_reference(q, k, v)
    assert got.dtype == want.dtype == qk_dtype
    assert not torch.isnan(got.float()).any()
    assert_long_close(got, want, v_dtype)


def test_long_kernel_source_misaligned_input(long_kernel):
    """A bf16 v whose rows are not 16-byte aligned sends the TF32 kernel to
    scalar loads for all three inputs."""
    q, k, v = long_case(1, 90, 2, 72, F32, BF16, seed=1, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_long(long_kernel, q, k, v)
    assert_long_close(got, flash_attention_long_reference(q, k, v), v.dtype)


def test_long_emulation_catches_mutation(libs):
    """A TF32 B fragment read from the wrong column (kt[0] for kt[4]) must
    fail the check above: the emulation runs the TF32 mma.sync path's
    fragments, which takes a v whose rows are not 16-byte aligned."""
    fn = long_function(libs["long_kt_column"])
    q, k, v = long_case(1, 100, 2, 72, F32, BF16, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_long(fn, q, k, v)
    assert (got - flash_attention_long_reference(q, k, v)).abs().max().item() > 2e-2


@pytest.mark.parametrize("qk_dtype", [F32, BF16])
@pytest.mark.parametrize("name", list(LONG_MUTATIONS))
def test_long_emulation_catches_planted_faults(libs, name, qk_dtype):
    """A dropped tail mask or a dropped rescale in the shared mma.sync body
    must exceed LONG_REL_TOL, for the TF32 and the bf16 q̃·k̃ᵀ, at an N
    whose last key tile holds one key (the chip check's N = 4,033 case).
    The inputs' rows are not 16-byte aligned, which keeps the call on that
    body."""
    fn = long_function(libs[f"long_{name}"])
    q, k, v = long_case(1, 129, 2, 72, qk_dtype, BF16, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_long(fn, q, k, v)
    assert long_rel_err(got, flash_attention_long_reference(q, k, v)) > LONG_REL_TOL

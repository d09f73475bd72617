"""The backward bodies through both backward entries, ``nat_attention_bwd.cu``
and ``attn_small_bwd.cu``, run on the CPU against the plain versions: bf16
the wgmma passes of ``attention_bwd.cuh``, fp32 the 3xTF32 body of
``attention_tf32.cuh`` (one tile at N = 64 and 50, the scratch path above);
and two faults planted in copies of the bf16 body, which the check must
catch. The emulation and helpers are ``tests/torch_emulation.py``."""
import pytest
import torch

from torch_emulation import *  # noqa: F401,F403
from torch_emulation import _run, _small_bwd_error, _tables  # noqa: F401
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    specs = {"nat_bwd": (expand_includes(BWD_SOURCE), BWD_LAUNCHES),
             "small_bwd": (expand_includes(SMALL_BWD_SOURCE), BWD_LAUNCHES)}
    for name, (old, new) in MUTATIONS.items():
        specs[f"nat_bwd_{name}"] = (mutated(BWD_SOURCE, old, new, once=False), BWD_LAUNCHES)
        specs[f"small_bwd_{name}"] = (mutated(SMALL_BWD_SOURCE, old, new, once=False),
                                      BWD_LAUNCHES)
    return build_libraries(tmp_path_factory, specs)


@pytest.fixture(scope="module")
def bwd_kernel(libs):
    return bwd_function(libs["nat_bwd"])


@pytest.fixture(scope="module")
def small_bwd_kernel(libs):
    return small_bwd_function(libs["small_bwd"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", [
    (1, 64, 1, 72, True),    # the XL head dim, one full tile in both passes
    (1, 100, 2, 8, True),    # N not a multiple of 64: ragged query and key tiles
    (2, 70, 1, 72, False),   # no RoPE, two batches
    (1, 256, 1, 72, True),   # four streamed tiles through the two-stage ring, two key blocks
    (1, 50, 2, 18, True),    # D % 4 != 0: one column per item in the prep and dq passes
    (1, 100, 1, 128, True),  # the widest head dim (DP = 128)
    (1, 70, 1, 96, False),   # D = 96 padded to 128
    (2, 64, 2, 64, True),    # the micro-Doppler DiT-S/2's likelihood (N = 64, D = 64)
])
def test_bwd_kernel_source_matches_plain_version(bwd_kernel, B, N, H, D, rope, dtype):
    # fp32: summation order only (and the kernel's P = exp(s - m)·(1/l));
    # bf16: 3e-2 of max|ref|, the TPU backward kernel's own tolerance
    qkv, g, tables = bwd_case(B, N, H, D, rope, dtype)
    got = run_bwd(bwd_kernel, qkv, g, tables)
    want = fused_qkv_attention_bwd_reference(qkv, g, tables)
    assert not torch.isnan(got.float()).any()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert bwd_error(got, want) <= 3e-2


def test_bwd_kernel_source_misaligned_input(bwd_kernel):
    """bf16 views that are not 16-byte aligned take the scalar-load path."""
    B, N, H, D = 1, 70, 1, 72
    gen = torch.Generator().manual_seed(1)
    buf = torch.randn(B * N * 3 * H * D + 1, generator=gen).bfloat16()
    qkv = buf[1:].view(B, N, 3, H, D)
    g = torch.randn(B * N * H * D + 1, generator=gen).bfloat16()[1:].view(B, N, H, D)
    assert qkv.data_ptr() % 16 != 0
    tables = _tables(N, D)
    got = run_bwd(bwd_kernel, qkv, g, tables)
    assert bwd_error(got, fused_qkv_attention_bwd_reference(qkv, g, tables)) <= 3e-2


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_bwd_emulation_catches_mutations(libs, name):
    fn = bwd_function(libs[f"nat_bwd_{name}"])
    qkv, g, tables = bwd_case(1, 64, 1, 72, True, torch.bfloat16)
    got = run_bwd(fn, qkv, g, tables)
    assert bwd_error(got, fused_qkv_attention_bwd_reference(qkv, g, tables)) > 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", [
    (1, 64, 1, 72, True),    # the XL head dim, one full tile in both passes
    (1, 100, 2, 8, True),    # ragged query and key tiles
    (2, 70, 1, 72, False),   # no RoPE: no tables are passed
    (1, 256, 1, 72, True),   # four streamed tiles through the two-stage ring, two key blocks
    (1, 40, 2, 12, True),    # D % 8 != 0: column pairs in the prep and dq passes, scalar tiles
    (1, 100, 1, 128, True),  # the widest head dim (DP = 128)
    (1, 70, 1, 96, False),   # D = 96 padded to 128
])
def test_small_bwd_kernel_source_matches_plain_version(small_bwd_kernel, B, N, H, D, rope, dtype):
    # fp32 1e-5 max-abs; bf16 3e-2 of max|ref| for each of dq, dk, dv
    q, k, v, g, tables = small_case(B, N, H, D, rope, dtype, seed=5)
    got = run_small_bwd(small_bwd_kernel, q, k, v, g, tables)
    want = flash_attention_bwd_reference(q, k, v, g, tables)
    assert not any(torch.isnan(t.float()).any() for t in got)
    if dtype == torch.float32:
        assert max((a - b).abs().max().item() for a, b in zip(got, want)) <= 1e-5
    else:
        assert _small_bwd_error(got, want) <= 3e-2


def test_small_bwd_kernel_source_misaligned_input(small_bwd_kernel):
    q, k, v, g, tables = small_case(1, 70, 1, 72, True, torch.bfloat16, seed=6, offset=3)
    assert v.data_ptr() % 16 != 0
    got = run_small_bwd(small_bwd_kernel, q, k, v, g, tables)
    assert _small_bwd_error(got, flash_attention_bwd_reference(q, k, v, g, tables)) <= 3e-2


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_small_bwd_emulation_catches_mutations(libs, name):
    """The same two faults in attn_small_bwd.cu (through the body it shares
    with nat_attention_bwd.cu) must fail the check above."""
    fn = small_bwd_function(libs[f"small_bwd_{name}"])
    q, k, v, g, tables = small_case(1, 64, 1, 72, True, torch.bfloat16, seed=5)
    got = run_small_bwd(fn, q, k, v, g, tables)
    assert _small_bwd_error(got, flash_attention_bwd_reference(q, k, v, g, tables)) > 3e-2

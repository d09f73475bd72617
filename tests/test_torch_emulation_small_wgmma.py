"""The small route's wgmma forward body (``attention_fwd_wgmma.cuh``)
through both forward entries, ``nat_attention_fwd.cu`` and
``attn_small_fwd.cu``, run on the CPU against the plain versions, and four
faults planted in copies of each, which the check must catch. The emulation
and helpers are ``tests/torch_emulation.py``."""
import pytest
import torch

from torch_emulation import *  # noqa: F401,F403
from torch_emulation import _run, _small_bwd_error, _tables  # noqa: F401
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    specs = {"nat_fwd": (expand_includes(SOURCE), FWD_LAUNCHES),
             "small_fwd": (expand_includes(SMALL_SOURCE), FWD_LAUNCHES)}
    for name, (old, new) in FWD_MUTATIONS.items():
        specs[f"nat_{name}"] = (mutated(SOURCE, old, new), FWD_LAUNCHES)
        specs[f"small_{name}"] = (mutated(SMALL_SOURCE, old, new), FWD_LAUNCHES)
    return build_libraries(tmp_path_factory, specs)


@pytest.fixture(scope="module")
def kernel(libs):
    return nat_fwd_function(libs["nat_fwd"])


@pytest.fixture(scope="module")
def small_kernel(libs):
    return small_fwd_function(libs["small_fwd"])


@pytest.mark.parametrize("B,N,H,D,rope", WGMMA_CASES)
def test_wgmma_fwd_source_matches_plain_version(kernel, B, N, H, D, rope):
    # bf16 2e-2 max-abs, the TPU kernel's tolerance, as above
    qkv = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(N)).bfloat16()
    tables = _tables(N, D) if rope else None
    got = _run(kernel, qkv, tables)
    assert not torch.isnan(got.float()).any()
    assert (got.float() - fused_qkv_attention_reference(qkv, tables).float()).abs().max() <= 2e-2


@pytest.mark.parametrize("name", list(FWD_MUTATIONS))
def test_wgmma_fwd_emulation_catches_mutations(libs, name):
    fn = nat_fwd_function(libs[f"nat_{name}"])
    qkv = torch.randn((1, 200, 3, 2, 72), generator=torch.Generator().manual_seed(3)).bfloat16()
    tables = _tables(200, 72)
    err = (_run(fn, qkv, tables).float() - fused_qkv_attention_reference(qkv, tables).float())
    assert err.abs().max().item() > 2e-2
    # fp32, and a bf16 view that is not 16-byte aligned: the first bodies
    B, N, H, D = 1, 70, 2, 72
    buf = torch.randn(B * N * 3 * H * D + 1, generator=torch.Generator().manual_seed(0))
    tables = _tables(N, D)
    for qkv, tol in ((buf[1:].view(B, N, 3, H, D), 1e-5),
                     (buf.bfloat16()[1:].view(B, N, 3, H, D), 2e-2)):
        want = fused_qkv_attention_reference(qkv, tables)
        assert (_run(fn, qkv, tables).float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("B,N,H,D,rope", WGMMA_CASES)
def test_small_wgmma_fwd_source_matches_plain_version(small_kernel, B, N, H, D, rope):
    """The wgmma body through the separate-q/k/v entry, v a strided view."""
    q, k, v, _, tables = small_case(B, N, H, D, rope, torch.bfloat16, seed=2)
    got = run_small(small_kernel, q, k, v, tables)
    assert not torch.isnan(got.float()).any()
    assert (got.float() - flash_attention_reference(q, k, v, tables).float()).abs().max() <= 2e-2


@pytest.mark.parametrize("name", list(FWD_MUTATIONS))
def test_small_wgmma_fwd_emulation_catches_mutations(libs, name):
    """The same four faults through attn_small_fwd.cu; its misaligned view
    and fp32 inputs stay on the first bodies and pass."""
    fn = small_fwd_function(libs[f"small_{name}"])
    q, k, v, _, tables = small_case(1, 200, 2, 72, True, torch.bfloat16, seed=3)
    err = run_small(fn, q, k, v, tables).float() - flash_attention_reference(q, k, v, tables).float()
    assert err.abs().max().item() > 2e-2
    for dtype, offset, tol in ((torch.float32, 0, 1e-5), (torch.bfloat16, 1, 2e-2)):
        q, k, v, _, tables = small_case(1, 70, 2, 72, True, dtype, offset=offset)
        want = flash_attention_reference(q, k, v, tables)
        assert (run_small(fn, q, k, v, tables).float() - want.float()).abs().max().item() <= tol

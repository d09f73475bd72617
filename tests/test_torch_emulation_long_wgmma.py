"""The long route's wgmma forward body (``flash_fwd_wgmma.cuh``) through
``flash_fwd.cu``, run on the CPU against the plain version, and three
faults planted in copies of it, which the check must catch. The emulation
and helpers are ``tests/torch_emulation.py``."""
import pytest
import torch

from torch_emulation import *  # noqa: F401,F403
from torch_emulation import _run, _small_bwd_error, _tables  # noqa: F401
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    specs = {"long": (expand_includes(LONG_SOURCE), LONG_LAUNCHES)}
    for name, (old, new) in LONG_WGMMA_MUTATIONS.items():
        specs[f"long_wgmma_{name}"] = (mutated(LONG_SOURCE, old, new), LONG_LAUNCHES)
    return build_libraries(tmp_path_factory, specs)


@pytest.fixture(scope="module")
def long_kernel(libs):
    return long_function(libs["long"])


@pytest.mark.parametrize("B,N,H,D,qk_dtype,v_dtype", LONG_WGMMA_CASES)
def test_long_wgmma_source_matches_plain_version(long_kernel, B, N, H, D, qk_dtype, v_dtype):
    # limits as in assert_long_close
    q, k, v = long_case(B, N, H, D, qk_dtype, v_dtype, seed=4)
    assert not v.is_contiguous() and v.data_ptr() % 16 == 0
    got = run_long(long_kernel, q, k, v)
    want = flash_attention_long_reference(q, k, v)
    assert got.dtype == want.dtype == qk_dtype
    assert not torch.isnan(got.float()).any()
    assert_long_close(got, want, v_dtype)


@pytest.mark.parametrize("name", list(LONG_WGMMA_MUTATIONS))
def test_long_wgmma_emulation_catches_planted_faults(libs, name):
    """Each fault exceeds LONG_REL_TOL on the main path's pair at an N whose
    last key tile holds one key; the all-fp32 pair and a misaligned v stay
    on the first bodies and pass."""
    fn = long_function(libs[f"long_wgmma_{name}"])
    q, k, v = long_case(1, 129, 2, 72, F32, BF16, seed=5)
    assert long_rel_err(run_long(fn, q, k, v), flash_attention_long_reference(q, k, v)) > LONG_REL_TOL
    for v_dtype, offset in ((F32, 0), (BF16, 1)):
        q, k, v = long_case(1, 70, 2, 72, F32, v_dtype, seed=6, offset=offset)
        assert_long_close(run_long(fn, q, k, v), flash_attention_long_reference(q, k, v), v_dtype)

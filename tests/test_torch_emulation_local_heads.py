"""The DiT's four attention kernels at a tensor-parallel rank's local heads,
run on the CPU through the emulation (``tests/torch_emulation.py``).

Under tensor = 2 the XL/1's 16 heads of 72 split into 8 a rank
(``parallel/tensor_parallel.py``): rank r's fused qkv is the (B, N, 3, 8,
72) tensor of heads 8r … 8r + 7, and on the QK-norm branch q, k and the
strided v view have 8 heads too. The kernels take the head count at run
time; here each kernel's ``.cu`` (#1 ``nat_attention_fwd``, #2
``nat_attention_bwd``, #3 ``attn_small_fwd`` with RoPE, #6
``attn_small_bwd``) runs on a rank's 8 heads and is held against the plain
version over all 16 heads, sliced to the rank's, at the kernels' own
tolerances (forward 2e-2 max-abs, backward 3e-2 of max|ref|).

A tensor size that does not divide the heads leaves ranks odd counts
(``tensor_parallel.pieces``: the first ``H % T`` ranks one more), and the
grids are sized from them: 7 heads of 64 a rank of 1p6B/1 (28 heads) at
tensor = 4, 3 of 64 of 1p0B/1 (24) at tensor = 8, and 1 of 72 of XL/1 (16)
at tensor = 12 (ranks 0-3 hold 2, the rest 1)."""
import pytest
import torch

from torch_emulation import *  # noqa: F401,F403
from torch_emulation import _run, _small_bwd_error, _tables  # noqa: F401
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

B, N, H, D, TENSOR = 1, 64, 16, 72, 2  # XL/1's heads; N one tile of the kernels
LOCAL = H // TENSOR


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_libraries(tmp_path_factory, {
        "nat_fwd": (expand_includes(SOURCE), FWD_LAUNCHES),
        "small_fwd": (expand_includes(SMALL_SOURCE), FWD_LAUNCHES),
        "nat_bwd": (expand_includes(BWD_SOURCE), BWD_LAUNCHES),
        "small_bwd": (expand_includes(SMALL_BWD_SOURCE), BWD_LAUNCHES)})


def _heads(rank: int) -> slice:
    return slice(rank * LOCAL, (rank + 1) * LOCAL)


@pytest.mark.parametrize("rank", range(TENSOR))
def test_fused_qkv_kernels_on_local_heads(libs, rank):
    """#1 and #2 on rank ``rank``'s fused qkv of 8 heads."""
    gen = torch.Generator().manual_seed(14 + rank)
    qkv = torch.randn((B, N, 3, H, D), generator=gen).bfloat16()
    g = torch.randn((B, N, H, D), generator=gen).bfloat16()
    tables = _tables(N, D)
    local = qkv[:, :, :, _heads(rank)].contiguous()
    out = _run(nat_fwd_function(libs["nat_fwd"]), local, tables)
    want = fused_qkv_attention_reference(qkv, tables)[:, :, _heads(rank)]
    assert out.shape == (B, N, LOCAL, D) and not torch.isnan(out.float()).any()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    dqkv = run_bwd(bwd_function(libs["nat_bwd"]), local,
                   g[:, :, _heads(rank)].contiguous(), tables)
    want = fused_qkv_attention_bwd_reference(qkv, g, tables)[:, :, :, _heads(rank)]
    assert not torch.isnan(dqkv.float()).any()
    assert bwd_error(dqkv, want) <= 3e-2


@pytest.mark.parametrize("rank", range(TENSOR))
def test_separate_qkv_kernels_on_local_heads(libs, rank):
    """#3 and #6 (the QK-norm branch, RoPE) on rank ``rank``'s q and k of
    8 heads and the strided v view of its fused qkv."""
    q, k, v, g, tables = small_case(B, N, H, D, True, torch.bfloat16, seed=14 + rank)
    h = _heads(rank)
    local_qkv = torch.zeros((B, N, 3, LOCAL, D), dtype=v.dtype)
    local_qkv[:, :, 2] = v[:, :, h]
    local_v = local_qkv[:, :, 2]  # the strided view into the rank's (B, N, 3, 8, 72) qkv
    lq, lk, lg = (t[:, :, h].contiguous() for t in (q, k, g))
    out = run_small(small_fwd_function(libs["small_fwd"]), lq, lk, local_v, tables)
    want = flash_attention_reference(q, k, v, tables)[:, :, h]
    assert not torch.isnan(out.float()).any()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    got = run_small_bwd(small_bwd_function(libs["small_bwd"]), lq, lk, local_v, lg, tables)
    want = [t[:, :, h] for t in flash_attention_bwd_reference(q, k, v, g, tables)]
    assert _small_bwd_error(got, want) <= 3e-2


# (H, D, tensor, rank): rank's heads start at rank·(H // T) + min(rank, H % T)
UNEVEN = {
    "1p6B_tensor4_rank3_7x64": (28, 64, 4, 3),
    "1p0B_tensor8_rank5_3x64": (24, 64, 8, 5),
    "XL_tensor12_rank7_1x72": (16, 72, 12, 7),
}


def _uneven_heads(case: str) -> tuple[int, int, slice]:
    H, D, tensor, rank = UNEVEN[case]
    q, r = divmod(H, tensor)
    start = rank * q + min(rank, r)
    return H, D, slice(start, start + q + (rank < r))


@pytest.mark.parametrize("case", UNEVEN)
def test_fused_qkv_kernels_on_uneven_local_heads(libs, case):
    """#1 and #2 on a rank's fused qkv of 7, 3 or 1 local heads."""
    H, D, h = _uneven_heads(case)
    local_h = h.stop - h.start
    gen = torch.Generator().manual_seed(H + D)
    qkv = torch.randn((B, N, 3, H, D), generator=gen).bfloat16()
    g = torch.randn((B, N, H, D), generator=gen).bfloat16()
    tables = _tables(N, D)
    local = qkv[:, :, :, h].contiguous()
    out = _run(nat_fwd_function(libs["nat_fwd"]), local, tables)
    want = fused_qkv_attention_reference(qkv, tables)[:, :, h]
    assert out.shape == (B, N, local_h, D) and not torch.isnan(out.float()).any()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    dqkv = run_bwd(bwd_function(libs["nat_bwd"]), local, g[:, :, h].contiguous(), tables)
    want = fused_qkv_attention_bwd_reference(qkv, g, tables)[:, :, :, h]
    assert not torch.isnan(dqkv.float()).any()
    assert bwd_error(dqkv, want) <= 3e-2


@pytest.mark.parametrize("case", UNEVEN)
def test_separate_qkv_kernels_on_uneven_local_heads(libs, case):
    """#3 and #6 (the QK-norm branch, RoPE) on a rank's q and k of 7, 3 or
    1 local heads and the strided v view of its fused qkv."""
    H, D, h = _uneven_heads(case)
    local_h = h.stop - h.start
    q, k, v, g, tables = small_case(B, N, H, D, True, torch.bfloat16, seed=H + D)
    local_qkv = torch.zeros((B, N, 3, local_h, D), dtype=v.dtype)
    local_qkv[:, :, 2] = v[:, :, h]
    local_v = local_qkv[:, :, 2]
    lq, lk, lg = (t[:, :, h].contiguous() for t in (q, k, g))
    out = run_small(small_fwd_function(libs["small_fwd"]), lq, lk, local_v, tables)
    want = flash_attention_reference(q, k, v, tables)[:, :, h]
    assert out.shape == (B, N, local_h, D) and not torch.isnan(out.float()).any()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    got = run_small_bwd(small_bwd_function(libs["small_bwd"]), lq, lk, local_v, lg, tables)
    want = [t[:, :, h] for t in flash_attention_bwd_reference(q, k, v, g, tables)]
    assert _small_bwd_error(got, want) <= 3e-2

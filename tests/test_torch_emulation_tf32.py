"""The fp32 bodies on the TF32 tensor cores (``attention_tf32.cuh``: 3xTF32
on ``mma.sync``), run on the CPU through every entry that launches them:
the forwards #1 (``nat_attention_fwd.cu``), #3 and #4 (``attn_small_fwd.cu``
with and without RoPE), the backwards #2 (``nat_attention_bwd.cu``) and #6
(``attn_small_bwd.cu``), each against its plain version at the fp32 limits
(forward 1e-5 max-abs, backward 1e-5 max-abs), and two faults planted in
copies of the sources, which the check must catch. The emulation and
helpers are ``tests/torch_emulation.py``; it reads each TF32 operand as its
TF32 bits, as the tensor cores do, so a product that skips the split is
plain TF32 here too."""
import pytest
import torch

from torch_emulation import *  # noqa: F401,F403
from torch_emulation import _run, _tables  # noqa: F401
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_FWD_TOL = 1e-5  # max-abs, summation order only (tests/test_torch_cuda.py)
F32_BWD_TOL = 1e-5  # max-abs of dq, dk, dv (tests/test_torch_emulation_bwd.py)

# Faults planted in copies of the bodies: the correction products dropped, so
# that every product is one TF32 pass (hi.hi); and v read without its
# transpose, the B fragment of P.V taken along v's rows instead of down its
# columns (and with it the backward's products over rows).
TF32_MUTATIONS = {
    "no_correction": ("  mma_m16n8k8_tf32(d, al, bh);\n  mma_m16n8k8_tf32(d, ah, bl);\n", ""),
    "v_untransposed": ("const float y[2] = {xr[u * 8], xr[LDX + u * 8]};",
                       "const float y[2] = {xs[(u * 8 + gr) * LDX + kk * 8 + 2 * cq], "
                       "xs[(u * 8 + gr) * LDX + kk * 8 + 2 * cq + 1]};"),
}

# (B, N, H, D, rope): every call here takes the 3xTF32 bodies (fp32, D <= 128)
TF32_CASES = [
    (2, 64, 2, 64, True),    # the micro-Doppler DiT-S/2's tile: one per head, both bodies
    (2, 64, 2, 64, False),
    (1, 37, 2, 64, True),    # ragged N: one tile, 27 keys and queries masked
    (1, 100, 1, 64, False),  # two tiles: the backward's scratch path, a ragged last tile
    (1, 130, 1, 64, True),   # three tiles, two keys in the last
    (1, 70, 1, 8, True),     # D = 8, zero-padded to 32
    (1, 64, 1, 72, True),    # D = 72 (the XL head dim)
    (1, 40, 1, 128, True),   # the widest head dim the bodies take
    (1, 1, 1, 64, True),     # one token
]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    specs = {"nat_fwd": (expand_includes(SOURCE), FWD_LAUNCHES),
             "small_fwd": (expand_includes(SMALL_SOURCE), FWD_LAUNCHES),
             "nat_bwd": (expand_includes(BWD_SOURCE), BWD_LAUNCHES),
             "small_bwd": (expand_includes(SMALL_BWD_SOURCE), BWD_LAUNCHES)}
    for name, (old, new) in TF32_MUTATIONS.items():
        specs[f"nat_fwd_{name}"] = (mutated(SOURCE, old, new), FWD_LAUNCHES)
        specs[f"nat_bwd_{name}"] = (mutated(BWD_SOURCE, old, new), BWD_LAUNCHES)
    return build_libraries(tmp_path_factory, specs)


def _qkv(B, N, H, D, seed, offset=0):
    """A (B, N, 3, H, D) fp32 projection starting ``offset`` elements into its
    buffer, and an output gradient."""
    gen = torch.Generator().manual_seed(seed + N + D)
    buf = torch.randn(offset + B * N * 3 * H * D, generator=gen)
    g = torch.randn((B, N, H, D), generator=gen)
    return buf[offset:].view(B, N, 3, H, D), g


def _max_abs(got, want) -> float:
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.parametrize("B,N,H,D,rope", TF32_CASES)
def test_fused_qkv_fwd_tf32(libs, B, N, H, D, rope):
    """#1 on the fused qkv."""
    qkv, _ = _qkv(B, N, H, D, seed=1)
    tables = _tables(N, D) if rope else None
    got = _run(nat_fwd_function(libs["nat_fwd"]), qkv, tables)
    assert not torch.isnan(got).any()
    assert _max_abs(got, fused_qkv_attention_reference(qkv, tables)) <= F32_FWD_TOL


@pytest.mark.parametrize("B,N,H,D,rope", TF32_CASES)
def test_fused_qkv_bwd_tf32(libs, B, N, H, D, rope):
    """#2 on the fused qkv and its output gradient."""
    qkv, g = _qkv(B, N, H, D, seed=2)
    tables = _tables(N, D) if rope else None
    got = run_bwd(bwd_function(libs["nat_bwd"]), qkv, g, tables)
    assert not torch.isnan(got).any()
    assert _max_abs(got, fused_qkv_attention_bwd_reference(qkv, g, tables)) <= F32_BWD_TOL


@pytest.mark.parametrize("B,N,H,D,rope", TF32_CASES)
def test_separate_fwd_tf32(libs, B, N, H, D, rope):
    """#3 (RoPE) and #4 (none) on q, k and the strided view v = qkv[:, :, 2]."""
    q, k, v, _, tables = small_case(B, N, H, D, rope, torch.float32, seed=3)
    got = run_small(small_fwd_function(libs["small_fwd"]), q, k, v, tables)
    assert not torch.isnan(got).any()
    assert _max_abs(got, flash_attention_reference(q, k, v, tables)) <= F32_FWD_TOL


@pytest.mark.parametrize("B,N,H,D,rope", TF32_CASES)
def test_separate_bwd_tf32(libs, B, N, H, D, rope):
    """#6 on q, k and the strided v."""
    q, k, v, g, tables = small_case(B, N, H, D, rope, torch.float32, seed=4)
    got = run_small_bwd(small_bwd_function(libs["small_bwd"]), q, k, v, g, tables)
    assert not any(torch.isnan(t).any() for t in got)
    assert _max_abs(got, flash_attention_bwd_reference(q, k, v, g, tables)) <= F32_BWD_TOL


@pytest.mark.parametrize("N", [64, 100])
def test_misaligned_rows_tf32(libs, N):
    """Rows that are not 16-byte aligned (a projection one float into its
    buffer, and a v view three floats in) take the scalar loads, in both
    forwards and both backwards, one tile and two."""
    qkv, g = _qkv(2, N, 2, 64, seed=5, offset=1)
    assert qkv.data_ptr() % 16 != 0
    tables = _tables(N, 64)
    fwd = _run(nat_fwd_function(libs["nat_fwd"]), qkv, tables)
    assert _max_abs(fwd, fused_qkv_attention_reference(qkv, tables)) <= F32_FWD_TOL
    bwd = run_bwd(bwd_function(libs["nat_bwd"]), qkv, g, tables)
    assert _max_abs(bwd, fused_qkv_attention_bwd_reference(qkv, g, tables)) <= F32_BWD_TOL
    q, k, v, g, tables = small_case(1, N, 2, 64, True, torch.float32, seed=6, offset=3)
    assert v.data_ptr() % 16 != 0
    got = run_small(small_fwd_function(libs["small_fwd"]), q, k, v, tables)
    assert _max_abs(got, flash_attention_reference(q, k, v, tables)) <= F32_FWD_TOL
    got = run_small_bwd(small_bwd_function(libs["small_bwd"]), q, k, v, g, tables)
    assert _max_abs(got, flash_attention_bwd_reference(q, k, v, g, tables)) <= F32_BWD_TOL


@pytest.mark.parametrize("N", [64, 130])
def test_bwd_tf32_is_deterministic(libs, N):
    """Two calls of each backward give bit-identical gradients (no atomics;
    dq summed over key tiles in key order)."""
    qkv, g = _qkv(1, N, 2, 64, seed=7)
    tables = _tables(N, 64)
    fn = bwd_function(libs["nat_bwd"])
    assert torch.equal(run_bwd(fn, qkv, g, tables), run_bwd(fn, qkv, g, tables))
    q, k, v, g, tables = small_case(1, N, 2, 64, True, torch.float32, seed=8)
    fn = small_bwd_function(libs["small_bwd"])
    first, second = (run_small_bwd(fn, q, k, v, g, tables) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("name", list(TF32_MUTATIONS))
def test_tf32_emulation_catches_planted_faults(libs, name):
    """Each fault must exceed the forward's and the backward's limit at the
    micro-Doppler tile (2, 64, 2, 64) with RoPE."""
    qkv, g = _qkv(2, 64, 2, 64, seed=9)
    tables = _tables(64, 64)
    fwd = _run(nat_fwd_function(libs[f"nat_fwd_{name}"]), qkv, tables)
    assert _max_abs(fwd, fused_qkv_attention_reference(qkv, tables)) > F32_FWD_TOL
    bwd = run_bwd(bwd_function(libs[f"nat_bwd_{name}"]), qkv, g, tables)
    assert _max_abs(bwd, fused_qkv_attention_bwd_reference(qkv, g, tables)) > F32_BWD_TOL

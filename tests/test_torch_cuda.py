"""The CUDA attention kernels against their plain versions, on the card, and
the wrappers' refusal to fall back off them. Imports nothing of JAX, so it
runs on the GPU machine: ``python -m pytest tests/test_torch_cuda.py -q``.
The ``gpu`` tests skip where torch sees no CUDA device.
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops import build
from vavae_tpu_torch.ops.flash_attention import (
    _LONG_DTYPE_PAIRS,
    _check_flash_input,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_long,
    flash_attention_long_reference,
    flash_attention_reference,
    fused_qkv_attention,
    fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
    long_attention_reference,
    rope_uncast,
)

torch.backends.cuda.matmul.allow_tf32 = False


def test_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor CUDA raises: the plain version is
    taken only for CPU tensors."""
    x = torch.empty((1, 8, 3, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no attention path"):
        fused_qkv_attention(x)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Where nvcc is missing the kernel's build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("nat_attention_fwd")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


# the micro-Doppler DiTs' calls (fp32 on their paths): the LoRA step, the B/2
# train step and CFG sampling, the e2e DiT-S/2 train step
MICRO_SHAPES = [(16, 6, 64, 64), (8, 12, 64, 64), (32, 6, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,N,D", [(16, 16, 256, 72), (2, 3, 200, 64), (1, 2, 37, 8),
                                     *MICRO_SHAPES])
@pytest.mark.parametrize("rope", [True, False])
def test_cuda_kernel_matches_plain_version(B, H, N, D, rope, dtype):
    # bf16: 2e-2 max-abs, the TPU kernel's tolerance; fp32: summation order only
    _cuda_or_skip()
    x = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(0)).to(dtype)
    tables = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    tables = (tables[0][:N], tables[1][:N]) if rope else None
    x = x.cuda()
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(x, rope=tables)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    want = fused_qkv_attention_reference(x, rope=tables)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_cuda_kernel_rejects_unsupported_shapes():
    _cuda_or_skip()
    with pytest.raises(ValueError, match="head dim"):
        fused_qkv_attention(torch.zeros((1, 8, 3, 2, 7), device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_qkv_attention(torch.zeros((1, 8, 3, 2, 8), device="cuda", dtype=torch.float16))


def _bwd_case(B, H, N, D, rope, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, N, 3, H, D), generator=gen).to(dtype).cuda()
    g = torch.randn((B, N, H, D), generator=gen).to(dtype).cuda()
    tables = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    return x, g, (tables[0][:N], tables[1][:N]) if rope else None


def _max_rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,N,D", [(32, 16, 256, 72), (2, 3, 200, 64), (1, 2, 37, 8),
                                     (4, 16, 1024, 72), (2, 3, 200, 128), (4, 6, 64, 64),
                                     *MICRO_SHAPES])
@pytest.mark.parametrize("rope", [True, False])
def test_cuda_bwd_kernel_matches_plain_version(B, H, N, D, rope, dtype):
    # max|err| / max|ref|: bf16 3e-2, the TPU backward kernel's tolerance
    # (tests/test_ops.py:188-190); fp32 1e-4, summation order only
    _cuda_or_skip()
    x, g, tables = _bwd_case(B, H, N, D, rope, dtype)
    before = fused_qkv_attention.bwd_launches
    got = fused_qkv_attention_bwd(x, g, rope=tables)
    torch.cuda.synchronize()
    assert fused_qkv_attention.bwd_launches == before + 1
    want = fused_qkv_attention_bwd_reference(x, g, rope=tables)
    assert _max_rel(got, want) <= (3e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_autograd_runs_both_kernels(dtype):
    """loss.backward() through fused_qkv_attention on the card leaves on qkv
    the gradient of the plain version's autograd, launching each kernel once."""
    _cuda_or_skip()
    x, g, tables = _bwd_case(4, 16, 256, 72, True, dtype, seed=1)
    x.requires_grad_(True)
    fwd, bwd = fused_qkv_attention.launches, fused_qkv_attention.bwd_launches
    out = fused_qkv_attention(x, rope=tables)
    assert out.grad_fn is not None
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fused_qkv_attention.launches, fused_qkv_attention.bwd_launches) == (fwd + 1, bwd + 1)
    xr = x.detach().clone().requires_grad_(True)
    (fused_qkv_attention_reference(xr, rope=tables).float() * g.float()).sum().backward()
    assert _max_rel(x.grad, xr.grad) <= (3e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
def test_cuda_bwd_kernel_rejects_unsupported_inputs():
    _cuda_or_skip()
    wide = torch.zeros((1, 8, 3, 2, 136), device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        fused_qkv_attention(wide)  # D > 128 has a forward kernel but no backward one
    x = torch.zeros((1, 8, 3, 2, 8), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_qkv_attention_bwd(x, torch.zeros((1, 8, 2, 8), device="cuda", dtype=torch.float16))
    x = torch.zeros((1, 8, 3, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="gradient must be"):
        fused_qkv_attention_bwd(x, torch.zeros((1, 8, 2, 4), device="cuda"))


def test_bwd_kernel_refuses_cpu_tensors():
    """The backward kernel's wrapper takes CUDA tensors only; CPU tensors
    differentiate the plain version through torch autograd instead."""
    x = torch.zeros((1, 8, 3, 2, 8))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fused_qkv_attention_bwd(x, torch.zeros((1, 8, 2, 8)))


# -- separate q, k, v (the qk-norm branch): attn_small_fwd.cu, attn_small_bwd.cu --


def _flash_case(B, H, N, D, rope, dtype, seed=0, offset=0, device="cuda"):
    """q, k contiguous, v the strided view qkv[:, :, 2] of a (B, N, 3, H, D)
    tensor starting ``offset`` elements into its buffer (as on the qk-norm
    path, where v is read in place), the output gradient and the tables."""
    gen = torch.Generator().manual_seed(seed)
    q, k, g = (torch.randn((B, N, H, D), generator=gen).to(dtype).to(device) for _ in range(3))
    buf = torch.randn(offset + B * N * 3 * H * D, generator=gen).to(dtype).to(device)
    v = buf[offset:].view(B, N, 3, H, D)[:, :, 2]
    tables = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    return q, k, v, g, (tables[0][:N], tables[1][:N]) if rope else None


def _flash_counts():
    return (flash_attention.rope_launches, flash_attention.launches, flash_attention.bwd_launches)


def test_flash_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor CUDA raises: the plain version is
    taken only for CPU tensors."""
    x = torch.empty((1, 8, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no attention path"):
        flash_attention(x, x, x)


def test_flash_bwd_kernel_refuses_cpu_tensors():
    q, k, v, g, _ = _flash_case(1, 2, 8, 8, False, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        flash_attention_bwd(q, k, v, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,N,D", [(16, 16, 256, 72), (2, 3, 200, 64), (1, 3, 37, 8),
                                     *MICRO_SHAPES])
@pytest.mark.parametrize("rope", [True, False])
def test_cuda_flash_kernel_matches_plain_version(B, H, N, D, rope, dtype):
    # bf16: 2e-2 max-abs, the TPU kernel's tolerance; fp32: summation order only
    _cuda_or_skip()
    q, k, v, _, tables = _flash_case(B, H, N, D, rope, dtype)
    before = _flash_counts()
    got = flash_attention(q, k, v, rope=tables)
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + rope, before[1] + (not rope), before[2])
    want = flash_attention_reference(q, k, v, rope=tables)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() <= tol


# the main paths' forward shapes, which the wgmma body takes: 256² sampling
# (B = 16), the longest sequence of the small route (N = 1,024) and the
# micro-Doppler DiT-S/2's sampling (N = 64: half of one 128-query block)
WGMMA_SHAPES = [(16, 16, 256, 72), (4, 16, 1024, 72), (16, 6, 64, 64), (8, 6, 64, 64)]


def _device_tables(N, D):
    """The split-half tables as the model holds them: fp32 buffers on the card."""
    cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    return torch.as_tensor(cos[:N], device="cuda"), torch.as_tensor(sin[:N], device="cuda")


def _fwd_call(entry, B, H, N, D, rope, seed=0):
    """One forward wrapper call on bf16 inputs (separate: v the strided view
    of the projection), and its plain version."""
    tables = _device_tables(N, D) if rope else None
    if entry == "fused_qkv":
        x = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(seed))
        x = x.bfloat16().cuda()
        return (lambda: fused_qkv_attention(x, rope=tables),
                lambda: fused_qkv_attention_reference(x, rope=tables))
    q, k, v, _, _ = _flash_case(B, H, N, D, False, torch.bfloat16, seed=seed)
    return (lambda: flash_attention(q, k, v, rope=tables),
            lambda: flash_attention_reference(q, k, v, rope=tables))


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("B,H,N,D", WGMMA_SHAPES)
@pytest.mark.parametrize("entry", ["fused_qkv", "separate"])
def test_cuda_wgmma_fwd_matches_plain_version(entry, B, H, N, D, rope):
    # bf16: 2e-2 max-abs, the TPU kernel's tolerance
    _cuda_or_skip()
    run, plain = _fwd_call(entry, B, H, N, D, rope, seed=4)
    got = run()
    torch.cuda.synchronize()
    assert (got.float() - plain().float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("entry", ["fused_qkv", "separate"])
def test_cuda_fwd_wrappers_launch_one_kernel(entry, rope):
    """A forward wrapper call on the model's device tables launches its
    kernel and nothing else (no table folding, no copies): one CUDA kernel
    per call in a profiler trace, the wgmma body."""
    _cuda_or_skip()
    run, _ = _fwd_call(entry, 16, 16, 256, 72, rope)
    run()
    torch.cuda.synchronize()
    reps = 5
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # a trace's first moments may lose kernel records
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    cuda = torch.autograd.DeviceType.CUDA
    counts = {ev.key: ev.count for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == cuda}
    assert len(counts) == 1 and "attn_fwd_wgmma_kernel" in next(iter(counts)), counts
    assert next(iter(counts.values())) <= reps, counts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,N,D", [(32, 16, 256, 72), (2, 3, 200, 64), (1, 3, 37, 8),
                                     (4, 16, 1024, 72), (2, 3, 200, 128), (4, 6, 64, 64),
                                     *MICRO_SHAPES])
@pytest.mark.parametrize("rope", [True, False])
def test_cuda_flash_bwd_kernel_matches_plain_version(B, H, N, D, rope, dtype):
    # max|err| / max|ref| of each of dq, dk, dv: bf16 3e-2, the TPU backward
    # kernel's tolerance (tests/test_ops.py:188-190); fp32 1e-4
    _cuda_or_skip()
    q, k, v, g, tables = _flash_case(B, H, N, D, rope, dtype, seed=2)
    before = flash_attention.bwd_launches
    got = flash_attention_bwd(q, k, v, g, rope=tables)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, g, rope=tables)
    for a, b in zip(got, want):
        assert _max_rel(a, b) <= (3e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [256, 1024])
@pytest.mark.parametrize("entry", ["fused_qkv", "separate"])
def test_cuda_bwd_kernels_are_deterministic(entry, N):
    """Two calls of a backward wrapper on the same inputs give bit-identical
    gradients: no atomics, and the dq partials are summed in a fixed order."""
    _cuda_or_skip()
    if entry == "fused_qkv":
        x, g, tables = _bwd_case(4, 16, N, 72, True, torch.bfloat16, seed=7)
        run = lambda: [fused_qkv_attention_bwd(x, g, rope=tables)]  # noqa: E731
    else:
        q, k, v, g, tables = _flash_case(4, 16, N, 72, True, torch.bfloat16, seed=7)
        run = lambda: list(flash_attention_bwd(q, k, v, g, rope=tables))  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,D", MICRO_SHAPES)
@pytest.mark.parametrize("entry", ["fused_qkv", "separate"])
def test_cuda_fp32_bwd_kernels_are_deterministic(entry, B, H, N, D):
    """The fp32 backward (the 3xTF32 body) gives bit-identical gradients on a
    second call at the micro-Doppler shapes."""
    _cuda_or_skip()
    if entry == "fused_qkv":
        x, g, tables = _bwd_case(B, H, N, D, True, torch.float32, seed=8)
        run = lambda: [fused_qkv_attention_bwd(x, g, rope=tables)]  # noqa: E731
    else:
        q, k, v, g, tables = _flash_case(B, H, N, D, True, torch.float32, seed=8)
        run = lambda: list(flash_attention_bwd(q, k, v, g, rope=tables))  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_cuda_flash_kernels_misaligned_v():
    """A bf16 v whose rows are not 16-byte aligned takes the kernels'
    scalar loads, with the same results."""
    _cuda_or_skip()
    q, k, v, g, tables = _flash_case(2, 3, 70, 72, True, torch.bfloat16, seed=3, offset=1)
    assert v.data_ptr() % 16 != 0
    got = flash_attention(q, k, v, rope=tables)
    want = flash_attention_reference(q, k, v, rope=tables)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    for a, b in zip(flash_attention_bwd(q, k, v, g, rope=tables),
                    flash_attention_bwd_reference(q, k, v, g, rope=tables)):
        assert _max_rel(a, b) <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_autograd_runs_both_kernels(dtype, rope):
    """loss.backward() through flash_attention on the card leaves on q, k and
    the tensor v is a view of the gradients of the plain version's autograd,
    launching each kernel once."""
    _cuda_or_skip()
    q, k, _, g, tables = _flash_case(4, 16, 256, 72, rope, dtype, seed=4)
    qkv = torch.randn((4, 256, 3, 16, 72), generator=torch.Generator().manual_seed(5))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, qkv.to(dtype).cuda())]
    before = _flash_counts()
    out = flash_attention(leaves[0], leaves[1], leaves[2][:, :, 2], rope=tables)
    assert out.grad_fn is not None
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + rope, before[1] + (not rope), before[2] + 1)
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref = flash_attention_reference(plain[0], plain[1], plain[2][:, :, 2], rope=tables)
    (ref.float() * g.float()).sum().backward()
    for a, b in zip(leaves, plain):
        assert _max_rel(a.grad, b.grad) <= (3e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
def test_cuda_flash_kernels_reject_unsupported_inputs():
    _cuda_or_skip()
    z = lambda *shape, **kw: torch.zeros(shape, device="cuda", **kw)  # noqa: E731
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(z(1, 8, 2, 7), z(1, 8, 2, 7), z(1, 8, 2, 7))
    wide = z(1, 8, 2, 136, requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(wide, wide, wide)  # D > 128 has a forward kernel but no backward one
    half = z(1, 8, 2, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(half, half, half)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(z(1, 8, 2, 8), z(1, 8, 2, 8), z(1, 8, 2, 8, dtype=torch.bfloat16))
    strided = z(1, 8, 2, 16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attention(strided, strided, strided)
    with pytest.raises(ValueError, match="gradient must be"):
        flash_attention_bwd(z(1, 8, 2, 8), z(1, 8, 2, 8), z(1, 8, 2, 8), z(1, 8, 2, 4))


# -- the long route (N > 1024): flash_fwd.cu ------------------------------------------


def _all_counts():
    return (fused_qkv_attention.launches, fused_qkv_attention.bwd_launches,
            *_flash_counts(), flash_attention.long_launches)


def _long_case(B, H, N, D, qk_dtype, v_dtype, seed=0, offset=0, device="cuda"):
    """q̃, k̃, v as the long route hands them to the kernel: v the strided view
    qkv[:, :, 2] of a (B, N, 3, H, D) projection starting ``offset`` elements
    into its buffer; fp32 q̃, k̃ its q and k rotated with the fp32 tables,
    bf16 q̃, k̃ its unrotated strided views (a ``use_rope: false`` model)."""
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randn(offset + B * N * 3 * H * D, generator=gen).to(v_dtype).to(device)
    qkv = buf[offset:].view(B, N, 3, H, D)
    if qk_dtype == torch.bfloat16:
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    tables = (cos[:N], sin[:N])
    return rope_uncast(qkv[:, :, 0], tables), rope_uncast(qkv[:, :, 1], tables), qkv[:, :, 2]


def test_long_route_no_fallback_off_the_cpu():
    """N > 1024 on neither the CPU nor CUDA raises, on both entry points."""
    x = torch.empty((1, 1100, 3, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no attention path"):
        fused_qkv_attention(x)
    with pytest.raises(RuntimeError, match="no attention path"):
        flash_attention(*x.unbind(dim=2))


def test_long_kernel_refuses_cpu_tensors():
    q, k, v = _long_case(1, 2, 1100, 8, torch.float32, torch.bfloat16, device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        flash_attention_long(q, k, v)


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16, torch.bfloat16),
                                    (torch.float16, torch.float16, torch.float16)])
def test_long_kernel_rejects_dtype_pairs(dtypes):
    """The kernel takes fp32 q̃, k̃ with bf16 v, all bf16 or all fp32; the
    wrapper refuses anything else before a launch (checked on CPU tensors)."""
    q, k, v = (torch.zeros((1, 8, 2, 8), dtype=dt) for dt in dtypes)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check_flash_input(q, k, v, dtype_pairs=_LONG_DTYPE_PAIRS)


LONG_PAIRS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float32)]


def _assert_long_close(got, want, v_dtype):
    """All fp32: summation order only, 1e-5 max-abs. With bf16 v: 2e-2
    max-abs, the TPU kernel's tolerance, and 5e-3 relative (Frobenius) error:
    the kernel and the plain version round P to bf16 against a running and a
    final row max (about 2e-3 apart), while a dropped tail mask gives about
    3e-2 at N = 1037 or 1100, under the max-abs limit."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if v_dtype == torch.float32:
        assert err <= 1e-5
    else:
        assert err <= 2e-2
        assert ((got - want).norm() / want.norm()).item() <= 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("qk_dtype,v_dtype", LONG_PAIRS)
@pytest.mark.parametrize("B,H,N,D", [(1, 4, 2048, 72), (2, 3, 1100, 64), (1, 2, 1037, 8)])
def test_cuda_long_kernel_matches_plain_version(B, H, N, D, qk_dtype, v_dtype):
    # limits as in _assert_long_close
    _cuda_or_skip()
    q, k, v = _long_case(B, H, N, D, qk_dtype, v_dtype)
    before = _all_counts()
    got = flash_attention_long(q, k, v)
    torch.cuda.synchronize()
    assert _all_counts() == (*before[:-1], before[-1] + 1)
    want = flash_attention_long_reference(q, k, v)
    assert got.dtype == want.dtype == qk_dtype
    _assert_long_close(got, want, v_dtype)


@pytest.mark.gpu
def test_cuda_long_kernel_misaligned_v():
    """A bf16 v whose rows are not 16-byte aligned sends the TF32 kernel to
    scalar loads, with the same results."""
    _cuda_or_skip()
    q, k, v = _long_case(1, 3, 1100, 72, torch.float32, torch.bfloat16, seed=1, offset=1)
    assert v.data_ptr() % 16 != 0
    got = flash_attention_long(q, k, v)
    _assert_long_close(got, flash_attention_long_reference(q, k, v), v.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False])
def test_cuda_long_route_entry_points(rope):
    """Both entry points at N > 1024 on bf16 CUDA tensors launch flash_fwd
    once and no other kernel; with RoPE the output is fp32 (q, k rotated with
    the fp32 tables), without it bf16. Limits against the route's plain
    version as in _assert_long_close."""
    _cuda_or_skip()
    B, N, H, D = 2, 1100, 4, 72
    qkv = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(2))
    qkv = qkv.bfloat16().cuda()
    cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    tables = (cos[:N], sin[:N]) if rope else None
    want = long_attention_reference(*qkv.unbind(dim=2), tables)
    for run in (lambda: fused_qkv_attention(qkv, rope=tables),
                lambda: flash_attention(*qkv.unbind(dim=2), rope=tables)):
        before = _all_counts()
        got = run()
        torch.cuda.synchronize()
        assert _all_counts() == (*before[:-1], before[-1] + 1)
        assert got.dtype == (torch.float32 if rope else torch.bfloat16)
        _assert_long_close(got, want, qkv.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_long_route_autograd(dtype):
    """loss.backward() through the long route on the card launches the
    forward kernel once and no backward kernel (the backward is autograd of
    the exact op); the gradients on qkv match autograd of the route's plain
    version (bf16 3e-2 of max|ref|, fp32 1e-4)."""
    _cuda_or_skip()
    B, N, H, D = 1, 1100, 4, 72
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((B, N, 3, H, D), generator=gen).to(dtype).cuda().requires_grad_(True)
    g = torch.randn((B, N, H, D), generator=gen).cuda()
    cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    tables = (cos[:N], sin[:N])
    before = _all_counts()
    out = fused_qkv_attention(x, rope=tables)
    (out.float() * g).sum().backward()
    torch.cuda.synchronize()
    assert _all_counts() == (*before[:-1], before[-1] + 1)
    xr = x.detach().clone().requires_grad_(True)
    (long_attention_reference(*xr.unbind(dim=2), tables).float() * g).sum().backward()
    assert _max_rel(x.grad, xr.grad) <= (3e-2 if dtype == torch.bfloat16 else 1e-4)


def _kernels_launched(fn, reps=3) -> dict:
    """Launch counts by kernel name of ``reps`` calls of ``fn`` in one
    profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # a trace's first moments may lose kernel records
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    cuda = torch.autograd.DeviceType.CUDA
    return {ev.key: ev.count for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("qk_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,N,D", [(1, 4, 1025, 72), (2, 3, 4033, 72), (1, 2, 1100, 64)])
def test_cuda_long_wgmma_body(B, H, N, D, qk_dtype):
    """Aligned fp32 or bf16 q̃, k̃ with bf16 v (D % 8 == 0, D <= 72) run the
    wgmma body (flash_fwd_wgmma.cuh) alone; a second call on the same inputs
    is bit-identical; limits as in _assert_long_close."""
    _cuda_or_skip()
    q, k, v = _long_case(B, H, N, D, qk_dtype, torch.bfloat16, seed=5)
    first = flash_attention_long(q, k, v)
    second = flash_attention_long(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_long_close(first, flash_attention_long_reference(q, k, v), torch.bfloat16)
    counts = _kernels_launched(lambda: flash_attention_long(q, k, v))
    assert len(counts) == 1 and "flash_fwd_wgmma_kernel" in next(iter(counts)), counts


@pytest.mark.gpu
def test_cuda_long_misaligned_v_stays_on_first_body():
    """A bf16 v whose rows are not 16-byte aligned sends the call to the
    TF32 mma.sync body (attention_fwd.cuh), with the same limits."""
    _cuda_or_skip()
    q, k, v = _long_case(1, 3, 1025, 72, torch.float32, torch.bfloat16, seed=6, offset=1)
    assert v.data_ptr() % 16 != 0
    _assert_long_close(flash_attention_long(q, k, v), flash_attention_long_reference(q, k, v),
                       v.dtype)
    counts = _kernels_launched(lambda: flash_attention_long(q, k, v))
    assert len(counts) == 1 and "attn_fwd_mma_kernel" in next(iter(counts)), counts


# -- the tokenizer side (no kernel of its own: cuDNN convolutions) -------------


@contextlib.contextmanager
def _tf32_on():
    """TF32 allowed globally, as cuDNN's default has it; the functions under
    test must pin fp32 themselves."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


@pytest.mark.gpu
def test_cuda_ssim_and_lpips_match_cpu_with_tf32_on():
    """SSIM and LPIPS at 224², batch 2, on the card within 1e-4 of the CPU
    with TF32 globally on (the functions pin it off for their convolutions)."""
    _cuda_or_skip()
    from vavae_tpu_torch.eval.metrics import ssim
    from vavae_tpu_torch.models.lpips import LPIPS, init_lpips_weights

    gen = torch.Generator().manual_seed(0)
    a = torch.rand((2, 224, 224, 3), generator=gen)
    b = (a + 0.1 * torch.randn(a.shape, generator=gen)).clamp(0, 1)
    model = LPIPS()
    init_lpips_weights(model, torch.Generator().manual_seed(1))
    model.eval()
    with torch.no_grad():
        want_ssim = ssim(a, b)
        want_lpips = model(2 * a - 1, 2 * b - 1)
        model.cuda()
        with _tf32_on():
            got_ssim = ssim(a.cuda(), b.cuda())
            got_lpips = model(2 * a.cuda() - 1, 2 * b.cuda() - 1)
            same = model(2 * a.cuda() - 1, 2 * a.cuda() - 1)
    assert _rel(got_ssim, want_ssim) < 1e-4 and _rel(got_lpips, want_lpips) < 1e-4
    assert float(same.abs().max()) < 1e-6


def test_resize_uint8_large_image_timed():
    """The ADM crop of a 4000×3000 photo-sized image to 256² on the host
    (three BOX halvings, then BICUBIC): a flat colour stays exact, and the
    time is printed (the crop runs on the host for every extracted image)."""
    from vavae_tpu_torch.tokenizer import center_crop_arr

    img = np.full((3000, 4000, 3), (17, 128, 250), np.uint8)
    t0 = time.perf_counter()
    out = center_crop_arr(img, 256)
    seconds = time.perf_counter() - t0
    assert out.shape == (256, 256, 3) and out.dtype == np.uint8
    assert (out == np.array([17, 128, 250], np.uint8)).all()
    print(f"center_crop_arr 4000x3000 -> 256: {seconds * 1e3:.1f} ms")


@pytest.mark.gpu
def test_cuda_extract_batch_matches_cpu(tmp_path):
    """One extraction batch at the f16d32 VAE's full width (two 256² PNGs):
    ``extract`` on the card writes its shard, and the card's fp32 posterior
    mode equals the CPU's within 1e-4 with TF32 globally on."""
    _cuda_or_skip()
    from vavae_tpu_torch.pipelines.extract_features import extract, iter_batches, list_image_folder
    from vavae_tpu_torch.tokenizer import VA_VAE
    from vavae_tpu_torch.utils.png import write_pngs
    from vavae_tpu_torch.utils.safetensors_io import read_safetensors

    (tmp_path / "img" / "c").mkdir(parents=True)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 300, 260, 3)).astype(np.uint8)
    write_pngs(imgs, [str(tmp_path / "img" / "c" / f"{i}.png") for i in range(2)])
    card = VA_VAE(embed_dim=32, img_size=256, seed=3, device="cuda")
    host = VA_VAE(embed_dim=32, img_size=256, seed=3, device="cpu")
    with _tf32_on():
        extract(str(tmp_path / "img"), str(tmp_path / "lat"), card, batch_size=2, image_size=256)
        (x, _, _), = iter_batches(list_image_folder(str(tmp_path / "img")), 2, 256)
        got = card.encode_moments(x).mean
    want = host.encode_moments(x).mean
    assert _rel(got, want) < 1e-4
    shard = read_safetensors(str(tmp_path / "lat" / "latents_rank00_shard000.safetensors"))[0]
    assert shard["latents"].shape == (2, 32, 16, 16) and np.isfinite(shard["latents"]).all()


@pytest.mark.gpu
def test_tsne_on_the_card_matches_the_host():
    """The t-SNE of 400 points of 32 channels on the card against the same
    call on the host: P to rounding; before chaos sets in, the gradient and
    KL at the same P and positions (the init; the host's final layout, with
    P exaggerated, as there P itself is near balance) within 1e-10 and the
    positions after 10 exaggerated iterations from the same init within
    1e-8 (another row chunking on the host moves them by 3e-15; float32
    repulsion or a lost row chunk by far more); the final
    KL, normalised entropy and Gini within ``chip_smoke.py``'s ``TSNE_TOL``
    (float64 on both, but the iterations are chaotic: sixteen host runs of
    these points whose inits differ by 1e-14 to 1e-13 relative end in other
    layouts, their KL within 3.2%, entropy 0.0062, Gini 0.0099)."""
    _cuda_or_skip()
    from vavae_tpu_torch.eval import tsne as T
    from vavae_tpu_torch.eval.latent_vis import calculate_uniformity_metrics

    x = np.random.default_rng(0).standard_normal((400, 32)).astype(np.float32)
    x[:, :4] *= 2.0
    pc = [t.cpu() for t in T.joint_probabilities(torch.as_tensor(x, device="cuda"))]
    ph = T.joint_probabilities(torch.as_tensor(x))
    assert torch.equal(pc[0], ph[0]) and torch.equal(pc[1], ph[1])
    torch.testing.assert_close(pc[2], ph[2], rtol=1e-12, atol=0)
    card, kl_card = T.tsne(x, device="cuda")
    host, kl_host = T.tsne(x, device="cpu")
    xh = (ph[0], ph[1], ph[2] * 12.0)
    pc, xc = tuple(t.cuda() for t in ph), tuple(t.cuda() for t in xh)
    y0 = torch.as_tensor(T.pca_init(x, 0).astype(np.float64))
    for y, p_host, p_card in ((y0, ph, pc), (torch.as_tensor(host), xh, xc)):
        eh, gh = T.kl_gradient(y, p_host)
        ec, gc = T.kl_gradient(y.cuda(), p_card)
        assert (gc.cpu() - gh).abs().max() <= 1e-10 * gh.abs().max()
        assert abs(ec - eh) <= 1e-10 * eh
    args = (0, 10, 0.5, 50.0, 250)
    yh = T._gradient_descent(y0, xh, *args)[0]
    yc = T._gradient_descent(y0.cuda(), xc, *args)[0]
    assert (yc.cpu() - yh).abs().max() <= 1e-8 * yh.abs().max()
    assert card.shape == (400, 2) and np.isfinite(card).all()
    assert abs(kl_card - kl_host) / kl_host < 0.08
    mc, mh = calculate_uniformity_metrics(card), calculate_uniformity_metrics(host)
    assert abs(mc["normalized_entropy"] - mh["normalized_entropy"]) < 0.02
    assert abs(mc["gini"] - mh["gini"]) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["webp", "bmp"])
def test_image_readers_on_the_card_machine(kind):
    """The WebP decoder (built on the card's machine from the repo's
    source) and the BMP reader against the committed expected arrays of
    every fixture (PIL's decodes: PIL is not a stated package of that machine)."""
    _cuda_or_skip()
    from pathlib import Path

    from vavae_tpu_torch.utils.png import read_image_rgb
    from vavae_tpu_torch.utils.webp import decode_webp

    folder = Path(__file__).resolve().parent / "data" / kind
    want = np.load(folder / "expected.npz")
    paths = sorted(folder.glob(f"*.{kind}"))
    assert len(paths) > 20
    for path in paths:
        np.testing.assert_array_equal(read_image_rgb(str(path)), want[path.stem], err_msg=path.name)
        if f"{path.stem}__rgba" in want.files:
            np.testing.assert_array_equal(decode_webp(path.read_bytes(), alpha=True),
                                          want[f"{path.stem}__rgba"], err_msg=path.name)


@pytest.mark.gpu
@pytest.mark.slow
def test_train_then_conditional_sample_learns():
    """The port of ``tests/test_learning_tpu.py`` (``apps/learning_check.py``,
    which ``chip_smoke.py`` phase 38 runs too): DiT-S/2 bf16 trained 1,200
    steps on per-class latents, its EMA weights CFG-sampled; the last loss
    below half the first, at least 0.75 of the samples nearest their class's
    mean, #1 and #2 launched exactly once a block a step and #1 once a
    block a sampling model call."""
    _cuda_or_skip()
    from vavae_tpu_torch.apps import learning_check

    res = learning_check.run("cuda")
    assert learning_check.passed(res), res
    depth, steps, calls = res["depth"], res["steps"], res["sample_model_calls"]
    assert res["train_launches"] == [depth * steps, depth * steps]
    assert res["sample_launches"] == [depth * calls, 0]


# a tensor-parallel rank's call where the tensor size does not divide the
# heads (parallel/tensor_parallel.py:pieces): 1p6B/1 at tensor = 4 (7 heads
# of 64), 1p0B/1 at tensor = 8 (3 of 64), XL/1 at tensor = 12 (1 of 72),
# each at the training path's (B, N) = (8, 256)
UNEVEN_LOCAL_HEADS = [(8, 7, 256, 64), (8, 3, 256, 64), (8, 1, 256, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,D", UNEVEN_LOCAL_HEADS)
@pytest.mark.parametrize("entry", ["fused_qkv", "separate"])
def test_cuda_kernels_on_uneven_local_heads(entry, B, H, N, D):
    """Forward and backward through autograd on a rank's odd local head
    count (bf16, RoPE): one forward and one backward launch, the output
    within 2e-2 max-abs and each gradient within 3e-2 of max|ref| of the
    plain version's autograd."""
    _cuda_or_skip()
    if entry == "fused_qkv":
        x, g, tables = _bwd_case(B, H, N, D, True, torch.bfloat16, seed=7)
        inputs = [x.requires_grad_(True)]
        run, plain, fwd = fused_qkv_attention, fused_qkv_attention_reference, "launches"
    else:
        q, k, v, g, tables = _flash_case(B, H, N, D, True, torch.bfloat16, seed=7)
        inputs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        run, plain, fwd = flash_attention, flash_attention_reference, "rope_launches"
    before = (getattr(run, fwd), run.bwd_launches)
    out = run(*inputs, rope=tables)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (getattr(run, fwd), run.bwd_launches) == (before[0] + 1, before[1] + 1)
    refs = [t.detach().clone().requires_grad_(True) for t in inputs]
    want = plain(*refs, rope=tables)
    (want.float() * g.float()).sum().backward()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    for a, b in zip(inputs, refs):
        assert _max_rel(a.grad, b.grad) <= 3e-2

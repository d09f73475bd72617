"""The CUDA attention kernels against their plain versions, on the card, and
the wrappers' refusal to fall back off them. Imports nothing of JAX, so it
runs on the GPU machine: ``python -m pytest tests/test_torch_cuda.py -q``.
The ``gpu`` tests skip where torch sees no CUDA device.
"""
import numpy as np
import pytest
import torch

from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops import build
from vavae_tpu_torch.ops.flash_attention import (
    fused_qkv_attention,
    fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,N,D", [(16, 16, 256, 72), (2, 3, 200, 64), (1, 2, 37, 8)])
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
@pytest.mark.parametrize("B,H,N,D", [(32, 16, 256, 72), (2, 3, 200, 64), (1, 2, 37, 8)])
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

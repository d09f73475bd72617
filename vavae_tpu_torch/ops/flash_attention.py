"""Fused-qkv attention with in-kernel RoPE: the Hopper port of
``vavae_tpu/ops/pallas/flash_attention.py:_nat_fwd_kernel``.

``fused_qkv_attention(qkv5, rope)`` takes the free reshape of the qkv
projection, ``(B, N, 3, H, D)``, and returns ``(B, N, H, D)``. For a CUDA
tensor it launches ``csrc/nat_attention_fwd.cu`` (built at first use) or
raises; for a CPU tensor it runs ``fused_qkv_attention_reference``, the
plain version with the kernel's numerics. There is no fallback from the
kernel to the plain version.

Unlike the JAX entry point there is no sequence-length routing: the JAX
thresholds (256 ≤ N ≤ 1024) keep tiny CPU dry runs off the TPU kernel,
while the CUDA kernel takes any N ≥ 1 and any even D ≤ 256.
"""
from __future__ import annotations

import ctypes

import torch

from vavae_tpu_torch.ops.build import load_library

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fold_sin(rope, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) split-half tables → (cos, sign-folded sin) as (N, D) fp32,
    so that ``rotate_half(x)·sin == roll(x, D/2)·sin'`` (JAX ``_fold_sin``)."""
    cos, sin = rope
    cos = torch.as_tensor(cos, dtype=torch.float32, device=device)
    sin = torch.as_tensor(sin, dtype=torch.float32, device=device)
    d = cos.shape[-1]
    sign = torch.ones(d, dtype=torch.float32, device=cos.device)
    sign[: d // 2] = -1.0
    return cos.contiguous(), (sin * sign).contiguous()


def fused_qkv_attention_reference(qkv5: torch.Tensor, rope=None) -> torch.Tensor:
    """Plain version of the kernel, op for op: RoPE in the input dtype,
    fp32 ``q·kᵀ·D^-0.5``, fp32 softmax numerator, P rounded to the input
    dtype before P·V with fp32 accumulation, division by the row sum last."""
    _, _, _, _, D = qkv5.shape
    dtype = qkv5.dtype
    q, k, v = qkv5.unbind(dim=2)  # (B, N, H, D)
    if rope is not None:
        cos, sinf = fold_sin(rope, device=qkv5.device)
        cos = cos[None, :, None, :].to(dtype)
        sinf = sinf[None, :, None, :].to(dtype)
        q = q * cos + torch.roll(q, D // 2, dims=-1) * sinf
        k = k * cos + torch.roll(k, D // 2, dims=-1) * sinf
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(dtype).float(), v.float())
    return (acc / l).to(dtype).transpose(1, 2)


def _check_kernel_input(qkv5: torch.Tensor) -> None:
    B, N, _, H, D = qkv5.shape
    if min(B, N, H) < 1:
        raise ValueError(f"empty attention input {tuple(qkv5.shape)}")
    if D % 2 or D > MAX_HEAD_DIM:
        raise ValueError(f"head dim must be even and <= {MAX_HEAD_DIM}, got {D}")
    if qkv5.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv5.dtype}")
    if not qkv5.is_contiguous():
        raise ValueError("qkv5 must be contiguous")


def _launch(qkv5: torch.Tensor, rope) -> torch.Tensor:
    B, N, _, H, D = qkv5.shape
    out = torch.empty((B, N, H, D), dtype=qkv5.dtype, device=qkv5.device)
    if rope is not None:
        cos, sinf = fold_sin(rope, device=qkv5.device)
        if cos.shape != (N, D) or sinf.shape != (N, D):
            raise ValueError(f"rope tables must be ({N}, {D}), got {tuple(cos.shape)}")
        tables = (cos.data_ptr(), sinf.data_ptr())
    else:
        tables = (None, None)
    lib = load_library("nat_attention_fwd")
    fn = lib.nat_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(qkv5.device).cuda_stream
    err = fn(
        qkv5.data_ptr(), tables[0], tables[1], out.data_ptr(),
        B, N, H, D, int(rope is not None), _DTYPE_CODES[qkv5.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"nat_attention_fwd launch failed: CUDA error {err}")
    fused_qkv_attention.launches += 1
    return out


def fused_qkv_attention(qkv5: torch.Tensor, rope=None) -> torch.Tensor:
    """qkv5: (B, N, 3, H, D) → (B, N, H, D). ``rope``: optional (cos, sin)
    split-half tables of shape (N, D).

    CUDA tensors go through the hand-written kernel (counted in
    ``fused_qkv_attention.launches``); CPU tensors through the plain
    version. Any other device raises."""
    if qkv5.dim() != 5 or qkv5.shape[2] != 3:
        raise ValueError(f"qkv5 must be (B, N, 3, H, D), got {tuple(qkv5.shape)}")
    if qkv5.device.type == "cuda":
        _check_kernel_input(qkv5)
        return _launch(qkv5, rope)
    if qkv5.device.type == "cpu":
        return fused_qkv_attention_reference(qkv5, rope)
    raise RuntimeError(f"no attention path for device {qkv5.device}")


fused_qkv_attention.launches = 0

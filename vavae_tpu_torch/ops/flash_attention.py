"""Fused-qkv attention with in-kernel RoPE: the Hopper port of
``vavae_tpu/ops/pallas/flash_attention.py:_nat_fwd_kernel`` and of its
recompute backward ``_nat_bwd_kernel``.

``fused_qkv_attention(qkv5, rope)`` takes the free reshape of the qkv
projection, ``(B, N, 3, H, D)``, and returns ``(B, N, H, D)``. For a CUDA
tensor it runs ``_FusedQKVAttention``: the forward launches
``csrc/nat_attention_fwd.cu`` and the backward ``csrc/nat_attention_bwd.cu``
(each built at first use), or they raise. For a CPU tensor it runs
``fused_qkv_attention_reference``, the plain version with the kernel's
numerics, under torch autograd (as the JAX package differentiates its XLA
fallback off the TPU). There is no fallback from a kernel to a plain version.

Unlike the JAX entry point there is no sequence-length routing: the JAX
thresholds (256 ≤ N ≤ 1024) keep tiny CPU dry runs off the TPU kernel,
while the CUDA kernels take any N ≥ 1 and any even D ≤ 256 (forward) or
D ≤ 128 (backward).
"""
from __future__ import annotations

import ctypes

import torch

from vavae_tpu_torch.ops.build import load_library

MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128
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


def _rotate(x: torch.Tensor, cos: torch.Tensor, sinf: torch.Tensor) -> torch.Tensor:
    """The RoPE roll form ``x·cos + roll(x, D/2)·sin'`` on (B, N, H, D)."""
    return x * cos + torch.roll(x, x.shape[-1] // 2, dims=-1) * sinf


def fused_qkv_attention_reference(qkv5: torch.Tensor, rope=None) -> torch.Tensor:
    """Plain version of the kernel, op for op: RoPE in the input dtype,
    fp32 ``q·kᵀ·D^-0.5``, fp32 softmax numerator, P rounded to the input
    dtype before P·V with fp32 accumulation, division by the row sum last."""
    _, _, _, _, D = qkv5.shape
    dtype = qkv5.dtype
    q, k, v = qkv5.unbind(dim=2)  # (B, N, H, D)
    if rope is not None:
        cos, sinf = fold_sin(rope, device=qkv5.device)
        cos, sinf = cos[None, :, None, :].to(dtype), sinf[None, :, None, :].to(dtype)
        q, k = _rotate(q, cos, sinf), _rotate(k, cos, sinf)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(dtype).float(), v.float())
    return (acc / l).to(dtype).transpose(1, 2)


def fused_qkv_attention_bwd_reference(qkv5: torch.Tensor, g: torch.Tensor,
                                      rope=None) -> torch.Tensor:
    """Plain version of the backward kernel, op for op with
    ``_nat_bwd_kernel``: q̃, k̃ rotated in the input dtype; fp32 scores; the
    *normalised* fp32 softmax (the backward normalises first, the forward
    divides last); P rounded to the dtype for dv; fp32 dP and dS, dS rounded
    to the dtype for dq and dk; the transposed RoPE ``x·cos + roll(x·sin',
    D/2)`` in fp32 with the fp32 tables; the result cast to the dtype last.

    qkv5: (B, N, 3, H, D), g: (B, N, H, D) → dqkv (B, N, 3, H, D), the layout
    of the qkv projection's output."""
    _, _, _, _, D = qkv5.shape
    dtype = qkv5.dtype
    scale = D ** -0.5
    q, k, v = qkv5.unbind(dim=2)
    if rope is not None:
        cos, sinf = fold_sin(rope, device=qkv5.device)
        cos, sinf = cos[None, :, None, :], sinf[None, :, None, :]
        q, k = _rotate(q, cos.to(dtype), sinf.to(dtype)), _rotate(k, cos.to(dtype), sinf.to(dtype))
    gf = g.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    if rope is not None:
        dq = dq * cos + torch.roll(dq * sinf, D // 2, dims=-1)
        dk = dk * cos + torch.roll(dk * sinf, D // 2, dims=-1)
    return torch.stack([dq, dk, dv], dim=2).to(dtype)


def _check_kernel_input(qkv5: torch.Tensor, max_head_dim: int = MAX_HEAD_DIM) -> None:
    B, N, _, H, D = qkv5.shape
    if min(B, N, H) < 1:
        raise ValueError(f"empty attention input {tuple(qkv5.shape)}")
    if D % 2 or D > max_head_dim:
        raise ValueError(f"head dim must be even and <= {max_head_dim}, got {D}")
    if qkv5.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv5.dtype}")
    if not qkv5.is_contiguous():
        raise ValueError("qkv5 must be contiguous")


def _kernel_tables(rope, N: int, D: int, device) -> tuple[torch.Tensor, torch.Tensor] | None:
    if rope is None:
        return None
    cos, sinf = fold_sin(rope, device=device)
    if cos.shape != (N, D) or sinf.shape != (N, D):
        raise ValueError(f"rope tables must be ({N}, {D}), got {tuple(cos.shape)}")
    return cos, sinf


def _table_ptrs(tables) -> tuple:
    return (None, None) if tables is None else (tables[0].data_ptr(), tables[1].data_ptr())


def _launch_fwd(qkv5: torch.Tensor, tables) -> torch.Tensor:
    B, N, _, H, D = qkv5.shape
    out = torch.empty((B, N, H, D), dtype=qkv5.dtype, device=qkv5.device)
    fn = load_library("nat_attention_fwd").nat_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(qkv5.device).cuda_stream
    cos, sinf = _table_ptrs(tables)
    err = fn(qkv5.data_ptr(), cos, sinf, out.data_ptr(),
             B, N, H, D, int(tables is not None), _DTYPE_CODES[qkv5.dtype], stream)
    if err != 0:
        raise RuntimeError(f"nat_attention_fwd launch failed: CUDA error {err}")
    fused_qkv_attention.launches += 1
    return out


def _launch_bwd(qkv5: torch.Tensor, g: torch.Tensor, tables) -> torch.Tensor:
    """dqkv (B, N, 3, H, D) through ``csrc/nat_attention_bwd.cu``: its two
    passes are one launch of the wrapper, counted in
    ``fused_qkv_attention.bwd_launches``."""
    _check_kernel_input(qkv5, MAX_BWD_HEAD_DIM)
    B, N, _, H, D = qkv5.shape
    if g.shape != (B, N, H, D) or g.dtype != qkv5.dtype or g.device != qkv5.device:
        raise ValueError(f"gradient must be ({B}, {N}, {H}, {D}) {qkv5.dtype} on {qkv5.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    g = g.contiguous()
    dqkv = torch.empty_like(qkv5)
    stats = torch.empty((3, B, H, N), dtype=torch.float32, device=qkv5.device)
    fn = load_library("nat_attention_bwd").nat_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(qkv5.device).cuda_stream
    cos, sinf = _table_ptrs(tables)
    err = fn(qkv5.data_ptr(), g.data_ptr(), cos, sinf, dqkv.data_ptr(), stats.data_ptr(),
             B, N, H, D, int(tables is not None), _DTYPE_CODES[qkv5.dtype], stream)
    if err != 0:
        raise RuntimeError(f"nat_attention_bwd launch failed: CUDA error {err}")
    fused_qkv_attention.bwd_launches += 1
    return dqkv


def fused_qkv_attention_bwd(qkv5: torch.Tensor, g: torch.Tensor, rope=None) -> torch.Tensor:
    """The backward kernel on CUDA tensors (raises on any other device):
    dqkv (B, N, 3, H, D) for qkv5 (B, N, 3, H, D) and the output gradient g
    (B, N, H, D). ``rope``: optional (cos, sin) split-half tables."""
    if qkv5.device.type != "cuda":
        raise RuntimeError(f"the backward kernel needs CUDA tensors, got {qkv5.device}")
    B, N, _, H, D = qkv5.shape
    return _launch_bwd(qkv5, g, _kernel_tables(rope, N, D, qkv5.device))


class _FusedQKVAttention(torch.autograd.Function):
    """Both kernels under autograd, as ``_natural_attention``'s custom VJP:
    the forward saves qkv5 and the folded tables (``_nat_fwd_rule`` saves
    ``(qkv3, tables)``); the backward recomputes P in the backward kernel.
    The tables get no gradient."""

    @staticmethod
    def forward(ctx, qkv5, cos, sinf):
        tables = None if cos is None else (cos, sinf)
        ctx.save_for_backward(qkv5, cos, sinf)
        ctx.use_rope = tables is not None
        return _launch_fwd(qkv5, tables)

    @staticmethod
    def backward(ctx, g):
        qkv5, cos, sinf = ctx.saved_tensors
        tables = (cos, sinf) if ctx.use_rope else None
        return _launch_bwd(qkv5, g, tables), None, None


def fused_qkv_attention(qkv5: torch.Tensor, rope=None) -> torch.Tensor:
    """qkv5: (B, N, 3, H, D) → (B, N, H, D). ``rope``: optional (cos, sin)
    split-half tables of shape (N, D).

    CUDA tensors go through the hand-written kernels (the forward counted
    in ``fused_qkv_attention.launches``, the backward in
    ``fused_qkv_attention.bwd_launches``); CPU tensors through the plain
    version. Any other device raises."""
    if qkv5.dim() != 5 or qkv5.shape[2] != 3:
        raise ValueError(f"qkv5 must be (B, N, 3, H, D), got {tuple(qkv5.shape)}")
    if qkv5.device.type == "cuda":
        _check_kernel_input(qkv5)
        if torch.is_grad_enabled() and qkv5.requires_grad:
            _check_kernel_input(qkv5, MAX_BWD_HEAD_DIM)  # refuse now, not in the backward
        _, N, _, _, D = qkv5.shape
        tables = _kernel_tables(rope, N, D, qkv5.device)
        cos, sinf = (None, None) if tables is None else tables
        return _FusedQKVAttention.apply(qkv5, cos, sinf)
    if qkv5.device.type == "cpu":
        return fused_qkv_attention_reference(qkv5, rope)
    raise RuntimeError(f"no attention path for device {qkv5.device}")


fused_qkv_attention.launches = 0
fused_qkv_attention.bwd_launches = 0

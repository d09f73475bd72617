"""Attention with in-kernel RoPE: the Hopper ports of the TPU kernels in
``vavae_tpu/ops/pallas/flash_attention.py``.

``fused_qkv_attention(qkv5, rope)`` ports ``_nat_fwd_kernel`` and its
recompute backward ``_nat_bwd_kernel``. It takes the free reshape of the qkv
projection, ``(B, N, 3, H, D)``, and returns ``(B, N, H, D)``. For a CUDA
tensor it runs ``_FusedQKVAttention``: the forward launches
``csrc/nat_attention_fwd.cu`` and the backward ``csrc/nat_attention_bwd.cu``.

``flash_attention(q, k, v, rope)`` ports the JAX entry point of the same
name, the qk-norm models' attention: ``_attn_kernel_small_rope`` (with
``rope``) and ``_attn_kernel_small`` (without) forward, and
``_attn_bwd_kernel_small`` backward. It takes separate ``(B, N, H, D)``
tensors of any batch, token and head strides (the head dim contiguous), so
``v`` may be the strided view ``qkv[:, :, 2]``, and returns ``(B, N, H, D)``.
For CUDA tensors it runs ``_FlashAttention``: the forward launches
``csrc/attn_small_fwd.cu`` and the backward ``csrc/attn_small_bwd.cu``.

Sequences longer than ``SMALL_SEQ_MAX = 1024`` tokens take the long route
on both entry points and on both devices, as ``_forward`` does for them on
the TPU (``fused_qkv_attention`` first unbinds q, k and the strided v, as
the JAX function hands them to ``dot_product_attention``):
``long_attention`` rotates q and k outside the kernel with the fp32 tables
uncast (``layers.apply_rope``, so bf16 q, k become fp32 q̃, k̃), then
launches ``csrc/flash_fwd.cu``, the port of ``_flash_kernel``, on CUDA
tensors or runs its plain version ``flash_attention_long_reference`` on CPU
tensors. The output takes q̃'s dtype: fp32 for the RoPE models. The
backward (``_LongAttention``) is torch autograd of the exact op, as the JAX
``_bwd`` takes ``jax.vjp`` of ``_xla_rope_attention``: no backward kernel,
and it holds the (B, H, N, N) fp32 scores. The kernel takes any N; the JAX
package sends an N that is not a multiple of 256 to ``_xla_attention``
instead, which differs only in not rounding P to v's dtype before P·V. The
other JAX threshold (``_FLASH_MIN_SEQ`` = 256) keeps tiny CPU dry runs off
the TPU kernels and has no counterpart: for N ≤ 1024 the CUDA kernels take
any N ≥ 1.

The forward kernels take the split-half (cos, sin) tables as the model
holds them and fold the sign of sin themselves, so a forward call launches
its kernel and nothing else; the backward kernels take sin sign-folded
(``fold_sin``, once per backward call). Each kernel is built at first use;
a failed build or launch raises. CPU tensors run the plain versions
(``*_reference``, the kernels' numerics) under torch autograd, as the JAX
package differentiates its XLA fallback off the TPU. There is no fallback
from a kernel to a plain version.
"""
from __future__ import annotations

import ctypes

import torch

from vavae_tpu_torch.ops.build import load_library

MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128
SMALL_SEQ_MAX = 1024  # longer sequences take the long route (JAX SMALL_SEQ_MAX)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# each C entry's (argument types, result type); ``_entry`` binds them once
_SIGNATURES = {
    "nat_attention_fwd": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "nat_attention_bwd": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "attn_small_fwd": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "attn_small_bwd": ([_P] * 11 + [_I] * 6 + [_P], _I),
    "flash_fwd": ([_P] * 5 + [_I] * 6 + [_P], _I),
}
_ENTRIES: dict = {}


def _entry(library: str, scratch_bytes: bool = False):
    """The C entry ``<library>`` of ``csrc/<library>.cu`` (or, with
    ``scratch_bytes``, its ``<library>_scratch_bytes``), its argument and
    result types set on first use."""
    key = (library, scratch_bytes)
    fn = _ENTRIES.get(key)
    if fn is None:
        lib = load_library(library)
        if scratch_bytes:
            fn = getattr(lib, f"{library}_scratch_bytes")
            fn.argtypes, fn.restype = [_I] * 5, ctypes.c_longlong
        else:
            fn = getattr(lib, library)
            fn.argtypes, fn.restype = _SIGNATURES[library]
        _ENTRIES[key] = fn
    return fn


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


def _table_pair(rope, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) split-half tables → (1, N, 1, D) in ``dtype``."""
    cos, sin = (torch.as_tensor(t, dtype=torch.float32, device=device) for t in rope)
    return cos[None, :, None, :].to(dtype), sin[None, :, None, :].to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Split-half rotation partner: (x1 | x2) -> (-x2 | x1) (the TPU
    kernels' ``_rot_half``)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rot_half_t(y: torch.Tensor) -> torch.Tensor:
    """Its transpose, (y1 | y2) → (y2 | −y1) (``_attn_bwd_kernel_small``'s
    ``rot_t``)."""
    half = y.shape[-1] // 2
    return torch.cat([y[..., half:], -y[..., :half]], dim=-1)


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


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              rope=None) -> torch.Tensor:
    """Plain version of ``_attn_kernel_small_rope`` (``rope`` given) and
    ``_attn_kernel_small``, op for op: q̃, k̃ = x·cos + rot_half(x)·sin in the
    input dtype with the tables cast to it; fp32 ``q̃·k̃ᵀ·D^-0.5``; fp32
    softmax numerator; P rounded to the input dtype before P·V with fp32
    accumulation; division by the row sum last.

    q, k, v: (B, N, H, D) → (B, N, H, D); ``rope``: optional (cos, sin)
    split-half tables of shape (N, D)."""
    D = q.shape[-1]
    dtype = q.dtype
    if rope is not None:
        cos, sin = _table_pair(rope, dtype, q.device)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(dtype).float(), v.float())
    return (acc / l).to(dtype).transpose(1, 2)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  g: torch.Tensor, rope=None):
    """Plain version of ``_attn_bwd_kernel_small``, op for op: q̃, k̃ rotated
    in the input dtype; fp32 scores; the *normalised* fp32 softmax; P rounded
    to the dtype for dv; fp32 dP and dS = P∘(dP − rowsum(dP∘P))·scale, dS
    rounded to the dtype for dq and dk; the transposed rotation
    ``x·cos + rot_t(x·sin)`` in fp32 with the fp32 tables; each result cast to
    the dtype last.

    q, k, v, g: (B, N, H, D) → (dq, dk, dv), each (B, N, H, D)."""
    D = q.shape[-1]
    dtype = q.dtype
    scale = D ** -0.5
    if rope is not None:
        cos, sin = _table_pair(rope, torch.float32, q.device)
        cd, sd = cos.to(dtype), sin.to(dtype)
        q, k = q * cd + rotate_half(q) * sd, k * cd + rotate_half(k) * sd
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
        dq = dq * cos + _rot_half_t(dq * sin)
        dk = dk * cos + _rot_half_t(dk * sin)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


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


def _raw_tables(rope, N: int, D: int, device) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The split-half (cos, sin) as (N, D) fp32 contiguous tensors on
    ``device``, the forward kernels' tables (they fold the sign of sin
    themselves): the model's own buffers, so nothing is launched."""
    if rope is None:
        return None
    cos, sin = (torch.as_tensor(t, dtype=torch.float32, device=device).contiguous() for t in rope)
    if cos.shape != (N, D) or sin.shape != (N, D):
        raise ValueError(f"rope tables must be ({N}, {D}), got {tuple(cos.shape)}")
    return cos, sin


def _kernel_tables(rope, N: int, D: int, device) -> tuple[torch.Tensor, torch.Tensor] | None:
    """(cos, sign-folded sin), the backward kernels' tables."""
    tables = _raw_tables(rope, N, D, device)
    return None if tables is None else fold_sin(tables)


def _table_ptrs(tables) -> tuple:
    return (None, None) if tables is None else (tables[0].data_ptr(), tables[1].data_ptr())


def _launch_fwd(qkv5: torch.Tensor, tables) -> torch.Tensor:
    """(B, N, H, D) through ``csrc/nat_attention_fwd.cu`` on the raw tables
    (``_raw_tables``): one kernel, counted in ``fused_qkv_attention.launches``."""
    B, N, _, H, D = qkv5.shape
    out = torch.empty((B, N, H, D), dtype=qkv5.dtype, device=qkv5.device)
    fn = _entry("nat_attention_fwd")
    stream = torch.cuda.current_stream(qkv5.device).cuda_stream
    cos, sinf = _table_ptrs(tables)
    err = fn(qkv5.data_ptr(), cos, sinf, out.data_ptr(),
             B, N, H, D, int(tables is not None), _DTYPE_CODES[qkv5.dtype], stream)
    if err != 0:
        raise RuntimeError(f"nat_attention_fwd launch failed: CUDA error {err}")
    fused_qkv_attention.launches += 1
    return out


def _bwd_scratch(name: str, B: int, N: int, H: int, D: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """The scratch a backward kernel needs for these shapes, as the library
    computes it (``<name>_scratch_bytes``): for bf16 the row statistics, the
    rotated q̃, k̃ and the per-key-block dq partials; for fp32 nothing at N ≤
    64 (one tile a head), else the rotated q̃, k̃, dq's sum over key tiles
    and the row statistics."""
    size = _entry(name, scratch_bytes=True)(B, N, H, D, _DTYPE_CODES[dtype])
    return torch.empty(size, dtype=torch.uint8, device=device)


def _launch_bwd(qkv5: torch.Tensor, g: torch.Tensor, tables) -> torch.Tensor:
    """dqkv (B, N, 3, H, D) through ``csrc/nat_attention_bwd.cu``: its
    passes are one launch of the wrapper, counted in
    ``fused_qkv_attention.bwd_launches``."""
    _check_kernel_input(qkv5, MAX_BWD_HEAD_DIM)
    B, N, _, H, D = qkv5.shape
    if g.shape != (B, N, H, D) or g.dtype != qkv5.dtype or g.device != qkv5.device:
        raise ValueError(f"gradient must be ({B}, {N}, {H}, {D}) {qkv5.dtype} on {qkv5.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    g = g.contiguous()
    dqkv = torch.empty_like(qkv5)
    scratch = _bwd_scratch("nat_attention_bwd", B, N, H, D, qkv5.dtype, qkv5.device)
    fn = _entry("nat_attention_bwd")
    stream = torch.cuda.current_stream(qkv5.device).cuda_stream
    cos, sinf = _table_ptrs(tables)
    err = fn(qkv5.data_ptr(), g.data_ptr(), cos, sinf, dqkv.data_ptr(), scratch.data_ptr(),
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
    the forward saves qkv5 and the raw tables (``_nat_fwd_rule`` saves
    ``(qkv3, tables)``) and launches the forward kernel alone; the backward
    folds the sign of sin once and recomputes P in the backward kernel. The
    tables get no gradient."""

    @staticmethod
    def forward(ctx, qkv5, cos, sin):
        tables = None if cos is None else (cos, sin)
        ctx.save_for_backward(qkv5, cos, sin)
        ctx.use_rope = tables is not None
        return _launch_fwd(qkv5, tables)

    @staticmethod
    def backward(ctx, g):
        qkv5, cos, sin = ctx.saved_tensors
        tables = fold_sin((cos, sin)) if ctx.use_rope else None
        return _launch_bwd(qkv5, g, tables), None, None


def fused_qkv_attention(qkv5: torch.Tensor, rope=None) -> torch.Tensor:
    """qkv5: (B, N, 3, H, D) → (B, N, H, D). ``rope``: optional (cos, sin)
    split-half tables of shape (N, D).

    CUDA tensors go through the hand-written kernels (the forward counted
    in ``fused_qkv_attention.launches``, the backward in
    ``fused_qkv_attention.bwd_launches``); CPU tensors through the plain
    version. Any other device raises. N > ``SMALL_SEQ_MAX``: q, k and v are
    unbound (v a strided view) and take ``long_attention``."""
    if qkv5.dim() != 5 or qkv5.shape[2] != 3:
        raise ValueError(f"qkv5 must be (B, N, 3, H, D), got {tuple(qkv5.shape)}")
    if qkv5.shape[1] > SMALL_SEQ_MAX:
        return long_attention(*qkv5.unbind(dim=2), rope=rope)
    if qkv5.device.type == "cuda":
        _check_kernel_input(qkv5)
        if torch.is_grad_enabled() and qkv5.requires_grad:
            _check_kernel_input(qkv5, MAX_BWD_HEAD_DIM)  # refuse now, not in the backward
        _, N, _, _, D = qkv5.shape
        tables = _raw_tables(rope, N, D, qkv5.device)
        cos, sin = (None, None) if tables is None else tables
        return _FusedQKVAttention.apply(qkv5, cos, sin)
    if qkv5.device.type == "cpu":
        return fused_qkv_attention_reference(qkv5, rope)
    raise RuntimeError(f"no attention path for device {qkv5.device}")


fused_qkv_attention.launches = 0
fused_qkv_attention.bwd_launches = 0


# -- separate q, k, v: _attn_kernel_small_rope, _attn_kernel_small and
#    _attn_bwd_kernel_small ----------------------------------------------------


# (q and k, v) dtypes the separate-q/k/v kernels take; the long route's adds
# the RoPE models' fp32 q̃, k̃ with bf16 v
_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16))
_LONG_DTYPE_PAIRS = _DTYPE_PAIRS + ((torch.float32, torch.bfloat16),)


def _check_flash_input(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       max_head_dim: int = MAX_HEAD_DIM, dtype_pairs=_DTYPE_PAIRS) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, N, H, D) alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, N, H, D = q.shape
    if min(B, N, H) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if D < 2 or D % 2 or D > max_head_dim:
        raise ValueError(f"head dim must be even and <= {max_head_dim}, got {D}")
    if k.dtype != q.dtype or (q.dtype, v.dtype) not in dtype_pairs:
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v with (q and k, v) dtypes in "
                        f"{dtype_pairs}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dim (stride 1)")


def _strides(*tensors: torch.Tensor):
    """(batch, token, head) element strides of each tensor, as a C array."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables) -> torch.Tensor:
    """(B, N, H, D) through ``csrc/attn_small_fwd.cu`` on the raw tables
    (``_raw_tables``): one kernel, counted in ``flash_attention.rope_launches``
    with tables, else in ``flash_attention.launches``."""
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    fn = _entry("attn_small_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cos, sinf = _table_ptrs(tables)
    strides = _strides(q, k, v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos, sinf, out.data_ptr(),
             ctypes.addressof(strides), B, N, H, D, int(tables is not None),
             _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attn_small_fwd launch failed: CUDA error {err}")
    if tables is None:
        flash_attention.launches += 1
    else:
        flash_attention.rope_launches += 1
    return out


def _launch_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      tables) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each (B, N, H, D), through ``csrc/attn_small_bwd.cu``:
    its passes are one launch of the wrapper, counted in
    ``flash_attention.bwd_launches``."""
    _check_flash_input(q, k, v, MAX_BWD_HEAD_DIM)
    B, N, H, D = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"gradient must be ({B}, {N}, {H}, {D}) {q.dtype} on {q.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    dq, dk, dv = (torch.empty((B, N, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    scratch = _bwd_scratch("attn_small_bwd", B, N, H, D, q.dtype, q.device)
    fn = _entry("attn_small_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cos, sinf = _table_ptrs(tables)
    strides = _strides(q, k, v, g)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), cos, sinf,
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
             ctypes.addressof(strides), B, N, H, D, int(tables is not None),
             _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attn_small_bwd launch failed: CUDA error {err}")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        rope=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on CUDA tensors (raises on any other device):
    (dq, dk, dv) for q, k, v (B, N, H, D) and the output gradient g.
    ``rope``: optional (cos, sin) split-half tables."""
    if q.device.type != "cuda":
        raise RuntimeError(f"the backward kernel needs CUDA tensors, got {q.device}")
    _, N, _, D = q.shape
    return _launch_flash_bwd(q, k, v, g, _kernel_tables(rope, N, D, q.device))


class _FlashAttention(torch.autograd.Function):
    """Both kernels under autograd, as the JAX ``flash_attention`` custom VJP:
    the forward saves q, k, v and the raw tables (``_fwd`` saves
    ``(q, k, v, rope)``) and launches the forward kernel alone; the backward
    folds the sign of sin once and recomputes P in the backward kernel. The
    tables get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        tables = None if cos is None else (cos, sin)
        ctx.save_for_backward(q, k, v, cos, sin)
        ctx.use_rope = tables is not None
        return _launch_flash_fwd(q, k, v, tables)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin = ctx.saved_tensors
        tables = fold_sin((cos, sin)) if ctx.use_rope else None
        return (*_launch_flash_bwd(q, k, v, g, tables), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rope=None) -> torch.Tensor:
    """q, k, v: (B, N, H, D) → (B, N, H, D). Softmax scale D^-0.5.
    ``rope``: optional (cos, sin) split-half tables of shape (N, D), applied
    to q and k inside the kernel.

    CUDA tensors go through the hand-written kernels (the forward counted in
    ``flash_attention.rope_launches`` with RoPE and ``flash_attention.launches``
    without, the backward in ``flash_attention.bwd_launches``); CPU tensors
    through the plain version. Any other device raises. N > ``SMALL_SEQ_MAX``
    takes ``long_attention`` instead."""
    if q.shape[1] > SMALL_SEQ_MAX:
        return long_attention(q, k, v, rope)
    if q.device.type == "cuda":
        _check_flash_input(q, k, v)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            _check_flash_input(q, k, v, MAX_BWD_HEAD_DIM)  # refuse now, not in the backward
        _, N, _, D = q.shape
        tables = _raw_tables(rope, N, D, q.device)
        cos, sin = (None, None) if tables is None else tables
        return _FlashAttention.apply(q, k, v, cos, sin)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, rope)
    raise RuntimeError(f"no attention path for device {q.device}")


flash_attention.rope_launches = 0
flash_attention.launches = 0
flash_attention.bwd_launches = 0
flash_attention.long_launches = 0


# -- the long route (N > SMALL_SEQ_MAX): _flash_kernel -------------------------


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX ``_xla_attention``: fp32 logits and softmax, the normalised
    probabilities cast to q's dtype before P·V, which runs in the promoted
    dtype of q and v (as ``jnp.einsum``). (B, N, H, D) → (B, N, H, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    dtype = torch.promote_types(q.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v.to(dtype))


def rope_uncast(x: torch.Tensor, rope) -> torch.Tensor:
    """``layers.apply_rope`` with the tables uncast, as ``_forward`` rotates
    q and k before ``_flash_kernel``: bf16 x and fp32 tables give fp32."""
    cos, sin = (torch.as_tensor(t, device=x.device)[None, :, None, :] for t in rope)
    return x * cos + rotate_half(x) * sin


def xla_rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rope=None) -> torch.Tensor:
    """The JAX ``_xla_rope_attention``, the exact op the long route's
    backward differentiates: RoPE with the tables cast to q's dtype, then
    ``plain_attention``."""
    if rope is not None:
        cos, sin = _table_pair(rope, q.dtype, q.device)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
    return plain_attention(q, k, v)


def flash_attention_long_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_flash_kernel`` on q̃, k̃ rotated beforehand, op for
    op: fp32 ``q̃·k̃ᵀ·D^-0.5`` from q̃, k̃ in their own dtype; fp32 softmax
    numerator; P rounded to v's dtype before P·V with fp32 accumulation;
    division by the row sum last; the result in q̃'s dtype.

    q, k, v: (B, N, H, D) → (B, N, H, D)."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype).transpose(1, 2)


def long_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rope=None) -> torch.Tensor:
    """Plain version of the whole long route: ``rope_uncast``, then
    ``flash_attention_long_reference``."""
    if rope is not None:
        q, k = rope_uncast(q, rope), rope_uncast(k, rope)
    return flash_attention_long_reference(q, k, v)


def flash_attention_long(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``csrc/flash_fwd.cu`` on CUDA tensors (raises on any other device):
    q̃, k̃ (rotated beforehand) and v (B, N, H, D) of any N → (B, N, H, D) in
    q̃'s dtype. Counted in ``flash_attention.long_launches``."""
    if q.device.type != "cuda":
        raise RuntimeError(f"the long-route kernel needs CUDA tensors, got {q.device}")
    _check_flash_input(q, k, v, dtype_pairs=_LONG_DTYPE_PAIRS)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    fn = _entry("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = _strides(q, k, v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
             B, N, H, D, _DTYPE_CODES[q.dtype], _DTYPE_CODES[v.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.long_launches += 1
    return out


def _long_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_long(q, k, v)
    return flash_attention_long_reference(q, k, v)


class _LongAttention(torch.autograd.Function):
    """The long route under autograd, as the JAX ``flash_attention`` custom
    VJP for N > 1024: the forward rotates (tables uncast) and runs
    ``_flash_kernel``'s port; it saves q, k, v and the tables (``_fwd``
    saves ``(q, k, v, rope)``), and the backward is torch autograd of
    ``xla_rope_attention`` (``_bwd``: ``jax.vjp`` of
    ``_xla_rope_attention``). The tables get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        ctx.save_for_backward(q, k, v, cos, sin)
        if cos is not None:
            q, k = rope_uncast(q, (cos, sin)), rope_uncast(k, (cos, sin))
        return _long_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin = ctx.saved_tensors
        rope = None if cos is None else (cos, sin)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = xla_rope_attention(*leaves, rope)
            grads = torch.autograd.grad(out, leaves, g.to(out.dtype))
        return (*grads, None, None)


def long_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rope=None) -> torch.Tensor:
    """``_forward``'s long route, for N > ``SMALL_SEQ_MAX``: q, k, v (B, N, H,
    D) → (B, N, H, D) in the rotated q's dtype. ``rope``: optional (cos, sin)
    split-half tables of shape (N, D), applied outside the kernel in their
    own dtype. CUDA tensors launch the kernel, CPU tensors run its plain
    version; any other device raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no attention path for device {q.device}")
    cos = sin = None
    if rope is not None:
        cos, sin = (torch.as_tensor(t, device=q.device) for t in rope)
        N, D = q.shape[1], q.shape[-1]
        if cos.shape != (N, D) or sin.shape != (N, D):
            raise ValueError(f"rope tables must be ({N}, {D}), got {tuple(cos.shape)}")
    return _LongAttention.apply(q, k, v, cos, sin)

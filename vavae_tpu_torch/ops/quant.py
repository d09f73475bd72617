"""INT8 weight quantization of the DiT's Linear layers (port of
``vavae_tpu/ops/quant.py``).

Per-output-channel symmetric int8: ``w ≈ values · scales``. The port's
``nn.Linear.weight`` is (out, in) where the JAX kernel is (in, out), so the
absmax reduces over the last axis here and the scales are (…, out, 1); the
values and scales are the JAX package's transposed, bit for bit (fp32
division in the same order, round half to even on both sides).

``quantize_params`` walks a DiT state dict (parameter name → tensor) and
replaces each Linear weight whose JAX module name (``utils/weights.py``:
``dit_jax_path``) is in ``targets`` by ``{"values": int8, "scales": fp32}``;
``dit_state_to_jax`` / ``dit_state_from_jax`` carry such leaves to and from
the JAX layout and keys (values (in, out), scales (1, out), stacked over the
blocks), so an int8 file written by either package restores in the other.

``int8_matmul`` quantizes the activations per row and multiplies int8 by
int8 with int32 accumulation, as the JAX package's ``dot_general``:
  - CUDA: ``torch._int_mm`` (cuBLASLt IMMA). It takes a 2-D int8 activation
    with more than 16 rows, K and N multiples of 8; other shapes are padded
    with zero rows and columns to those sizes, which leaves every int32
    accumulator unchanged, and sliced back.
  - CPU: an int32 ``torch.matmul`` (exact; no int8 kernel is needed there).
No shape takes a float product.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_TARGETS = ("qkv", "proj", "w12", "w3", "fc1", "fc2", "adaLN", "linear")
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows
INT_MM_MULTIPLE = 8   # ... and K, N multiples of 8


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(…, out, in) → {"values": int8 (…, out, in), "scales": fp32 (…, out, 1)}."""
    w = w.detach().float()
    absmax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    scales = torch.clamp(absmax / 127.0, min=1e-12)
    values = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return {"values": values, "scales": scales}


def dequantize_kernel(q: Mapping[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (q["values"].float() * q["scales"]).to(dtype)


def _int_mm_padded(xq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(xq, values.T)`` for any (M, K) × (N, K): zero rows and
    columns bring M above 16 and K, N to multiples of 8 (exact), and the
    result is sliced back to (M, N)."""
    M, K = xq.shape
    N = values.shape[0]
    pad_k = -K % INT_MM_MULTIPLE
    pad_n = -N % INT_MM_MULTIPLE
    pad_m = max(INT_MM_MIN_ROWS - M, 0)
    if pad_k or pad_m:
        xq = F.pad(xq, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        values = F.pad(values, (0, pad_k, 0, pad_n))
    # values (N, K) row-major: its transpose is the column-major (K, N)
    # operand cuBLASLt's int8 product takes
    return torch._int_mm(xq.contiguous(), values.contiguous().T)[:M, :N]


def int8_accumulate(xq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """int32 accumulators of int8 (M, K) × int8 (N, K)ᵀ: ``torch._int_mm``
    on the card, an int32 matmul on the CPU."""
    if xq.is_cuda:
        return _int_mm_padded(xq, values)
    return xq.to(torch.int32) @ values.to(torch.int32).T


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x (…, K): (int8 values, fp32 (…, 1) scales)."""
    x = x.float()
    x_absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    x_scale = torch.clamp(x_absmax / 127.0, min=1e-12)
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


def int8_matmul(x: torch.Tensor, q: Mapping[str, torch.Tensor],
                return_acc: bool = False):
    """x (…, in) @ Wᵀ with the int8 weight ``q`` (values (out, in), scales
    (out, 1)): activations quantized per row, int8 × int8 → int32, rescaled
    as ``acc · x_scale · scales``. ``return_acc`` also returns the int32
    accumulators."""
    x_q, x_scale = quantize_activations(x)
    lead = x_q.shape[:-1]
    acc = int8_accumulate(x_q.reshape(-1, x_q.shape[-1]), q["values"])
    acc = acc.reshape(*lead, -1)
    out = acc.float() * x_scale * q["scales"].reshape(1, -1)
    return (out, acc) if return_acc else out


def _is_int8_leaf(v) -> bool:
    return isinstance(v, Mapping) and "values" in v and "scales" in v


def quantize_params(params: Mapping[str, torch.Tensor],
                    targets: Sequence[str] = DEFAULT_TARGETS) -> Tuple[dict, dict]:
    """(params with int8 leaves, layout): each Linear ``weight`` of a DiT
    state dict whose JAX module name is in ``targets`` becomes ``{"values",
    "scales"}``; ``layout`` maps the quantized names to True."""
    from vavae_tpu_torch.utils.weights import dit_jax_path

    out, layout = {}, {}
    for name, v in params.items():
        path = dit_jax_path(name)
        if path[-1] == "kernel" and path[-2] in targets and v.dim() >= 2:
            out[name] = quantize_kernel(v)
            layout[name] = True
        else:
            out[name] = v
    return out, layout


def dequantize_params(qparams: Mapping, dtype=torch.float32) -> dict:
    return {k: dequantize_kernel(v, dtype) if _is_int8_leaf(v) else v
            for k, v in qparams.items()}


def quantized_size_bytes(params: Mapping) -> int:
    total = 0
    for v in params.values():
        for t in (v.values() if _is_int8_leaf(v) else (v,)):
            total += t.numel() * t.element_size()
    return total


def benchmark_quantization(
    apply_fn: Callable,
    params: Mapping[str, torch.Tensor],
    example_inputs: tuple,
    targets: Sequence[str] = DEFAULT_TARGETS,
    reps: int = 10,
) -> Dict:
    """Size, latency and output deviation of the quantized weights, the JAX
    package's report. ``apply_fn(params, *inputs)`` is the model forward
    (``torch.func.functional_call``). Each timed call is bracketed by
    ``torch.cuda.synchronize()`` on the card, and the output fetched to the
    host, so the time is the call's."""
    qparams, _ = quantize_params(params, targets)
    deq = dequantize_params(qparams)
    cuda = any(t.is_cuda for t in params.values())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    @torch.inference_mode()
    def timed(p):
        out = apply_fn(p, *example_inputs).float().cpu().numpy()  # warm-up + fetch
        total = 0.0
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            out = apply_fn(p, *example_inputs).float().cpu().numpy()
            sync()
            total += time.perf_counter() - t0
        return total / reps, out

    fp_time, fp_out = timed(params)
    # the dequantized weights through the fp forward: the quantization's
    # quality cost (the storage win is in the sizes)
    q_time, q_out = timed(deq)
    denom = float(np.abs(fp_out.astype(np.float32)).mean()) or 1.0
    return {
        "fp_size_mb": quantized_size_bytes(params) / 2**20,
        "int8_size_mb": quantized_size_bytes(qparams) / 2**20,
        "compression": quantized_size_bytes(params) / max(quantized_size_bytes(qparams), 1),
        "fp_latency_ms": fp_time * 1e3,
        "dequant_latency_ms": q_time * 1e3,
        "mean_abs_rel_error": float(
            np.abs(fp_out.astype(np.float32) - q_out.astype(np.float32)).mean()
        ) / denom,
    }

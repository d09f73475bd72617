"""Device selection for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent, so no entry point silently carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions and matmuls inside the block (TF32 off in cuDNN and
    cuBLAS), whatever the caller set; the caller's flags come back after.
    cuDNN's ``allow_tf32`` defaults to True, so a function whose fp32
    result must hold (a metric, an fp32 encode) pins it here itself. The
    flags are read when a kernel is launched, so the block holds the
    launches, not the device's execution."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved

"""EMA of the DiT's parameters (port of ``vavae_tpu/train/ema.py``)."""
from __future__ import annotations

from typing import Iterable

import torch
from torch import nn


def _tensors(x: nn.Module | Iterable[torch.Tensor]) -> list[torch.Tensor]:
    return list(x.parameters()) if isinstance(x, nn.Module) else list(x)


@torch.no_grad()
def update_ema(ema: nn.Module | Iterable[torch.Tensor],
               params: nn.Module | Iterable[torch.Tensor], decay: float = 0.9999) -> None:
    """ema = decay·ema + (1 − decay)·params, in place, computed in fp32.

    The EMA must be stored in fp32 when decay is close to 1: at decay 0.9999
    the per-step increment is ~1e-4 relative, below bf16's ~4e-3 resolution,
    so a bf16-stored EMA silently never moves. bf16 params are fine: they
    are widened for the blend."""
    ema_t, params_t = _tensors(ema), _tensors(params)
    if len(ema_t) != len(params_t):
        raise ValueError(f"EMA has {len(ema_t)} tensors, params {len(params_t)}")
    if 1.0 - decay < 2.0 ** -8 and any(e.dtype == torch.bfloat16 for e in ema_t):
        raise ValueError(
            f"bf16-stored EMA with decay {decay}: the (1-decay) increment underflows "
            "bf16 and the EMA would never update. Keep the EMA in float32 "
            "(params may be bf16)."
        )
    if all(e.dtype == p.dtype == torch.float32 for e, p in zip(ema_t, params_t)):
        torch._foreach_mul_(ema_t, decay)
        torch._foreach_add_(ema_t, params_t, alpha=1.0 - decay)
        return
    for e, p in zip(ema_t, params_t):
        e.copy_(e.float() * decay + p.float() * (1.0 - decay))

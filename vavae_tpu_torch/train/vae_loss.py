"""VA-VAE loss pieces (port of ``vavae_tpu/train/vae_loss.py``): L1 + LPIPS
NLL, the hinge GAN gate, the VF alignment loss and the adaptive weights.

  - rec = |x − x̂|·w_pix + w_p·LPIPS; nll = Σ(rec/exp(logvar) + logvar)/B
    with logvar the constant ``logvar_init`` (the reference never optimises it);
  - VF = relu(|cos-sim-mat(z) − cos-sim-mat(aux)| − m₁).mean()·w_dm
         + relu(1 − m₂ − cos(aux, z)).mean()·w_cos;
  - adaptive weight ‖∇nll‖ / (‖∇other‖ + 1e-4), clipped to [0, clip]·base,
    detached.

Tensors are NHWC; channel cosines run over the last axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    disc_start: int = 5001
    kl_weight: float = 1e-6
    pixelloss_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 0.5
    logvar_init: float = 0.0
    vf_weight: float = 0.1
    adaptive_vf: bool = True
    cos_margin: float = 0.5
    distmat_margin: float = 0.25
    distmat_weight: float = 1.0
    cos_weight: float = 1.0
    disc_loss: str = "hinge"


def nll_loss(x: torch.Tensor, rec: torch.Tensor, p_loss: Optional[torch.Tensor],
             cfg: VAELossConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(nll, mean L1). ``p_loss``: per-image LPIPS (B,) or None."""
    rec_l1 = torch.abs(x - rec) * cfg.pixelloss_weight
    if p_loss is not None and cfg.perceptual_weight > 0:
        rec_full = rec_l1 + cfg.perceptual_weight * p_loss.reshape(-1, 1, 1, 1)
    else:
        rec_full = rec_l1
    nll = rec_full / math.exp(cfg.logvar_init) + cfg.logvar_init
    return torch.sum(nll) / x.shape[0], torch.mean(rec_l1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def vf_loss(z: torch.Tensor, aux: torch.Tensor, cfg: VAELossConfig):
    """(total, distmat term, cos term) of the projected latents ``z`` and
    the foundation features ``aux``, both (B, h, w, C)."""
    B, H, W, C = z.shape
    zn = _unit(z.reshape(B, H * W, C))
    an = _unit(aux.reshape(B, H * W, C))
    z_sim = torch.einsum("bic,bjc->bij", zn, zn)
    a_sim = torch.einsum("bic,bjc->bij", an, an)
    distmat = torch.mean(F.relu(torch.abs(z_sim - a_sim) - cfg.distmat_margin))
    cos = torch.sum(zn * an, dim=-1)
    cos_term = torch.mean(F.relu(1.0 - cfg.cos_margin - cos))
    return distmat * cfg.distmat_weight + cos_term * cfg.cos_weight, distmat, cos_term


def adopt_weight(weight: float, global_step: int, threshold: int) -> float:
    """The discriminator's warm-up gate (taming ``adopt_weight``)."""
    return 0.0 if global_step < threshold else weight


def adaptive_weight(nll_grad_norm: torch.Tensor, other_grad_norm: torch.Tensor, base: float,
                    clip_max: float) -> torch.Tensor:
    w = nll_grad_norm / (other_grad_norm + 1e-4)
    return (torch.clamp(w, 0.0, clip_max) * base).detach()

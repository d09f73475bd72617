"""Flow-matching coupling paths: Linear (rectified flow), GVP, VP.

Port of ``vavae_tpu/transport/paths.py``. Pure elementwise functions of
(t, x); ``t`` enters as (B,) and is broadcast to x's rank.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def expand_t(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], *([1] * (x.dim() - 1)))


@dataclasses.dataclass(frozen=True)
class LinearPath:
    """alpha_t = t, sigma_t = 1 - t (the rectified-flow interpolant)."""

    def alpha(self, t):
        return t, torch.ones_like(t)

    def sigma(self, t):
        return 1.0 - t, -torch.ones_like(t)

    def d_alpha_over_alpha(self, t):
        return 1.0 / t

    def drift(self, x, t):
        """Score-parametrised SDE (drift_mean, diffusion)."""
        t = expand_t(t, x)
        ratio = self.d_alpha_over_alpha(t)
        sigma_t, d_sigma_t = self.sigma(t)
        return -ratio * x, ratio * sigma_t**2 - sigma_t * d_sigma_t


@dataclasses.dataclass(frozen=True)
class GVPPath(LinearPath):
    """alpha_t = sin(πt/2), sigma_t = cos(πt/2)."""

    def alpha(self, t):
        return torch.sin(t * math.pi / 2), math.pi / 2 * torch.cos(t * math.pi / 2)

    def sigma(self, t):
        return torch.cos(t * math.pi / 2), -math.pi / 2 * torch.sin(t * math.pi / 2)

    def d_alpha_over_alpha(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))


@dataclasses.dataclass(frozen=True)
class VPPath(LinearPath):
    """Variance-preserving path."""

    sigma_min: float = 0.1
    sigma_max: float = 20.0

    def _log_mean_coeff(self, t):
        return (
            -0.25 * (1.0 - t) ** 2 * (self.sigma_max - self.sigma_min)
            - 0.5 * (1.0 - t) * self.sigma_min
        )

    def _d_log_mean_coeff(self, t):
        return 0.5 * (1.0 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def alpha(self, t):
        a = torch.exp(self._log_mean_coeff(t))
        return a, a * self._d_log_mean_coeff(t)

    def sigma(self, t):
        p = 2.0 * self._log_mean_coeff(t)
        s = torch.sqrt(1.0 - torch.exp(p))
        ds = torch.exp(p) * (2.0 * self._d_log_mean_coeff(t)) / (-2.0 * s)
        return s, ds

    def d_alpha_over_alpha(self, t):
        return self._d_log_mean_coeff(t)

    def drift(self, x, t):
        t = expand_t(t, x)
        beta_t = self.sigma_min + (1.0 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2.0


# -- shared conversions ----------------------------------------------------------


def plan(path, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """xt on the path and its target vector field ut."""
    te = expand_t(t, x1)
    alpha_t, d_alpha_t = path.alpha(te)
    sigma_t, d_sigma_t = path.sigma(te)
    xt = alpha_t * x1 + sigma_t * x0
    ut = d_alpha_t * x1 + d_sigma_t * x0
    return t, xt, ut


def score_from_velocity(path, velocity, x, t):
    te = expand_t(t, x)
    alpha_t, d_alpha_t = path.alpha(te)
    sigma_t, d_sigma_t = path.sigma(te)
    reverse_ratio = alpha_t / d_alpha_t
    var = sigma_t**2 - reverse_ratio * d_sigma_t * sigma_t
    return (reverse_ratio * velocity - x) / var


def noise_from_velocity(path, velocity, x, t):
    te = expand_t(t, x)
    alpha_t, d_alpha_t = path.alpha(te)
    sigma_t, d_sigma_t = path.sigma(te)
    reverse_ratio = alpha_t / d_alpha_t
    var = reverse_ratio * d_sigma_t - sigma_t
    return (reverse_ratio * velocity - x) / var


def velocity_from_score(path, score, x, t):
    drift_mean, var = path.drift(x, t)
    return var * score - drift_mean


def diffusion_coeff(path, x, t, form: str = "constant", norm: float = 1.0):
    """SDE diffusion term choices."""
    te = expand_t(t, x)
    if form == "constant":
        return torch.full_like(te, norm)
    if form == "SBDM":
        return norm * path.drift(x, t)[1]
    if form == "sigma":
        return norm * path.sigma(te)[0]
    if form == "linear":
        return norm * (1.0 - te)
    if form == "decreasing":
        return 0.25 * (norm * torch.cos(math.pi * te) + 1.0) ** 2
    if form == "increasing-decreasing":
        return norm * torch.sin(math.pi * te) ** 2
    raise NotImplementedError(f"diffusion form {form}")

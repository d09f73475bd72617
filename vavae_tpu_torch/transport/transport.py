"""Transport (port of ``vavae_tpu/transport/transport.py``): the path
definitions, the training-time ``sample_t`` and ``training_losses``, the
ODE drift and the score the samplers integrate, and the Gaussian prior's
log-density of the likelihood.

Randomness comes from an explicit ``torch.Generator``. ``training_losses``
draws ``t`` and then ``x0`` and hands both to ``losses_at``, the
deterministic part, so a test can feed it the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from vavae_tpu_torch.transport.paths import (
    GVPPath,
    LinearPath,
    VPPath,
    expand_t,
    plan,
    score_from_velocity,
)


class ModelType(enum.Enum):
    NOISE = "noise"
    SCORE = "score"
    VELOCITY = "velocity"


class PathType(enum.Enum):
    LINEAR = "Linear"
    GVP = "GVP"
    VP = "VP"


class WeightType(enum.Enum):
    NONE = "none"
    VELOCITY = "velocity"
    LIKELIHOOD = "likelihood"


def _ndtri(u: torch.Tensor) -> torch.Tensor:
    """Inverse standard-normal CDF (for truncated logit-normal sampling)."""
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)


def _uniform(shape, generator, device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


_PATHS = {
    PathType.LINEAR: LinearPath(),
    PathType.GVP: GVPPath(),
    PathType.VP: VPPath(),
}


@dataclasses.dataclass(frozen=True)
class Transport:
    model_type: ModelType = ModelType.VELOCITY
    path_type: PathType = PathType.LINEAR
    loss_type: WeightType = WeightType.NONE
    train_eps: float = 0.0
    sample_eps: float = 0.0
    use_cosine_loss: bool = False
    use_lognorm: bool = False
    partial_train: Optional[Tuple[float, float]] = None
    partial_ratio: float = 1.0
    shift_lg: bool = False

    @property
    def path(self):
        return _PATHS[self.path_type]

    def check_interval(
        self,
        *,
        eval: bool = False,
        sde: bool = False,
        reverse: bool = False,
        diffusion_form: str = "SBDM",
        last_step_size: float = 0.0,
    ) -> Tuple[float, float]:
        t0, t1 = 0.0, 1.0
        eps = self.sample_eps if eval else self.train_eps
        if self.path_type == PathType.VP:
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        elif self.model_type != ModelType.VELOCITY or sde:
            t0 = (
                eps
                if (diffusion_form == "SBDM" and sde) or self.model_type != ModelType.VELOCITY
                else 0.0
            )
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        if reverse:
            t0, t1 = 1.0 - t0, 1.0 - t1
        return t0, t1

    # -- t sampling (reference transport.py:113-166) ------------------------

    def sample_t(
        self,
        batch: int,
        generator: Optional[torch.Generator] = None,
        sp_timesteps: Optional[Tuple[float, float]] = None,
        shifted_mu: float = 0.0,
        device: str | torch.device | None = None,
    ) -> torch.Tensor:
        """(batch,) training times: uniform, ``partial_train`` (with its
        ``partial_ratio`` gate), logit-normal, shifted logit-normal, or the
        truncated logit-normal on ``partial_train`` by inverse CDF."""
        if device is None and generator is not None:
            device = generator.device
        t0, t1 = self.check_interval()
        if sp_timesteps is not None:
            lo, hi = sp_timesteps
            return _uniform((batch,), generator, device, lo, hi)

        if not self.use_lognorm:
            if self.partial_train is not None:
                # one uniform draw serves both branches, as in the JAX package
                u = _uniform((batch,), generator, device)
                lo, hi = self.partial_train
                gate = _uniform((), generator, device) < self.partial_ratio
                return torch.where(gate, u * (hi - lo) + lo, u * (t1 - t0) + t0)
            return _uniform((batch,), generator, device) * (t1 - t0) + t0

        if self.shift_lg and self.partial_train is not None:
            raise ValueError(
                "shift_lg is not compatible with partial_train — the "
                "reference asserts this combination is invalid"
            )
        mu = shifted_mu if self.shift_lg else 0.0
        normal = torch.randn((batch,), generator=generator, device=device, dtype=torch.float32)
        if self.partial_train is not None:
            lo, hi = self.partial_train

            def cdf(x: float) -> float:
                return float(torch.special.ndtr(torch.tensor(math.log(x / (1.0 - x)))))

            u = _uniform((batch,), generator, device, cdf(lo), cdf(hi))
            gate = _uniform((), generator, device) < self.partial_ratio
            partial_t = torch.sigmoid(_ndtri(u))
            return torch.where(gate, partial_t, torch.sigmoid(normal) * (t1 - t0) + t0)
        return torch.sigmoid(mu + normal) * (t1 - t0) + t0

    # -- training losses (reference transport.py:169-215) -------------------

    def training_losses(
        self,
        model_fn: Callable[..., torch.Tensor],
        x1: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        sp_timesteps: Optional[Tuple[float, float]] = None,
        shifted_mu: float = 0.0,
        **model_kwargs: Any,
    ) -> dict:
        """model_fn(xt, t, **model_kwargs) -> prediction. x1: NHWC data.
        Draws t, then x0, from ``generator``."""
        t = self.sample_t(x1.shape[0], generator, sp_timesteps, shifted_mu, device=x1.device)
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device,
                         dtype=torch.float32).to(x1.dtype)
        return self.losses_at(model_fn, t, x0, x1, **model_kwargs)

    def losses_at(self, model_fn: Callable[..., torch.Tensor], t: torch.Tensor,
                  x0: torch.Tensor, x1: torch.Tensor, **model_kwargs: Any) -> dict:
        """The deterministic part of ``training_losses`` at given t and x0:
        per-sample fp32 velocity MSE and, with ``use_cosine_loss``, the
        channel-wise cosine loss with smooth 1e-16 norms (the zero-initialised
        DiT outputs exactly 0, where a plain norm's gradient is NaN); the
        weighted noise/score losses otherwise."""
        t, xt, ut = plan(self.path, t, x0, x1)
        pred = model_fn(xt, t, **model_kwargs)
        terms: dict = {"pred": pred, "t": t}
        reduce_dims = tuple(range(1, x1.dim()))
        if self.model_type == ModelType.VELOCITY:
            p, u = pred.float(), ut.float()
            terms["loss"] = torch.square(p - u).mean(dim=reduce_dims)
            if self.use_cosine_loss:
                dot = (p * u).sum(dim=-1)
                pn = torch.sqrt((p * p).sum(dim=-1) + 1e-16)
                un = torch.sqrt((u * u).sum(dim=-1) + 1e-16)
                cos = dot / (pn * un)
                terms["cos_loss"] = (1.0 - cos).mean(dim=tuple(range(1, cos.dim())))
        else:
            _, drift_var = self.path.drift(xt, t)
            sigma_t, _ = self.path.sigma(expand_t(t, xt))
            if self.loss_type == WeightType.VELOCITY:
                weight = (drift_var / sigma_t) ** 2
            elif self.loss_type == WeightType.LIKELIHOOD:
                weight = drift_var / (sigma_t ** 2)
            else:
                weight = 1.0
            if self.model_type == ModelType.NOISE:
                terms["loss"] = (weight * torch.square(pred - x0)).mean(dim=reduce_dims)
            else:
                terms["loss"] = (weight * torch.square(pred * sigma_t + x0)).mean(dim=reduce_dims)
        return terms

    def drift_fn(self) -> Callable:
        """Probability-flow ODE drift as a function of the model output."""

        def velocity_ode(x, t, model_fn, **kw):
            return model_fn(x, t, **kw)

        def score_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = self.path.drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t, **kw)

        def noise_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = self.path.drift(x, t)
            sigma_t, _ = self.path.sigma(expand_t(t, x))
            score = model_fn(x, t, **kw) / -sigma_t
            return -drift_mean + drift_var * score

        return {
            ModelType.VELOCITY: velocity_ode,
            ModelType.SCORE: score_ode,
            ModelType.NOISE: noise_ode,
        }[self.model_type]

    def score_fn(self) -> Callable:
        """The score ∇log p_t(x) as a function of the model output."""

        def from_noise(x, t, model_fn, **kw):
            sigma_t, _ = self.path.sigma(expand_t(t, x))
            return model_fn(x, t, **kw) / -sigma_t

        def from_score(x, t, model_fn, **kw):
            return model_fn(x, t, **kw)

        def from_velocity(x, t, model_fn, **kw):
            return score_from_velocity(self.path, model_fn(x, t, **kw), x, t)

        return {
            ModelType.NOISE: from_noise,
            ModelType.SCORE: from_score,
            ModelType.VELOCITY: from_velocity,
        }[self.model_type]

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """(B,) log-density of z under the standard normal prior; the
        constant is taken in float32 as JAX takes it."""
        n = z[0].numel()
        const = np.float32(-n / 2.0) * np.log(np.float32(2 * np.pi))
        return float(const) - torch.sum(torch.square(z.reshape(z.shape[0], -1)), dim=-1) / 2.0


def create_transport(
    path_type: str = "Linear",
    prediction: str = "velocity",
    loss_weight: Optional[str] = None,
    train_eps: Optional[float] = None,
    sample_eps: Optional[float] = None,
    use_cosine_loss: bool = False,
    use_lognorm: bool = False,
    partial_train: Optional[Tuple[float, float]] = None,
    partial_ratio: float = 1.0,
    shift_lg: bool = False,
) -> Transport:
    """Factory with the reference's eps defaults."""
    model_type = {
        "noise": ModelType.NOISE,
        "score": ModelType.SCORE,
    }.get(prediction, ModelType.VELOCITY)
    loss_type = {
        "velocity": WeightType.VELOCITY,
        "likelihood": WeightType.LIKELIHOOD,
    }.get(loss_weight, WeightType.NONE)
    ptype = PathType(path_type)

    if ptype == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    elif model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:  # velocity on Linear/GVP: an explicitly passed eps is honoured
        train_eps = 0.0 if train_eps is None else train_eps
        sample_eps = 0.0 if sample_eps is None else sample_eps

    return Transport(
        model_type=model_type,
        path_type=ptype,
        loss_type=loss_type,
        train_eps=float(train_eps),
        sample_eps=float(sample_eps),
        use_cosine_loss=bool(use_cosine_loss),
        use_lognorm=bool(use_lognorm),
        partial_train=tuple(partial_train) if partial_train else None,
        partial_ratio=float(partial_ratio),
        shift_lg=bool(shift_lg),
    )


def build_transport(cfg) -> Transport:
    """The transport of a reference-format config's ``transport:`` block."""
    t = cfg.transport
    return create_transport(
        t.get("path_type", "Linear"),
        t.get("prediction", "velocity"),
        t.get("loss_weight"),
        t.get("train_eps"),
        t.get("sample_eps"),
        use_cosine_loss=t.get("use_cosine_loss", False),
        use_lognorm=t.get("use_lognorm", False),
        partial_train=t.get("partitial_train"),  # reference key spelling
        partial_ratio=t.get("partial_ratio", 1.0),
        shift_lg=t.get("shift_lg", False),
    )

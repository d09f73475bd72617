"""Transport: the sampling half of ``vavae_tpu/transport/transport.py``.

``sample_t`` and ``training_losses`` come with the training slice.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Tuple

from vavae_tpu_torch.transport.paths import GVPPath, LinearPath, VPPath, expand_t


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

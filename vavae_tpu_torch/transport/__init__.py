from vavae_tpu_torch.transport.sampler import Sampler
from vavae_tpu_torch.transport.transport import (
    ModelType,
    PathType,
    Transport,
    WeightType,
    create_transport,
)

__all__ = [
    "ModelType",
    "PathType",
    "Transport",
    "WeightType",
    "create_transport",
    "Sampler",
]

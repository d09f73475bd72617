from vavae_tpu_torch.transport.sampler import Sampler
from vavae_tpu_torch.transport.transport import (
    ModelType,
    PathType,
    Transport,
    WeightType,
    build_transport,
    create_transport,
)

__all__ = [
    "ModelType",
    "PathType",
    "Transport",
    "WeightType",
    "build_transport",
    "create_transport",
    "Sampler",
]

"""M4Depth model (PyTorch)."""

from m4depth_tpu_torch.models.decoder import (
    DecoderLevel,
    DispRefiner,
    LevelEstimate,
    LevelState,
    prep_features,
)
from m4depth_tpu_torch.models.encoder import DomainNorm, Encoder, leaky_relu
from m4depth_tpu_torch.models.m4depth import (
    M4Depth,
    ModelState,
    init_state,
    level_shape,
)

__all__ = [
    "DecoderLevel", "DispRefiner", "DomainNorm", "Encoder", "LevelEstimate",
    "LevelState", "M4Depth", "ModelState", "init_state", "leaky_relu",
    "level_shape", "prep_features",
]

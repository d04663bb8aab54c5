"""M4Depth model (PyTorch)."""

from m4depth_tpu_torch.models.decoder import (
    DecoderLevel,
    DispRefiner,
    LevelEstimate,
    LevelState,
)
from m4depth_tpu_torch.models.encoder import DomainNorm, Encoder, leaky_relu
from m4depth_tpu_torch.models.m4depth import (
    M4Depth,
    ModelState,
    init_state,
    level_shape,
)
from m4depth_tpu_torch.models.m4depth_v1 import (
    DecoderLevelV1,
    EncoderV1,
    M4DepthV1,
    m4depth_v1_loss,
)
from m4depth_tpu_torch.ops.glue import prep_features
from m4depth_tpu_torch.ops.glue_v1 import inverse_leaky_relu

__all__ = [
    "DecoderLevel", "DecoderLevelV1", "DispRefiner", "DomainNorm", "Encoder",
    "EncoderV1", "LevelEstimate", "LevelState", "M4Depth", "M4DepthV1",
    "ModelState", "init_state", "inverse_leaky_relu", "leaky_relu",
    "level_shape", "m4depth_v1_loss", "prep_features",
]

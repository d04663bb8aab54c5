"""Model and optimisation configuration of the PyTorch port.

The model fields of ``m4depth_tpu.config.ModelConfig``, the whole of
``AblationFlags`` and the optimisation fields of ``TrainConfig``, copied so
that this package imports nothing of the JAX one. The JAX package's TPU
layout knobs (``dscv_*``, ``sncv_impl``,
``scan_unroll``, ``remat*``, ``time_axis``) have no counterpart: which
implementation of a cost volume runs is decided by the device its inputs
lie on.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DEPTH_TYPES = ("map", "velodyne")


@dataclasses.dataclass(frozen=True)
class AblationFlags:
    """Architecture ablation switches; all default to enabled."""

    dinl: bool = True                 # domain-invariant normalization at encoder level 0
    sncv: bool = True                 # spatial-neighborhood (auto-correlation) cost volume
    time_recurr: bool = True          # warped previous-parallax recurrence channel
    normalize_features: bool = True   # L2-normalize feature sub-vectors before correlation
    subdivide_features: bool = True   # split feature vectors into 2**(lvl//2) cuts
    level_memory: bool = True         # 4-channel "other" inter-level memory


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (defaults: the d6 model)."""

    num_levels: int = 6
    encoder_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 192)
    refiner_prep_channels: Tuple[int, ...] = (128, 128, 96)
    refiner_est_channels: Tuple[int, ...] = (64, 32, 16, 5)
    search_range: int = 4             # DSCV: 2*4+1 = 9 parallax hypotheses
    sncv_search_range: int = 3        # SNCV: 7x7 = 49 spatial offsets
    leaky_slope: float = 0.1
    depth_type: str = "map"           # "map" (dense gt) or "velodyne" (sparse gt)
    ablation: AblationFlags = dataclasses.field(default_factory=AblationFlags)
    compute_dtype: str = "float32"    # conv dtype: "float32" | "bfloat16"
    cv_dtype: str = "bfloat16"        # dtype the cost-volume inputs are rounded to

    def __post_init__(self):
        for name in ("compute_dtype", "cv_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError(f"{name} must be one of {sorted(DTYPES)}, "
                                 f"got {getattr(self, name)!r}")
        if self.depth_type not in DEPTH_TYPES:
            raise ValueError(f"depth_type must be one of {DEPTH_TYPES}, "
                             f"got {self.depth_type!r}")

    @property
    def channels(self) -> Tuple[int, ...]:
        return self.encoder_channels[: self.num_levels]

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def torch_cv_dtype(self) -> torch.dtype:
        return DTYPES[self.cv_dtype]

    def num_cuts(self, level: int) -> int:
        """Number of feature sub-vectors at 1-indexed pyramid ``level``."""
        return 2 ** (level // 2) if self.ablation.subdivide_features else 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings (the reference's Adam at 1e-4 for 220k
    steps)."""

    learning_rate: float = 1e-4
    lr_schedule: str = "constant"     # "constant" | "staircase" (halve at
                                      # 60k/120k/180k/240k/300k) | "cosine"
    grad_clip_norm: float = 0.0       # global-norm gradient clip; 0 = off
    total_steps: int = 220_000

"""M4Depth-V1, the original (arXiv 2021) architecture, as a second model
family. Counterpart of ``m4depth_tpu/models/m4depth_v1.py``; it differs from
the Sensors-2022 model (``models/m4depth.py``) as the JAX module says:

  * the encoder's convs are stride-2 first, then stride-1, with no domain
    normalisation;
  * the decoder is depth-recurrent: the previous frame's same-level depth is
    carried through ``recompute_depth``, and the previous features and that
    depth are warped into the current frame by a reprojection of the deeper
    level's (detached) estimate;
  * one cost volume, the SNCV as a (2r+1)^2 cross-correlation (one cut) of
    the current features with the warped previous ones, r =
    ``cfg.search_range``;
  * a 7-conv refiner (128, 128, 96, 64, 32, 16, 1), every conv leaky, whose
    last activation is inverted, clipped to [-7, 7] and mapped to depth
    ``exp(x) * 10``;
  * ``single_frame=True`` is the legacy "special case 1": no temporal
    recurrence, the current features correlate with their own warp.

The model contract (``forward``, ``forward_frame``, ``step``, ``loss``,
``final_depth``, the ``LevelState`` memory that ``init_state`` makes) is
M4Depth's, so the train step, the evaluator, ``fit`` and the CLI run either
family. A pyramid holds one depth map per level, finest first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import (
    Camera,
    resize_bilinear_v1,
    resize_nearest,
)
from m4depth_tpu_torch.models.decoder import LevelState
from m4depth_tpu_torch.models.encoder import Conv3x3
from m4depth_tpu_torch.models.m4depth import Device, ModelState
from m4depth_tpu_torch.ops import spatial_cost_volume_fused
from m4depth_tpu_torch.ops.glue_v1 import (
    glue_v1_assemble_fused,
    glue_v1_finish_fused,
    glue_v1_prep_fused,
)
from m4depth_tpu_torch.utils import tracing

V1_REFINER_CHANNELS = (128, 128, 96, 64, 32, 16, 1)
V1Pyramid = List[torch.Tensor]  # depth [b, h_l, w_l, 1], finest level first


class EncoderV1(nn.Module):
    """Stride-2-first feature pyramid: per level a stride-2 then a stride-1
    3x3 conv, each followed by a leaky relu."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        slope = cfg.leaky_slope
        ins = (3,) + tuple(cfg.channels[:-1])
        self.conv_s2 = nn.ModuleList(
            Conv3x3(cin, ch, stride=2, slope=slope)
            for cin, ch in zip(ins, cfg.channels))
        self.conv_s1 = nn.ModuleList(Conv3x3(ch, ch, slope=slope)
                                     for ch in cfg.channels)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.to(self.cfg.torch_compute_dtype)
        outputs = []
        for conv_s2, conv_s1 in zip(self.conv_s2, self.conv_s1):
            x = conv_s1(conv_s2(x))
            outputs.append(x)
        return outputs


class DecoderLevelV1(nn.Module):
    """Depth-recurrent decoder level (1-indexed ``level``; 1 = finest) for
    ``channels`` features and rotations of ``rot_dim`` values (3: small
    angle, 4: quaternion), which the refiner reads as input maps."""

    def __init__(self, cfg: ModelConfig, channels: int, rot_dim: int,
                 level: int = 1):
        super().__init__()
        self.cfg = cfg
        self.level = level
        side = 2 * cfg.search_range + 1
        # features, cost volume, two log depths, rotation, translation and
        # the pixel coordinates
        cin = channels + side * side + 2 + rot_dim + 3 + 2
        # each conv followed by a leaky relu, the last one's inverted by the
        # glue after the refiner
        self.convs = nn.ModuleList(
            Conv3x3(i, o, slope=cfg.leaky_slope)
            for i, o in zip((cin,) + V1_REFINER_CHANNELS[:-1],
                            V1_REFINER_CHANNELS))

    def forward(
        self,
        curr_f: torch.Tensor,
        state: Optional[LevelState],
        deeper_depth: Optional[torch.Tensor],
        rot: torch.Tensor,
        trans: torch.Tensor,
        camera: Camera,
        new_traj: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (depth, depth): the estimate and the next temporal
        memory. ``state`` is the last frame's memory of this level, or None
        (no temporal memory); ``camera`` is at full resolution.

        The glue around the SNCV and the refiner (``ops/glue_v1.py``)
        runs through its fused wrappers, which choose between the kernels
        of ``ops/csrc/glue_v1.cu`` and the plain PyTorch versions."""
        cfg = self.cfg
        scale = 2.0 ** self.level
        f0_w, log_d0w, log_dprev = glue_v1_prep_fused(
            curr_f, state, deeper_depth, new_traj, rot, trans, camera, scale)
        cv = spatial_cost_volume_fused(curr_f, f0_w, cfg.search_range, 1,
                                       cfg.torch_cv_dtype, cfg.leaky_slope)
        x = glue_v1_assemble_fused(curr_f, cv, log_d0w, log_dprev, rot,
                                   trans, camera, scale)
        tracing.mark(f"refiner{self.level}", x.device)
        for conv in self.convs:
            x = conv(x)
        tracing.mark(f"glue{self.level}", x.device)
        depth = glue_v1_finish_fused(x, cfg.leaky_slope)
        return depth, depth


class M4DepthV1(nn.Module):
    """The legacy model family with M4Depth's interface.

    ``rot_dim`` is the length of the rotations it is fed (4, the data
    path's quaternions, or 3, small angles): the refiner reads them as
    input channels. Weights come from a seeded ``torch.Generator`` on the
    CPU, or from ``interop.load_jax_params``; the model lives on ``cuda``
    unless ``device`` says otherwise.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device: Device = None,
                 seed: int = 0, single_frame: bool = False, rot_dim: int = 4):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.single_frame = single_frame
        self.encoder = EncoderV1(cfg)
        self.levels = nn.ModuleList(
            DecoderLevelV1(cfg, c, rot_dim, i + 1)
            for i, c in enumerate(cfg.channels))
        generator = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv3x3):
                m.reset_parameters(generator)
        self.to(dev)

    def forward_frame(
        self,
        state: Optional[ModelState],
        rgb: torch.Tensor,
        rot: torch.Tensor,
        trans: torch.Tensor,
        camera: Camera,
        new_traj: Optional[torch.Tensor],
        first: bool = False,
    ) -> Tuple[ModelState, V1Pyramid]:
        """One frame through the encoder and the levels, deepest first.
        ``first=True`` (or ``single_frame``) runs without temporal memory
        and does not read ``state``. The stages are marked as
        ``M4Depth.forward_frame`` marks them."""
        num_levels = self.cfg.num_levels
        tracing.mark("encoder", rgb.device)
        f_pyr = self.encoder(rgb)
        tracing.mark("glue", rgb.device)
        new_states: List[Optional[LevelState]] = [None] * num_levels
        ests: List[Optional[torch.Tensor]] = [None] * num_levels
        deeper = None
        for idx in reversed(range(num_levels)):
            memory = None if self.single_frame or first else state[idx]
            deeper, mem = self.levels[idx](f_pyr[idx], memory, deeper, rot,
                                           trans, camera, new_traj)
            ests[idx] = deeper
            new_states[idx] = LevelState(f_maps=f_pyr[idx], depth=mem)
        return tuple(new_states), ests

    def forward(self, rgb_seq: torch.Tensor, rot_seq: torch.Tensor,
                trans_seq: torch.Tensor, camera: Camera) -> List[V1Pyramid]:
        """A [b, T, ...] window whose frame 0 runs without temporal memory:
        one pyramid per frame, finest level first."""
        state: Optional[ModelState] = None
        outs: List[V1Pyramid] = []
        for t in range(rgb_seq.shape[1]):
            state, pyr = self.forward_frame(
                state, rgb_seq[:, t], rot_seq[:, t], trans_seq[:, t], camera,
                new_traj=None, first=(t == 0))
            outs.append(pyr)
        return outs

    @torch.no_grad()
    def step(self, state: ModelState, rgb: torch.Tensor, rot: torch.Tensor,
             trans: torch.Tensor, camera: Camera, new_traj: torch.Tensor
             ) -> Tuple[ModelState, torch.Tensor]:
        """Streaming inference with caller-owned state (``init_state``):
        one frame in, full-resolution depth [b, h, w, 1] out."""
        state, pyr = self.forward_frame(state, rgb, rot, trans, camera,
                                        new_traj)
        tracing.mark("output", rgb.device)
        return state, self.final_depth([pyr], rgb.shape[1:3])

    def loss(self, gt_depth_seq: torch.Tensor, preds: Sequence[V1Pyramid],
             group=None) -> torch.Tensor:
        """The legacy loss (``m4depth_v1_loss``). It is a plain mean, so
        under data parallelism (``group``) the mean of equal local batches'
        losses is already the global batch's."""
        del group
        return m4depth_v1_loss(gt_depth_seq, preds, self.single_frame)

    @staticmethod
    def final_depth(preds: Sequence[V1Pyramid], hw) -> torch.Tensor:
        return resize_nearest(preds[-1][0], hw)


def m4depth_v1_loss(gt_depth_seq: torch.Tensor, preds: Sequence[V1Pyramid],
                    single_frame: bool = False) -> torch.Tensor:
    """The legacy pyramid log-L1: depths clipped to [0.1, 200], level j
    (finest first) weighted by 0.64 / 2**(j-1), averaged over the scored
    frames: 1..T-1, or, single-frame, 0..T-2 (the last frame's prediction
    is never scored, as in the legacy loop)."""
    T = gt_depth_seq.shape[1]
    frames = range(max(T - 1, 1)) if single_frame else range(1, T)
    total = torch.zeros((), dtype=torch.float32, device=gt_depth_seq.device)
    for t in frames:
        gt_log = torch.log(torch.clamp(gt_depth_seq[:, t].float(), 0.1, 200.0))
        for j, depth in enumerate(preds[t]):
            gt_r = resize_bilinear_v1(gt_log, depth.shape[1:3])
            d = torch.log(torch.clamp(depth, 0.1, 200.0))
            total = total + (0.64 / 2.0 ** (j - 1)) * torch.mean(
                torch.abs(d - gt_r))
    return total / max(float(len(frames)), 1.0)

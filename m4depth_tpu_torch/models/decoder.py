"""Decoder pyramid level: parallax refinement with temporal memory.
Counterpart of ``m4depth_tpu/models/decoder.py``.

The temporal memory is an explicit ``LevelState`` passed in and out. A
trajectory reset is either a per-batch-element mask (streaming) or, on the
first frame of a training window, a statically different computation that
runs no cost volume.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import (
    Camera,
    parallax_to_depth,
    prev_depth_to_parallax,
    resize_bilinear_v1,
)
from m4depth_tpu_torch.models.encoder import Conv3x3, leaky_relu
from m4depth_tpu_torch.ops import (
    parallax_sweeping_cv_fused,
    spatial_cost_volume_fused,
)

INIT_DEPTH = 1000.0


class LevelState(NamedTuple):
    """Per-level temporal memory carried between frames.

    f_maps: [b, h_l, w_l, C_l] raw encoder features of the previous frame.
    depth:  [b, h_l, w_l, 1]   this level's previous depth estimate.
    """

    f_maps: torch.Tensor
    depth: torch.Tensor


class LevelEstimate(NamedTuple):
    """Per-level per-frame outputs (all float32)."""

    depth: torch.Tensor     # [b, h_l, w_l, 1]
    parallax: torch.Tensor  # [b, h_l, w_l, 1]
    other: torch.Tensor     # [b, h_l, w_l, 4] inter-level memory


def prep_features(f: torch.Tensor, num_cuts: int,
                  normalize: bool) -> torch.Tensor:
    """Per-cut L2 normalization of feature sub-vectors (float32 math)."""
    if not normalize:
        return f.contiguous()
    b, h, w, c = f.shape
    blocks = f.reshape(b, h, w, num_cuts, c // num_cuts).float()
    sq = torch.sum(blocks * blocks, dim=-1, keepdim=True)
    blocks = blocks * torch.rsqrt(torch.clamp(sq, min=1e-12))
    return blocks.reshape(b, h, w, c).to(f.dtype)


class DispRefiner(nn.Module):
    """Parallax refinement subnetwork: 3 prep convs + 4 estimation convs."""

    def __init__(self, cfg: ModelConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        prep_in = (in_channels,) + tuple(cfg.refiner_prep_channels[:-1])
        self.prep = nn.ModuleList(
            Conv3x3(cin, ch)
            for cin, ch in zip(prep_in, cfg.refiner_prep_channels))
        est_in = ((cfg.refiner_prep_channels[-1],)
                  + tuple(cfg.refiner_est_channels[:-1]))
        self.est = nn.ModuleList(
            Conv3x3(cin, ch)
            for cin, ch in zip(est_in, cfg.refiner_est_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slope = self.cfg.leaky_slope
        x = x.to(self.cfg.torch_compute_dtype)
        for conv in self.prep:
            x = leaky_relu(conv(x), slope)
        for i, conv in enumerate(self.est):
            x = conv(x)
            if i < len(self.est) - 1:
                x = leaky_relu(x, slope)
        return x


class DecoderLevel(nn.Module):
    """One decoder level (1-indexed ``level``; 1 = finest)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.cfg = cfg
        self.level = level
        self.refiner = DispRefiner(cfg, self.refiner_in_channels())

    @property
    def lvl_mul(self) -> float:
        # parallax scale: para = exp(clip(x, -7, 7)) / 2**(level-3)
        return 2.0 ** (self.level - 3)

    @property
    def other_channels(self) -> int:
        return self.cfg.refiner_est_channels[-1] - 1

    def refiner_in_channels(self) -> int:
        """Width of the concatenated refiner input (see ``forward``)."""
        cfg, abl = self.cfg, self.cfg.ablation
        cuts = cfg.num_cuts(self.level)
        n = cuts * (2 * cfg.search_range + 1) + 1
        if abl.level_memory:
            n += self.other_channels
        if abl.sncv:
            n += (2 * cfg.sncv_search_range + 1) ** 2 * cuts
        if abl.time_recurr:
            n += 1
        return n

    def initial_deeper_estimate(self, like: torch.Tensor) -> LevelEstimate:
        """Deepest-level stand-in for the absent deeper estimate: parallax
        1, depth 1000, other 0."""
        b, h, w, _ = like.shape
        kw = dict(dtype=torch.float32, device=like.device)
        return LevelEstimate(
            depth=torch.full((b, h, w, 1), INIT_DEPTH, **kw),
            parallax=torch.ones((b, h, w, 1), **kw),
            other=torch.zeros((b, h, w, self.other_channels), **kw))

    @staticmethod
    def upsample_deeper(deeper: LevelEstimate, h: int, w: int
                        ) -> LevelEstimate:
        """The deeper estimate at this level's size (TFv1 bilinear grid,
        parallax doubled)."""
        return LevelEstimate(
            depth=resize_bilinear_v1(deeper.depth, (h, w)),
            parallax=resize_bilinear_v1(deeper.parallax, (h, w)) * 2.0,
            other=resize_bilinear_v1(deeper.other, (h, w)))

    def forward(
        self,
        curr_f: torch.Tensor,
        deeper_est: Optional[LevelEstimate],
        state: Optional[LevelState],
        rot: torch.Tensor,
        trans: torch.Tensor,
        camera: Camera,
        new_traj: Optional[torch.Tensor],
    ) -> Tuple[LevelEstimate, LevelState]:
        """Run one level for one frame.

        Args:
          curr_f: [b,h,w,C] this level's encoder features (raw).
          deeper_est: the next-deeper level's estimate this frame, or None at
            the deepest level.
          state: the previous frame's memory, or None when this frame starts
            every sequence of the batch (a training window's frame 0): the
            level then returns the reset estimate and runs no cost volume.
          new_traj: [b] bool, per-element trajectory reset, or None when no
            element resets (training windows).
        """
        cfg, abl = self.cfg, self.cfg.ablation
        b, h, w, _ = curr_f.shape
        cuts = cfg.num_cuts(self.level)
        cdt = cfg.torch_compute_dtype

        prev_l = (self.initial_deeper_estimate(curr_f) if deeper_est is None
                  else self.upsample_deeper(deeper_est, h, w))
        if state is None:
            return prev_l, LevelState(
                f_maps=curr_f,
                depth=torch.full((b, h, w, 1), INIT_DEPTH,
                                 dtype=torch.float32, device=curr_f.device))

        curr_p = prep_features(curr_f, cuts, abl.normalize_features)
        prev_p = prep_features(state.f_maps, cuts, abl.normalize_features)
        para_prev_t = prev_depth_to_parallax(state.depth, rot, trans, camera)
        cv, para_reproj = parallax_sweeping_cv_fused(
            curr_p, prev_p, para_prev_t, prev_l.parallax, rot, trans, camera,
            cfg.search_range, cuts, cfg.torch_cv_dtype)

        def log_safe(x):
            return torch.log(torch.clamp(x, min=1e-12))

        # concatenation order is the reference's: cv (cut-major), log
        # parallax, other, SNCV (offset-major), log warped parallax
        inputs = [cv, log_safe(prev_l.parallax * self.lvl_mul)]
        if abl.level_memory:
            inputs.append(prev_l.other)
        if abl.sncv:
            inputs.append(spatial_cost_volume_fused(
                curr_p, curr_p, cfg.sncv_search_range, cuts,
                cfg.torch_cv_dtype, cfg.leaky_slope))
        if abl.time_recurr:
            inputs.append(log_safe(para_reproj * self.lvl_mul))
        f_input = torch.cat([x.to(cdt) for x in inputs], dim=-1)

        out = self.refiner(f_input).float()
        parallax = torch.exp(torch.clamp(out[..., :1], -7.0, 7.0)) / self.lvl_mul
        depth = parallax_to_depth(parallax, rot, trans, camera)

        # the feature memory is not detached: the gradient of the next
        # frame's c2 reaches this frame's encoder (the depth memory is
        # detached by prev_depth_to_parallax)
        est = LevelEstimate(depth=depth, parallax=parallax,
                            other=out[..., 1:])
        if new_traj is None:
            return est, LevelState(f_maps=curr_f, depth=depth)
        mask = new_traj.reshape(b, 1, 1, 1)
        est = LevelEstimate(
            depth=torch.where(mask, prev_l.depth, depth),
            parallax=torch.where(mask, prev_l.parallax, parallax),
            other=torch.where(mask, prev_l.other, est.other))
        # on a reset the feature memory is curr_f either way; only the depth
        # memory is masked
        new_state = LevelState(
            f_maps=curr_f,
            depth=torch.where(mask, torch.full_like(depth, INIT_DEPTH), depth))
        return est, new_state

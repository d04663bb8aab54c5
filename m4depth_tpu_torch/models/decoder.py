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
from torch.utils.checkpoint import checkpoint

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models.encoder import Conv3x3
from m4depth_tpu_torch.ops import (
    parallax_sweeping_cv_fused,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops.glue import (
    glue_assemble_fused,
    glue_finish_fused,
    glue_prep_fused,
)
from m4depth_tpu_torch.utils import tracing

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


class DispRefiner(nn.Module):
    """Parallax refinement subnetwork: 3 prep convs + 4 estimation convs,
    each followed by a leaky relu but the last."""

    def __init__(self, cfg: ModelConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        slope = cfg.leaky_slope
        prep_in = (in_channels,) + tuple(cfg.refiner_prep_channels[:-1])
        self.prep = nn.ModuleList(
            Conv3x3(cin, ch, slope=slope)
            for cin, ch in zip(prep_in, cfg.refiner_prep_channels))
        est_in = ((cfg.refiner_prep_channels[-1],)
                  + tuple(cfg.refiner_est_channels[:-1]))
        n_est = len(cfg.refiner_est_channels)
        self.est = nn.ModuleList(
            Conv3x3(cin, ch, slope=slope if i < n_est - 1 else None)
            for i, (cin, ch) in enumerate(zip(est_in,
                                              cfg.refiner_est_channels)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cfg.torch_compute_dtype)
        for conv in (*self.prep, *self.est):
            x = conv(x)
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
          camera: the full-resolution intrinsics (the level scales them by
            ``2**level``).
          new_traj: [b] bool, per-element trajectory reset, or None when no
            element resets (training windows).

        The glue around the cost volumes and the refiner (``ops/glue.py``)
        runs through its fused wrappers, which choose between the kernels
        of ``ops/csrc/glue.cu`` (under grad through their autograd
        Functions) and the plain PyTorch versions.
        """
        cfg, abl = self.cfg, self.cfg.ablation
        cuts = cfg.num_cuts(self.level)

        # at the deepest level the deeper estimate's stand-in is (1000, 1, 0)
        prev, cam_l, curr_p, prev_p, para_prev_t = glue_prep_fused(
            curr_f, deeper_est, state, trans, camera, 2.0 ** self.level, cuts,
            abl.normalize_features, self.other_channels, INIT_DEPTH,
            cfg.torch_cv_dtype)
        prev_l = LevelEstimate(*prev)
        if state is None:
            b, h, w, _ = curr_f.shape
            return prev_l, LevelState(
                f_maps=curr_f,
                depth=torch.full((b, h, w, 1), INIT_DEPTH,
                                 dtype=torch.float32, device=curr_f.device))

        dscv_args = (curr_p, prev_p, para_prev_t, prev_l.parallax, rot, trans,
                     cam_l, cfg.search_range, cuts, cfg.torch_cv_dtype)
        if cfg.remat and cfg.remat_policy == "dscv" and torch.is_grad_enabled():
            # the counterpart of the JAX package's jax.checkpoint of the DSCV
            # call: the backward runs the DSCV forward again (no random
            # numbers: no RNG state to restore)
            cv, para_reproj = checkpoint(parallax_sweeping_cv_fused,
                                         *dscv_args, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            cv, para_reproj = parallax_sweeping_cv_fused(*dscv_args)
        sncv = (spatial_cost_volume_fused(curr_p, curr_p,
                                          cfg.sncv_search_range, cuts,
                                          cfg.torch_cv_dtype, cfg.leaky_slope)
                if abl.sncv else None)
        f_input = glue_assemble_fused(
            cv, prev_l.parallax, prev_l.other if abl.level_memory else None,
            sncv, para_reproj if abl.time_recurr else None, self.lvl_mul,
            cfg.torch_compute_dtype)

        tracing.mark(f"refiner{self.level}", f_input.device)
        out = self.refiner(f_input)
        tracing.mark(f"glue{self.level}", f_input.device)
        # the feature memory is not detached: the gradient of the next
        # frame's c2 reaches this frame's encoder (the depth memory is
        # detached by prev_depth_to_parallax); on a reset the estimate is
        # the deeper one's and the depth memory starts again from 1000
        est, depth = glue_finish_fused(out, prev_l, new_traj, rot, trans,
                                       cam_l, self.lvl_mul, INIT_DEPTH)
        return LevelEstimate(*est), LevelState(f_maps=curr_f, depth=depth)

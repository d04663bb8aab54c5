"""M4Depth top level: recurrent encoder/decoder pyramid, training windows and
streaming inference. Counterpart of ``m4depth_tpu/models/m4depth.py``
(``level_shape``, ``init_state``, ``forward_frame``, ``__call__`` as
``forward``, ``loss``, ``step``, ``final_depth``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera, resize_nearest
from m4depth_tpu_torch.losses import m4depth_loss
from m4depth_tpu_torch.models.decoder import (
    INIT_DEPTH,
    DecoderLevel,
    LevelEstimate,
    LevelState,
)
from m4depth_tpu_torch.models.encoder import Conv3x3, Encoder
from m4depth_tpu_torch.utils import tracing

ModelState = Tuple[LevelState, ...]
Pyramid = List[LevelEstimate]  # finest level first
Device = Optional[Union[str, torch.device]]


def level_shape(h: int, w: int, idx: int) -> Tuple[int, int]:
    """Spatial shape of encoder output ``idx`` (stride 2**(idx+1), SAME)."""
    for _ in range(idx + 1):
        h = -(-h // 2)
        w = -(-w // 2)
    return h, w


def init_state(cfg: ModelConfig, batch: int, h: int, w: int,
               device: Device = None) -> ModelState:
    """Zero features in the compute dtype and depth 1000 at every level,
    overwritten by the first ``new_traj`` frame. Runs on ``cuda`` unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    states = []
    for idx in range(cfg.num_levels):
        hl, wl = level_shape(h, w, idx)
        states.append(LevelState(
            f_maps=torch.zeros((batch, hl, wl, cfg.channels[idx]),
                               dtype=cfg.torch_compute_dtype, device=dev),
            depth=torch.full((batch, hl, wl, 1), INIT_DEPTH,
                             dtype=torch.float32, device=dev)))
    return tuple(states)


class M4Depth(nn.Module):
    """Metric depth from a monocular video stream and known 6-DoF motion.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` (on
    the CPU, so a seed gives the same weights on every device), or loaded
    with ``m4depth_tpu_torch.interop.load_jax_params``. The model lives on
    ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device: Device = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.levels = nn.ModuleList(
            DecoderLevel(cfg, i + 1) for i in range(cfg.num_levels))
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
    ) -> Tuple[ModelState, Pyramid]:
        """One frame through the encoder and the decoder pyramid (deepest
        to finest). ``new_traj`` [b] resets elements of the batch (None:
        none resets); ``first=True`` marks the frame as the start of every
        sequence of the batch, and ``state`` is then not read. The stages
        ``encoder`` and ``glue`` are marked here, each level's refiner in
        ``DecoderLevel`` (``utils.tracing``)."""
        num_levels = self.cfg.num_levels
        tracing.mark("encoder", rgb.device)
        f_pyr = self.encoder(rgb)
        tracing.mark("glue", rgb.device)
        new_states: List[Optional[LevelState]] = [None] * num_levels
        ests: List[Optional[LevelEstimate]] = [None] * num_levels
        deeper: Optional[LevelEstimate] = None
        # remat_policy "all", the counterpart of the JAX package's
        # nn.remat(DecoderLevel): each level's body runs again in the
        # backward, and only its inputs are stored
        remat = (self.cfg.remat and self.cfg.remat_policy == "all"
                 and torch.is_grad_enabled())
        for idx in reversed(range(num_levels)):
            args = (f_pyr[idx], deeper, None if first else state[idx], rot,
                    trans, camera, new_traj)
            if remat:
                # the model draws no random numbers: nothing to restore
                # (and a CUDA graph's capture refuses the RNG's state)
                deeper, new_states[idx] = checkpoint(
                    self.levels[idx], *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                deeper, new_states[idx] = self.levels[idx](*args)
            ests[idx] = deeper
        return tuple(new_states), ests

    def forward(
        self,
        rgb_seq: torch.Tensor,     # [b, T, h, w, 3]
        rot_seq: torch.Tensor,     # [b, T, 3|4]
        trans_seq: torch.Tensor,   # [b, T, 3]
        camera: Camera,
    ) -> List[Pyramid]:
        """A training or evaluation window whose frame 0 starts every
        sequence: one pyramid per frame, finest level first."""
        state: Optional[ModelState] = None
        outs: List[Pyramid] = []
        for t in range(rgb_seq.shape[1]):
            state, pyr = self.forward_frame(
                state, rgb_seq[:, t], rot_seq[:, t], trans_seq[:, t], camera,
                new_traj=None, first=(t == 0))
            outs.append(pyr)
        return outs

    def loss(self, gt_depth_seq: torch.Tensor, preds: Sequence[Pyramid],
             group=None) -> torch.Tensor:
        """The training loss of a window (``losses.m4depth_loss``);
        ``group``, under data parallelism, makes the velodyne loss the
        global batch's."""
        return m4depth_loss(gt_depth_seq, preds, self.cfg.depth_type, group)

    @staticmethod
    def final_depth(preds: Sequence[Pyramid], hw) -> torch.Tensor:
        """Full-resolution depth of the last frame of ``preds`` (nearest
        upsampling of its finest level)."""
        return resize_nearest(preds[-1][0].depth, hw)

    @torch.no_grad()
    def step(
        self,
        state: ModelState,
        rgb: torch.Tensor,        # [b, h, w, 3]
        rot: torch.Tensor,        # [b, 3|4]
        trans: torch.Tensor,      # [b, 3]
        camera: Camera,
        new_traj: torch.Tensor,   # [b] bool
    ) -> Tuple[ModelState, torch.Tensor]:
        """Streaming inference: one frame in, full-resolution depth
        [b, h, w, 1] out. The caller owns the state (``init_state``) and
        passes ``new_traj=True`` on each trajectory's first frame."""
        state, pyr = self.forward_frame(state, rgb, rot, trans, camera,
                                        new_traj)
        tracing.mark("output", rgb.device)
        return state, self.final_depth([pyr], rgb.shape[1:3])

"""Train and eval steps. Counterpart of ``m4depth_tpu/train/step.py``.

One optimisation step over a ``[b, T, ...]`` window: the window forward,
the loss, autograd (through the cost-volume kernels' backward on the card),
an optional global-norm clip and Adam, as ``optax.chain(clip, adam)`` does
it. Every scalar a step returns is a 0-d tensor: nothing waits for the
device inside a step.

Training batch (a dict of tensors on the model's device):
  rgb      [b, T, h, w, 3] float32 in [0, 1]
  depth    [b, T, h, w, 1] float32 (0 = hole for velodyne gt)
  rot      [b, T, 4] (w, x, y, z) frame-to-frame quaternion, or [b, T, 3]
  trans    [b, T, 3] frame-to-frame translation (camera axes)
  camera_f [b, 2], camera_c [b, 2] intrinsics
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from m4depth_tpu_torch.config import TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.metrics import (
    MetricAccumulator,
    clip_for_eval,
    compute_metrics,
)
from m4depth_tpu_torch.models.m4depth import M4Depth, ModelState

Batch = Dict[str, torch.Tensor]

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def batch_camera(batch: Batch) -> Camera:
    return Camera(f=batch["camera_f"], c=batch["camera_c"])


def make_lr_schedule(learning_rate: float, schedule: str = "constant",
                     total_steps: int = 0) -> Callable[[int], float]:
    """The learning rate of the update that follows ``count`` updates, as
    the JAX package's optax schedules give it: "constant"; "staircase",
    halved once the count reaches each of 60k, 120k, 180k, 240k and 300k;
    "cosine", a linear warm-up from 0 over 200 steps, then a cosine decay
    to 5% at ``max(total_steps, 1000)`` steps."""
    if schedule == "constant":
        return lambda count: learning_rate
    if schedule == "staircase":
        boundaries = (60_000, 120_000, 180_000, 240_000, 300_000)
        return lambda count: learning_rate * 0.5 ** sum(
            count >= b for b in boundaries)
    if schedule == "cosine":
        warmup = 200
        decay = max(total_steps, 1000) - warmup
        alpha = 0.05

        def cosine(count: int) -> float:
            if count < warmup:
                return learning_rate * count / warmup
            t = min(count - warmup, decay)
            cos = 0.5 * (1 + math.cos(math.pi * t / decay))
            return learning_rate * ((1 - alpha) * cos + alpha)

        return cosine
    raise ValueError(f"unknown lr_schedule: {schedule!r}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([t.float() for t in tensors])))


@dataclasses.dataclass
class Optimizer:
    """Adam with a per-step learning rate and an optional global-norm clip
    (``optax.chain(clip_by_global_norm, adam(schedule))``).

    ``count`` is the number of updates applied; the next update runs at
    ``lr_schedule(count)``.
    """

    adam: torch.optim.Adam
    lr_schedule: Callable[[int], float]
    grad_clip_norm: float = 0.0
    count: int = 0

    def apply_gradients(self) -> torch.Tensor:
        """Clip the parameters' ``.grad`` and take one Adam step; returns
        the global gradient norm before the clip."""
        params = [p for g in self.adam.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if self.grad_clip_norm > 0:
            # optax: g / |g| * max once |g| >= max (clip_grad_norm_ would
            # divide by |g| + 1e-6)
            keep = norm < self.grad_clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g,
                                    g / norm * self.grad_clip_norm))
        lr = self.lr_schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1
        return norm


def make_optimizer(model: torch.nn.Module,
                   cfg: TrainConfig = TrainConfig()) -> Optimizer:
    """Adam (betas 0.9/0.999, eps 1e-8: optax's defaults) over every
    parameter of ``model``, at ``cfg``'s learning-rate schedule and with its
    gradient clip."""
    schedule = make_lr_schedule(cfg.learning_rate, cfg.lr_schedule,
                                cfg.total_steps)
    adam = torch.optim.Adam(model.parameters(), lr=schedule(0),
                            betas=ADAM_BETAS, eps=ADAM_EPS)
    return Optimizer(adam, schedule, cfg.grad_clip_norm)


def _rmse_log(gt: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """The train-time monitoring metric."""
    return compute_metrics(*clip_for_eval(gt, est))["RMSE_log"]


def make_train_step(model: M4Depth, optimizer: Optimizer
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """One optimisation step over a [b, T, ...] window.

    ``train_step(batch)`` updates the model's parameters in place and
    returns ``{"loss", "RMSE_log", "grad_norm"}`` as 0-d tensors: the loss
    and RMSE_log (last frame, full resolution, eval clipping) of the
    parameters before the update, and the global gradient norm before the
    clip.
    """

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        camera = batch_camera(batch)
        preds = model(batch["rgb"], batch["rot"], batch["trans"], camera)
        loss = model.loss(batch["depth"], preds)
        optimizer.adam.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = optimizer.apply_gradients()
        with torch.no_grad():
            gt = batch["depth"][:, -1]
            rmse = _rmse_log(gt, model.final_depth(preds, gt.shape[1:3]))
        return {"loss": loss.detach(), "RMSE_log": rmse,
                "grad_norm": grad_norm}

    return train_step


def make_windowed_eval_step(model: M4Depth):
    """KITTI-protocol eval: run a [b, T, ...] window and score its last
    frame at full resolution. ``eval_step(batch, acc) -> acc``."""

    @torch.no_grad()
    def eval_step(batch: Batch, acc: MetricAccumulator) -> MetricAccumulator:
        preds = model(batch["rgb"], batch["rot"], batch["trans"],
                      batch_camera(batch))
        gt = batch["depth"][:, -1]
        est = model.final_depth(preds, gt.shape[1:3])
        return acc.update(compute_metrics(*clip_for_eval(gt, est)))

    return eval_step


def make_streaming_eval_step(model: M4Depth):
    """Frame-at-a-time eval (Mid-Air / TartanAir protocol): the caller
    carries the model state; a frame flagged ``new_traj`` is scored with
    weight 0. ``eval_step(model_state, frame, acc) -> (model_state, acc)``,
    where ``frame`` holds one frame of each batch entry and ``new_traj``
    [b] bool."""

    def eval_step(model_state: ModelState, frame: Batch,
                  acc: MetricAccumulator
                  ) -> Tuple[ModelState, MetricAccumulator]:
        new_traj = frame["new_traj"]
        model_state, est = model.step(
            model_state, frame["rgb"], frame["rot"], frame["trans"],
            batch_camera(frame), new_traj)
        weight = 1.0 - torch.max(new_traj.float())
        acc = acc.update(compute_metrics(*clip_for_eval(frame["depth"], est)),
                         weight=weight)
        return model_state, acc

    return eval_step

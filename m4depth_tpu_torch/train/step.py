"""Train and eval steps. Counterpart of ``m4depth_tpu/train/step.py``.

One optimisation step over a ``[b, T, ...]`` window: the window forward,
the loss, autograd (through the cost-volume kernels' backward on the card),
an optional global-norm clip and Adam, as ``optax.chain(clip, adam)`` does
it. Every scalar a step returns is a 0-d tensor: nothing waits for the
device inside a step. ``TrainState`` (the model and its optimiser) is what
a checkpoint holds.

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
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from m4depth_tpu_torch.config import TrainConfig
from m4depth_tpu_torch.geometry import Camera, reproject
from m4depth_tpu_torch.metrics import (
    MetricAccumulator,
    clip_for_eval,
    compute_metrics,
)
from m4depth_tpu_torch.models.decoder import LevelEstimate
from m4depth_tpu_torch.models.m4depth import M4Depth, ModelState
from m4depth_tpu_torch.utils import tracing

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

    ``adam`` holds the parameter groups and the Adam state in
    ``torch.optim.Adam``'s layout, which a checkpoint saves; its own
    ``step`` is not called: every training step updates through
    ``apply_gradients``. ``count`` is the number of updates applied; the
    next update runs at ``lr_schedule(count)``.
    """

    adam: torch.optim.Adam
    lr_schedule: Callable[[int], float]
    grad_clip_norm: float = 0.0
    count: int = 0

    def clip_(self, grads) -> torch.Tensor:
        """Clip ``grads`` in place by their global norm (when
        ``grad_clip_norm`` is set); returns the norm before the clip."""
        norm = global_norm(grads)
        if self.grad_clip_norm > 0:
            # optax: g / |g| * max once |g| >= max (clip_grad_norm_ would
            # divide by |g| + 1e-6)
            keep = norm < self.grad_clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g,
                                    g / norm * self.grad_clip_norm))
        return norm

    @torch.no_grad()
    def apply_gradients(self, lr: torch.Tensor) -> torch.Tensor:
        """The update of every training step: clip the parameters'
        ``.grad``, then ``adam_update_`` at the learning rate ``lr``, a 0-d
        tensor on the parameters' device, so that nothing is read on the
        host and a CUDA graph replays it with each step's rate. The Adam
        state must exist (``init_adam_state``); ``count`` and the groups'
        rates are the caller's to advance (the train step's host side).
        Returns the global gradient norm before the clip."""
        params = [p for g in self.adam.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        norm = self.clip_(grads)
        state = [self.adam.state[p] for p in params]
        adam_update_(params, grads, [s["exp_avg"] for s in state],
                     [s["exp_avg_sq"] for s in state],
                     [s["step"] for s in state], lr)
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


def _to_cpu(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU: a saved state
    shares no storage with tensors that later steps update in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


@dataclasses.dataclass
class TrainState:
    """The model and its optimiser: the port's counterpart of the JAX
    package's ``TrainState`` (params, Adam state, step)."""

    model: M4Depth
    optimizer: Optimizer

    @property
    def step(self) -> int:
        """Updates applied so far (the schedule's count)."""
        return self.optimizer.count

    def state_dict(self) -> dict:
        """The model's weights, the Adam state (its per-parameter step
        counts included) and the schedule's count, copied to the CPU."""
        return _to_cpu({"model": self.model.state_dict(),
                        "adam": self.optimizer.adam.state_dict(),
                        "count": self.optimizer.count})

    def load_state_dict(self, state: dict) -> "TrainState":
        """Load a ``state_dict`` (its step counts, saved on the CPU, go to
        the parameters' device: ``init_adam_state``). Load before building
        a compiled step: its graph holds the tensors it was built with."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.adam.load_state_dict(state["adam"])
        self.optimizer.count = int(state["count"])
        init_adam_state(self.optimizer)
        return self


def create_train_state(model: M4Depth,
                       cfg: TrainConfig = TrainConfig()) -> TrainState:
    """``model`` with a fresh optimiser at ``cfg``'s settings."""
    return TrainState(model, make_optimizer(model, cfg))


def _rmse_log(gt: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """The train-time monitoring metric."""
    return compute_metrics(*clip_for_eval(gt, est))["RMSE_log"]


def _summary_images(batch: Batch, preds, camera: Camera
                    ) -> Dict[str, torch.Tensor]:
    """Image summaries from tensors the train forward already computed: the
    input frame, the previous frame reprojected through the ground truth
    (a check of the motion and intrinsics), and the ground truth and each
    level's estimate as normalised log-depth; first batch element only."""
    max_d = 200.0
    gt = batch["depth"][:, -1]
    reproj, _ = reproject(batch["rgb"][:, -2], gt, batch["rot"][:, -1],
                          batch["trans"][:, -1], camera)

    def log_norm(x):
        return torch.log(torch.clamp(x.float(), 1.0, max_d)) / math.log(max_d)

    images = {
        "RGB_im": batch["rgb"][0, -1],
        "camera_prev_t_reproj": reproj[0],
        "depth_gt": log_norm(gt[0]),
    }
    for i, est in enumerate(preds[-1]):
        # an M4Depth pyramid holds LevelEstimates, a V1 one depth maps
        depth = est.depth if isinstance(est, LevelEstimate) else est
        images[f"depth_lvl_{i}"] = log_norm(depth[0])
    return {k: v.detach() for k, v in images.items()}


def data_parallel(model: M4Depth, mesh):
    """``model`` wrapped in ``DistributedDataParallel`` over ``mesh``'s
    data group: rank 0's weights are broadcast to every rank when it is
    built, and each backward all-reduces (averages) the gradients, bucket
    by bucket, as the ranks' gradients come. Every parameter gets a
    gradient in every step (the cost volumes carry the gradient to the
    encoder), so ``find_unused_parameters`` is off. Counterpart of the JAX
    package's ``jit_data_parallel``; ``make_train_step`` takes the
    wrapper."""
    from torch.nn.parallel import DistributedDataParallel

    from m4depth_tpu_torch.parallel.mesh import data_group

    return DistributedDataParallel(model, process_group=data_group(mesh),
                                   find_unused_parameters=False)


def make_train_step(
    model: M4Depth,
    optimizer: Optimizer,
    with_images: bool = False,
    augment_fn: Optional[Callable[[Batch, int, int], Batch]] = None,
    augment_seed: int = 0,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """One optimisation step over a [b, T, ...] window.

    ``train_step(batch)`` updates the model's parameters in place and
    returns ``{"loss", "RMSE_log", "grad_norm"}`` as 0-d tensors: the loss
    and RMSE_log (last frame, full resolution, eval clipping) of the
    parameters before the update, and the global gradient norm before the
    clip. ``with_images=True`` adds ``"images"``, made from the same
    forward (``_summary_images``).

    ``augment_fn(batch, seed, step)`` (``data.augment_device``), when
    given, augments the batch inside the step, keyed by ``augment_seed``
    and the optimiser's count of updates.

    The update is ``Optimizer.apply_gradients`` at the schedule's rate,
    written into a device scalar before each step, with device step
    counts: ``compile_train_step``'s arithmetic, bit for bit. The Adam
    state is made here (``init_adam_state``).

    ``model`` may be the ``data_parallel`` wrapper: the forward then runs
    through it (its backward all-reduces the gradients, so ``grad_norm`` is
    the global one), the loss through the wrapped model's, over the global
    batch (``losses.m4depth_loss``'s ``group``), and ``loss`` and
    ``RMSE_log`` are the means of the ranks' values (for the loss, the
    global batch's). Every rank gets the same scalars, so every rank's NaN
    tripwire stops at the same step.
    """
    return _build_train_step(model, optimizer, with_images, augment_fn,
                             augment_seed, as_graph=False)


def _train_body(model, optimizer: Optimizer, with_images: bool,
                lr: torch.Tensor) -> Callable[[Batch], Dict[str, Any]]:
    """The body of every train step: the window's forward, the loss, the
    backward, ``optimizer.apply_gradients(lr)``, RMSE_log and the images.
    Returns ``{"scalars": [loss, RMSE_log, grad_norm]}`` as one stacked
    tensor, and ``"images"`` with ``with_images``. Through the
    ``data_parallel`` wrapper the loss is the global batch's and ``loss``
    and ``RMSE_log`` are the means over the ranks. After the model's own
    stage marks it marks ``loss``, ``backward``, ``optimizer`` and
    ``metrics`` (``utils.tracing``)."""
    from torch.nn.parallel import DistributedDataParallel

    ddp = isinstance(model, DistributedDataParallel)
    core = model.module if ddp else model
    group = model.process_group if ddp else None

    def body(batch: Batch) -> Dict[str, Any]:
        camera = batch_camera(batch)
        device = batch["depth"].device
        preds = model(batch["rgb"], batch["rot"], batch["trans"], camera)
        tracing.mark("loss", device)
        loss = core.loss(batch["depth"], preds, group=group)
        optimizer.adam.zero_grad(set_to_none=True)
        tracing.mark("backward", device)
        loss.backward()
        tracing.mark("optimizer", device)
        grad_norm = optimizer.apply_gradients(lr)
        tracing.mark("metrics", device)
        with torch.no_grad():
            gt = batch["depth"][:, -1]
            rmse = _rmse_log(gt, core.final_depth(preds, gt.shape[1:3]))
            both = torch.stack([loss.detach(), rmse.float()])
            if ddp:
                dist.all_reduce(both, group=group)
                both = both / dist.get_world_size(group)
            out = {"scalars": torch.cat([both, grad_norm.reshape(1)])}
            if with_images:
                out["images"] = _summary_images(batch, preds, camera)
        return out

    return body


def _build_train_step(model, optimizer: Optimizer, with_images: bool,
                      augment_fn, augment_seed: int, as_graph: bool
                      ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``train_step(batch)`` of ``make_train_step`` and
    ``compile_train_step``: ``augment_fn`` at the optimiser's count; the
    host side of the step, which writes the schedule's rate at ``count``
    into the device scalar that the body's update reads and into the
    groups' ``lr``; ``_train_body``, wrapped in
    ``utils.graphs.Compiled`` when ``as_graph``; then ``count += 1``. Its
    stacked scalars are returned by name; in the host spans ``train.step``
    and ``train.augment``. A call that replayed the compiled body counts
    in the ``train.step`` counter (``utils.tracing``). The Adam state is
    made here (``init_adam_state``)."""
    from m4depth_tpu_torch.utils.graphs import Compiled

    adam = optimizer.adam
    init_adam_state(optimizer)
    lr = torch.zeros((), dtype=torch.float32,
                     device=adam.param_groups[0]["params"][0].device)
    body = _train_body(model, optimizer, with_images, lr)
    compiled = Compiled(body) if as_graph else None
    run = body if compiled is None else compiled

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        t0 = tracing.clock()
        with tracing.span("train.step"):
            if augment_fn is not None:
                with tracing.span("train.augment"):
                    batch = augment_fn(batch, augment_seed, optimizer.count)
            rate = optimizer.lr_schedule(optimizer.count)
            lr.fill_(rate)
            for group in adam.param_groups:
                group["lr"] = rate
            out = run(batch)
            optimizer.count += 1
        if compiled is not None and compiled.replayed:
            tracing.count("train.step", t0)
        loss, rmse, grad_norm = out["scalars"]
        result = {"loss": loss, "RMSE_log": rmse, "grad_norm": grad_norm}
        if "images" in out:
            result["images"] = out["images"]
        return result

    train_step.compiled = compiled
    return train_step


def make_windowed_eval_step(model: M4Depth):
    """KITTI-protocol eval: run a [b, T, ...] window and score its last
    frame at full resolution. ``eval_step(batch, acc) -> acc``."""

    @torch.no_grad()
    def eval_step(batch: Batch, acc: MetricAccumulator) -> MetricAccumulator:
        preds = model(batch["rgb"], batch["rot"], batch["trans"],
                      batch_camera(batch))
        gt = batch["depth"][:, -1]
        tracing.mark("metrics", gt.device)
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
        tracing.mark("metrics", est.device)
        weight = 1.0 - torch.max(new_traj.float())
        acc = acc.update(compute_metrics(*clip_for_eval(frame["depth"], est)),
                         weight=weight)
        return model_state, acc

    return eval_step


def init_adam_state(optimizer: Optimizer) -> None:
    """Give each parameter of ``optimizer`` the Adam state that
    ``torch.optim.Adam`` makes at its first step (a step count and two
    zero moments), where it has none yet, with the step counts on the
    parameters' device, as ``adam_update_`` takes them. Building a train
    step and loading a checkpoint call it; the layout is
    ``torch.optim.Adam``'s own, so a checkpoint written by its ``step``
    loads too."""
    adam = optimizer.adam
    for group in adam.param_groups:
        for p in group["params"]:
            state = adam.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            state["step"] = state["step"].to(p.device, torch.float32)


def adam_update_(params, grads, exp_avgs, exp_avg_sqs, steps,
                 lr: torch.Tensor) -> None:
    """One Adam update of ``params`` in place (``torch.optim.Adam``'s and
    optax's arithmetic: betas 0.9/0.999, eps 1e-8), with the learning rate
    ``lr`` and the step counts ``steps`` as tensors on the parameters'
    device: nothing is read on the host, so a CUDA graph replays it with
    each step's rate and count. Every parameter has taken the same number
    of steps."""
    b1, b2 = ADAM_BETAS
    torch._foreach_add_(steps, 1.0)
    torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
    torch._foreach_mul_(exp_avg_sqs, b2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, value=1 - b2)
    # the bias corrections in float64, as torch.optim.Adam takes them on
    # the host: in float32, 1 - 0.999^t loses five digits at small t
    t = steps[0].double()
    step_size = (lr.double() / (1 - torch.pow(b1, t))).float()
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(denom, torch.sqrt(1 - torch.pow(b2, t)).float())
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_div_(denom, step_size)
    # p -= step_size * m / (sqrt(v / bc2) + eps)
    torch._foreach_addcdiv_(params, exp_avgs, denom, value=-1.0)


# -- compiled steps: the counterparts of the JAX package's jitted steps -------


def compile_train_step(
    model: M4Depth,
    optimizer: Optimizer,
    with_images: bool = False,
    augment_fn: Optional[Callable[[Batch, int, int], Batch]] = None,
    augment_seed: int = 0,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``make_train_step``'s step on one process, compiled: the
    counterpart of the JAX package's ``jit_data_parallel(
    make_train_step(...))``, which donates the train state. Same
    arguments and results as ``make_train_step`` (a data-parallel wrapper
    is refused: it runs eagerly).

    On the card the window's forward, the loss, the backward, the clip and
    Adam are one CUDA graph (``utils.graphs.Compiled``); the parameters,
    the Adam state and the gradients are its buffers, updated in place.
    The schedule stays on the host: each step's rate is written into a
    device scalar before the replay, which ``Optimizer.apply_gradients``
    reads, as in ``make_train_step``. On the CPU the step runs eagerly.
    ``augment_fn`` runs eagerly on the batch before it is
    copied into the graph's inputs. The results are copied out of the
    graph's buffers (the scalars as one stacked copy), so a loss held
    across later steps (``fit``'s lagged NaN tripwire) keeps its value.

    The Adam state is made here (``init_adam_state``): load a checkpoint
    into ``optimizer`` before compiling. The compiled step holds one graph
    for each batch signature it has seen twice.
    """
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(model, DistributedDataParallel):
        raise ValueError("compile_train_step runs on one process; the "
                         "data-parallel step is make_train_step's")
    return _build_train_step(model, optimizer, with_images, augment_fn,
                             augment_seed, as_graph=True)


def compile_windowed_eval_step(model: M4Depth):
    """``make_windowed_eval_step`` compiled, the window's forward and the
    metric update in one CUDA graph on the card: ``eval_step(batch, acc)
    -> acc``. The accumulator is donated: the step adds to its ``totals``
    and ``count`` in place and returns it (on the card, from the second
    call on, the graph's own; pass it back)."""
    from m4depth_tpu_torch.utils.graphs import Compiled, assign_

    step = make_windowed_eval_step(model)

    def body(batch: Batch, acc: MetricAccumulator) -> MetricAccumulator:
        return assign_(acc, step(batch, acc))

    return Compiled(body)


def compile_streaming_eval_step(model: M4Depth):
    """``make_streaming_eval_step`` compiled, the model's step and the
    metric update in one CUDA graph on the card: ``eval_step(model_state,
    frame, acc) -> (model_state, acc)``. The model state and the
    accumulator are donated, updated in place and returned (on the card,
    from the second call on, the graph's own; pass them back). A
    ``new_traj`` frame's weight 0 is computed on the device, so a reset
    replays the same graph."""
    from m4depth_tpu_torch.utils.graphs import Compiled, assign_

    step = make_streaming_eval_step(model)

    def body(model_state: ModelState, frame: Batch, acc: MetricAccumulator
             ) -> Tuple[ModelState, MetricAccumulator]:
        return assign_((model_state, acc), step(model_state, frame, acc))

    return Compiled(body)

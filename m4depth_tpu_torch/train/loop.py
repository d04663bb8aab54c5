"""Training loop: epochs, NaN tripwire, checkpoints, validation, telemetry.
Counterpart of ``m4depth_tpu/train/loop.py::fit``.

  * restore the latest checkpoint on start, save one per epoch and keep
    the last few, never save after a non-finite loss, and feed optional
    per-epoch validation to the best-K manager;
  * throughput telemetry: img/sec mean +/- stderr, MAD jitter, and the
    median step time.

The batches of a numpy dataset reach the device from pinned host memory
with ``non_blocking=True``; a dataset that yields tensors already on the
model's device (``DeviceSyntheticStream``) is used as it is.

Without a mesh ``fit`` runs ``compile_train_step``, the counterpart of
the JAX package's jitted, state-donating step: on the card one CUDA graph
a step. With a mesh (a process group, even of one rank) it trains data
parallel over ``mesh`` with the eager DDP step (``make_train_step``): each
rank steps on its own slice of the global batch (the dataset's
``host_shard``), every rank resumes from the same checkpoint directory,
rank 0 alone writes checkpoints and logs and runs validation, and the
others wait at a barrier after each epoch's save.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from m4depth_tpu_torch.config import TrainConfig
from m4depth_tpu_torch.models import M4Depth
from m4depth_tpu_torch.parallel.mesh import rank_and_world
from m4depth_tpu_torch.train.checkpoints import (
    BestCheckpointManager,
    TrainCheckpointManager,
)
from m4depth_tpu_torch.train.step import (
    compile_train_step,
    create_train_state,
    data_parallel,
    make_train_step,
)
from m4depth_tpu_torch.utils import tracing
from m4depth_tpu_torch.utils.logging import MetricLogger


class ThroughputMeter:
    """Step-time statistics: img/sec mean +/- stderr, MAD jitter, median.

    A tick is the host's wall time of one step, from the end of the
    previous step to the end of this one's dispatch: the wait for the
    batch, its copy to the device and the step's launches. Eager dispatch
    runs at most the tripwire's lag ahead of the device, so over many steps
    the ticks add up to the loop's wall time.
    """

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.times = []

    def tick(self, dt: float):
        self.times.append(dt)

    def report(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times[1:] or self.times)
        ips = self.batch_size / arr
        mad = float(np.median(np.abs(arr - np.median(arr))))
        return {
            "img_per_sec": float(ips.mean()),
            "img_per_sec_stderr": float(ips.std() / max(len(ips), 1) ** 0.5),
            "step_time_mad_jitter": mad,
            "step_ms_median": float(np.median(arr) * 1e3),
        }


class NaNStop(RuntimeError):
    pass


class OutOfMemory(RuntimeError):
    """Raised when the device runs out of memory, so that callers can exit
    cleanly (the legacy pipeline's exit code -2)."""


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``: numpy arrays go through
    pinned memory and an asynchronous copy to a CUDA device; tensors
    already there are kept."""
    out = {}
    for k, v in batch.items():
        # (a record store's mmap-backed arrays are read-only: copied)
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.require(v, requirements=("C", "W")))
        if t.device != device:
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[k] = t
    return out


def fit(
    model: M4Depth,
    dataset,
    cfg: TrainConfig,
    total_steps: Optional[int] = None,
    resume: bool = True,
    validation_fn: Optional[Callable[[M4Depth], Dict[str, float]]] = None,
    nan_check_every: int = 25,
    log_every: Optional[int] = None,
    augment_fn: Optional[Callable] = None,
    mesh=None,
):
    """Train to ``total_steps`` optimizer steps (the reference's semantics:
    epochs = total_steps // len(dataset)).

    With ``mesh`` (``parallel.make_mesh``; a process group of more than
    one rank needs one) the step runs eagerly through ``data_parallel``,
    and says so: ``dataset`` then yields this rank's share of each global
    batch, and ``len(dataset)`` must be the same on every rank. Without a
    mesh the step is ``compile_train_step``'s.

    Each batch is fetched in the host span ``train.loader_wait``
    (``utils.tracing``), and each log line adds ``loader_wait_ms``, the
    mean wait for a batch over the steps since the last one.

    Returns the final ``TrainState``. Raises ``NaNStop`` on a non-finite
    loss without saving the poisoned state (on every rank at the same
    step: the tripwire reads the loss averaged over the ranks), and
    ``OutOfMemory`` when the device runs out of memory.
    """
    rank, world = rank_and_world()
    if world > 1 and mesh is None:
        raise ValueError(f"fit under a process group of {world} ranks "
                         "needs mesh= (parallel.make_mesh()) to train data "
                         "parallel")
    main = rank == 0
    total_steps = total_steps or cfg.total_steps
    steps_per_epoch = len(dataset)
    if steps_per_epoch == 0:
        raise ValueError("dataset yields zero batches")
    n_epochs = max(total_steps // steps_per_epoch, 1)
    device = next(model.parameters()).device

    # peek the first batch for shapes, then continue the SAME generator for
    # epoch 0 (restarting it would decode the lookahead windows twice and
    # abandon a live worker pool)
    epoch0_gen = dataset.batches(0)
    sample = next(epoch0_gen)
    epoch0 = itertools.chain([sample], epoch0_gen)
    logger = MetricLogger(cfg.log_dir if main else None)
    state = create_train_state(
        model, dataclasses.replace(cfg, total_steps=total_steps))

    ckpt_mgr = TrainCheckpointManager(os.path.join(cfg.ckpt_dir, "train"),
                                      max_keep=cfg.keep_last_n)
    start_epoch = 0
    if resume:
        start_epoch = ckpt_mgr.resume_epoch
        if start_epoch > 0:
            if main:
                print(f"Resuming from epoch {start_epoch}")
            ckpt_mgr.restore_latest(state)
            epoch0_gen.close()  # resume skips epoch 0: stop its workers

    best_mgr = None
    if validation_fn is not None:
        best_mgr = BestCheckpointManager(
            ckpt_mgr.directory, os.path.join(cfg.ckpt_dir, "best"),
            keep_top_n=cfg.keep_top_n)

    step_args = dict(with_images=bool(cfg.log_dir) and main,
                     augment_fn=augment_fn, augment_seed=cfg.seed)
    if mesh is not None:
        if main:
            print(f"fit: data parallel over {world} rank(s) runs the eager "
                  "DDP step (DDP is not captured in a CUDA graph)",
                  flush=True)
        step = make_train_step(data_parallel(model, mesh), state.optimizer,
                               **step_args)
    else:
        step = compile_train_step(model, state.optimizer, **step_args)
    # images of the global batch a step
    meter = ThroughputMeter(dataset.batch_size * sample["rgb"].shape[1]
                            * world)
    log_every = log_every or cfg.summary_interval

    step_idx = start_epoch * steps_per_epoch
    last_scalars = None

    # Lagged NaN tripwire: a loss is read ``nan_lag`` steps behind the
    # dispatch frontier, when the device has long computed it, so the read
    # does not hold the host back. NaN parameters poison every later loss,
    # so a lagged check still guarantees that no poisoned checkpoint is
    # saved: the epoch's end drains every pending loss before its save.
    nan_lag = max(2, min(nan_check_every, 8))
    inflight = deque()

    def drain_nan_checks(upto_len: int):
        while len(inflight) > upto_len:
            s_i, loss = inflight.popleft()
            lf = float(loss)
            if not np.isfinite(lf):
                raise NaNStop(f"non-finite loss at step {s_i}: {lf}")

    wait_s, waits = 0.0, 0

    try:
        for epoch in range(start_epoch, n_epochs):
            t_epoch = t_last = time.perf_counter()
            batches = iter(epoch0 if epoch == 0 and start_epoch == 0
                           else dataset.batches(epoch))
            while True:
                t_fetch = time.perf_counter()
                with tracing.span("train.loader_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                wait_s += time.perf_counter() - t_fetch
                waits += 1
                scalars = step(to_device(batch, device))
                inflight.append((step_idx, scalars["loss"]))
                drain_nan_checks(nan_lag)
                now = time.perf_counter()
                meter.tick(now - t_last)
                t_last = now
                last_scalars = scalars
                if main and step_idx % log_every == 0:
                    images = scalars.pop("images", None)
                    vals = {k: float(v) for k, v in scalars.items()}
                    vals.update(meter.report())
                    vals["loader_wait_ms"] = 1e3 * wait_s / waits
                    wait_s, waits = 0.0, 0
                    logger.log_scalars(step_idx, vals, prefix="train/")
                    print(f"epoch {epoch} step {step_idx}: " +
                          " ".join(f"{k}={v:.4g}" for k, v in vals.items()),
                          flush=True)
                    if images is not None:
                        logger.log_images(step_idx, {
                            k: v.float().cpu().numpy()
                            for k, v in images.items()})
                step_idx += 1

            # epoch end: drain the tripwire, then NaN-gate the save
            drain_nan_checks(0)
            if last_scalars is not None and \
                    not np.isfinite(float(last_scalars["loss"])):
                raise NaNStop(f"non-finite loss at end of epoch {epoch}")
            if main:
                ckpt_mgr.save(epoch, state)
                report = meter.report()
                logger.log_scalars(step_idx, report, prefix="epoch/")
                print(f"epoch {epoch} done in "
                      f"{time.perf_counter() - t_epoch:.1f}s; step ms median "
                      f"{report['step_ms_median']:.3f} (this run's steps "
                      "after its first); checkpoint saved", flush=True)

                if validation_fn is not None:
                    perfs = validation_fn(model)
                    if perfs is not None:  # None => in a subprocess
                        logger.log_scalars(step_idx, perfs, prefix="val/")
                        best_mgr.update(epoch, perfs, state)
            if world > 1:
                # the others wait for rank 0's save (and validation)
                if dist.get_backend() == "nccl":
                    dist.barrier(device_ids=[device.index])
                else:
                    dist.barrier()
    except torch.OutOfMemoryError as e:
        # an asynchronous launch can surface the device's out-of-memory at
        # any later synchronising read (the tripwire's float, a log, the
        # checkpoint's copy): caught around the whole loop
        raise OutOfMemory(str(e)) from e
    finally:
        logger.close()
        close = getattr(validation_fn, "close", None)
        if close is not None:  # reap any in-flight validation subprocess
            close()
    return state

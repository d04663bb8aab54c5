"""Evaluation protocols. Counterpart of ``m4depth_tpu/eval/evaluator.py``.

  * Mid-Air / TartanAir: frame-at-a-time streaming, the model state carried
    across frames; frames flagged new_traj are left out of the metrics.
  * KITTI: 4-frame windows, only the LAST frame scored (sparse gt with the
    Garg/Eigen crop applied by the dataloader).

The metrics are the 7-metric suite with the clip-to-[0, 80] protocol,
accumulated on the device; results go to ``perfs-<dataset>.txt``. The
model carries its weights, so these functions take no parameter tree.

Each protocol runs its compiled step (``compile_streaming_eval_step``,
``compile_windowed_eval_step``), as the JAX evaluator runs its jitted one:
on the card one CUDA graph of the model's step and the metric update,
replayed every frame or window.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from m4depth_tpu_torch.metrics import METRIC_NAMES, MetricAccumulator
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.train.loop import to_device
from m4depth_tpu_torch.train.step import (
    compile_streaming_eval_step,
    compile_windowed_eval_step,
)


def _finish(acc: MetricAccumulator, n: int, t0: float, unit: str,
            trace) -> Dict[str, float]:
    if trace is not None:
        trace.close()
    out = {k: float(v) for k, v in acc.result().items()}
    dt = time.perf_counter() - t0
    print(f"  evaluated {n} {unit}s in {dt:.3f} s "
          f"({1e3 * dt / max(n, 1):.3f} ms/{unit}, loading included)",
          flush=True)
    return out


@torch.no_grad()
def evaluate_streaming(model: M4Depth, dataset, progress_every: int = 0,
                       trace=None, max_steps: int = 0) -> Dict[str, float]:
    """Frame-at-a-time evaluation with O(1) device memory.

    ``max_steps`` > 0 bounds the number of frames scored (a validation
    subset; 0 = the full set)."""
    device = next(model.parameters()).device
    step = compile_streaming_eval_step(model)
    acc = MetricAccumulator.zeros(device)
    model_state = None
    n = 0
    t0 = time.perf_counter()
    for frame in dataset.frames():
        if model_state is None:
            b, h, w = frame["rgb"].shape[:3]
            model_state = init_state(model.cfg, b, h, w, device)
        if trace is not None:
            trace.on_step(n)
        model_state, acc = step(model_state, to_device(frame, device), acc)
        n += 1
        if progress_every and n % progress_every == 0:
            print(f"  eval frame {n}", flush=True)
        if max_steps and n >= max_steps:
            break
    return _finish(acc, n, t0, "frame", trace)


@torch.no_grad()
def evaluate_windowed(model: M4Depth, dataset, progress_every: int = 0,
                      trace=None, max_steps: int = 0) -> Dict[str, float]:
    """Fixed-window evaluation scoring the last frame of each window."""
    device = next(model.parameters()).device
    step = compile_windowed_eval_step(model)
    acc = MetricAccumulator.zeros(device)
    n = 0
    t0 = time.perf_counter()
    for batch in dataset.batches():
        if trace is not None:
            trace.on_step(n)
        acc = step(to_device(batch, device), acc)
        n += 1
        if progress_every and n % progress_every == 0:
            print(f"  eval window {n}", flush=True)
        if max_steps and n >= max_steps:
            break
    return _finish(acc, n, t0, "window", trace)


def evaluate(model: M4Depth, dataset, progress_every: int = 0, trace=None,
             max_steps: int = 0) -> Dict[str, float]:
    """Dispatch on the dataset protocol (windowed iff db_seq_len is set).

    ``trace``: an optional ``utils.profiling.TraceWindow`` (the reference's
    ``profile_batch='10, 25'`` eval profiling).
    """
    if dataset.db_seq_len is not None:
        return evaluate_windowed(model, dataset, progress_every, trace,
                                 max_steps)
    return evaluate_streaming(model, dataset, progress_every, trace,
                              max_steps)


def write_perfs(metrics: Dict[str, float], ckpt_dir: str,
                dataset_name: str) -> str:
    """perfs-<dataset>.txt, one metric per line."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"perfs-{dataset_name}.txt")
    values = [metrics[name] for name in METRIC_NAMES]
    np.savetxt(path, np.asarray(values), fmt="%.18e", delimiter="\t")
    return path


def metrics_to_validation_perfs(metrics: Dict[str, float]) -> Dict[str, float]:
    """Map metric names to the best-checkpoint ledger keys."""
    return {
        "abs_rel": metrics["AbsRel"],
        "sq_rel": metrics["SqRel"],
        "rmse": metrics["RMSE"],
        "rmsel": metrics["RMSE_log"],
        "a1": metrics["Delta1"],
        "a2": metrics["Delta2"],
        "a3": metrics["Delta3"],
    }

"""Profiling and timing harness. Counterpart of
``m4depth_tpu/utils/profiling.py``.

``TraceWindow`` records a ``torch.profiler`` trace (host and, on a card,
device activity) over a window of steps into a log directory as a Chrome
trace file; ``benchmark_fn`` gives wall-clock statistics of a call that
ends in ``torch.cuda.synchronize`` on a card. The JAX module's
``compiled_cost`` reads XLA's cost analysis and has no counterpart here.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _export(prof, log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class TraceWindow:
    """Start and stop a profiler trace over a window of step indices: the
    ``profile_batch='10, 25'`` pattern."""

    def __init__(self, log_dir: Optional[str], start_step: int,
                 stop_step: int):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self._prof = None

    def on_step(self, step: int) -> None:
        if not self.log_dir:
            return
        if step == self.start_step and self._prof is None:
            self._prof = _profiler()
            self._prof.start()
        elif step >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            _export(self._prof, self.log_dir)
            self._prof = None


def benchmark_fn(fn: Callable, *args, warmup: int = 3, iters: int = 30,
                 **kwargs) -> Dict[str, float]:
    """Wall-clock statistics (mean, p50, MAD jitter, stderr) of ``fn``;
    each call ends in ``torch.cuda.synchronize()`` when a card is there."""

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args, **kwargs)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "mean_s": float(arr.mean()),
        "p50_s": float(np.median(arr)),
        "mad_jitter_s": float(np.median(np.abs(arr - np.median(arr)))),
        "stderr_s": float(arr.std() / len(arr) ** 0.5),
    }

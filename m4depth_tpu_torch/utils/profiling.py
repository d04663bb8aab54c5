"""Profiling and timing harness. Counterpart of
``m4depth_tpu/utils/profiling.py``.

``device_trace`` and ``TraceWindow`` record a ``torch.profiler`` trace
(host and, on a card, device activity) into a log directory as a Chrome
trace file; ``device_breakdown`` splits a trace's device time by the
model's stage marks (``utils.tracing``); ``benchmark_fn`` gives
wall-clock statistics of a call that ends in ``torch.cuda.synchronize`` on
a card; ``compiled_cost`` counts the operations and bytes of one call.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from m4depth_tpu_torch.ops import cost
from m4depth_tpu_torch.utils import tracing


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


class Trace:
    """What ``device_trace`` yields: the profiler, and after the block the
    path of the Chrome trace file it wrote."""

    def __init__(self, prof):
        self.prof = prof
        self.path: Optional[str] = None


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace the block's host and (on a card) device activity into
    ``log_dir`` as a Chrome trace file; nothing when ``log_dir`` is falsy,
    as the JAX function. Yields a :class:`Trace` (None when off)."""
    if not log_dir:
        yield None
        return
    trace = Trace(_profiler())
    trace.prof.start()
    try:
        yield trace
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        trace.prof.stop()
        trace.path = _export(trace.prof, log_dir)


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


# -- device time by stage --------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNMARKED = "unmarked"     # device work before the trace's first stage mark
OUTSIDE = "outside"       # device work after an ``end`` mark: between graphs


def innermost_attribution(events) -> Dict[str, float]:
    """Each time point covered by ``events`` ((ts, dur, key) tuples) to the
    innermost (latest started) event open at it; {key: us}. The result
    sums to the length of the events' union."""
    out = collections.defaultdict(float)
    marks = []
    for i, (ts, dur, key) in enumerate(events):
        marks.append((ts, 1, -dur, i, key))
        marks.append((ts + dur, 0, 0.0, i, key))
    marks.sort()
    stack, last = [], None
    for t, start, _, i, key in marks:
        if stack and t > last:
            out[stack[-1][1]] += t - last
        if start:
            stack.append((i, key))
        else:
            stack.remove((i, key))
        last = t
    return dict(out)


def device_breakdown(trace_path: str, n: int = 1) -> dict:
    """Device time of a Chrome trace (``device_trace``'s) in us per call
    over ``n`` calls, by the stage marks of ``utils.tracing``, replayed
    CUDA graphs included: each device event (kernel, copy, memset) belongs
    to the stage of the latest mark that started at or before it
    (``unmarked`` before the first, ``outside`` after an ``end``), and
    each time point to the innermost device event open at it, so nothing
    counts twice. Returns ``busy_us`` (the union of device events),
    ``groups`` {stage: us}, which sum to ``busy_us``, ``ops`` {(kernel,
    stage): us}, ``n_events`` and ``units``, ``tracing.summarize`` of the
    trace's marked units (each stage's span from its mark to the next and
    its busy time, the unit's span and gap, complete and seen units)."""
    with open(trace_path) as f:
        dev = sorted((e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda e: e["ts"])
    marks = [(e["ts"], st) for e in dev
             if (st := tracing.mark_stage(e["name"])) is not None]
    starts = [t for t, _ in marks]
    keyed = []
    for e in dev:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        stage = (UNMARKED if i < 0 else
                 OUTSIDE if marks[i][1] == tracing.END and
                 tracing.mark_stage(e["name"]) != tracing.END
                 else marks[i][1])
        keyed.append((e["ts"], e.get("dur", 0.0), (stage, e["name"][:60])))
    per = innermost_attribution(keyed)
    groups, ops = collections.defaultdict(float), collections.defaultdict(
        float)
    for (stage, name), us in per.items():
        groups[stage] += us / n
        ops[(name, stage)] += us / n
    found = tracing.units((e["name"], e["ts"], e["ts"] + e.get("dur", 0.0))
                          for e in dev)
    return dict(busy_us=sum(per.values()) / n, groups=dict(groups),
                ops=dict(ops), n_events=len(dev),
                units=tracing.summarize(found))


# -- operations and bytes -----------------------------------------------


def compiled_cost(fn: Callable, *args) -> Dict[str, float]:
    """The operations and bytes of one call of ``fn(*args)``, under the
    JAX function's keys: ``flops`` and ``bytes accessed``.

    Eager PyTorch compiles nothing, so the call runs once and is counted
    as it runs. ``flops``: the matrix products and convolutions by
    ``FlopCounterMode``'s formulas (2 per multiply-add, as XLA counts;
    elementwise ops count none, as FlopCounterMode's), plus the cost
    volumes' analytic operations (``ops.cost``). ``bytes accessed``: the
    bytes every aten op reads and writes (its tensor inputs and outputs;
    views move none), plus the cost volumes' analytic bytes. A cost-volume
    call counts once, its forward and (when autograd runs it) its
    backward, whether the plain version (CPU) or the kernel (card) runs;
    the aten ops inside it do not count on top. Eager has no fusion, so
    the bytes are an upper bound of what a fused program moves, where
    XLA's count is after fusion. Also returned: ``convolution flops`` (the
    forward convolutions), ``convolution backward flops``, ``cost volume
    flops`` and ``cost volume bytes``.
    """
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    registry = FlopCounterMode(display=False).flop_registry

    def nbytes(tree) -> int:
        seen = {id(t): t for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}
        return sum(t.numel() * t.element_size() for t in seen.values())

    class AtenCount(TorchDispatchMode):
        def __init__(self, count):
            super().__init__()
            self.count = count
            self.flops = collections.Counter()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view or self.count.owns_current_op():
                return out
            packet = func._overloadpacket
            if packet in registry:
                self.flops[packet.__name__] += registry[packet](
                    *args, **kwargs, out_val=out)
            self.bytes += nbytes((args, kwargs)) + nbytes(out)
            return out

    with cost.counting() as cv, AtenCount(cv) as aten:
        fn(*args)
    conv = {d: sum(v for k, v in aten.flops.items() if "convolution" in k
                   and ("backward" in k) == d) for d in (False, True)}
    return {"flops": float(sum(aten.flops.values()) + cv.flops),
            "bytes accessed": float(aten.bytes + cv.bytes),
            "convolution flops": float(conv[False]),
            "convolution backward flops": float(conv[True]),
            "cost volume flops": float(cv.flops),
            "cost volume bytes": float(cv.bytes)}

"""The traced run's readings: a ``torch.profiler`` window (CPU and CUDA
activity) over a number of frames or steps, reduced to what the
per-layer readers in ``metrics/`` take.

Device time is grouped by kernel name, since a replayed CUDA graph has no
Python stack to attribute it by: the port's cost-volume kernels (their
names hold ``sncv_`` or ``dscv_``), convolution and GEMM kernels (cuDNN's
and cuBLAS' names), copies and memsets, and the rest ("elementwise").
Busy time is the union of every kernel, copy and memset interval. Host
launches are the CUDA runtime's kernel launches, graph launches, async
copies and memsets.

The profiler slows the host, so every share divides device time from the
profiled window by the wall time of the unprofiled window before it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

CV_KERNEL = re.compile(r"(sncv|dscv)_\w*kernel")
CONV_KERNEL = re.compile(
    r"conv|gemm|xmma|cutlass|cudnn|wgrad|dgrad|fprop|winograd|implicit|"
    r"sm90_|sm80_|nchwToNhwc|nhwcToNchw", re.IGNORECASE)
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
SPAN_PREFIX = "bench."
NAME_CHARS = 160
SHORT_GAP_US = 10.0


def kernel_class(name: str) -> str:
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copy"
    if CV_KERNEL.search(name):
        return "cost_volume"
    if CONV_KERNEL.search(name):
        return "conv"
    return "elementwise"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own (``bench.<name>``), which the
    profiler records and the idle gaps are labelled by."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    """A profiled window of ``units`` frames or steps, and the unprofiled
    wall time of one, ``wall_s``. Times are seconds a unit."""

    units: int
    wall_s: float
    window_s: float                   # the profiled window's wall time
    busy_s: float                     # union of device activity, a unit
    by_class: Dict[str, float]        # device time by kernel class, a unit
    host_launches: float              # a unit
    flops: float                      # the model's FLOPs a unit
    cv_bound_s: float                 # the cost volumes' bound, a unit
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def profile(run_unit: Callable[[int], None], units: int, wall_s: float,
            flops: float, cv_bound_s: float) -> Trace:
    """Profile ``units`` calls of ``run_unit(i)`` (each ending when its
    work has finished on the device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            run_unit(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host, spans = [], collections.Counter(), []
    per_name: Dict[str, float] = collections.defaultdict(float)
    by_class: Dict[str, float] = collections.defaultdict(float)
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            if evt.name.startswith(SPAN_PREFIX) or (
                    "#" in evt.name and "(" not in evt.name):
                continue  # a user annotation, not device work
            device.append((start, end))
            dur = (end - start) * 1e-6
            per_name[evt.name[:NAME_CHARS]] += dur
            by_class[kernel_class(evt.name)] += dur
        else:
            if evt.name.startswith(HOST_LAUNCHES):
                host[evt.name] += 1
            spans.append((start, end, evt.name))
    if not device:
        raise RuntimeError("the profile holds no device activity: the "
                           "profiler saw no kernel on the card")
    busy = _union(device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = _label_gaps(busy, spans)
    return Trace(
        units=units, wall_s=wall_s, window_s=window_s,
        busy_s=busy_s / units,
        by_class={k: v / units for k, v in by_class.items()},
        host_launches=sum(host.values()) / units,
        flops=flops, cv_bound_s=cv_bound_s,
        device_ops=sorted(per_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=gaps)


def _label_gaps(busy, spans) -> List[Tuple[str, float]]:
    """Idle time between device activity, summed by what the host was
    doing at each gap's middle: the innermost host event open there (the
    benchmark's spans, the runtime's calls, aten ops), else "host". Gaps
    under SHORT_GAP_US, between the kernels of one replay or one launch
    stream, are summed apart."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    totals: Dict[str, float] = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 < SHORT_GAP_US:
            totals[f"gaps under {SHORT_GAP_US:g} us"] += (s1 - e0) * 1e-6
            continue
        mid = 0.5 * (e0 + s1)
        label: Optional[str] = None
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, name = spans[j]
            if mid - s > 1e6:
                break
            if e >= mid:
                label = name
                break
        totals[(label or "host")[:NAME_CHARS]] += (s1 - e0) * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:10]

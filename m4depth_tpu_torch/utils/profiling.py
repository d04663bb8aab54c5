"""Profiling and timing harness. Counterpart of
``m4depth_tpu/utils/profiling.py``.

``device_trace`` and ``TraceWindow`` record a ``torch.profiler`` trace
(host and, on a card, device activity) into a log directory as a Chrome
trace file; ``device_breakdown`` splits a trace's device time by component
and direction without labels in the model; ``benchmark_fn`` gives
wall-clock statistics of a call that ends in ``torch.cuda.synchronize`` on
a card; ``compiled_cost`` counts the operations and bytes of one call.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from m4depth_tpu_torch.ops import cost


def _profiler(with_stack: bool = False):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, with_stack=with_stack)


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
def device_trace(log_dir: Optional[str], with_stack: bool = False):
    """Trace the block's host and (on a card) device activity into
    ``log_dir`` as a Chrome trace file; nothing when ``log_dir`` is falsy,
    as the JAX function. Yields a :class:`Trace` (None when off).
    ``with_stack`` also records the Python calls, among them each
    ``nn.Module``'s, which ``device_breakdown`` attributes by."""
    if not log_dir:
        yield None
        return
    trace = Trace(_profiler(with_stack))
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


# -- device time by component -------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"
# a kernel's component: the port's kernels by name ("void (anonymous
# namespace)::sncv_forward_kernel<...>"), the others by the model's module
# they were launched under (outermost first wins)
KERNEL_COMPONENTS = (("::sncv_", "sncv"), ("::dscv_", "dscv"))
MODULE_COMPONENTS = (("Encoder", "encoder"), ("DispRefiner", "refiner"))


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


def _component(kernel: str, modules) -> str:
    for part, comp in KERNEL_COMPONENTS:
        if part in kernel:
            return comp
    for mod in modules:
        for pattern, comp in MODULE_COMPONENTS:
            if mod.startswith(pattern):
                return comp
    return "other"


def _host_context(events):
    """For each launch on the host, by its correlation id: the nn.Modules
    open around it (outermost first), the outermost aten op, and the
    sequence number of the backward node it runs in (None in the
    forward); and each forward op's modules by its sequence number."""
    by_lane = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("cpu_op", "python_function") + LAUNCH_CATS:
            by_lane[(e.get("pid"), e.get("tid"))].append(e)
    launches, forward = {}, {}
    for lane in by_lane.values():
        lane.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []
        for e in lane:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) \
                    <= e["ts"]:
                stack.pop()
            mods = [s["name"][len("nn.Module: "):] for s in stack
                    if s["name"].startswith("nn.Module: ")]
            bwd = next((s["args"].get("Sequence number") for s in stack
                        if s["name"].startswith(BACKWARD_OP)), None)
            if e.get("cat") in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                op = next((s["name"] for s in stack
                           if s["name"].startswith("aten::")), "")
                launches[corr] = (mods, op, bwd)
                continue
            # a backward node's own events (its name, its ops) carry the
            # node's sequence number too: only the forward's ops map it
            seq = e.get("args", {}).get("Sequence number")
            if (e.get("cat") == "cpu_op" and seq is not None and bwd is None
                    and not e["name"].startswith(BACKWARD_OP)):
                forward.setdefault(seq, mods)
            stack.append(e)
    return launches, forward


def device_breakdown(trace_path: str, n: int = 1) -> dict:
    """Device time of a Chrome trace (``device_trace``'s, recorded with
    ``with_stack``) in us per call over ``n`` calls, split without overlap:
    each time point goes to the innermost device event open at it, that
    event to its kernel's component (``sncv``, ``dscv``, or by the module
    it was launched under: ``encoder``, ``refiner``, else ``other``) and
    direction (``bwd`` when launched inside an autograd backward node,
    whose component is that of the forward op with the node's sequence
    number). Returns ``busy_us`` (the union of device events),
    ``groups`` {(direction, component): us}, ``ops`` {(kernel, aten op):
    us} and ``n_events``; the groups sum to ``busy_us``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches, forward = _host_context(events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    keyed = []
    for e in dev:
        mods, op, bwd = launches.get(e.get("args", {}).get("correlation"),
                                     ([], "", None))
        if bwd is not None:
            mods = forward.get(bwd, [])
        direction = "fwd" if bwd is None else "bwd"
        keyed.append((e["ts"], e.get("dur", 0.0),
                      (direction, _component(e["name"], mods),
                       e["name"][:60], op)))
    per = innermost_attribution(keyed)
    groups, ops = collections.defaultdict(float), collections.defaultdict(
        float)
    for (direction, comp, name, op), us in per.items():
        groups[(direction, comp)] += us / n
        ops[(name, op)] += us / n
    return dict(busy_us=sum(per.values()) / n, groups=dict(groups),
                ops=dict(ops), n_events=len(dev))


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

"""The port's own instruments: stage marks on the device, host spans and
host counters.

**Stage marks** (``mark``). A replayed CUDA graph makes no host call per
node, so a host annotation (NVTX, ``record_function``) placed while it was
captured never reaches a replay. A stage boundary inside a graph is
therefore device work captured into it: ``mark(stage, device)`` launches an
empty one-thread kernel (``ops/csrc/mark.cu``), one instantiation per
stage, so that the profiler shows ``m4d_stage_mark<i>`` as a device event
on the clock of every other kernel and the stage's index ``i`` reads from
its name. A stage runs from its mark to the next one; ``end`` closes every
function that ``utils.graphs.Compiled`` captures, so each replay's marks
bracket the whole graph. A mark computes nothing. Under a capture it is
always recorded, so every replay runs it; on the card outside a capture it
launches only while a profiler records; on the CPU, and inside an autograd
backward node (a remat's recompute: the backward is one stage), it does
nothing. ``STAGES`` is the fixed table of stage names:

* ``encoder``, then ``glue`` where the decoder starts;
* for each decoder level k that runs its refiner, ``refiner<k>`` just
  before the refiner's call and ``glue<k>`` just after it: ``glue<k>``
  holds level k's work after its refiner and the next (finer) level's
  work up to its own refiner;
* ``output`` (the full-resolution depth of a streaming step), ``loss``,
  ``backward``, ``optimizer`` and ``metrics``;
* ``end``.

``units`` reduces a profile's device events to replays of marked graphs
(``Unit``: each stage's span and busy time).

**Host spans** (``span``): ``record_function("m4d#" + name)`` while a
profiler records, so that the profiler's idle-gap labels name the port's
own phases; otherwise a shared null context after one check. The ``#``
marks the name as a user annotation, which the profile reducers keep out of
device work (the profiler also draws such a range on the device timeline).

**Counters** (``count``, ``counters``): calls and host nanoseconds
(``time.perf_counter_ns``), always on, in memory. ``serve.step`` and
``train.step`` count only the entry calls that ended in a replay;
``compiled.replays`` splits a replay's host time into ``prepare``
(signature, copies in), ``launch`` (``cudaGraphLaunch``) and ``finish``
(the launch counts, the copies out); ``compiled.warmups`` and
``compiled.captures`` count the calls that ran eagerly and those that
captured (and replayed once), so neither enters a replay's mean. Which
path a kernel's wrapper took reads from the kernel's own ``launches``
(``ops._build.CudaKernel``), which counts replays too.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd.profiler import record_function

MAX_LEVELS = 8
STAGES: Tuple[str, ...] = (
    ("encoder", "glue", "output", "loss", "backward", "optimizer", "metrics",
     "end")
    + tuple(f"refiner{k}" for k in range(1, MAX_LEVELS + 1))
    + tuple(f"glue{k}" for k in range(1, MAX_LEVELS + 1)))
STAGE_INDEX: Dict[str, int] = {s: i for i, s in enumerate(STAGES)}
END = "end"
MARK_NAME = re.compile(r"m4d_stage_mark<(\d+)>")
SPAN_PREFIX = "m4d#"

_NULL = contextlib.nullcontext()
_MARK_KERNEL = None


def _mark_kernel():
    global _MARK_KERNEL
    if _MARK_KERNEL is None:
        import ctypes

        from m4depth_tpu_torch.ops._build import CudaKernel

        _MARK_KERNEL = CudaKernel("mark.cu", "stage_mark",
                                  [ctypes.c_int, ctypes.c_void_p])
    return _MARK_KERNEL


def profiling() -> bool:
    """Whether a profiler records in this process."""
    return torch.autograd._profiler_enabled()


def mark(stage: str, device: torch.device) -> None:
    """Mark the start of ``stage`` on ``device``'s current stream (see the
    module's docstring for when it launches)."""
    if device.type != "cuda" or torch._C._current_autograd_node() is not None:
        return
    if not (torch.cuda.is_current_stream_capturing() or profiling()):
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    _mark_kernel().launch(STAGE_INDEX[stage], stream, device=device)


def mark_launches() -> int:
    """The mark kernel's runs on the device so far
    (``CudaKernel.launches``)."""
    return 0 if _MARK_KERNEL is None else _MARK_KERNEL.launches


def span(name: str):
    """A host span ``m4d#<name>`` while a profiler records, else a null
    context."""
    if not profiling():
        return _NULL
    return record_function(SPAN_PREFIX + name)


# -- counters --------------------------------------------------------------


def clock() -> int:
    """The counters' clock, in ns."""
    return time.perf_counter_ns()


class Counters:
    """Calls and host nanoseconds by name; a counter may split its time
    into named parts (``<part>_ns``). Not locked: the port dispatches its
    compiled steps from one thread."""

    def __init__(self):
        self._calls: Dict[str, int] = collections.Counter()
        self._ns: Dict[str, Dict[str, int]] = collections.defaultdict(
            collections.Counter)

    def add(self, name: str, ns: int, **parts: int) -> None:
        self._calls[name] += 1
        total = self._ns[name]
        total["ns"] += ns
        for part, v in parts.items():
            total[part] += v

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """{name: {"calls": n, "ns": total, "<part>_ns": ...}}."""
        return {name: dict(calls=calls, **self._ns[name])
                for name, calls in self._calls.items()}


COUNTERS = Counters()


def count(name: str, since: int) -> None:
    """One call of ``name`` that started at ``since`` (``clock()``) and
    ends now."""
    COUNTERS.add(name, clock() - since)


def count_replay(t0: int, t1: int, t2: int) -> None:
    """One replay: prepared from ``t0`` to ``t1``, launched until ``t2``,
    finished now."""
    t3 = clock()
    COUNTERS.add("compiled.replays", t3 - t0, prepare_ns=t1 - t0,
                 launch_ns=t2 - t1, finish_ns=t3 - t2)


def counters() -> Dict[str, Dict[str, int]]:
    """Every counter of this process so far (``Counters.snapshot``)."""
    return COUNTERS.snapshot()


def mean_us(snapshot: Dict[str, Dict[str, int]], name: str,
            before: Optional[Dict[str, Dict[str, int]]] = None,
            key: str = "ns") -> Optional[float]:
    """The mean host time of ``name``'s calls in us (``key`` picks a
    part), over the calls since ``before`` when given; None without
    calls."""
    now = snapshot.get(name, {})
    old = (before or {}).get(name, {})
    calls = now.get("calls", 0) - old.get("calls", 0)
    if calls <= 0:
        return None
    return 1e-3 * (now.get(key, 0) - old.get(key, 0)) / calls


# -- stage marks in a profile ------------------------------------------------


def mark_stage(name: str) -> Optional[str]:
    """The stage a device event's name marks, or None."""
    m = MARK_NAME.search(name)
    if m is None:
        return None
    i = int(m.group(1))
    return STAGES[i] if i < len(STAGES) else None


@dataclasses.dataclass
class Unit:
    """One replay (or eager call) of a marked function in a profile:
    ``stages`` in order, each (stage, span, busy) in us, its span running
    from its mark to the next one (``end``'s span is its own mark's);
    ``span_us`` from the first mark's start to ``end``'s end, which the
    stages' spans sum to; ``busy_us`` the union of device activity inside
    it; ``complete`` when its sequence of marks is the expected one."""

    stages: List[Tuple[str, float, float]]
    span_us: float
    busy_us: float
    complete: bool = True

    @property
    def sequence(self) -> Tuple[str, ...]:
        return tuple(s for s, _, _ in self.stages)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _covered(union: List[Tuple[float, float]], starts: List[float],
             a: float, b: float) -> float:
    """How much of [a, b) the sorted, disjoint ``union`` covers."""
    total = 0.0
    for s, e in union[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def units(events: Iterable[Tuple[str, float, float]],
          expected: Optional[Sequence[str]] = None) -> List[Unit]:
    """The marked units of a profile's device events ((name, start, end),
    in us, every kernel, copy and memset on the card): each run of marks
    that an ``end`` mark closes. A unit is complete when its marks are
    ``expected``, by default the sequence most units have: the profiler
    has dropped graph kernels before, and a dropped mark leaves its unit
    out of anything read from complete units. Marks after the last ``end``
    make no unit."""
    events = sorted(events, key=lambda e: e[1])
    marks = [(s, e, st) for name, s, e in events
             if (st := mark_stage(name)) is not None]
    union = _union([(s, e) for _, s, e in events])
    starts = [s for s, _ in union]
    out: List[Unit] = []
    run: List[Tuple[float, float, str]] = []
    for m in marks:
        run.append(m)
        if m[2] != END:
            continue
        stages = []
        for (s, _, st), nxt in zip(run, run[1:] + [None]):
            stop = nxt[0] if nxt is not None else m[1]
            stages.append((st, stop - s, _covered(union, starts, s, stop)))
        out.append(Unit(stages=stages, span_us=m[1] - run[0][0],
                        busy_us=sum(b for _, _, b in stages)))
        run = []
    if out:
        want = tuple(expected) if expected is not None else \
            collections.Counter(u.sequence for u in out).most_common(1)[0][0]
        for u in out:
            u.complete = u.sequence == want
    return out


def summarize(found: List[Unit]) -> Dict:
    """Means over the complete units: ``stages`` {stage: (span, busy)}
    in us summed over a unit's marks of that stage, ``span_us``,
    ``busy_us``, ``gap_pct`` (100 x (1 - busy / span)), and
    ``complete`` / ``seen`` units."""
    done = [u for u in found if u.complete]
    out: Dict = dict(complete=len(done), seen=len(found))
    if not done:
        return out
    spans: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0])
    for u in done:
        for st, sp, busy in u.stages:
            spans[st][0] += sp / len(done)
            spans[st][1] += busy / len(done)
    span = sum(u.span_us for u in done) / len(done)
    busy = sum(u.busy_us for u in done) / len(done)
    out.update(stages={k: tuple(v) for k, v in spans.items()}, span_us=span,
               busy_us=busy, gap_pct=100.0 * (1.0 - busy / span))
    return out


def stage_of_level(stage: str) -> Tuple[Optional[int], str]:
    """(level, kind) of a stage: ``refiner3`` -> (3, "refiner"),
    ``glue3`` -> (3, "glue"), any other -> (None, stage)."""
    m = re.fullmatch(r"(refiner|glue)(\d+)", stage)
    return (int(m.group(2)), m.group(1)) if m else (None, stage)

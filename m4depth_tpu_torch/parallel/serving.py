"""Multi-stream and fresh-frame serving. Counterpart of
``m4depth_tpu/parallel/serving.py``.

``sharded_stream`` serves N independent video streams batched along the
stream axis, split evenly over a list of devices, each with its own
replica of the model. The streaming step has no cross-batch terms, so the
devices never communicate (``assert_collective_free`` checks a profile of
it). On one device it is ``M4Depth.step`` at batch N: the host's launches a
frame stay those of one stream while the device does N streams' work.
Over several devices the step is dispatched from the caller's one host
thread, replica after replica, so the host issues each replica's launches
in turn. The model's step is bound by the host's launches (PERF.md), so
that split is slower than batching all N streams on one card; serving
across cards needs one process or thread a card.

``FreshFrameStream`` overlaps the next frame's host work with the current
frame's step.

Both run ``compile_step``, the counterpart of the JAX package's jitted,
state-donating step: on the card one CUDA graph a device
(``utils.graphs.Compiled``), its state held in the graph's buffers and
updated in place by each replay, as ``donate_state`` does.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.utils import tracing
from m4depth_tpu_torch.utils.graphs import Compiled, assign_

# names of the profiler events that a collective records: the c10d ops
# (c10d::allreduce_, c10d::broadcast_, ...) and the backends' own spans
# (nccl:all_reduce, gloo:all_reduce, ...)
COLLECTIVE_MARKERS = ("nccl", "gloo", "allreduce", "all_reduce",
                      "all_gather", "allgather", "broadcast",
                      "reduce_scatter")


def compile_step(model) -> Compiled:
    """``model.step`` (``M4Depth`` or ``M4DepthV1``) compiled, with its
    state donated: ``step(state, rgb, rot, trans, camera, new_traj) ->
    (state, depth)``. Counterpart of the JAX package's
    ``jit_sharded_stream`` and ``FreshFrameStream``'s jitted step.

    The step writes the new state into the ``state`` it is given and
    returns it. On the card, from the second call with one signature on,
    that is the graph's own state (pass it back: a state of another
    origin is copied in first), and ``new_traj`` is an input, so a reset
    replays the same graph. ``depth`` is a new tensor each call. The
    compiled step holds one graph for each input signature it has seen
    twice: one for a stream of frames of one shape.
    """

    def step(state, rgb, rot, trans, camera, new_traj):
        new_state, depth = model.step(state, rgb, rot, trans, camera,
                                      new_traj)
        return assign_(state, new_state), depth

    return Compiled(step)


def replicate_params(model, devices: Sequence[torch.device]) -> list:
    """One replica of ``model`` on each of ``devices``: ``model`` itself on
    its own device, a copy on each other one (two entries that name one
    device get two replicas)."""
    home = next(model.parameters()).device
    out, used_home = [], False
    for dev in map(torch.device, devices):
        if dev == home and not used_home:
            out.append(model)
            used_home = True
        else:
            out.append(copy.deepcopy(model).to(dev))
    return out


def _split(x, n: int, i: int, dev: torch.device):
    """Slice ``i`` of ``n`` equal slices of every tensor of ``x`` along its
    leading dim, on ``dev`` (tuples, NamedTuples, lists and dicts kept)."""
    if isinstance(x, torch.Tensor):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} streams do not split evenly "
                             f"over {n} devices")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per].to(dev, non_blocking=True)
    if isinstance(x, dict):
        return {k: _split(v, n, i, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_split(v, n, i, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_split(v, n, i, dev) for v in x)
    return x


def shard_stream_inputs(inputs, devices: Sequence[torch.device]) -> list:
    """``inputs`` split along the stream axis: one copy of its structure a
    device, holding that device's contiguous slice of every tensor. A slice
    along the leading dim of a contiguous tensor stays contiguous, as the
    kernels need."""
    devices = [torch.device(d) for d in devices]
    return [_split(inputs, len(devices), i, d)
            for i, d in enumerate(devices)]


def sharded_stream(model, devices: Sequence[torch.device]):
    """The streaming step over N streams split evenly over ``devices``.

    Returns ``step(state, rgb, rot, trans, camera, new_traj) -> (state,
    depth)``. ``state`` is the list of per-device model states that
    ``shard_stream_inputs(init_state(cfg, N, h, w), devices)`` makes, and
    the step returns its successor; the other inputs are whole batches of
    N streams, on any device. ``depth`` [N, h, w, 1] is in stream order on
    ``devices[0]``. N must divide by the device count. Each replica runs
    its own ``compile_step`` (one graph a device on the card), which
    updates its state shard in place.

    The replicas are stepped one after another from this thread: on a
    model bound by the host's launches, splitting over devices is slower
    than one device's batch of N.

    A call opens the host span ``serve.step`` and, around each replica's
    call, ``serve.shard``; a call in which every replica replayed its
    graph counts in the ``serve.step`` counter (``utils.tracing``).
    """
    devices = [torch.device(d) for d in devices]
    steps = [compile_step(m) for m in replicate_params(model, devices)]

    def step(state: List, rgb, rot, trans, camera: Camera, new_traj):
        t0 = tracing.clock()
        with tracing.span("serve.step"):
            out = _step(state, rgb, rot, trans, camera, new_traj)
        if all(st.replayed for st in steps):
            tracing.count("serve.step", t0)
        return out

    def _step(state: List, rgb, rot, trans, camera: Camera, new_traj):
        if len(state) != len(devices):
            raise ValueError(f"{len(state)} state shards for "
                             f"{len(devices)} devices")
        shards = shard_stream_inputs((rgb, rot, trans, camera, new_traj),
                                     devices)
        out = []
        for st, s, x in zip(steps, state, shards):
            with tracing.span("serve.shard"):
                out.append(st(s, *x))
        depths = [d for _, d in out]
        if len(depths) == 1:
            return [out[0][0]], depths[0]
        depth = torch.cat([d.to(devices[0], non_blocking=True)
                           for d in depths])
        return [s for s, _ in out], depth

    return step


class FreshFrameStream:
    """Double-buffered fresh-frame streaming on one device.

    ``push(frame t)`` copies the host frame (numpy arrays) into one of two
    pinned host buffers, issues its host-to-device copy on a side stream
    and records an event, then launches frame t-1's step (``compile_step``:
    on the card a replay of its graph, which copies the staged frame into
    its inputs) on the current stream, which waits on frame t-1's event
    first. So frame t's copy rides under frame t-1's step. It returns frame
    t-1's depth as a device tensor (``None`` on the first call);
    ``flush()`` runs the last staged frame, and a second ``flush()``
    returns ``None``.

    A pinned buffer is reused two frames later: before the host overwrites
    it, it waits for the event of the copy that read it. The device tensors
    made on the side stream are marked with ``record_stream`` for the
    current stream, so the caching allocator does not hand their blocks
    out again before the step that reads them has run.

    On a CPU device the copies are plain synchronous ones (the path the
    tests take).
    """

    def __init__(self, model, state, *, device: torch.device):
        self._step = compile_step(model)
        self._state = state
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._side = torch.cuda.Stream(self._device) if self._cuda else None
        self._host: List[Optional[list]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0
        self._staged = None  # (device tensors, event) of the last frame

    @staticmethod
    def _arrays(rgb, rot, trans, camera, new_traj) -> list:
        return [np.asarray(a) for a in (rgb, rot, trans, camera.f, camera.c,
                                        new_traj)]

    def _stage(self, arrays: list):
        if not self._cuda:
            return [torch.from_numpy(np.array(a)).to(self._device)
                    for a in arrays], None
        k = self._slot
        self._slot ^= 1
        if self._copied[k] is not None:
            self._copied[k].synchronize()  # the copy two frames ago read it
        if self._host[k] is None:
            self._host[k] = [torch.empty(a.shape, pin_memory=True,
                                         dtype=torch.from_numpy(a).dtype)
                             for a in arrays]
        for buf, a in zip(self._host[k], arrays):
            buf.copy_(torch.from_numpy(a))
        main = torch.cuda.current_stream(self._device)
        with torch.cuda.stream(self._side):
            dev = [buf.to(self._device, non_blocking=True)
                   for buf in self._host[k]]
            event = torch.cuda.Event()
            event.record(self._side)
        for t in dev:
            t.record_stream(main)
        self._copied[k] = event
        return dev, event

    def _run(self, staged):
        dev, event = staged
        if event is not None:
            torch.cuda.current_stream(self._device).wait_event(event)
        rgb, rot, trans, f, c, new_traj = dev
        self._state, depth = self._step(
            self._state, rgb, rot, trans, Camera(f, c), new_traj)
        return depth

    def push(self, rgb, rot, trans, camera: Camera, new_traj):
        """Stage frame t and run frame t-1's step; returns frame t-1's
        depth, or ``None`` on the first call."""
        staged = self._stage(self._arrays(rgb, rot, trans, camera,
                                          new_traj))
        depth = self._run(self._staged) if self._staged is not None else None
        self._staged = staged
        return depth

    def flush(self):
        """Run the step of the last staged frame; returns its depth, or
        ``None`` when nothing is staged."""
        if self._staged is None:
            return None
        depth = self._run(self._staged)
        self._staged = None
        return depth

    @property
    def state(self):
        """The model state after the last step run (a staged frame is not
        in it until the next push or flush)."""
        return self._state


def assert_collective_free(prof) -> None:
    """Serving steps must not communicate: raise if any event of the
    ``torch.profiler`` trace ``prof`` is a collective. ATen's own ops
    (``aten::broadcast_tensors``) are not collectives and are passed
    over."""
    for evt in prof.events():
        name = evt.name.lower()
        if name.startswith("aten::"):
            continue
        for marker in COLLECTIVE_MARKERS:
            if marker in name:
                raise AssertionError(
                    f"the serving trace holds a collective: {evt.name}")

"""Compiled programs on the card: the port's counterpart of ``jax.jit``
with ``donate_argnums``.

The JAX package never dispatches its model op by op: every entry point
wraps a frame or a step in ``jax.jit``, and most donate the state so that
it is updated in place. On an NVIDIA GPU the counterpart is a CUDA graph,
captured once per input signature and replayed: one launch from the host
for the whole program. :class:`Compiled` wraps a function of tensors so:

* on CUDA tensors, the first call with a new signature (the shape,
  strides, dtype and device of every tensor, and every other argument)
  runs the function eagerly on a side stream, its warm-up, as
  ``torch.cuda.graph``'s whole-network recipe does (cuDNN's plans, cuBLAS'
  workspace, the kernels' build and their shared-memory attributes are
  made then, not under capture), and returns that run's result. The second
  call captures one ``torch.cuda.CUDAGraph`` on the same stream, into the
  graph's private memory pool, over static copies of the arguments; from
  then on each call copies its arguments into those buffers and replays.
  A failed capture raises: nothing falls back to eager on the card;
* on CPU tensors it calls the function: the CPU has no graphs, as the
  kernels' wrappers run their plain versions there.

Donation: a function that updates an argument in place and returns it
(``assign_``) returns, on the card, the graph's own buffer for it, which
the next replay updates in place; passed back, it is not copied. Every
other output is copied out of the graph's buffers after each replay, so
nothing the caller holds is overwritten by a later one.

Kernel launches (``ops._build.CudaKernel.launches``) count device runs: a
capture records its launches and adds none, and each replay adds them.

Tracing (``utils.tracing``): a replay has no Python stack and makes no
host call per node, so the model's stages are marked by kernels captured
into the graph, and every captured function ends with an ``end`` mark, so
that a replay's marks bracket the whole graph.
``utils.profiling.device_breakdown`` attributes a
profile's device time by those marks, replays included. Each call opens
the host spans ``compiled.signature``, then ``compiled.copy_in``,
``compiled.launch`` and ``compiled.copy_out`` for a replay, or
``compiled.warm_up`` or ``compiled.capture``, and adds its host time to
the counters ``compiled.replays`` (prepare, launch, finish),
``compiled.warmups`` or ``compiled.captures``; ``replayed`` says whether
the last call replayed a graph.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from m4depth_tpu_torch.ops import _build
from m4depth_tpu_torch.utils import tracing


def assign_(dst: Any, src: Any) -> Any:
    """Copy every tensor of ``src`` into the tensor at the same place of
    ``dst`` (tuples, NamedTuples, lists and dicts of the same structure);
    returns ``dst``. A compiled function donates an argument so: it
    returns the argument, updated in place."""
    dst_leaves, dst_spec = tree_flatten(dst)
    src_leaves, src_spec = tree_flatten(src)
    if dst_spec != src_spec:
        raise ValueError(f"assign_: structures differ: {dst_spec} and "
                         f"{src_spec}")
    for d, s in zip(dst_leaves, src_leaves):
        if isinstance(d, torch.Tensor) and d is not s:
            d.copy_(s)
    return dst


def _signature(leaves: List[Any]):
    """The key a graph is captured for, and the inputs' CUDA device (None
    when every tensor lies on the CPU). Raises on a mix of devices."""
    sig, devices = [], set()
    for x in leaves:
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.stride(), x.dtype, x.device))
            devices.add(x.device)
        else:
            sig.append(x)
    if len(devices) > 1:
        raise ValueError("compiled function: tensors on "
                         f"{sorted(map(str, devices))}; give it tensors "
                         "of one device")
    device = devices.pop() if devices else None
    return tuple(sig), (device if device is not None
                        and device.type == "cuda" else None)


class _Graph:
    """One capture: the graph, its static inputs and outputs, and the
    kernel launches a replay runs."""

    def __init__(self, graph, static: List[Any], out: List[Any], out_spec,
                 launches):
        self.graph = graph
        self.static = static
        self.out_spec = out_spec
        self.launches = launches
        ids = {id(s) for s in static if isinstance(s, torch.Tensor)}
        # an output that is an argument's static buffer is that argument,
        # donated; every other tensor is copied out after a replay
        self.out = [(o, isinstance(o, torch.Tensor) and id(o) not in ids)
                    for o in out]

    def replay(self, leaves: List[Any], t0: Optional[int] = None):
        """Copy ``leaves`` in, replay, copy the outputs out; with ``t0``
        (the call's start on ``tracing.clock``) count the replay."""
        with tracing.span("compiled.copy_in"):
            for s, x in zip(self.static, leaves):
                if isinstance(s, torch.Tensor) and x is not s:
                    s.copy_(x)
        t1 = tracing.clock()
        with tracing.span("compiled.launch"):
            self.graph.replay()
        t2 = tracing.clock()
        with tracing.span("compiled.copy_out"):
            _build.add_launches(self.launches)
            out = tree_unflatten([o.clone() if copy else o
                                  for o, copy in self.out], self.out_spec)
        if t0 is not None:
            tracing.count_replay(t0, t1, t2)
        return out


class Compiled:
    """``fn`` (a function of tensors, tuples, NamedTuples, lists and dicts
    of them, and of plain values) as a CUDA graph per input signature on
    the card, and as itself on the CPU; see the module's docstring.

    ``graphs`` is the number of graphs captured so far: one for each
    signature called more than once.
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self._warm = set()
        self._graphs: Dict[Any, _Graph] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.replayed = False

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> int:
        """Device memory held by the graphs' private pools (the segments
        the caching allocator reserved for them): a frame's or a step's
        intermediates, kept for the graphs' lifetime."""
        pools = {tuple(g.graph.pool()) for g in self._graphs.values()}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id") or ()) in pools)

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def __call__(self, *args):
        t0 = tracing.clock()
        self.replayed = False
        with tracing.span("compiled.signature"):
            leaves, spec = tree_flatten(args)
            sig, device = _signature(leaves)
            if device is not None:
                key = (str(spec), sig)
                graph = self._graphs.get(key)
        if device is None:
            return self.fn(*args)
        if graph is not None:
            out = graph.replay(leaves, t0)
            self.replayed = True
            return out
        if key not in self._warm:
            self._warm.add(key)
            with tracing.span("compiled.warm_up"):
                out = self._warm_up(args, device)
            tracing.count("compiled.warmups", t0)
            return out
        with tracing.span("compiled.capture"):
            graph = self._graphs[key] = self._capture(leaves, spec, device)
            out = graph.replay(leaves)
        tracing.count("compiled.captures", t0)
        return out

    def _run(self, args, device: torch.device):
        """The function, then the ``end`` mark."""
        out = self.fn(*args)
        tracing.mark(tracing.END, device)
        return out

    def _warm_up(self, args, device: torch.device):
        main = torch.cuda.current_stream(device)
        side = self._stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._run(args, device)
        main.wait_stream(side)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor) and o.device == device:
                # made on the side stream, read on the current one
                o.record_stream(main)
        return out

    def _capture(self, leaves: List[Any], spec, device: torch.device
                 ) -> _Graph:
        static = [x.clone() if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as launches, \
                torch.cuda.graph(graph, stream=self._stream(device)):
            out = self._run(tree_unflatten(static, spec), device)
        out_leaves, out_spec = tree_flatten(out)
        return _Graph(graph, static, out_leaves, out_spec, launches)

"""The cost volumes' work, counted from their shapes: the bytes each call
must move (each input read once, each output written once) and the
operations it does. ``chip_smoke.py`` divides them by the card's peak rates
for the kernels' bounds; ``utils.profiling.compiled_cost`` adds them to
what it counts of the other ops.

``counting()`` opens a :class:`CostCount`; while one is open, each call of
``spatial_cost_volume_fused`` or ``parallax_sweeping_cv_fused`` adds its
forward's work once, and its backward's once when autograd runs it, on
the CPU (the plain versions) as on the card (the kernels). A counter of
aten ops asks ``CostCount.owns_current_op()`` to leave out the ops such a
call runs: the plain version's, or the wrapper's casts and allocations
around a kernel, in the forward and in the backward. With no count open
the wrappers do nothing more than before.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Iterable, List, Tuple

import torch

Work = Tuple[float, float]          # (bytes, operations)


def sncv_forward_work(n_pix: int, C: int, cuts: int, radius: int,
                      itemsize: int, same: bool) -> Work:
    """The feature maps read (one when c1 is c2), (2r+1)^2 * cuts float32
    written a pixel; one multiply-add per channel and offset, one compare
    per output."""
    n_off = (2 * radius + 1) ** 2
    n_in = 1 if same else 2
    return (n_pix * (n_in * C * itemsize + n_off * cuts * 4),
            n_pix * n_off * (2 * C + cuts))


def sncv_backward_work(n_pix: int, C: int, cuts: int, radius: int,
                       itemsize: int, same: bool) -> Work:
    """g and the forward's output (float32) and the feature maps read, their
    gradients (one when c1 is c2) written; per offset and channel two
    multiply-adds, per output gradient a select and a scale."""
    n_off = (2 * radius + 1) ** 2
    n_in = 1 if same else 2
    return (n_pix * (2 * n_off * cuts * 4 + 2 * n_in * C * itemsize),
            n_pix * n_off * (4 * C + 2 * cuts))


def dscv_forward_work(n_pix: int, C: int, cuts: int, search_range: int,
                      itemsize: int) -> Work:
    """c1, c2 and the previous parallax in the cost-volume dtype and the
    float32 centre read, (2r+1) * cuts + 1 float32 written a pixel. Per
    hypothesis and channel 3 lerps (2 operations each) and a multiply-add;
    ~40 operations of geometry per hypothesis and cut."""
    s = 2 * search_range + 1
    return (n_pix * ((2 * C + 1) * itemsize + 4 + (s * cuts + 1) * 4),
            n_pix * s * (8 * C + 40 * cuts))


def dscv_backward_work(n_pix: int, C: int, cuts: int, search_range: int,
                       itemsize: int) -> Work:
    """The forward's inputs, dcv and dpara_out read; dc1, dc2 (cost-volume
    dtype) and dcentre written. Per hypothesis and channel ~27 operations
    (the sample, its two position derivatives, four corner weights and
    adds, the dc1 sum); ~40 operations of geometry per hypothesis."""
    s = 2 * search_range + 1
    return (n_pix * ((2 * C + 1) * itemsize + 4 + (s * cuts + 1) * 4
                     + 2 * C * itemsize + 4),
            n_pix * s * (27 * C + 40))


class CostCount:
    """The work of the cost-volume calls made while it is open: ``bytes``
    and ``flops`` in all, and ``calls`` by name (``sncv_forward`` ...).
    ``inside`` is above zero while such a call's forward runs; ``nodes``
    holds the autograd nodes such calls made."""

    def __init__(self):
        self.bytes = 0.0
        self.flops = 0.0
        self.calls = collections.Counter()
        self.inside = 0
        self.nodes = set()

    def add(self, name: str, work: Work) -> None:
        self.bytes += work[0]
        self.flops += work[1]
        self.calls[name] += 1

    def owns_current_op(self) -> bool:
        """Whether the op running now is a counted call's: inside its
        forward, or run by autograd for one of its nodes (the node's
        backward, and autograd's sum of the gradients the node passes
        on)."""
        if self.inside:
            return True
        node = torch._C._current_autograd_node()
        return node is not None and node in self.nodes


# the counts open, innermost last: autograd runs a CUDA backward on a
# thread of its own, so this is not thread-local
_open: List[CostCount] = []


@contextlib.contextmanager
def counting():
    """Open a :class:`CostCount` for the calls made inside the block."""
    count = CostCount()
    _open.append(count)
    try:
        yield count
    finally:
        _open.remove(count)


def _graph_nodes(outputs: Iterable[torch.Tensor],
                 inputs: Iterable[torch.Tensor]) -> list:
    """The autograd nodes between ``outputs`` and ``inputs``: those the
    call made."""
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    todo = [t.grad_fn for t in outputs if t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        # an AccumulateGrad (it has ``variable``) belongs to a leaf input
        if node in seen or node in stop or hasattr(node, "variable"):
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions if n is not None)
    return list(seen)


def _unchanged(outputs):
    return outputs


@contextlib.contextmanager
def counted_call(name: str, work: Callable[[], Tuple[Work, Work]],
                 inputs: Iterable[torch.Tensor]):
    """Count one cost-volume call in the innermost open count, if any:
    ``work()`` gives its forward's and its backward's work.

    Yields ``done(outputs)``, which the caller applies to its outputs: it
    records the autograd nodes the call made, and hooks them so that the
    first of them to run adds the backward's work."""
    if not _open:
        yield _unchanged
        return
    count = _open[-1]
    forward, backward = work()
    count.add(f"{name}_forward", forward)
    inputs = list(inputs)

    def done(outputs):
        outs = outputs if isinstance(outputs, tuple) else (outputs,)
        nodes = _graph_nodes(outs, inputs)
        count.nodes.update(nodes)
        counted = []

        def pre(*_):
            if not counted:
                counted.append(True)
                count.add(f"{name}_backward", backward)

        for node in nodes:
            node.register_prehook(pre)
        return outputs

    count.inside += 1
    try:
        yield done
    finally:
        count.inside -= 1

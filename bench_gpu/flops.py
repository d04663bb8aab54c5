"""The model's work counted from the configuration's shapes, the same
whatever implements it: each conv as 2 * 9 * Cin * Cout * Hout * Wout, and
each cost-volume call by the formulas of ``m4depth_tpu_torch/ops/cost.py``
(frozen here: bytes each input read once and each output written once,
operations as the algorithm needs them). Elementwise work is not counted.

The H100's published peaks (NVIDIA's data sheet, SXM, dense, at 700 W)
are kept here too, for the rooflines and the shares of peak.
"""

from __future__ import annotations

from typing import List, Tuple

from bench_gpu.reference.m4depth import convs, cuts, level_hw

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}

Work = Tuple[float, float]          # (bytes, operations)


# -- the cost volumes (frozen copy of ops/cost.py's formulas) -----------------


def sncv_forward_work(n_pix, C, cuts_, radius, itemsize, same) -> Work:
    n_off = (2 * radius + 1) ** 2
    n_in = 1 if same else 2
    return (n_pix * (n_in * C * itemsize + n_off * cuts_ * 4),
            n_pix * n_off * (2 * C + cuts_))


def sncv_backward_work(n_pix, C, cuts_, radius, itemsize, same) -> Work:
    n_off = (2 * radius + 1) ** 2
    n_in = 1 if same else 2
    return (n_pix * (2 * n_off * cuts_ * 4 + 2 * n_in * C * itemsize),
            n_pix * n_off * (4 * C + 2 * cuts_))


def dscv_forward_work(n_pix, C, cuts_, radius, itemsize) -> Work:
    s = 2 * radius + 1
    return (n_pix * ((2 * C + 1) * itemsize + 4 + (s * cuts_ + 1) * 4),
            n_pix * s * (8 * C + 40 * cuts_))


def dscv_backward_work(n_pix, C, cuts_, radius, itemsize) -> Work:
    s = 2 * radius + 1
    return (n_pix * ((2 * C + 1) * itemsize + 4 + (s * cuts_ + 1) * 4
                     + 2 * C * itemsize + 4),
            n_pix * s * (27 * C + 40))


def bound_s(work: Work) -> float:
    """The least time of a cost-volume call on the card: its bytes at the
    memory's rate or its float32 operations at the CUDA cores' rate,
    whichever is longer (the kernels compute in float32)."""
    return max(work[0] / PEAK_BYTES, work[1] / PEAK_FP32_FLOPS)


# -- a frame ------------------------------------------------------------------


def cv_calls(cfg: dict, batch: int, h: int, w: int
             ) -> List[Tuple[str, tuple]]:
    """The cost-volume calls of one frame that runs its cost volumes, as
    (kind, arguments of the work formulas without the direction)."""
    item = DTYPE_BYTES[cfg["cv_dtype"]]
    out = []
    for i, ch in enumerate(cfg["encoder_channels"][: cfg["num_levels"]]):
        hl, wl = level_hw(h, w, i)
        n = batch * hl * wl
        if cfg["family"] == "m4depth":
            k = cuts(i + 1)
            out.append(("dscv", (n, ch, k, cfg["search_range"], item)))
            out.append(("sncv", (n, ch, k, cfg["sncv_search_range"], item,
                                 True)))
        else:
            out.append(("sncv", (n, ch, 1, cfg["search_range"], item, False)))
    return out


def conv_flops(cfg: dict, batch: int, h: int, w: int,
               encoder_only: bool = False) -> float:
    """2 * 9 * Cin * Cout * Hout * Wout over a frame's convs (only the
    encoder's with ``encoder_only``)."""
    total = 0.0
    for name, cin, cout, stride in convs(cfg):
        if encoder_only and not name.startswith("encoder."):
            continue
        part = name.split(".")
        if part[0] == "encoder":
            i = int(part[2])
            # M4Depth: the stride-1 conv runs at the level's input size;
            # V1: it follows the stride-2 one, at the level's output size
            if stride == 2 or cfg["family"] == "m4depth-v1":
                hl, wl = level_hw(h, w, i)
            else:
                hl, wl = (h, w) if i == 0 else level_hw(h, w, i - 1)
        else:
            hl, wl = level_hw(h, w, int(part[1]))
        total += 2 * 9 * cin * cout * hl * wl * batch
    return total


def cv_forward(cfg, batch, h, w) -> Tuple[float, float]:
    """(operations, bound in s) of a frame's cost-volume forwards."""
    ops = bound = 0.0
    for kind, args in cv_calls(cfg, batch, h, w):
        work = (dscv_forward_work(*args) if kind == "dscv"
                else sncv_forward_work(*args))
        ops += work[1]
        bound += bound_s(work)
    return ops, bound


def cv_backward(cfg, batch, h, w) -> Tuple[float, float]:
    ops = bound = 0.0
    for kind, args in cv_calls(cfg, batch, h, w):
        work = (dscv_backward_work(*args) if kind == "dscv"
                else sncv_backward_work(*args))
        ops += work[1]
        bound += bound_s(work)
    return ops, bound


def serve_frame(cfg: dict, batch: int, h: int, w: int) -> dict:
    """A streamed frame of ``batch`` streams: its model FLOPs and its
    cost volumes' bound in s."""
    cv_ops, cv_bound = cv_forward(cfg, batch, h, w)
    return dict(flops=conv_flops(cfg, batch, h, w) + cv_ops,
                cv_bound_s=cv_bound)


def train_step(cfg: dict, batch: int, T: int, h: int, w: int) -> dict:
    """A training step on a [batch, T] window: the forward counted three
    times (the forward and a backward of twice it), no recomputation. A
    window's frame 0 runs M4Depth's encoder alone (no decoder level has a
    previous frame), V1's whole frame. The cost volumes' bound: each
    call's forward and its backward."""
    full = conv_flops(cfg, batch, h, w)
    first = (conv_flops(cfg, batch, h, w, encoder_only=True)
             if cfg["family"] == "m4depth" else full)
    cv_frames = T - 1 if cfg["family"] == "m4depth" else T
    fops, fbound = cv_forward(cfg, batch, h, w)
    _, bbound = cv_backward(cfg, batch, h, w)
    forward = first + (T - 1) * full + cv_frames * fops
    return dict(flops=3.0 * forward, cv_bound_s=cv_frames * (fbound + bbound))

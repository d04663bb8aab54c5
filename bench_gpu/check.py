"""The numbers that decide ``correct``: what the timed path produced,
against the float32 reference on the same inputs and weights.

Serving (``depth_error``): the relative error of every pixel's depth,
|got - want| / |want|; for each camera its 99th percentile over every
pixel of its trajectory's frames; the largest of those over the cameras,
so that a fault in one camera's slot of the batch shows. The number
compared, ``depth_err_ratio``, divides the program's by the same error of
the reference computed at the configuration's own precision (its convs
and cost volumes rounded to bfloat16) on the same frames: the random
weights of some seeds make every precision's error several times that of
others, in the program and the references alike, and the ratio is steady
from seed to seed. A depth that is not finite makes it infinite.

Training (``train_gaps``): the first step's loss, as a relative gap (the
later steps' are printed: Adam moves every weight by about the learning
rate on the sign of its gradient, so rounding-sized gradients part the two
sides by then); the first step's gradient and the parameters' change over
the checked steps, each leaf's norm against the reference's, as
|norm_got - norm_want| over the larger of the reference leaf's norm and the
median leaf's: the worst leaf and the median leaf. Leaves whose reference
gradient is under LEAF_FLOOR of the median leaf's (a bias that a
normalisation after it cancels) are left out.

``judge`` holds each number to its limit from ``workloads/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

LEAF_FLOOR = 1e-3


def _p99(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The 99th percentile (nearest rank) along ``dim``."""
    return x.kthvalue(math.ceil(0.99 * x.shape[dim]), dim=dim).values


def depth_error(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]
                ) -> float:
    """``pairs`` of (got, want) depths of one camera, [frames, h, w, 1]:
    the largest over the cameras of each one's 99th percentile of the
    relative error (infinite where ``got`` is not finite)."""
    cams, worst = [], 0.0
    for got, want in pairs:
        g, r = got.double().flatten(1), want.double().flatten(1)
        if not bool(torch.isfinite(r).all()):
            raise RuntimeError("the reference's depth is not finite")
        if not bool(torch.isfinite(g).all()):
            return math.inf
        rel = ((g - r).abs() / r.abs().clamp(min=1e-12)).float()
        cams.append(_p99(rel.flatten()).item())
        worst = max(worst, _p99(rel, 1).max().item())
    print("cameras' 99th percentiles " + " ".join(f"{x:.6f}" for x in cams)
          + f"; the worst frame's {worst:.6f}", flush=True)
    return max(cams)


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: List[str]) -> Tuple[float, str, float]:
    """Each kept leaf's |norm_got - norm_want| / max(norm_want, the median
    leaf's norm_want): the largest, its leaf, and the median."""
    norms = {k: want[k].double().norm().item() for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    gaps = {}
    for k in keep:
        n_got = got[k].double().norm().item()
        gaps[k] = (abs(n_got - norms[k]) / max(norms[k], median)
                   if math.isfinite(n_got) else math.inf)
    name = max(gaps, key=gaps.get)
    return gaps[name], name, sorted(gaps.values())[len(gaps) // 2]


def train_gaps(losses: List[float], ref_losses: List[float],
               grads: Dict[str, torch.Tensor],
               ref_grads: Dict[str, torch.Tensor],
               change: Dict[str, torch.Tensor],
               ref_change: Dict[str, torch.Tensor]) -> Dict[str, float]:
    norms = {k: g.double().norm().item() for k, g in ref_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    keep = [k for k, n in norms.items() if n >= LEAF_FLOOR * median]
    gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(losses, ref_losses)]
    grad_gap, grad_leaf, grad_med = _leaf_gap(grads, ref_grads, keep)
    change_gap, change_leaf, _ = _leaf_gap(change, ref_change, keep)
    print(f"leaves compared {len(keep)} of {len(norms)}; worst gradient "
          f"leaf {grad_leaf}, worst change leaf {change_leaf}; the steps' "
          f"loss gaps {gaps}", flush=True)
    return dict(loss_rel_gap=gaps[0], grad_norm_gap=grad_gap,
                grad_norm_gap_median=grad_med, change_norm_gap=change_gap)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (and every limit's number given)."""
    return all(name in numbers and numbers[name] <= limit
               for name, limit in limits.items())

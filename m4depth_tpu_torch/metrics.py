"""Depth evaluation metrics with running-mean accumulation. Counterpart of
``m4depth_tpu/metrics.py``.

Seven masked metrics (AbsRel, SqRel, RMSE, RMSE_log, delta<1.25^{1,2,3}),
each one scalar per batch (mask gt > 1e-6) and averaged uniformly over
update steps. The eval protocol clips gt to [0, 80] and estimates to
[0.001, 80] before scoring.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

METRIC_NAMES = ("AbsRel", "SqRel", "RMSE", "RMSE_log", "Delta1", "Delta2",
                "Delta3")


def _masked_mean(err: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    mask = (gate > 1e-6).float()
    # a masked-off entry contributes 0 even where err is not finite
    prod = torch.where(mask > 0, err * mask, torch.zeros_like(err))
    return torch.sum(prod) / torch.clamp(torch.sum(mask), min=1.0)


def compute_metrics(gt: torch.Tensor, est: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Seven 0-d metrics for one batch; gt == 0 pixels are masked out."""
    gt = gt.float()
    est = est.float()
    out = {}
    out["AbsRel"] = _masked_mean(torch.abs(gt - est) / (gt + 1e-6), gt)
    out["SqRel"] = _masked_mean(torch.square(gt - est) / (gt + 1e-6), gt)
    out["RMSE"] = torch.sqrt(_masked_mean(torch.square(gt - est), gt))
    # RMSE_log gates on the *logged* gt (> 1e-6, so gt > ~1 m), as the
    # reference does
    lt, lp = torch.log(gt + 1e-6), torch.log(est + 1e-6)
    out["RMSE_log"] = torch.sqrt(_masked_mean(torch.square(lt - lp), lt))
    thresh = torch.maximum(gt / torch.clamp(est, min=1e-12),
                           est / torch.clamp(gt, min=1e-12))
    for k in (1, 2, 3):
        out[f"Delta{k}"] = _masked_mean((thresh < 1.25 ** k).float(), gt)
    return out


def clip_for_eval(gt: torch.Tensor, est: torch.Tensor,
                  max_depth: float = 80.0):
    """The eval protocol's clipping of gt and estimate."""
    return torch.clamp(gt, 0.0, max_depth), torch.clamp(est, 0.001, max_depth)


class MetricAccumulator(NamedTuple):
    """Uniform-over-steps running means, held as tensors (no host sync).

    ``update`` returns a new accumulator; ``weight`` 0 skips a step (a
    ``new_traj`` frame in streaming eval).
    """

    totals: torch.Tensor  # [7]
    count: torch.Tensor   # []

    @classmethod
    def zeros(cls, device=None) -> "MetricAccumulator":
        return cls(totals=torch.zeros(len(METRIC_NAMES), device=device),
                   count=torch.zeros((), device=device))

    def update(self, metrics: Dict[str, torch.Tensor],
               weight: Union[torch.Tensor, float] = 1.0
               ) -> "MetricAccumulator":
        vec = torch.stack([metrics[name].float() for name in METRIC_NAMES])
        # a plain weight is filled on the device: no host-to-device copy,
        # which a CUDA graph's capture could not hold
        w = (weight.to(torch.float32) if isinstance(weight, torch.Tensor)
             else torch.full((), float(weight), device=vec.device))
        # a skipped frame must add nothing even if its metrics are not
        # finite: NaN * 0 is NaN and would poison the totals for good
        vec = torch.where(w > 0, vec * w, torch.zeros_like(vec))
        return MetricAccumulator(totals=self.totals + vec,
                                 count=self.count + w)

    def result(self) -> Dict[str, torch.Tensor]:
        means = self.totals / torch.clamp(self.count, min=1.0)
        return {name: means[i] for i, name in enumerate(METRIC_NAMES)}

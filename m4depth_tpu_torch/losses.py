"""Training loss. Counterpart of ``m4depth_tpu/losses.py``.

L1 on log-depth ``log(clip(d, 0.01, 200))``, pyramid level i (finest first)
weighted ``0.64 / 2**(i-1)``, averaged over frames 1..T-1; the "velodyne"
variant block-pools sparse ground truth with hole-aware masked means.
"""

from __future__ import annotations

from typing import Sequence

import torch

from m4depth_tpu_torch.geometry.resize import resize_bilinear


def _preprocess(d: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(d, 0.01, 200.0))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None
                 ) -> torch.Tensor:
    if dim is None:
        return torch.sum(x * mask) / (torch.sum(mask) + 1e-12)
    return torch.sum(x * mask, dim=dim) / (torch.sum(mask, dim=dim) + 1e-12)


def m4depth_loss(gt_depth_seq: torch.Tensor, preds: Sequence[Sequence],
                 depth_type: str = "map") -> torch.Tensor:
    """Sequence loss over frames 1..T-1 (frame 0 has no temporal context).

    Args:
      gt_depth_seq: [b, T, H, W, 1] ground-truth depth (0 = hole for
        velodyne).
      preds: per frame, the pyramid of level estimates, finest first (each
        has a ``depth`` [b, h, w, 1]).
    """
    T = gt_depth_seq.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=gt_depth_seq.device)
    for t in range(1, T):
        gt = gt_depth_seq[:, t].float()
        gt_log = _preprocess(gt)
        b, hg, wg = gt.shape[:3]
        for i, pred in enumerate(preds[t]):
            pd = _preprocess(pred.depth)
            h, w = pd.shape[1:3]
            weight = 0.64 / (2.0 ** (i - 1))
            if depth_type == "velodyne":
                if hg % h or wg % w:
                    raise ValueError(
                        f"velodyne loss requires the gt resolution "
                        f"({hg}x{wg}) to be an integer multiple of every "
                        f"level resolution (got {h}x{w})")
                blocks = (b, h, hg // h, w, wg // w, 1)
                mask = (gt.reshape(blocks) > 0).float()
                gt_resized = _masked_mean(gt_log.reshape(blocks), mask,
                                          dim=(2, 4))
                valid = (torch.sum(mask, dim=(2, 4)) > 0).float()
                term = weight * _masked_mean(torch.abs(gt_resized - pd), valid)
            else:
                gt_resized = resize_bilinear(gt_log, (h, w))
                term = weight * torch.mean(torch.abs(gt_resized - pd))
            total = total + term / float(T - 1)
    return total


def l1_param_regularization(model: torch.nn.Module,
                            weight: float) -> torch.Tensor:
    """Optional L1 kernel regularization: ``weight`` times the sum of |x|
    over the parameters that the JAX tree holds with two or more
    dimensions: the conv kernels and the domain norm's scale and bias
    (``[1, 1, 1, C]`` there, ``[C]`` here)."""
    leaves = [p for name, p in model.named_parameters()
              if p.dim() >= 2 or ".dinl." in f".{name}"]
    if weight == 0.0:
        return torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    return weight * sum(p.abs().sum() for p in leaves)

"""Image resizing in the reference's TF conventions, on [b, h, w, c].

Counterpart of ``m4depth_tpu/geometry/resize.py``:
  * ``resize_bilinear_v1``: TFv1 ``resize_bilinear`` grid, src = dst*scale
    with NO half-pixel offset (used between decoder levels).
    ``F.interpolate`` has no mode that reproduces it.
  * ``resize_bilinear``: TF2 bilinear, half-pixel centres, no antialias.
  * ``resize_nearest``: TF2 nearest, src = floor((dst + 0.5) * scale).
All three are separable gather + lerp, as in the JAX code.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _lerp_axis(x: torch.Tensor, axis: int, dst: int,
               half_pixel: bool) -> torch.Tensor:
    """Linear-resample one axis; ``half_pixel`` selects the TF2 grid."""
    src = x.shape[axis]
    if src == dst:
        return x
    scale = src / dst
    out = torch.arange(dst, dtype=torch.float32, device=x.device)
    pos = (out + 0.5) * scale - 0.5 if half_pixel else out * scale
    pos = torch.clamp(pos, 0.0, float(src - 1))
    lo = torch.clamp(torch.floor(pos).long(), max=src - 1)
    hi = torch.clamp(lo + 1, max=src - 1)
    shape = [1] * x.dim()
    shape[axis] = dst
    frac = (pos - lo.float()).reshape(shape).to(x.dtype)
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, hi)
    return a + (b - a) * frac


def _nearest_axis(x: torch.Tensor, axis: int, dst: int) -> torch.Tensor:
    src = x.shape[axis]
    if src == dst:
        return x
    scale = src / dst
    idx = torch.floor(
        (torch.arange(dst, dtype=torch.float32, device=x.device) + 0.5) * scale)
    idx = torch.clamp(idx, 0, src - 1).long()
    return torch.index_select(x, axis, idx)


def resize_bilinear_v1(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Legacy TFv1 ``resize_bilinear`` (align_corners=False): src = dst*scale."""
    h, w = size
    return _lerp_axis(_lerp_axis(x, 1, h, half_pixel=False), 2, w,
                      half_pixel=False)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF2 bilinear (half-pixel centres, no antialias)."""
    h, w = size
    return _lerp_axis(_lerp_axis(x, 1, h, half_pixel=True), 2, w,
                      half_pixel=True)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF2 nearest neighbour (half-pixel floor)."""
    h, w = size
    return _nearest_axis(_nearest_axis(x, 1, h), 2, w)

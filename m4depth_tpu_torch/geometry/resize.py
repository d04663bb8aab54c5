"""Image resizing in the reference's TF conventions, on [b, h, w, c].

Counterpart of ``m4depth_tpu/geometry/resize.py``:
  * ``resize_bilinear_v1``: TFv1 ``resize_bilinear`` grid, src = dst*scale
    with NO half-pixel offset (used between decoder levels).
    ``F.interpolate`` has no mode that reproduces it. Its transpose,
    ``resize_bilinear_v1_transpose``, is the decoder glue's plain backward.
  * ``resize_bilinear``: TF2 bilinear, half-pixel centres, no antialias.
  * ``resize_nearest``: TF2 nearest, src = floor((dst + 0.5) * scale).
All three are separable gather + lerp, as in the JAX code.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _taps(x: torch.Tensor, axis: int, src: int, dst: int,
          half_pixel: bool):
    """The two source taps of each of ``dst`` outputs along ``axis``, and
    the second's weight, shaped to broadcast against ``x``."""
    scale = src / dst
    out = torch.arange(dst, dtype=torch.float32, device=x.device)
    pos = (out + 0.5) * scale - 0.5 if half_pixel else out * scale
    pos = torch.clamp(pos, 0.0, float(src - 1))
    lo = torch.clamp(torch.floor(pos).long(), max=src - 1)
    hi = torch.clamp(lo + 1, max=src - 1)
    shape = [1] * x.dim()
    shape[axis] = dst
    return lo, hi, (pos - lo.float()).reshape(shape).to(x.dtype)


def _lerp_axis(x: torch.Tensor, axis: int, dst: int,
               half_pixel: bool) -> torch.Tensor:
    """Linear-resample one axis; ``half_pixel`` selects the TF2 grid."""
    src = x.shape[axis]
    if src == dst:
        return x
    lo, hi, frac = _taps(x, axis, src, dst, half_pixel)
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, hi)
    return a + (b - a) * frac


def _lerp_axis_transpose(g: torch.Tensor, axis: int, src: int,
                         half_pixel: bool) -> torch.Tensor:
    """The transpose of ``_lerp_axis`` to ``src`` entries along ``axis``:
    each output's ``g`` added to its taps at their weights."""
    dst = g.shape[axis]
    if src == dst:
        return g
    lo, hi, frac = _taps(g, axis, src, dst, half_pixel)
    shape = list(g.shape)
    shape[axis] = src
    out = torch.zeros(shape, dtype=g.dtype, device=g.device)
    out.index_add_(axis, lo, g - g * frac)
    return out.index_add_(axis, hi, g * frac)


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


def resize_bilinear_v1_transpose(g: torch.Tensor,
                                 size: Sequence[int]) -> torch.Tensor:
    """The transpose of ``resize_bilinear_v1`` from ``size`` to ``g``'s
    size: the gradient of its input from ``g``, that of its output."""
    h, w = size
    return _lerp_axis_transpose(_lerp_axis_transpose(g, 2, w, False), 1, h,
                                False)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF2 bilinear (half-pixel centres, no antialias)."""
    h, w = size
    return _lerp_axis(_lerp_axis(x, 1, h, half_pixel=True), 2, w,
                      half_pixel=True)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """TF2 nearest neighbour (half-pixel floor)."""
    h, w = size
    return _nearest_axis(_nearest_axis(x, 1, h), 2, w)

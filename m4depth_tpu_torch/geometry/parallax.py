"""Closed-form 6-DoF parallax/depth geometry.

Counterpart of ``m4depth_tpu/geometry/parallax.py`` (same definitions):
  * a pixel ray ``h = ((u+0.5-cx)/fx, (v+0.5-cy)/fy, 1)``;
  * ``rc = R @ h``, ``alpha = rc_z``, ``proj = rc_xy * f / alpha``;
  * ``delta = (t*f)_xy - t_z * proj``, ``rho = |delta|``;
  * parallax ``disp = rho / (depth * alpha + t_z)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from m4depth_tpu_torch.geometry.camera import Camera, pixel_grid
from m4depth_tpu_torch.geometry.rotations import rot_mat


def _apply_rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate per-pixel 3-vectors: R [b,3,3] applied to v [b,h,w,3], as
    element-wise products so the sum order matches the reference."""
    b = R.shape[0]
    Rb = R.reshape(b, 1, 1, 3, 3)
    return (Rb[..., 0] * v[..., 0:1] + Rb[..., 1] * v[..., 1:2]
            + Rb[..., 2] * v[..., 2:3])


class EpipolarTerms(NamedTuple):
    """Per-pixel parallax-independent quantities, all float32.

    alpha: [b,h,w,1], proj: [b,h,w,2], delta: [b,h,w,2], rho: [b,h,w,1],
    mesh: [b,h,w,2] (pixel centres relative to c), t_z: [b,1,1,1].
    """

    alpha: torch.Tensor
    proj: torch.Tensor
    delta: torch.Tensor
    rho: torch.Tensor
    mesh: torch.Tensor
    t_z: torch.Tensor


def _f_and_one(camera: Camera) -> torch.Tensor:
    b = camera.batch
    ones = torch.ones((b, 1), dtype=torch.float32, device=camera.f.device)
    return torch.cat([camera.f, ones], dim=1).reshape(b, 1, 1, 3)


def epipolar_terms(h: int, w: int, rot: torch.Tensor, trans: torch.Tensor,
                   camera: Camera) -> EpipolarTerms:
    """Compute the shared epipolar quantities for an (h, w) grid."""
    b = camera.batch
    coords, mesh = pixel_grid(h, w, camera)
    rc = _apply_rot(rot_mat(rot), coords)
    alpha = rc[..., 2:3]
    proj = rc[..., :2] * camera.f.reshape(b, 1, 1, 2) / alpha
    scaled_t = trans.reshape(b, 1, 1, 3) * _f_and_one(camera)
    t_z = scaled_t[..., 2:3]
    delta = scaled_t[..., :2] - t_z * proj
    rho = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    return EpipolarTerms(alpha=alpha, proj=proj, delta=delta, rho=rho,
                         mesh=mesh, t_z=t_z.expand(b, 1, 1, 1))


def depth_to_parallax(depth: torch.Tensor, rot: torch.Tensor,
                      trans: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Convert a depth map [b,h,w,1] to a parallax map [b,h,w,1]."""
    _, h, w = depth.shape[:3]
    e = epipolar_terms(h, w, rot, trans, camera)
    return e.rho / (depth * e.alpha + e.t_z)


def parallax_to_depth(parallax: torch.Tensor, rot: torch.Tensor,
                      trans: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Convert a parallax map [b,h,w,1] to a depth map [b,h,w,1]."""
    _, h, w = parallax.shape[:3]
    e = epipolar_terms(h, w, rot, trans, camera)
    return (e.rho / parallax - e.t_z) / e.alpha


def prev_depth_to_parallax(prev_depth: torch.Tensor, rot: torch.Tensor,
                           trans: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Parallax observed now for a point whose depth was measured in the
    previous frame at the same pixel.

    Rotation creates no parallax, so ``rot`` is unused (kept for the
    reference's signature). Detached: the temporal recurrence is not
    differentiated through.
    """
    del rot
    b, h, w = prev_depth.shape[:3]
    coords, _ = pixel_grid(h, w, camera)
    f_vec = _f_and_one(camera)
    ch = coords * f_vec                                  # (u-cx, v-cy, 1)
    t = trans.reshape(b, 1, 1, 3)
    t_z = t[..., 2:3]
    delta = (t * f_vec - t_z * ch) / (prev_depth - t_z)
    disp = torch.linalg.vector_norm(delta[..., :2], dim=-1, keepdim=True)
    return disp.detach()


def parallax_sweep_flows(parallax: torch.Tensor, rot: torch.Tensor,
                         trans: torch.Tensor, camera: Camera,
                         search_range: int) -> torch.Tensor:
    """Backward-warp flows for the 2*search_range+1 swept parallax hypotheses.

    Hypothesis k in [-r, r] samples output pixel p at
    ``proj(p) + (delta(p)/max(rho(p), 1e-12)) * clip(parallax(p)+k, 1e-6, 1e6)
    + c - 0.5`` in source index coordinates; the flow is that position minus
    the index grid.

    Args:
      parallax: [b, h, w, 1] sweep centre.
    Returns:
      flows: [b, s, h, w, 2] with s = 2*search_range+1, (dx, dy) order.
    """
    _, h, w = parallax.shape[:3]
    e = epipolar_terms(h, w, rot, trans, camera)
    offsets = torch.arange(-search_range, search_range + 1,
                           dtype=torch.float32, device=parallax.device)
    disp_k = torch.clamp(parallax[:, None] + offsets.reshape(1, -1, 1, 1, 1),
                         1e-6, 1e6)                      # [b,s,h,w,1]
    # rho == 0 (no translation) would give 0/0: guard instead of NaN
    unit = e.delta / torch.clamp(e.rho, min=1e-12)
    target = e.proj[:, None] + unit[:, None] * disp_k    # [b,s,h,w,2]
    return target - e.mesh[:, None]

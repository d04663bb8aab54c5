"""Rotation parameterizations: a small-angle (x, y, z) 3-vector or a
(w, x, y, z) quaternion. Counterpart of ``m4depth_tpu/geometry/rotations.py``.
"""

from __future__ import annotations

import torch


def rot_mat_small_angle(rot: torch.Tensor) -> torch.Tensor:
    """First-order rotation matrix from a small-angle vector: [..., 3] ->
    [..., 3, 3]."""
    x, y, z = rot[..., 0], rot[..., 1], rot[..., 2]
    one = torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([one, -z, y], dim=-1),
            torch.stack([z, one, -x], dim=-1),
            torch.stack([-y, x, one], dim=-1),
        ],
        dim=-2,
    )


def rot_mat_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a unit (w, x, y, z) quaternion: [..., 4] ->
    [..., 3, 3], as R = (w^2 - v.v) I + 2 v v^T + 2 w [v]x."""
    w = q[..., :1]
    v = q[..., 1:]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    zero = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    skew = torch.stack(
        [
            torch.stack([zero, -vz, vy], dim=-1),
            torch.stack([vz, zero, -vx], dim=-1),
            torch.stack([-vy, vx, zero], dim=-1),
        ],
        dim=-2,
    )
    vvt = v[..., :, None] * v[..., None, :]
    scal = (w * w - torch.sum(v * v, dim=-1, keepdim=True))[..., None]
    return scal * eye + 2.0 * vvt + 2.0 * w[..., None] * skew


def rot_mat(rot: torch.Tensor) -> torch.Tensor:
    """Dispatch on the trailing dimension: 3 = small angle, 4 = quaternion."""
    c = rot.shape[-1]
    if c == 3:
        return rot_mat_small_angle(rot)
    if c == 4:
        return rot_mat_quaternion(rot)
    raise ValueError(
        "Rotation must be a small angle (x,y,z) or quaternion (w,x,y,z); "
        f"got trailing dim {c}")

"""Pinhole camera and normalized pixel grids.

Counterpart of ``m4depth_tpu/geometry/camera.py``. Pixel centres sit at
index + 0.5.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Camera(NamedTuple):
    """Per-sample pinhole intrinsics.

    f: [b, 2] focal lengths (fx, fy) in pixels.
    c: [b, 2] principal point (cx, cy) in pixels.
    """

    f: torch.Tensor
    c: torch.Tensor

    @property
    def batch(self) -> int:
        return self.f.shape[0]


def scale_camera(camera: Camera, factor: float) -> Camera:
    """Scale intrinsics for a pyramid level (f, c divided by ``factor``)."""
    return Camera(f=camera.f / factor, c=camera.c / factor)


def pixel_grid(h: int, w: int, camera: Camera
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized homogeneous pixel coordinates.

    Returns:
      coords: [b, h, w, 3] rays ((u+0.5-cx)/fx, (v+0.5-cy)/fy, 1).
      mesh:   [b, h, w, 2] pixel-centre offsets from the principal point,
              ordered (x, y) in pixels.
    """
    b = camera.batch
    dev = camera.f.device
    xs = torch.arange(0.5, w, 1.0, dtype=torch.float32, device=dev)
    ys = torch.arange(0.5, h, 1.0, dtype=torch.float32, device=dev)
    grid_x = xs[None, :].expand(h, w)
    grid_y = ys[:, None].expand(h, w)
    mesh = torch.stack([grid_x, grid_y], dim=-1)[None]  # [1, h, w, 2]
    mesh = mesh - camera.c.reshape(b, 1, 1, 2)
    rays = mesh / camera.f.reshape(b, 1, 1, 2)
    ones = torch.ones((b, h, w, 1), dtype=torch.float32, device=dev)
    coords = torch.cat([rays, ones], dim=-1)
    return coords, mesh

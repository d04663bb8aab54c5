"""Camera, rotation, parallax and resize geometry (PyTorch)."""

from m4depth_tpu_torch.geometry.camera import Camera, pixel_grid, scale_camera
from m4depth_tpu_torch.geometry.parallax import (
    EpipolarTerms,
    depth_to_parallax,
    epipolar_terms,
    parallax_sweep_flows,
    parallax_to_depth,
    prev_depth_to_parallax,
    recompute_depth,
    reprojection_flow,
    reproject,
)
from m4depth_tpu_torch.geometry.resize import (
    resize_bilinear,
    resize_bilinear_v1,
    resize_bilinear_v1_transpose,
    resize_nearest,
)
from m4depth_tpu_torch.geometry.rotations import rot_mat

__all__ = [
    "Camera", "EpipolarTerms", "depth_to_parallax", "epipolar_terms",
    "parallax_sweep_flows", "parallax_to_depth", "pixel_grid",
    "prev_depth_to_parallax", "recompute_depth", "reproject",
    "reprojection_flow", "resize_bilinear", "resize_bilinear_v1",
    "resize_bilinear_v1_transpose", "resize_nearest", "rot_mat",
    "scale_camera",
]

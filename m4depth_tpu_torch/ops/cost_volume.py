"""Parallax-sweeping cost volume (DSCV): the fused CUDA kernel and its plain
PyTorch version.

``parallax_sweeping_cv_fused`` is what the model calls. On CPU tensors it
runs ``parallax_sweeping_cv``, the plain version (a port of the reference
formulation ``m4depth_tpu/ops/cost_volume.py::parallax_sweeping_cv``: warp
c2 once per hypothesis, correlate); on CUDA tensors it launches
``csrc/dscv.cu`` (which replaces the TPU kernel
``m4depth_tpu/ops/dscv_pallas.py::_reduce_kernel`` and the gather around it)
or raises.

Both round c1, c2 and the previous parallax to ``cv_dtype`` (as the JAX
paths do) and then sample, multiply and sum in float32. Both return only
the centre hypothesis's warped parallax: the model reads no other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from m4depth_tpu_torch.geometry.camera import Camera
from m4depth_tpu_torch.geometry.parallax import parallax_sweep_flows
from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs
from m4depth_tpu_torch.ops.sncv import KERNEL_DTYPES
from m4depth_tpu_torch.ops.warp import dense_image_warp

DSCV_KERNEL = CudaKernel(
    "dscv.cu", "dscv_forward",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def parallax_sweeping_cv(
    c1: torch.Tensor,
    c2: torch.Tensor,
    para_prev_t: torch.Tensor,
    para_sweep_center: torch.Tensor,
    rot: torch.Tensor,
    trans: torch.Tensor,
    camera: Camera,
    search_range: int,
    num_cuts: int = 1,
    cv_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain DSCV.

    Args:
      c1: [b,h,w,C] current-frame features (cut-normalized).
      c2: [b,h,w,C] previous-frame features (cut-normalized).
      para_prev_t: [b,h,w,1] parallax from the previous depth estimate,
        warped like c2.
      para_sweep_center: [b,h,w,1] sweep centre.
      search_range: r; hypotheses are centre + {-r..r}, s = 2r+1.

    Returns:
      cv: [b,h,w,num_cuts*s] float32 per-cut mean correlations, channels
        cut-major / hypothesis-minor.
      para_center: [b,h,w,1] float32, ``para_prev_t`` warped by the centre
        hypothesis.
    """
    b, h, w, C = c1.shape
    s = 2 * search_range + 1
    flows = parallax_sweep_flows(para_sweep_center, rot, trans, camera,
                                 search_range)            # [b,s,h,w,2]
    c2w = dense_image_warp(
        c2.to(cv_dtype).float()[:, None].expand(b, s, h, w, C), flows)
    prod = c1.to(cv_dtype).float()[:, None] * c2w
    cv = prod.reshape(b, s, h, w, num_cuts, C // num_cuts).mean(dim=-1)
    cv = cv.permute(0, 2, 3, 4, 1).reshape(b, h, w, num_cuts * s)
    para_center = dense_image_warp(para_prev_t.to(cv_dtype).float(),
                                   flows[:, search_range])
    return cv, para_center


def parallax_sweeping_cv_fused(
    c1: torch.Tensor,
    c2: torch.Tensor,
    para_prev_t: torch.Tensor,
    para_sweep_center: torch.Tensor,
    rot: torch.Tensor,
    trans: torch.Tensor,
    camera: Camera,
    search_range: int,
    num_cuts: int = 1,
    cv_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DSCV: the fused CUDA kernel on CUDA tensors, the plain version on CPU
    ones. Same arguments and results as :func:`parallax_sweeping_cv`."""
    inputs = (c1, c2, para_prev_t, para_sweep_center, rot, trans, camera.f,
              camera.c)
    if all(t.device.type == "cpu" for t in inputs):
        return parallax_sweeping_cv(c1, c2, para_prev_t, para_sweep_center,
                                    rot, trans, camera, search_range,
                                    num_cuts, cv_dtype)
    if c1.dim() != 4 or c1.shape != c2.shape:
        raise ValueError(f"dscv: c1 {tuple(c1.shape)} and c2 "
                         f"{tuple(c2.shape)} must both be [b, h, w, C]")
    b, h, w, C = c1.shape
    if (para_prev_t.shape != (b, h, w, 1)
            or para_sweep_center.shape != (b, h, w, 1)):
        raise ValueError("dscv: para_prev_t and para_sweep_center must be "
                         f"[{b}, {h}, {w}, 1]")
    if h < 2 or w < 2:
        raise ValueError(f"dscv: the image must be at least 2x2, got {h}x{w}")
    if num_cuts <= 0 or C % num_cuts:
        raise ValueError(f"dscv: {C} channels do not split into "
                         f"{num_cuts} cuts")
    if cv_dtype not in KERNEL_DTYPES:
        raise TypeError(f"dscv: cv_dtype {cv_dtype} not in {KERNEL_DTYPES}")
    a, bb, para = (t.to(cv_dtype) for t in (c1, c2, para_prev_t))
    check_kernel_inputs("dscv", (a, bb, para), (cv_dtype,), c1.device)
    check_kernel_inputs("dscv", (para_sweep_center,), (torch.float32,),
                        c1.device)
    if rot.shape not in ((b, 3), (b, 4)) or trans.shape != (b, 3) or any(
            t.shape != (b, 2) for t in (camera.f, camera.c)):
        raise ValueError(f"dscv: rot must be [{b}, 3|4], trans [{b}, 3] and "
                         f"the camera's f and c [{b}, 2]")
    motion = tuple(t.float().contiguous()
                   for t in (rot, trans, camera.f, camera.c))
    check_kernel_inputs("dscv", motion, (torch.float32,), c1.device)
    s = 2 * search_range + 1
    cv = torch.empty((b, h, w, num_cuts * s), dtype=torch.float32,
                     device=c1.device)
    para_center = torch.empty((b, h, w, 1), dtype=torch.float32,
                              device=c1.device)
    DSCV_KERNEL.launch(
        a.data_ptr(), bb.data_ptr(), para.data_ptr(),
        para_sweep_center.data_ptr(), *(t.data_ptr() for t in motion),
        cv.data_ptr(), para_center.data_ptr(), b, h, w, C, num_cuts,
        search_range, rot.shape[1], int(cv_dtype == torch.bfloat16),
        torch.cuda.current_stream(c1.device).cuda_stream)
    return cv, para_center

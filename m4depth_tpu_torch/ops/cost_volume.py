"""Parallax-sweeping cost volume (DSCV): the fused CUDA kernels and the plain
PyTorch version.

``parallax_sweeping_cv_fused`` is what the model calls. On CPU tensors it
runs ``parallax_sweeping_cv``, the plain version (a port of the reference
formulation ``m4depth_tpu/ops/cost_volume.py::parallax_sweeping_cv``: warp
c2 once per hypothesis, correlate), and autograd differentiates it. On CUDA
tensors it launches ``csrc/dscv.cu``'s ``dscv_forward`` (which replaces the
TPU kernel ``m4depth_tpu/ops/dscv_pallas.py::_reduce_kernel`` and the gather
around it) through ``DSCVFunction`` or raises; the Function's backward
launches ``dscv_backward`` (the counterpart
of ``m4depth_tpu/ops/dscv_bwd_pallas.py::_grad_kernel``: the whole VJP of
the forward, since the port has no expanded map). Its plain version is
autograd through ``parallax_sweeping_cv``.

Both round c1, c2 and the previous parallax to ``cv_dtype`` (as the JAX
paths do) and then sample, multiply and sum in float32. For float16 the
parallax is first clamped to float16's finite range (``round_parallax``,
the JAX package's ``_saturating_cast``). Both return only the centre
hypothesis's warped parallax: the model reads no other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from m4depth_tpu_torch.geometry.camera import Camera
from m4depth_tpu_torch.geometry.parallax import parallax_sweep_flows
from m4depth_tpu_torch.ops import cost
from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs
from m4depth_tpu_torch.ops.sncv import KERNEL_DTYPES, _dtype_code, _stream
from m4depth_tpu_torch.ops.warp import dense_image_warp

DSCV_KERNEL = CudaKernel(
    "dscv.cu", "dscv_forward",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
DSCV_BACKWARD_KERNEL = CudaKernel(
    "dscv.cu", "dscv_backward",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def round_parallax(para: torch.Tensor, cv_dtype: torch.dtype) -> torch.Tensor:
    """``para`` in ``cv_dtype``. For float16 it is clamped to +-65504 first:
    the parallax is rho/depth-shaped and exceeds float16's range under a
    degenerate depth (random weights give one), where a plain cast gives
    inf and inf * 0 in the bilinear weights NaN. The clamp's gradient is
    zero outside the range, as ``jnp.clip``'s. float32 and bfloat16 hold
    any finite parallax, so they are cast alone (no added launch)."""
    if cv_dtype == torch.float16:
        big = torch.finfo(torch.float16).max
        para = para.clamp(-big, big)
    return para.to(cv_dtype)


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
    para_center = dense_image_warp(round_parallax(para_prev_t, cv_dtype)
                                   .float(), flows[:, search_range])
    return cv, para_center


def _dscv_forward(a, bb, para, centre, rot, trans, f, c, search_range: int,
                  num_cuts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``dscv_forward`` on checked inputs."""
    b, h, w, C = a.shape
    s = 2 * search_range + 1
    cv = torch.empty((b, h, w, num_cuts * s), dtype=torch.float32,
                     device=a.device)
    para_center = torch.empty((b, h, w, 1), dtype=torch.float32,
                              device=a.device)
    DSCV_KERNEL.launch(
        a.data_ptr(), bb.data_ptr(), para.data_ptr(), centre.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), f.data_ptr(), c.data_ptr(),
        cv.data_ptr(), para_center.data_ptr(), b, h, w, C, num_cuts,
        search_range, rot.shape[1], _dtype_code(a), _stream(a),
        device=a.device)
    return cv, para_center


def _dscv_backward(a, bb, para, centre, rot, trans, f, c, dcv, dpara_out,
                   search_range: int, num_cuts: int, want_dpara: bool):
    """Launch ``dscv_backward``: (dc1, dc2, dpara or None, dcentre), each in
    its input's dtype, from the forward's inputs and its outputs'
    gradients. dc2 and dpara accumulate in zeroed float32 scratch."""
    b, h, w, C = a.shape
    dcv = dcv.float().contiguous()
    dpara_out = dpara_out.float().contiguous()
    dc1 = torch.empty_like(a)
    dc2 = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    dcentre = torch.empty_like(centre)
    dpara = (torch.zeros(para.shape, dtype=torch.float32, device=a.device)
             if want_dpara else None)
    DSCV_BACKWARD_KERNEL.launch(
        a.data_ptr(), bb.data_ptr(), para.data_ptr(), centre.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), f.data_ptr(), c.data_ptr(),
        dcv.data_ptr(), dpara_out.data_ptr(), dc1.data_ptr(), dc2.data_ptr(),
        dcentre.data_ptr(), None if dpara is None else dpara.data_ptr(),
        b, h, w, C, num_cuts, search_range, rot.shape[1], _dtype_code(a),
        _stream(a), device=a.device)
    return (dc1, dc2.to(bb.dtype),
            None if dpara is None else dpara.to(para.dtype), dcentre)


class DSCVFunction(torch.autograd.Function):
    """The fused DSCV kernel with its backward kernel: gradients for c1, c2,
    the previous parallax and the sweep centre (inputs already rounded to
    the cost-volume dtype; the casts stay outside, so autograd casts the
    gradients back). The motion and the camera get none: the Function
    raises if any of them requires grad."""

    @staticmethod
    def forward(ctx, a, bb, para, centre, rot, trans, f, c,
                search_range: int, num_cuts: int):
        if any(ctx.needs_input_grad[4:8]):
            raise ValueError("dscv: the CUDA kernel gives no gradient for "
                             "rot, trans or the camera, and one of them "
                             "requires grad")
        cv, para_center = _dscv_forward(a, bb, para, centre, rot, trans, f,
                                        c, search_range, num_cuts)
        ctx.save_for_backward(a, bb, para, centre, rot, trans, f, c)
        ctx.args = (search_range, num_cuts)
        return cv, para_center

    @staticmethod
    def backward(ctx, dcv, dpara_out):
        grads = _dscv_backward(*ctx.saved_tensors, dcv, dpara_out, *ctx.args,
                               want_dpara=ctx.needs_input_grad[2])
        return grads + (None,) * 6


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
    ones. Same arguments and results as :func:`parallax_sweeping_cv`. On
    CUDA tensors the results carry ``DSCVFunction``'s graph when an input
    requires grad. Under ``cost.counting()`` the call counts its work
    once."""
    inputs = (c1, c2, para_prev_t, para_sweep_center, rot, trans, camera.f,
              camera.c)

    def work():
        n_pix = c1.shape[0] * c1.shape[1] * c1.shape[2]
        args = (n_pix, c1.shape[3], num_cuts, search_range,
                torch.finfo(cv_dtype).bits // 8)
        return cost.dscv_forward_work(*args), cost.dscv_backward_work(*args)

    with cost.counted_call("dscv", work, inputs) as done:
        return done(_dscv_fused(c1, c2, para_prev_t, para_sweep_center,
                                rot, trans, camera, search_range, num_cuts,
                                cv_dtype))


def _dscv_fused(c1, c2, para_prev_t, para_sweep_center, rot, trans, camera,
                search_range, num_cuts, cv_dtype):
    if all(t.device.type == "cpu" for t in (c1, c2, para_prev_t,
                                            para_sweep_center, rot, trans,
                                            camera.f, camera.c)):
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
    a, bb = c1.to(cv_dtype), c2.to(cv_dtype)
    para = round_parallax(para_prev_t, cv_dtype)
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
    return DSCVFunction.apply(a, bb, para, para_sweep_center, *motion,
                              search_range, num_cuts)

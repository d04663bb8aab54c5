"""A V1 decoder level's glue: the three CUDA kernels of ``csrc/glue_v1.cu``
and their plain PyTorch versions.

The glue is the tensor work that ``models/m4depth_v1.py::DecoderLevelV1``
does around its cost volume and its refiner, in three steps:

* ``glue_v1_prep``, before the SNCV: the previous depth seen from the new
  viewpoint (``recompute_depth``; 1 where the element starts a trajectory
  or the level has no memory), the deeper depth resized to this level (100
  at the deepest), and the previous features (the current ones where the
  element resets or without memory) with that depth warped into the
  current frame by the reprojection of the deeper depth;
* ``glue_v1_assemble``, between the SNCV and the refiner: the refiner's
  input, its maps concatenated in the reference's order;
* ``glue_v1_finish``, after the refiner: the inverse of its last leaky
  ReLU, clipped to [-7, 7], as depth ``exp(x) * 10``.

The plain versions are autograd's. Each ``*_fused`` wrapper takes the
same arguments and chooses from what it can observe, as the d6 wrappers
of ``ops/glue.py`` do:

* on CPU tensors, the plain version;
* on CUDA tensors that need no gradient, its kernel;
* on CUDA tensors that need one (grad is enabled and an input requires
  grad: training), the plain version, because the kernels have no
  backward.

The decoder level calls only the wrappers. The choice is no fallback: on
CUDA tensors without grad a missing build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from m4depth_tpu_torch.geometry import (
    Camera,
    pixel_grid,
    recompute_depth,
    reprojection_flow,
    resize_bilinear_v1,
    scale_camera,
)
from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs
from m4depth_tpu_torch.ops.glue import (
    CONV_DTYPES,
    _differentiates,
    _log_safe,
    _motion,
    _on_cpu,
    _ptr,
)
from m4depth_tpu_torch.ops.sncv import _stream
from m4depth_tpu_torch.ops.warp import dense_image_warp

GLUE_V1_PREP_KERNEL = CudaKernel(
    "glue_v1.cu", "glue_v1_prep",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_int, ctypes.c_void_p])
GLUE_V1_ASSEMBLE_KERNEL = CudaKernel(
    "glue_v1.cu", "glue_v1_assemble",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int, ctypes.c_void_p])
GLUE_V1_FINISH_KERNEL = CudaKernel(
    "glue_v1.cu", "glue_v1_finish",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float]
    + [ctypes.c_int, ctypes.c_void_p])

# (f0_w, log_d0w, log_dprev)
Prepared = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def inverse_leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """Invert a leaky-relu activation."""
    return torch.where(x > 0, x, x / slope)


def glue_v1_prep(curr_f: torch.Tensor,
                 state: Optional[Sequence[torch.Tensor]],
                 deeper: Optional[torch.Tensor],
                 new_traj: Optional[torch.Tensor], rot: torch.Tensor,
                 trans: torch.Tensor, camera: Camera,
                 scale: float) -> Prepared:
    """The glue before a V1 level's SNCV (plain): ``(f0_w, log_d0w,
    log_dprev)``, the warped previous features [b, h, w, C] (contiguous,
    the SNCV's second input) and log(max(d / 10, 1e-12)) of the warped
    previous depth and of the deeper depth at this size, [b, h, w, 1], all
    in ``curr_f``'s dtype.

    Args:
      curr_f: [b, h, w, C] the level's features.
      state: (f_maps [b, h, w, C] in ``curr_f``'s dtype, depth [b, h, w,
        1]) of the last frame, or None (no temporal memory: ``curr_f`` is
        warped, at depth 1).
      deeper: [b, h/2, w/2, 1] the deeper level's depth, or None (100).
      new_traj: [b] bool, the elements whose memory is replaced by
        ``curr_f`` at depth 1, or None.
      rot: [b, 3 | 4]; trans: [b, 3]; camera: the intrinsics that ``scale``
        divides into the level's.
    """
    cam_l = scale_camera(camera, scale)
    b, h, w, _ = curr_f.shape
    kw = dict(dtype=torch.float32, device=curr_f.device)
    if state is None:
        prev_f = curr_f
        d_0 = torch.ones((b, h, w, 1), **kw)
    else:
        prev_f, prev_t_depth = state
        # The legacy recompute_depth reads the transposed small-angle
        # row [ry, -rx, 1]; negating rot reproduces it exactly for the
        # I + skew form, as the JAX package does. For a quaternion
        # R(-q) == R(q), so quaternion runs read the untransposed row:
        # a fault of the JAX package that this port matches rather than
        # fixes on its own.
        d_0 = recompute_depth(prev_t_depth, -rot, trans, cam_l)
        if new_traj is not None:
            prev_f = torch.where(new_traj.reshape(-1, 1, 1, 1), curr_f,
                                 prev_f)
            d_0 = torch.where(new_traj.reshape(b, 1, 1, 1),
                              torch.ones_like(d_0), d_0)
    if deeper is None:
        d_prev_l = torch.full((b, h, w, 1), 100.0, **kw)
    else:
        d_prev_l = resize_bilinear_v1(deeper, (h, w))

    # warp (previous depth | previous features) into the current frame
    # by the deeper level's estimate, its gradient cut
    fmap = torch.cat([d_0.to(curr_f.dtype), prev_f], dim=-1)
    flow = reprojection_flow(d_prev_l.detach(), rot, trans, cam_l)
    warped = dense_image_warp(fmap, flow)
    d0_w = warped[..., :1].float()
    # the SNCV kernel takes contiguous features
    f0_w = warped[..., 1:].contiguous()
    dt = curr_f.dtype
    return (f0_w, _log_safe(d0_w / 10.0).to(dt),
            _log_safe(d_prev_l / 10.0).to(dt))


def glue_v1_assemble(curr_f: torch.Tensor, cv: torch.Tensor,
                     log_d0w: torch.Tensor, log_dprev: torch.Tensor,
                     rot: torch.Tensor, trans: torch.Tensor, camera: Camera,
                     scale: float) -> torch.Tensor:
    """The refiner's input [b, h, w, C + n_cv + 2 + rot_dim + 3 + 2] in
    ``curr_f``'s dtype (plain): the features, the cost volume ``cv`` [b, h,
    w, n_cv] (float32), ``glue_v1_prep``'s two log depths, the rotation and
    the translation at every pixel, and the pixel's ray (x, y) under the
    intrinsics that ``scale`` divides ``camera`` into."""
    b, h, w, _ = curr_f.shape
    rc = rot.shape[-1]
    dt = curr_f.dtype
    coords, _ = pixel_grid(h, w, scale_camera(camera, scale))
    return torch.cat([
        curr_f,
        cv.to(dt),
        log_d0w,
        log_dprev,
        rot.reshape(b, 1, 1, rc).expand(b, h, w, rc).to(dt),
        trans.reshape(b, 1, 1, 3).expand(b, h, w, 3).to(dt),
        coords[..., :2].expand(b, h, w, 2).to(dt),
    ], dim=-1)


def glue_v1_finish(out: torch.Tensor, slope: float) -> torch.Tensor:
    """The depth [b, h, w, 1] float32 (plain) from the refiner's output
    ``out`` [b, h, w, 1] after its last leaky ReLU of ``slope``: the
    activation inverted, clipped to [-7, 7], ``exp(x) * 10``."""
    x = inverse_leaky_relu(out.float(), slope)
    return torch.exp(torch.clamp(x, -7.0, 7.0)) * 10.0


# -- the kernels ---------------------------------------------------------


def _level(name: str, curr_f: torch.Tensor):
    """``curr_f``'s device and shape, checked as a kernel input."""
    if curr_f.dim() != 4:
        raise ValueError(f"{name}: curr_f must be [b, h, w, C], got "
                         f"{tuple(curr_f.shape)}")
    check_kernel_inputs(name, (curr_f,), CONV_DTYPES, curr_f.device)
    return curr_f.device, tuple(curr_f.shape)


def glue_v1_prep_fused(curr_f: torch.Tensor,
                       state: Optional[Sequence[torch.Tensor]],
                       deeper: Optional[torch.Tensor],
                       new_traj: Optional[torch.Tensor], rot: torch.Tensor,
                       trans: torch.Tensor, camera: Camera,
                       scale: float) -> Prepared:
    """:func:`glue_v1_prep`, or ``glue_v1_prep`` of ``csrc/glue_v1.cu``
    on CUDA tensors that need no gradient (h and w at least 2)."""
    tensors = [curr_f, rot, trans, camera.f, camera.c, *(state or ())] + [
        t for t in (deeper, new_traj) if t is not None]
    if _on_cpu(tensors) or _differentiates(tensors):
        return glue_v1_prep(curr_f, state, deeper, new_traj, rot, trans,
                            camera, scale)
    dev, (b, h, w, C) = _level("glue_v1_prep", curr_f)
    if h < 2 or w < 2:
        raise ValueError(f"glue_v1_prep: a {h}x{w} level is below the "
                         "warp's 2x2 taps")
    rot, trans, f, c = _motion(
        "glue_v1_prep", dev, (rot, [(b, 3), (b, 4)]), (trans, [(b, 3)]),
        (camera.f, [(b, 2)]), (camera.c, [(b, 2)]))
    prev_f = depth = None
    if state is not None:
        prev_f, depth = state
        check_kernel_inputs("glue_v1_prep", (prev_f,), (curr_f.dtype,), dev)
        check_kernel_inputs("glue_v1_prep", (depth,), (torch.float32,), dev)
        if prev_f.shape != curr_f.shape or depth.shape != (b, h, w, 1):
            raise ValueError(f"glue_v1_prep: the state must be [{b}, {h}, "
                             f"{w}, {C}] and [{b}, {h}, {w}, 1]")
    hd = wd = 0
    if deeper is not None:
        check_kernel_inputs("glue_v1_prep", (deeper,), (torch.float32,), dev)
        if deeper.dim() != 4 or deeper.shape[0] != b or deeper.shape[3] != 1:
            raise ValueError(f"glue_v1_prep: the deeper depth must be [{b}, "
                             f"hd, wd, 1], got {tuple(deeper.shape)}")
        hd, wd = deeper.shape[1:3]
    if new_traj is not None:
        check_kernel_inputs("glue_v1_prep", (new_traj,), (torch.bool,), dev)
        if new_traj.shape != (b,):
            raise ValueError(f"glue_v1_prep: new_traj must be [{b}]")
    f0_w = torch.empty_like(curr_f)
    logs = [torch.empty((b, h, w, 1), dtype=curr_f.dtype, device=dev)
            for _ in range(2)]
    GLUE_V1_PREP_KERNEL.launch(
        curr_f.data_ptr(), _ptr(prev_f), _ptr(depth), _ptr(new_traj),
        _ptr(deeper), rot.data_ptr(), trans.data_ptr(), f.data_ptr(),
        c.data_ptr(), f0_w.data_ptr(), logs[0].data_ptr(),
        logs[1].data_ptr(), b, h, w, C, hd, wd, rot.shape[1], float(scale),
        hd / h, wd / w, CONV_DTYPES.index(curr_f.dtype), _stream(curr_f),
        device=dev)
    return f0_w, logs[0], logs[1]


def glue_v1_assemble_fused(curr_f: torch.Tensor, cv: torch.Tensor,
                           log_d0w: torch.Tensor, log_dprev: torch.Tensor,
                           rot: torch.Tensor, trans: torch.Tensor,
                           camera: Camera, scale: float) -> torch.Tensor:
    """:func:`glue_v1_assemble`, or ``glue_v1_assemble`` of
    ``csrc/glue_v1.cu`` on CUDA tensors that need no gradient."""
    tensors = [curr_f, cv, log_d0w, log_dprev, rot, trans, camera.f,
               camera.c]
    if _on_cpu(tensors) or _differentiates(tensors):
        return glue_v1_assemble(curr_f, cv, log_d0w, log_dprev, rot, trans,
                                camera, scale)
    dev, (b, h, w, C) = _level("glue_v1_assemble", curr_f)
    check_kernel_inputs("glue_v1_assemble", (cv,), (torch.float32,), dev)
    check_kernel_inputs("glue_v1_assemble", (log_d0w, log_dprev),
                        (curr_f.dtype,), dev)
    if (cv.dim() != 4 or cv.shape[:3] != (b, h, w)
            or log_d0w.shape != (b, h, w, 1)
            or log_dprev.shape != (b, h, w, 1)):
        raise ValueError(f"glue_v1_assemble: the maps must be [{b}, {h}, "
                         f"{w}, n], the log depths n = 1")
    rot, trans, f, c = _motion(
        "glue_v1_assemble", dev, (rot, [(b, 3), (b, 4)]), (trans, [(b, 3)]),
        (camera.f, [(b, 2)]), (camera.c, [(b, 2)]))
    n_cv, rc = cv.shape[3], rot.shape[1]
    out = torch.empty((b, h, w, C + n_cv + 2 + rc + 3 + 2),
                      dtype=curr_f.dtype, device=dev)
    GLUE_V1_ASSEMBLE_KERNEL.launch(
        curr_f.data_ptr(), cv.data_ptr(), log_d0w.data_ptr(),
        log_dprev.data_ptr(), rot.data_ptr(), trans.data_ptr(), f.data_ptr(),
        c.data_ptr(), out.data_ptr(), b, h, w, C, n_cv, rc, float(scale),
        CONV_DTYPES.index(curr_f.dtype), _stream(curr_f), device=dev)
    return out


def glue_v1_finish_fused(out: torch.Tensor, slope: float) -> torch.Tensor:
    """:func:`glue_v1_finish`, or ``glue_v1_finish`` of
    ``csrc/glue_v1.cu`` on CUDA tensors that need no gradient, which reads
    ``out`` in its own dtype."""
    if _on_cpu([out]) or _differentiates([out]):
        return glue_v1_finish(out, slope)
    dev = out.device
    check_kernel_inputs("glue_v1_finish", (out,), CONV_DTYPES, dev)
    if out.dim() != 4 or out.shape[3] != 1:
        raise ValueError(f"glue_v1_finish: out must be [b, h, w, 1], got "
                         f"{tuple(out.shape)}")
    b, h, w, _ = out.shape
    depth = torch.empty((b, h, w, 1), dtype=torch.float32, device=dev)
    GLUE_V1_FINISH_KERNEL.launch(
        out.data_ptr(), depth.data_ptr(), b, h, w, float(slope),
        CONV_DTYPES.index(out.dtype), _stream(out), device=dev)
    return depth

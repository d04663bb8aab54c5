"""A decoder level's glue: the three CUDA kernels of ``csrc/glue.cu`` and
their plain PyTorch versions.

The glue is the tensor work that ``models/decoder.py::DecoderLevel`` does
around its two cost volumes and its refiner, in three steps:

* ``glue_prep``, before the cost volumes: the intrinsics over ``scale``,
  the deeper estimate resized to this size (or, without one, the
  constants ``(init_depth, 1, 0)``), the per-cut normalised features of
  this frame and of the last (``prep_features``) and the parallax of the
  previous depth (``prev_depth_to_parallax``);
* ``glue_assemble``, between the cost volumes and the refiner: the
  refiner's input, its maps concatenated in the reference's order;
* ``glue_finish``, after the refiner: the parallax, the depth and the
  other channels of its output, the elements that ``reset`` selects put
  back to the deeper estimate, and the depth the next frame reads.

Every function takes and returns tensors, tuples of them and a ``Camera``:
an estimate is a tuple ``(depth, parallax, other)`` of float32 maps
``[b, h, w, 1 | 1 | n_other]``. The plain versions are autograd's; the
decoder calls them while grad is enabled (training). Each ``*_fused``
wrapper takes the same arguments: on CPU tensors it runs the plain
version; on CUDA tensors it launches its kernel, or raises
(``ValueError``) if an input requires grad, since the kernels have no
backward. The decoder calls the wrappers while grad is disabled (the
streaming step, the compiled serving frame, the eval steps).

One difference in the results: ``glue_prep_fused`` returns the features
and the previous parallax already rounded to the cost volumes' dtype (as
the cost-volume wrappers round them: ``round_parallax`` for the
parallax), where ``glue_prep`` leaves that rounding to the cost-volume
wrappers, in whose place autograd differentiates it. The wrappers' own
roundings of them are then no-ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from m4depth_tpu_torch.geometry import (
    Camera,
    parallax_to_depth,
    prev_depth_to_parallax,
    resize_bilinear_v1,
    scale_camera,
)
from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs
from m4depth_tpu_torch.ops.sncv import KERNEL_DTYPES, _stream

GLUE_PREP_KERNEL = CudaKernel(
    "glue.cu", "glue_prep",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
GLUE_ASSEMBLE_KERNEL = CudaKernel(
    "glue.cu", "glue_assemble",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int, ctypes.c_void_p])
GLUE_FINISH_KERNEL = CudaKernel(
    "glue.cu", "glue_finish",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p])

# the dtypes of the convs' features, by the code the C entry points read
CONV_DTYPES = (torch.float32, torch.bfloat16)

# an estimate: (depth, parallax, other)
Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Prepared = Tuple[Maps, Camera, Optional[torch.Tensor], Optional[torch.Tensor],
                 Optional[torch.Tensor]]


def prep_features(f: torch.Tensor, num_cuts: int,
                  normalize: bool) -> torch.Tensor:
    """Per-cut L2 normalization of feature sub-vectors (float32 math)."""
    if not normalize:
        return f.contiguous()
    b, h, w, c = f.shape
    blocks = f.reshape(b, h, w, num_cuts, c // num_cuts).float()
    sq = torch.sum(blocks * blocks, dim=-1, keepdim=True)
    blocks = blocks * torch.rsqrt(torch.clamp(sq, min=1e-12))
    return blocks.reshape(b, h, w, c).to(f.dtype)


def glue_prep(curr_f: torch.Tensor, deeper: Optional[Sequence[torch.Tensor]],
              state: Optional[Sequence[torch.Tensor]], trans: torch.Tensor,
              camera: Camera, scale: float, num_cuts: int, normalize: bool,
              n_other: int, init_depth: float,
              cv_dtype: torch.dtype) -> Prepared:
    """The glue before a level's cost volumes (plain): ``(prev, camera_l,
    curr_p, prev_p, para_prev_t)``, the last three None without ``state``.

    Args:
      curr_f: [b, h, w, C] the level's features.
      deeper: the deeper estimate (depth, parallax, other) at half this
        size, or None: ``prev`` is then ``(init_depth, 1, 0)`` everywhere.
        Otherwise ``prev`` is it resized on the TFv1 bilinear grid, its
        parallax doubled.
      state: (f_maps [b, h, w, C] in ``curr_f``'s dtype, depth [b, h, w,
        1]) of the last frame, or None.
      trans: [b, 3]; camera: the intrinsics that ``scale`` divides into
        ``camera_l``.
      n_other: the width of ``prev``'s other channels.
      cv_dtype: the cost volumes' dtype, to which ``glue_prep_fused``
        rounds; here the cost-volume wrappers round.
    """
    del cv_dtype
    cam_l = scale_camera(camera, scale)
    b, h, w, _ = curr_f.shape
    if deeper is None:
        kw = dict(dtype=torch.float32, device=curr_f.device)
        prev = (torch.full((b, h, w, 1), init_depth, **kw),
                torch.ones((b, h, w, 1), **kw),
                torch.zeros((b, h, w, n_other), **kw))
    else:
        depth, parallax, other = deeper
        prev = (resize_bilinear_v1(depth, (h, w)),
                resize_bilinear_v1(parallax, (h, w)) * 2.0,
                resize_bilinear_v1(other, (h, w)))
    if state is None:
        return prev, cam_l, None, None, None
    f_maps, depth = state
    # rotation creates no parallax: prev_depth_to_parallax reads no rot
    return (prev, cam_l, prep_features(curr_f, num_cuts, normalize),
            prep_features(f_maps, num_cuts, normalize),
            prev_depth_to_parallax(depth, None, trans, cam_l))


def _log_safe(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=1e-12))


def glue_assemble(cv: torch.Tensor, parallax: torch.Tensor,
                  other: Optional[torch.Tensor], sncv: Optional[torch.Tensor],
                  para_reproj: Optional[torch.Tensor], para_mul: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """The refiner's input [b, h, w, n] in ``dtype`` (plain), in the
    reference's order: ``cv`` (cut-major), the log of ``parallax`` times
    ``para_mul``, ``other``, ``sncv`` (offset-major), the log of
    ``para_reproj`` times ``para_mul``; each of the last three left out
    where it is None."""
    inputs = [cv, _log_safe(parallax * para_mul)]
    if other is not None:
        inputs.append(other)
    if sncv is not None:
        inputs.append(sncv)
    if para_reproj is not None:
        inputs.append(_log_safe(para_reproj * para_mul))
    return torch.cat([x.to(dtype) for x in inputs], dim=-1)


def glue_finish(out: torch.Tensor, prev: Sequence[torch.Tensor],
                reset: Optional[torch.Tensor], rot: torch.Tensor,
                trans: torch.Tensor, camera: Camera, para_mul: float,
                init_depth: float) -> Tuple[Maps, torch.Tensor]:
    """The glue after a level's refiner (plain): from its output ``out``
    [b, h, w, 1 + n_other], the estimate ``(depth, parallax, other)``
    (parallax exp(clip(out_0, -7, 7)) / ``para_mul``, its depth through
    ``camera``, ``out[..., 1:]``) and the depth the next frame reads.
    Where ``reset`` [b] (None: no element) is set, the estimate is
    ``prev`` and the depth read next ``init_depth``."""
    out = out.float()
    parallax = torch.exp(torch.clamp(out[..., :1], -7.0, 7.0)) / para_mul
    depth = parallax_to_depth(parallax, rot, trans, camera)
    est = (depth, parallax, out[..., 1:])
    if reset is None:
        return est, depth
    mask = reset.reshape(out.shape[0], 1, 1, 1)
    est = tuple(torch.where(mask, p, e) for p, e in zip(prev, est))
    return est, torch.where(mask, torch.full_like(depth, init_depth), depth)


# -- the kernels ---------------------------------------------------------


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _refuse_grad(name: str, tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel has no backward, and an "
                         "input requires grad (the decoder calls it with "
                         "grad disabled only)")


def _motion(name, device, *pairs):
    """Each (tensor, its allowed shapes) of the motion and the camera as a
    float32 contiguous tensor on ``device``."""
    for t, shapes in pairs:
        if tuple(t.shape) not in shapes:
            raise ValueError(f"{name}: a motion or camera tensor of shape "
                             f"{tuple(t.shape)}, not one of {shapes}")
    out = tuple(t.float().contiguous() for t, _ in pairs)
    check_kernel_inputs(name, out, (torch.float32,), device)
    return out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def glue_prep_fused(curr_f: torch.Tensor,
                    deeper: Optional[Sequence[torch.Tensor]],
                    state: Optional[Sequence[torch.Tensor]],
                    trans: torch.Tensor, camera: Camera, scale: float,
                    num_cuts: int, normalize: bool, n_other: int,
                    init_depth: float, cv_dtype: torch.dtype) -> Prepared:
    """:func:`glue_prep` on CPU tensors; on CUDA ones ``glue_prep`` of
    ``csrc/glue.cu``, whose features and previous parallax are in
    ``cv_dtype``."""
    tensors = [curr_f, trans, camera.f, camera.c, *(deeper or ()),
               *(state or ())]
    if _on_cpu(tensors):
        return glue_prep(curr_f, deeper, state, trans, camera, scale,
                         num_cuts, normalize, n_other, init_depth, cv_dtype)
    _refuse_grad("glue_prep", tensors)
    dev = curr_f.device
    if curr_f.dim() != 4:
        raise ValueError(f"glue_prep: curr_f must be [b, h, w, C], got "
                         f"{tuple(curr_f.shape)}")
    b, h, w, C = curr_f.shape
    if num_cuts <= 0 or C % num_cuts:
        raise ValueError(f"glue_prep: {C} channels do not split into "
                         f"{num_cuts} cuts")
    if cv_dtype not in KERNEL_DTYPES:
        raise TypeError(f"glue_prep: cv_dtype {cv_dtype} not in "
                        f"{KERNEL_DTYPES}")
    check_kernel_inputs("glue_prep", (curr_f,), CONV_DTYPES, dev)
    trans, f, c = _motion("glue_prep", dev, (trans, [(b, 3)]),
                          (camera.f, [(b, 2)]), (camera.c, [(b, 2)]))
    kw = dict(dtype=torch.float32, device=dev)
    cam = torch.empty((2, b, 2), **kw)
    prev = (torch.empty((b, h, w, 1), **kw), torch.empty((b, h, w, 1), **kw),
            torch.empty((b, h, w, n_other), **kw))
    hd = wd = 0
    if deeper is not None:
        check_kernel_inputs("glue_prep", deeper, (torch.float32,), dev)
        hd, wd = deeper[0].shape[1:3]
        if tuple(t.shape for t in deeper) != tuple(
                (b, hd, wd, n) for n in (1, 1, n_other)):
            raise ValueError(f"glue_prep: the deeper estimate must be "
                             f"[{b}, hd, wd, 1 | 1 | {n_other}]")
    curr_p = prev_p = para = f_maps = depth = None
    if state is not None:
        f_maps, depth = state
        check_kernel_inputs("glue_prep", (f_maps,), (curr_f.dtype,), dev)
        check_kernel_inputs("glue_prep", (depth,), (torch.float32,), dev)
        if f_maps.shape != curr_f.shape or depth.shape != (b, h, w, 1):
            raise ValueError(f"glue_prep: the state must be [{b}, {h}, {w}, "
                             f"{C}] and [{b}, {h}, {w}, 1]")
        curr_p = torch.empty(curr_f.shape, dtype=cv_dtype, device=dev)
        prev_p = torch.empty(curr_f.shape, dtype=cv_dtype, device=dev)
        para = torch.empty((b, h, w, 1), dtype=cv_dtype, device=dev)
    GLUE_PREP_KERNEL.launch(
        curr_f.data_ptr(), _ptr(f_maps), _ptr(depth),
        *(_ptr(t) for t in (deeper or (None,) * 3)), trans.data_ptr(),
        f.data_ptr(), c.data_ptr(), cam.data_ptr(),
        *(t.data_ptr() for t in prev), _ptr(curr_p), _ptr(prev_p),
        _ptr(para), b, h, w, C, num_cuts, hd, wd, n_other, int(normalize),
        float(scale), hd / h if hd else 0.0, wd / w if wd else 0.0,
        float(init_depth), CONV_DTYPES.index(curr_f.dtype),
        KERNEL_DTYPES.index(cv_dtype), _stream(curr_f), device=dev)
    return prev, Camera(f=cam[0], c=cam[1]), curr_p, prev_p, para


def glue_assemble_fused(cv: torch.Tensor, parallax: torch.Tensor,
                        other: Optional[torch.Tensor],
                        sncv: Optional[torch.Tensor],
                        para_reproj: Optional[torch.Tensor], para_mul: float,
                        dtype: torch.dtype) -> torch.Tensor:
    """:func:`glue_assemble` on CPU tensors; on CUDA ones
    ``glue_assemble`` of ``csrc/glue.cu``."""
    maps = [t for t in (cv, parallax, other, sncv, para_reproj)
            if t is not None]
    if _on_cpu(maps):
        return glue_assemble(cv, parallax, other, sncv, para_reproj,
                             para_mul, dtype)
    _refuse_grad("glue_assemble", maps)
    if dtype not in CONV_DTYPES:
        raise TypeError(f"glue_assemble: dtype {dtype} not in "
                        f"{CONV_DTYPES}")
    dev = cv.device
    check_kernel_inputs("glue_assemble", maps, (torch.float32,), dev)
    b, h, w, n_cv = cv.shape
    n_other = 0 if other is None else other.shape[3]
    n_sncv = 0 if sncv is None else sncv.shape[3]
    ones = [t for t in (parallax, para_reproj) if t is not None]
    if any(t.shape[:3] != (b, h, w) for t in maps) or any(
            t.shape[3] != 1 for t in ones):
        raise ValueError(f"glue_assemble: the maps must all be [{b}, {h}, "
                         f"{w}, n], the parallax ones n = 1")
    recurr = int(para_reproj is not None)
    n = n_cv + 1 + n_other + n_sncv + recurr
    f_input = torch.empty((b, h, w, n), dtype=dtype, device=dev)
    GLUE_ASSEMBLE_KERNEL.launch(
        cv.data_ptr(), parallax.data_ptr(), _ptr(other), _ptr(sncv),
        _ptr(para_reproj), f_input.data_ptr(), b * h * w, n_cv, n_other,
        n_sncv, recurr, float(para_mul), CONV_DTYPES.index(dtype),
        _stream(cv), device=dev)
    return f_input


def glue_finish_fused(out: torch.Tensor, prev: Sequence[torch.Tensor],
                      reset: Optional[torch.Tensor], rot: torch.Tensor,
                      trans: torch.Tensor, camera: Camera, para_mul: float,
                      init_depth: float) -> Tuple[Maps, torch.Tensor]:
    """:func:`glue_finish` on CPU tensors; on CUDA ones ``glue_finish`` of
    ``csrc/glue.cu``, which reads ``out`` in its own dtype."""
    tensors = [out, *prev, rot, trans, camera.f, camera.c] + (
        [] if reset is None else [reset])
    if _on_cpu(tensors):
        return glue_finish(out, prev, reset, rot, trans, camera, para_mul,
                           init_depth)
    _refuse_grad("glue_finish", tensors)
    dev = out.device
    check_kernel_inputs("glue_finish", (out,), CONV_DTYPES, dev)
    check_kernel_inputs("glue_finish", prev, (torch.float32,), dev)
    if out.dim() != 4:
        raise ValueError(f"glue_finish: out must be [b, h, w, n], got "
                         f"{tuple(out.shape)}")
    b, h, w, n = out.shape
    if tuple(t.shape for t in prev) != (
            (b, h, w, 1), (b, h, w, 1), (b, h, w, n - 1)):
        raise ValueError(f"glue_finish: prev must be [{b}, {h}, {w}, "
                         f"1 | 1 | {n - 1}]")
    rot, trans, f, c = _motion(
        "glue_finish", dev, (rot, [(b, 3), (b, 4)]), (trans, [(b, 3)]),
        (camera.f, [(b, 2)]), (camera.c, [(b, 2)]))
    if reset is not None:
        check_kernel_inputs("glue_finish", (reset,), (torch.bool,), dev)
        if reset.shape != (b,):
            raise ValueError(f"glue_finish: reset must be [{b}]")
    kw = dict(dtype=torch.float32, device=dev)
    est = (torch.empty((b, h, w, 1), **kw), torch.empty((b, h, w, 1), **kw),
           torch.empty((b, h, w, n - 1), **kw))
    next_depth = None if reset is None else torch.empty_like(est[0])
    GLUE_FINISH_KERNEL.launch(
        out.data_ptr(), *(t.data_ptr() for t in prev), _ptr(reset),
        rot.data_ptr(), trans.data_ptr(), f.data_ptr(), c.data_ptr(),
        *(t.data_ptr() for t in est), _ptr(next_depth), b, h, w, n - 1,
        rot.shape[1], float(para_mul), float(init_depth),
        CONV_DTYPES.index(out.dtype), _stream(out), device=dev)
    return est, est[0] if next_depth is None else next_depth

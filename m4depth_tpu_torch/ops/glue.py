"""A decoder level's glue: the three CUDA kernels of ``csrc/glue.cu``, their
backward kernels (``csrc/glue_backward.cu``), and the plain PyTorch
versions of all six.

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
``[b, h, w, 1 | 1 | n_other]``. The plain versions are autograd's. Each
``*_fused`` wrapper takes the same arguments and chooses from what it can
observe, as V1's wrappers (``ops/glue_v1.py``) do:

* on CPU tensors, the plain version;
* on CUDA tensors that need no gradient, its kernel;
* on CUDA tensors that need one (grad is enabled and an input it
  differentiates requires grad: training), its kernel through its
  autograd Function (``GluePrepFunction``, ``GlueAssembleFunction``,
  ``GlueFinishFunction``), whose backward launches the kernels of
  ``csrc/glue_backward.cu``.

The backwards' plain versions are ``glue_prep_backward``,
``glue_assemble_backward`` and ``glue_finish_backward`` (autograd's
formulas for the plain forwards, written out), and their wrappers the
``*_backward_fused`` ones. The decoder calls only the wrappers, on every
path. The choice is no fallback: on CUDA tensors a missing build or a
failed launch raises.

No gradient reaches the previous depth (the plain glue detaches its
parallax too), the motion or the camera (nor through the cost-volume
kernels): on CUDA tensors the wrappers raise (``ValueError``) where the
motion or the camera requires grad under grad, and so does
``glue_finish_fused`` where a ``reset`` is given under grad (the
training windows reset none).

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
    epipolar_terms,
    parallax_to_depth,
    prev_depth_to_parallax,
    resize_bilinear_v1,
    resize_bilinear_v1_transpose,
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
GLUE_PREP_BACKWARD_KERNEL = CudaKernel(
    "glue_backward.cu", "glue_prep_backward",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
GLUE_ASSEMBLE_BACKWARD_KERNEL = CudaKernel(
    "glue_backward.cu", "glue_assemble_backward",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int, ctypes.c_void_p])
GLUE_FINISH_BACKWARD_KERNEL = CudaKernel(
    "glue_backward.cu", "glue_finish_backward",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
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




# -- the plain backward versions ------------------------------------------


def _prep_features_backward(g: Optional[torch.Tensor], f: torch.Tensor,
                            num_cuts: int,
                            normalize: bool) -> Optional[torch.Tensor]:
    """The gradient of ``f`` from ``g``, that of ``prep_features(f)`` in
    the cost volumes' dtype: ``g`` cast to ``f``'s dtype, then, per cut,
    ``g r + 2 x k`` with ``r = rsqrt(max(sq, 1e-12))`` and ``k = (x . g)
    (-r^3 / 2)`` where ``sq >= 1e-12`` (else 0), in float32."""
    if g is None:
        return None
    g = g.to(f.dtype)
    if not normalize:
        return g
    b, h, w, c = f.shape
    x = f.reshape(b, h, w, num_cuts, c // num_cuts).float()
    g = g.reshape(x.shape).float()
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(sq, min=1e-12))
    k = torch.where(sq >= 1e-12,
                    -0.5 * torch.sum(g * x, dim=-1, keepdim=True) * r ** 3,
                    0.0)
    return (g * r + 2.0 * (x * k)).reshape(f.shape).to(f.dtype)


def glue_prep_backward(g_curr_p: Optional[torch.Tensor],
                       g_prev_p: Optional[torch.Tensor],
                       g_prev: Sequence[Optional[torch.Tensor]],
                       curr_f: torch.Tensor, f_maps: Optional[torch.Tensor],
                       deeper_hw: Optional[Tuple[int, int]], num_cuts: int,
                       normalize: bool):
    """The gradients of ``glue_prep``'s inputs (plain): ``(d curr_f, d
    f_maps, d deeper)`` from those of its outputs ``curr_p``, ``prev_p``
    and ``prev = (depth, parallax, other)``, each None where no gradient
    flows (``d deeper`` a tuple, or None without a deeper estimate). The
    features' through the per-cut normalisation (``curr_f``, ``f_maps``:
    the forward's features), the deeper estimate's through the transpose
    of the TFv1 resize from ``deeper_hw`` (the parallax's doubled). The
    previous depth, the motion and the camera get none."""
    d_curr = _prep_features_backward(g_curr_p, curr_f, num_cuts, normalize)
    d_prev = (None if f_maps is None else
              _prep_features_backward(g_prev_p, f_maps, num_cuts, normalize))
    if deeper_hw is None:
        return d_curr, d_prev, None
    g_depth, g_para, g_other = g_prev
    up = [None if g is None else resize_bilinear_v1_transpose(g, deeper_hw)
          for g in (g_depth, None if g_para is None else g_para * 2.0,
                    g_other)]
    return d_curr, d_prev, tuple(up)


def glue_assemble_backward(g: torch.Tensor, parallax: torch.Tensor,
                           para_reproj: Optional[torch.Tensor], n_cv: int,
                           n_other: int, n_sncv: int, para_mul: float,
                           wanted: Sequence[bool]):
    """The gradients of ``glue_assemble``'s inputs (plain): ``(d cv, d
    parallax, d other, d sncv, d para_reproj)`` in float32 from ``g``,
    that of the refiner's input [b, h, w, n], each None where ``wanted``
    says no (or its map was left out: ``n_other``, ``n_sncv`` 0,
    ``para_reproj`` None). A log-parallax channel's as ``g / v *
    para_mul`` with ``v = x * para_mul`` where ``v >= 1e-12`` (the log's
    clamp), else 0."""
    g = g.float()
    widths = (n_cv, 1, n_other, n_sncv, int(para_reproj is not None))
    parts = torch.split(g, widths, dim=-1)

    def log_back(x, gx):
        v = x * para_mul
        return torch.where(v >= 1e-12, gx / v, 0.0) * para_mul

    grads = (parts[0], log_back(parallax, parts[1]), parts[2], parts[3],
             None if para_reproj is None else log_back(para_reproj,
                                                       parts[4]))
    return tuple(
        d.contiguous() if want and n and d is not None else None
        for d, want, n in zip(grads, wanted, widths))


def glue_finish_backward(g_est: Sequence[Optional[torch.Tensor]],
                         out: torch.Tensor, rot: torch.Tensor,
                         trans: torch.Tensor, camera: Camera,
                         para_mul: float) -> torch.Tensor:
    """The gradient of ``glue_finish``'s ``out`` (plain, no reset) from
    those of its estimate ``g_est = (depth, parallax, other)`` (None:
    zero), in ``out``'s dtype: the memory channels' as given, ``out_0``'s
    as ``(g_para + g_depth d depth / d para) exp(out_0) / para_mul`` inside
    [-7, 7] (0 outside: the clip), with ``d depth / d para = -(rho / para)
    / para / alpha`` (``epipolar_terms``)."""
    g_depth, g_para, g_other = g_est
    o = out.float()
    c0 = o[..., :1]
    ex = torch.exp(torch.clamp(c0, -7.0, 7.0))
    para = ex / para_mul
    gp = torch.zeros_like(para) if g_para is None else g_para
    if g_depth is not None:
        e = epipolar_terms(out.shape[1], out.shape[2], rot, trans, camera)
        gp = gp - (g_depth / e.alpha) * ((e.rho / para) / para)
    d0 = torch.where((c0 >= -7.0) & (c0 <= 7.0), gp / para_mul * ex, 0.0)
    d_other = torch.zeros_like(o[..., 1:]) if g_other is None else g_other
    return torch.cat([d0, d_other], dim=-1).to(out.dtype)


# -- the kernels ---------------------------------------------------------


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _differentiates(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(name: str, what: str, tensors) -> None:
    """Raise if grad is enabled and one of ``tensors`` requires it: the
    kernels give ``what`` no gradient."""
    if _differentiates(tensors):
        raise ValueError(f"{name}: the CUDA kernels give {what} no "
                         "gradient, and one of them requires grad")


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


def _launch_prep(curr_f, f_maps, depth, deeper, trans, f, c, scale,
                 num_cuts, normalize, n_other, init_depth, cv_dtype):
    """Launch ``glue_prep`` on checked inputs: (prev, cam [2, b, 2],
    curr_p, prev_p, para), the last three None without ``f_maps``."""
    dev = curr_f.device
    b, h, w, C = curr_f.shape
    kw = dict(dtype=torch.float32, device=dev)
    cam = torch.empty((2, b, 2), **kw)
    prev = (torch.empty((b, h, w, 1), **kw), torch.empty((b, h, w, 1), **kw),
            torch.empty((b, h, w, n_other), **kw))
    hd, wd = (0, 0) if deeper is None else deeper[0].shape[1:3]
    curr_p = prev_p = para = None
    if f_maps is not None:
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
    return prev, cam, curr_p, prev_p, para


class GluePrepFunction(torch.autograd.Function):
    """``glue_prep``'s kernel with ``glue_prep_backward``'s: gradients for
    the features (``curr_f``, ``f_maps``) and the deeper estimate. It saves
    the features alone: the backward recomputes the cuts' norms, and the
    resize's transpose needs only the deeper estimate's size. The outputs
    are ``(*prev, cam, curr_p, prev_p, para)`` (the last three without
    ``f_maps``); ``cam`` and ``para`` (the detached parallax of the
    previous depth) carry no gradient, nor an output whose inputs require
    none (``prev`` at the deepest level)."""

    @staticmethod
    def forward(ctx, curr_f, f_maps, depth, deep_depth, deep_para,
                deep_other, trans, f, c, scale, num_cuts, normalize,
                n_other, init_depth, cv_dtype):
        deeper = None if deep_depth is None else (deep_depth, deep_para,
                                                  deep_other)
        prev, cam, curr_p, prev_p, para = _launch_prep(
            curr_f, f_maps, depth, deeper, trans, f, c, scale, num_cuts,
            normalize, n_other, init_depth, cv_dtype)
        ctx.set_materialize_grads(False)
        # what no differentiated input reaches carries no gradient
        need = ctx.needs_input_grad
        ctx.mark_non_differentiable(cam, *(
            t for t, n in ((para, False), (curr_p, need[0]),
                           (prev_p, need[1]), *((p, any(need[3:6]))
                                                for p in prev))
            if t is not None and not n))
        ctx.save_for_backward(curr_f, f_maps)
        ctx.args = (None if deeper is None else tuple(deep_depth.shape[1:3]),
                    num_cuts, normalize)
        return (*prev, cam) + (() if f_maps is None else
                               (curr_p, prev_p, para))

    @staticmethod
    def backward(ctx, *grads):
        curr_f, f_maps = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_curr, g_prev = (grads[4:6] if f_maps is not None
                          else (None, None))
        d_curr, d_prev, deeper = glue_prep_backward_fused(
            g_curr if need[0] else None, g_prev if need[1] else None,
            tuple(g if n else None for g, n in zip(grads[:3], need[3:6])),
            curr_f, f_maps, *ctx.args)
        return (d_curr, d_prev, None, *(deeper or (None,) * 3)) + (None,) * 9


def glue_prep_fused(curr_f: torch.Tensor,
                    deeper: Optional[Sequence[torch.Tensor]],
                    state: Optional[Sequence[torch.Tensor]],
                    trans: torch.Tensor, camera: Camera, scale: float,
                    num_cuts: int, normalize: bool, n_other: int,
                    init_depth: float, cv_dtype: torch.dtype) -> Prepared:
    """:func:`glue_prep` on CPU tensors; on CUDA ones ``glue_prep`` of
    ``csrc/glue.cu``, whose features and previous parallax are in
    ``cv_dtype``, through ``GluePrepFunction`` where grad is enabled and
    the features (with a state) or the deeper estimate require grad."""
    tensors = [curr_f, trans, camera.f, camera.c, *(deeper or ()),
               *(state or ())]
    if _on_cpu(tensors):
        return glue_prep(curr_f, deeper, state, trans, camera, scale,
                         num_cuts, normalize, n_other, init_depth, cv_dtype)
    _refuse_grad("glue_prep", "the motion and the camera",
                 [trans, camera.f, camera.c])
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
    if deeper is not None:
        check_kernel_inputs("glue_prep", deeper, (torch.float32,), dev)
        hd, wd = deeper[0].shape[1:3]
        if tuple(t.shape for t in deeper) != tuple(
                (b, hd, wd, n) for n in (1, 1, n_other)):
            raise ValueError(f"glue_prep: the deeper estimate must be "
                             f"[{b}, hd, wd, 1 | 1 | {n_other}]")
    f_maps = depth = None
    if state is not None:
        f_maps, depth = state
        check_kernel_inputs("glue_prep", (f_maps,), (curr_f.dtype,), dev)
        check_kernel_inputs("glue_prep", (depth,), (torch.float32,), dev)
        if f_maps.shape != curr_f.shape or depth.shape != (b, h, w, 1):
            raise ValueError(f"glue_prep: the state must be [{b}, {h}, {w}, "
                             f"{C}] and [{b}, {h}, {w}, 1]")
    args = (trans, f, c, scale, num_cuts, normalize, n_other, init_depth,
            cv_dtype)
    if not _differentiates([*(deeper or ()), *((curr_f, f_maps)
                                               if state is not None
                                               else ())]):
        prev, cam, curr_p, prev_p, para = _launch_prep(
            curr_f, f_maps, depth, deeper, *args)
        return prev, Camera(f=cam[0], c=cam[1]), curr_p, prev_p, para
    out = GluePrepFunction.apply(curr_f, f_maps, depth,
                                 *(deeper or (None,) * 3), *args)
    curr_p, prev_p, para = out[4:] if state is not None else (None,) * 3
    return (tuple(out[:3]), Camera(f=out[3][0], c=out[3][1]), curr_p,
            prev_p, para)


def glue_prep_backward_fused(g_curr_p, g_prev_p, g_prev, curr_f, f_maps,
                             deeper_hw, num_cuts, normalize):
    """:func:`glue_prep_backward` on CPU tensors; on CUDA ones
    ``glue_prep_backward`` of ``csrc/glue_backward.cu``, one launch for
    every gradient that flows (none where none does)."""
    tensors = [curr_f, *(t for t in (g_curr_p, g_prev_p, f_maps, *g_prev)
                         if t is not None)]
    if _on_cpu(tensors):
        return glue_prep_backward(g_curr_p, g_prev_p, g_prev, curr_f, f_maps,
                                  deeper_hw, num_cuts, normalize)
    dev = curr_f.device
    b, h, w, C = curr_f.shape
    if f_maps is None:
        g_prev_p = None
    g_feat = [None if g is None else g.contiguous()
              for g in (g_curr_p, g_prev_p)]
    if deeper_hw is None:
        g_prev = (None,) * 3
    g_deep = [None if g is None else g.float().contiguous() for g in g_prev]
    if all(g is None for g in g_feat + g_deep):
        return None, None, None if deeper_hw is None else (None,) * 3
    cv_dtype = next(g.dtype for g in g_feat + [curr_f] if g is not None)
    check_kernel_inputs("glue_prep_backward",
                        [g for g in g_feat if g is not None],
                        (cv_dtype,), dev)
    check_kernel_inputs("glue_prep_backward", [curr_f] + (
        [] if f_maps is None else [f_maps]), (curr_f.dtype,), dev)
    check_kernel_inputs("glue_prep_backward",
                        [g for g in g_deep if g is not None],
                        (torch.float32,), dev)
    hd, wd = deeper_hw or (0, 0)
    n_other = 0 if g_deep[2] is None else g_deep[2].shape[3]
    d_feat = [None if g is None else torch.empty_like(x)
              for g, x in zip(g_feat, (curr_f, f_maps))]
    kw = dict(dtype=torch.float32, device=dev)
    d_deep = [None if g is None else torch.empty((b, hd, wd, g.shape[3]),
                                                 **kw)
              for g in g_deep]
    GLUE_PREP_BACKWARD_KERNEL.launch(
        *(_ptr(t) for t in (*g_feat, curr_f, f_maps, *g_deep, *d_feat,
                            *d_deep)),
        b, h, w, C, num_cuts, hd, wd, n_other, int(normalize),
        hd / h if hd else 0.0, wd / w if wd else 0.0,
        CONV_DTYPES.index(curr_f.dtype), KERNEL_DTYPES.index(cv_dtype),
        _stream(curr_f), device=dev)
    return d_feat[0], d_feat[1], None if deeper_hw is None else tuple(d_deep)


def _launch_assemble(cv, parallax, other, sncv, para_reproj, para_mul,
                     dtype) -> torch.Tensor:
    """Launch ``glue_assemble`` on checked inputs."""
    b, h, w, n_cv = cv.shape
    n_other = 0 if other is None else other.shape[3]
    n_sncv = 0 if sncv is None else sncv.shape[3]
    recurr = int(para_reproj is not None)
    n = n_cv + 1 + n_other + n_sncv + recurr
    f_input = torch.empty((b, h, w, n), dtype=dtype, device=cv.device)
    GLUE_ASSEMBLE_KERNEL.launch(
        cv.data_ptr(), parallax.data_ptr(), _ptr(other), _ptr(sncv),
        _ptr(para_reproj), f_input.data_ptr(), b * h * w, n_cv, n_other,
        n_sncv, recurr, float(para_mul), CONV_DTYPES.index(dtype),
        _stream(cv), device=cv.device)
    return f_input


class GlueAssembleFunction(torch.autograd.Function):
    """``glue_assemble``'s kernel with ``glue_assemble_backward``'s:
    gradients for every map it reads. It saves the two parallax maps, the
    only inputs the backward reads."""

    @staticmethod
    def forward(ctx, cv, parallax, other, sncv, para_reproj, para_mul,
                dtype):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(parallax, para_reproj)
        ctx.widths = tuple(0 if t is None else t.shape[3]
                           for t in (cv, other, sncv))
        ctx.para_mul = para_mul
        return _launch_assemble(cv, parallax, other, sncv, para_reproj,
                                para_mul, dtype)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * 7
        parallax, para_reproj = ctx.saved_tensors
        return glue_assemble_backward_fused(
            g, parallax, para_reproj, *ctx.widths, ctx.para_mul,
            ctx.needs_input_grad[:5]) + (None, None)


def glue_assemble_fused(cv: torch.Tensor, parallax: torch.Tensor,
                        other: Optional[torch.Tensor],
                        sncv: Optional[torch.Tensor],
                        para_reproj: Optional[torch.Tensor], para_mul: float,
                        dtype: torch.dtype) -> torch.Tensor:
    """:func:`glue_assemble` on CPU tensors; on CUDA ones
    ``glue_assemble`` of ``csrc/glue.cu``, through
    ``GlueAssembleFunction`` where grad is enabled and a map requires
    grad."""
    maps = [t for t in (cv, parallax, other, sncv, para_reproj)
            if t is not None]
    if _on_cpu(maps):
        return glue_assemble(cv, parallax, other, sncv, para_reproj,
                             para_mul, dtype)
    if dtype not in CONV_DTYPES:
        raise TypeError(f"glue_assemble: dtype {dtype} not in "
                        f"{CONV_DTYPES}")
    check_kernel_inputs("glue_assemble", maps, (torch.float32,), cv.device)
    b, h, w, _ = cv.shape
    ones = [t for t in (parallax, para_reproj) if t is not None]
    if any(t.shape[:3] != (b, h, w) for t in maps) or any(
            t.shape[3] != 1 for t in ones):
        raise ValueError(f"glue_assemble: the maps must all be [{b}, {h}, "
                         f"{w}, n], the parallax ones n = 1")
    args = (cv, parallax, other, sncv, para_reproj, para_mul, dtype)
    if _differentiates(maps):
        return GlueAssembleFunction.apply(*args)
    return _launch_assemble(*args)


def glue_assemble_backward_fused(g, parallax, para_reproj, n_cv, n_other,
                                 n_sncv, para_mul, wanted):
    """:func:`glue_assemble_backward` on CPU tensors; on CUDA ones
    ``glue_assemble_backward`` of ``csrc/glue_backward.cu``."""
    if _on_cpu([g, parallax]):
        return glue_assemble_backward(g, parallax, para_reproj, n_cv,
                                      n_other, n_sncv, para_mul, wanted)
    dev = g.device
    g = g.contiguous()
    check_kernel_inputs("glue_assemble_backward", (g,), CONV_DTYPES, dev)
    b, h, w, _ = g.shape
    widths = (n_cv, 1, n_other, n_sncv, int(para_reproj is not None))
    grads = tuple(
        torch.empty((b, h, w, n), dtype=torch.float32, device=dev)
        if want and n else None for want, n in zip(wanted, widths))
    if all(d is None for d in grads):
        return grads
    GLUE_ASSEMBLE_BACKWARD_KERNEL.launch(
        g.data_ptr(), parallax.data_ptr(), _ptr(para_reproj),
        *(_ptr(d) for d in grads), b * h * w, n_cv, n_other, n_sncv,
        widths[4], float(para_mul), CONV_DTYPES.index(g.dtype), _stream(g),
        device=dev)
    return grads


def _launch_finish(out, prev, reset, rot, trans, f, c, para_mul,
                   init_depth) -> Tuple[Maps, torch.Tensor]:
    """Launch ``glue_finish`` on checked inputs."""
    b, h, w, n = out.shape
    kw = dict(dtype=torch.float32, device=out.device)
    est = (torch.empty((b, h, w, 1), **kw), torch.empty((b, h, w, 1), **kw),
           torch.empty((b, h, w, n - 1), **kw))
    next_depth = None if reset is None else torch.empty_like(est[0])
    GLUE_FINISH_KERNEL.launch(
        out.data_ptr(), *(t.data_ptr() for t in prev), _ptr(reset),
        rot.data_ptr(), trans.data_ptr(), f.data_ptr(), c.data_ptr(),
        *(t.data_ptr() for t in est), _ptr(next_depth), b, h, w, n - 1,
        rot.shape[1], float(para_mul), float(init_depth),
        CONV_DTYPES.index(out.dtype), _stream(out), device=out.device)
    return est, est[0] if next_depth is None else next_depth


class GlueFinishFunction(torch.autograd.Function):
    """``glue_finish``'s kernel without a reset, with
    ``glue_finish_backward``'s: the gradient of the refiner's output
    ``out`` from those of the estimate (the depth the next frame reads is
    the estimate's). It saves ``out`` and the motion: the backward
    recomputes the parallax and the epipolar terms."""

    @staticmethod
    def forward(ctx, out, prev_depth, prev_para, prev_other, rot, trans, f,
                c, para_mul, init_depth):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out, rot, trans, f, c)
        ctx.para_mul = para_mul
        est, _ = _launch_finish(out, (prev_depth, prev_para, prev_other),
                                None, rot, trans, f, c, para_mul,
                                init_depth)
        return est

    @staticmethod
    def backward(ctx, *g_est):
        if all(g is None for g in g_est):
            return (None,) * 10
        out, rot, trans, f, c = ctx.saved_tensors
        return (glue_finish_backward_fused(g_est, out, rot, trans,
                                           Camera(f, c), ctx.para_mul),
                ) + (None,) * 9


def glue_finish_fused(out: torch.Tensor, prev: Sequence[torch.Tensor],
                      reset: Optional[torch.Tensor], rot: torch.Tensor,
                      trans: torch.Tensor, camera: Camera, para_mul: float,
                      init_depth: float) -> Tuple[Maps, torch.Tensor]:
    """:func:`glue_finish` on CPU tensors; on CUDA ones ``glue_finish`` of
    ``csrc/glue.cu``, which reads ``out`` in its own dtype, through
    ``GlueFinishFunction`` where grad is enabled and ``out`` requires grad
    (without a reset: a reset under grad raises)."""
    tensors = [out, *prev, rot, trans, camera.f, camera.c] + (
        [] if reset is None else [reset])
    if _on_cpu(tensors):
        return glue_finish(out, prev, reset, rot, trans, camera, para_mul,
                           init_depth)
    _refuse_grad("glue_finish", "the motion and the camera",
                 [rot, trans, camera.f, camera.c])
    if reset is not None:
        _refuse_grad("glue_finish", "a reset estimate", tensors)
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
    if not _differentiates([out]):
        return _launch_finish(out, prev, reset, rot, trans, f, c, para_mul,
                              init_depth)
    est = GlueFinishFunction.apply(out, *prev, rot, trans, f, c, para_mul,
                                   init_depth)
    return tuple(est), est[0]


def glue_finish_backward_fused(g_est, out, rot, trans, camera, para_mul):
    """:func:`glue_finish_backward` on CPU tensors; on CUDA ones
    ``glue_finish_backward`` of ``csrc/glue_backward.cu``."""
    if _on_cpu([out, rot, trans, camera.f, camera.c]):
        return glue_finish_backward(g_est, out, rot, trans, camera, para_mul)
    dev = out.device
    g_est = [None if g is None else g.float().contiguous() for g in g_est]
    check_kernel_inputs("glue_finish_backward",
                        [g for g in g_est if g is not None],
                        (torch.float32,), dev)
    b, h, w, n = out.shape
    d_out = torch.empty_like(out)
    GLUE_FINISH_BACKWARD_KERNEL.launch(
        *(_ptr(g) for g in g_est), out.data_ptr(), rot.data_ptr(),
        trans.data_ptr(), camera.f.data_ptr(), camera.c.data_ptr(),
        d_out.data_ptr(), b, h, w, n - 1, rot.shape[1], float(para_mul),
        CONV_DTYPES.index(out.dtype), _stream(out), device=dev)
    return d_out

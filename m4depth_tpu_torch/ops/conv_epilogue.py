"""A 3x3 conv layer on NHWC tensors with its epilogue: the bias and the leaky
ReLU after the convolution, as the two CUDA kernels of
``csrc/conv_epilogue.cu``, and their plain PyTorch versions.

``conv3x3`` is what ``models/encoder.py::Conv3x3`` runs. It chooses from
what it can observe, as the glue's wrappers do:

* on CPU tensors, the plain chain (``conv3x3_plain``): ``F.conv2d`` with
  the bias cast to the input's dtype, then ``F.leaky_relu``;
* on CUDA tensors that need no gradient, ``F.conv2d`` without a bias (cuDNN
  never took it: ATen added it after the conv), then the kernel
  ``conv_epilogue_forward`` in place on the conv's output;
* on CUDA tensors that need one (grad is enabled and the output or the bias
  requires it: training), the same through ``ConvEpilogueFunction``, whose
  backward launches ``conv_epilogue_backward``: the activation's gradient
  and the bias's, summed in float32.

The slope is the layer's (None: no activation follows, the bias alone).
The kernels' forward is the plain chain on the card bit for bit, in every
dtype; the bias gradient is the plain path's sum without its rounding to
the convs' dtype. The choice is no fallback: on CUDA tensors a missing
build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs
from m4depth_tpu_torch.ops.glue import _differentiates, _on_cpu, _ptr
from m4depth_tpu_torch.ops.sncv import KERNEL_DTYPES, _stream

CONV_EPILOGUE_FORWARD_KERNEL = CudaKernel(
    "conv_epilogue.cu", "conv_epilogue_forward",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
CONV_EPILOGUE_BACKWARD_KERNEL = CudaKernel(
    "conv_epilogue.cu", "conv_epilogue_backward",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])

# the backward kernel's blocks at most (four a streaming multiprocessor of
# an H100, each thread two vectors in flight): the rows of partial bias sums
# that its second launch adds up
BACKWARD_BLOCKS = 528
# the channels the backward kernel takes (its block size at most)
MAX_CHANNELS = 1024


def conv_epilogue(out: torch.Tensor, bias: torch.Tensor,
                  slope: Optional[float]) -> torch.Tensor:
    """The conv's output ``out`` [..., C] (channels last) plus the bias
    cast to its dtype, then the leaky ReLU of ``slope`` (plain)."""
    y = out + bias.to(out.dtype)
    return y if slope is None else F.leaky_relu(y, slope)


def conv_epilogue_backward(g: torch.Tensor, y: Optional[torch.Tensor],
                           slope: Optional[float]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dbias)`` of :func:`conv_epilogue` (plain): from the gradient
    ``g`` [..., C] of its output ``y`` (None without a slope), the
    gradient of its input (ATen's ``leaky_relu_backward``: a slope of 0 or
    more keeps ``y > 0`` where the input is) and the bias's, summed in
    float32."""
    dx = g if slope is None else torch.where(y > 0, g, g * slope)
    return dx, dx.float().sum(dim=tuple(range(dx.dim() - 1)))


# -- the kernels ---------------------------------------------------------


def _check(name: str, bias: Optional[torch.Tensor],
           *maps: torch.Tensor) -> None:
    """The NHWC maps [..., C] (all alike) and the bias [C] float32, if
    given, as the kernels take them."""
    dev = maps[0].device
    check_kernel_inputs(name, maps[:1], KERNEL_DTYPES, dev)
    check_kernel_inputs(name, maps, (maps[0].dtype,), dev)
    C = maps[0].shape[-1]
    if bias is not None:
        check_kernel_inputs(name, (bias,), (torch.float32,), dev)
    if any(t.shape != maps[0].shape for t in maps) or (
            bias is not None and bias.shape != (C,)):
        raise ValueError(f"{name}: the maps must be [..., C] alike and the "
                         f"bias [C], got {[tuple(t.shape) for t in maps]}"
                         + ("" if bias is None else
                            f" and {tuple(bias.shape)}"))


def _launch_forward(y: torch.Tensor, bias: torch.Tensor,
                    slope: Optional[float]) -> None:
    """``conv_epilogue_forward`` in place on ``y`` [..., C] (contiguous)."""
    _check("conv_epilogue_forward", bias, y)
    C = y.shape[-1]
    CONV_EPILOGUE_FORWARD_KERNEL.launch(
        y.data_ptr(), bias.data_ptr(), y.numel() // C, C,
        float(slope or 0.0), int(slope is not None),
        KERNEL_DTYPES.index(y.dtype), _stream(y), device=y.device)


def conv_epilogue_backward_fused(g: torch.Tensor, y: Optional[torch.Tensor],
                                 slope: Optional[float]
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`conv_epilogue_backward` on CPU tensors; on CUDA ones
    ``conv_epilogue_backward`` of ``csrc/conv_epilogue.cu`` on contiguous
    ``g`` and ``y`` [..., C] (``y`` None without a slope, and ``dx`` is then
    ``g``), whose bias gradient is the same sum in another order."""
    if _on_cpu([g]):
        return conv_epilogue_backward(g, y, slope)
    _check("conv_epilogue_backward", None, g,
           *(() if slope is None else (y,)))
    C = g.shape[-1]
    if C > MAX_CHANNELS:
        raise ValueError(f"conv_epilogue_backward: {C} channels, at most "
                         f"{MAX_CHANNELS}")
    if slope is not None and not slope >= 0:
        raise ValueError(f"conv_epilogue_backward: slope {slope} below 0 "
                         "(y > 0 would not mark the input's sign)")
    dev = g.device
    dx = g if slope is None else torch.empty_like(g)
    workspace = torch.empty((BACKWARD_BLOCKS, C), dtype=torch.float32,
                            device=dev)
    dbias = torch.empty(C, dtype=torch.float32, device=dev)
    CONV_EPILOGUE_BACKWARD_KERNEL.launch(
        g.data_ptr(), _ptr(y if slope is not None else None),
        None if slope is None else dx.data_ptr(), workspace.data_ptr(),
        dbias.data_ptr(), g.numel() // C, C, BACKWARD_BLOCKS,
        float(slope or 0.0), int(slope is not None),
        KERNEL_DTYPES.index(g.dtype), _stream(g), device=dev)
    return dx, dbias


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """A channels-last [b, C, h, w] tensor as its contiguous NHWC view."""
    return t.permute(0, 2, 3, 1)


class ConvEpilogueFunction(torch.autograd.Function):
    """``conv_epilogue_forward`` in place on the conv's output ``out`` [b,
    C, h, w] (channels-last memory), which it marks dirty, with
    ``conv_epilogue_backward``'s gradients for ``out`` and the bias. It
    saves the activated output alone, and nothing without a slope: the
    conv's backward keeps its input and weight, not this output."""

    @staticmethod
    def forward(ctx, out, bias, slope):
        _launch_forward(_nhwc(out), bias, slope)
        ctx.mark_dirty(out)
        ctx.slope = slope
        if slope is not None:
            ctx.save_for_backward(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y = _nhwc(ctx.saved_tensors[0]) if ctx.slope is not None else None
        g = _nhwc(g.contiguous(memory_format=torch.channels_last))
        dx, dbias = conv_epilogue_backward_fused(g, y, ctx.slope)
        return dx.permute(0, 3, 1, 2), dbias, None


def conv_epilogue_fused(out: torch.Tensor, bias: torch.Tensor,
                        slope: Optional[float]) -> torch.Tensor:
    """:func:`conv_epilogue` of the conv's output ``out`` [b, C, h, w] on
    CUDA tensors, as a contiguous NHWC [b, h, w, C]: ``conv_epilogue``'s
    kernel in place on ``out`` (made channels-last first: cuDNN returns it
    so for the channels-last inputs the layer gives it), through
    ``ConvEpilogueFunction`` where grad is enabled and ``out`` or the bias
    requires grad."""
    out = out.contiguous(memory_format=torch.channels_last)
    if _differentiates([out, bias]):
        return _nhwc(ConvEpilogueFunction.apply(out, bias, slope))
    _launch_forward(_nhwc(out), bias, slope)
    return _nhwc(out)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  stride: int, padding: Tuple[int, int],
                  slope: Optional[float]) -> torch.Tensor:
    """:func:`conv3x3` as plain PyTorch on any device: ``F.conv2d`` with the
    bias cast to ``x``'s dtype, then ``F.leaky_relu``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype),
                 stride=stride, padding=padding)
    # a backend that returns NCHW would otherwise hand the cost-volume
    # kernels a strided view
    y = y.permute(0, 2, 3, 1).contiguous()
    return y if slope is None else F.leaky_relu(y, slope)


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            stride: int, padding: Tuple[int, int],
            slope: Optional[float]) -> torch.Tensor:
    """A 3x3 conv of ``x`` [b, h, w, Cin] (NHWC) with ``weight`` [Cout,
    Cin, 3, 3] and ``bias`` [Cout] (float32, cast to ``x``'s dtype),
    ``stride`` and symmetric ``padding`` (top, left), then the leaky ReLU
    of ``slope`` (None: none), as a contiguous NHWC [b, ho, wo, Cout]: on
    CPU tensors :func:`conv3x3_plain`, on CUDA ones the conv without its
    bias and :func:`conv_epilogue_fused`. The conv sees ``x`` as a
    channels-last NCHW view, which cuDNN takes without a copy and answers
    in channels-last memory."""
    if _on_cpu([x, weight, bias]):
        return conv3x3_plain(x, weight, bias, stride, padding, slope)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None,
                 stride=stride, padding=padding)
    return conv_epilogue_fused(y, bias, slope)

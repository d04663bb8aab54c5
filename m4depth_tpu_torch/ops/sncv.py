"""Spatial-neighbourhood cost volume (SNCV): the CUDA kernels and their plain
PyTorch versions.

``spatial_cost_volume_fused`` is what the model calls. On CPU tensors it
runs ``spatial_cost_volume``, the plain version (a port of
``m4depth_tpu/ops/cost_volume.py::spatial_cost_volume``), and autograd
differentiates it. On CUDA tensors it launches ``csrc/sncv.cu``'s
``sncv_forward`` (which replaces the TPU kernel
``m4depth_tpu/ops/sncv_pallas.py::_sncv_kernel``) through ``SNCVFunction``
or raises; the Function's backward launches ``sncv_backward`` (the
counterpart of the JAX custom VJP ``_sncv_bwd``), whose plain version is
autograd through ``spatial_cost_volume``.

Both round their inputs to ``cv_dtype`` (float32, bfloat16 or float16) and
then multiply and sum in float32, as the Pallas kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from m4depth_tpu_torch.ops import cost
from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs

SNCV_KERNEL = CudaKernel(
    "sncv.cu", "sncv_forward",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
SNCV_BACKWARD_KERNEL = CudaKernel(
    "sncv.cu", "sncv_backward",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# the input dtypes the kernels take, by the code their C entry points read
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def spatial_cost_volume(
    c1: torch.Tensor,
    c2: torch.Tensor,
    search_range: int,
    num_cuts: int = 1,
    cv_dtype: torch.dtype = torch.bfloat16,
    leaky_slope: float = 0.1,
) -> torch.Tensor:
    """Plain SNCV (auto-correlation when ``c2 is c1``).

    For every offset (dy, dx) of the (2r+1)^2 window and every feature cut,
    the per-pixel mean correlation of c1 with the shifted c2 (zero outside
    the image), then leaky-relu. Channels offset-major / cut-minor.

    Returns: [b, h, w, (2r+1)^2 * num_cuts] float32.
    """
    b, h, w, C = c1.shape
    r = search_range
    side = 2 * r + 1
    n_off = side * side
    cc = C // num_cuts

    c1r = c1.to(cv_dtype).float().reshape(b, h, w, num_cuts, cc)
    pad = F.pad(c2.to(cv_dtype).float(), (0, 0, r, r, r, r))

    def cost_at(o):
        dy, dx = divmod(o, side)
        shifted = pad[:, dy:dy + h, dx:dx + w, :]
        return (c1r * shifted.reshape(b, h, w, num_cuts, cc)).mean(dim=-1)

    if c2 is c1:
        # autocorrelation symmetry: the cost at offset -delta is the +delta
        # cost map shifted by delta (exact, zero-padded borders included),
        # so only (n_off+1)/2 correlation maps are computed
        half = (n_off + 1) // 2
        costs = [cost_at(o) for o in range(half)]
        for o in range(half, n_off):
            mirror = costs[n_off - 1 - o]
            dy, dx = divmod(o, side)
            costs.append(F.pad(mirror, (0, 0, r, r, r, r))[
                :, dy:dy + h, dx:dx + w, :])
    else:
        costs = [cost_at(o) for o in range(n_off)]
    cv = torch.cat(costs, dim=-1)
    return torch.where(cv > 0, cv, cv * leaky_slope)


def _dtype_code(t: torch.Tensor) -> int:
    """The C entry points' code of ``t``'s dtype: 0 float32, 1 bfloat16,
    2 float16."""
    return KERNEL_DTYPES.index(t.dtype)


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _sncv_forward(a: torch.Tensor, bb: torch.Tensor, search_range: int,
                  num_cuts: int, leaky_slope: float) -> torch.Tensor:
    """Launch ``sncv_forward`` on checked inputs of the cost-volume dtype."""
    b, h, w, _ = a.shape
    n_off = (2 * search_range + 1) ** 2
    out = torch.empty((b, h, w, n_off * num_cuts), dtype=torch.float32,
                      device=a.device)
    SNCV_KERNEL.launch(
        a.data_ptr(), bb.data_ptr(), out.data_ptr(), b, h, w, a.shape[3],
        num_cuts, search_range, float(leaky_slope), _dtype_code(a),
        _stream(a), device=a.device)
    return out


def _sncv_backward(grad: torch.Tensor, a: torch.Tensor, bb: torch.Tensor,
                   out: torch.Tensor, search_range: int, num_cuts: int,
                   leaky_slope: float
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``sncv_backward``: (dc1, dc2) in the inputs' dtype, from the
    forward's inputs ``a``, ``bb`` and output ``out``. When ``a is bb`` the
    kernel writes one gradient, their sum: (dc, None)."""
    b, h, w, C = a.shape
    same = a is bb
    g = grad.float().contiguous()
    dc1 = torch.empty_like(a)
    dc2 = None if same else torch.empty_like(bb)
    SNCV_BACKWARD_KERNEL.launch(
        g.data_ptr(), out.data_ptr(), a.data_ptr(), bb.data_ptr(),
        dc1.data_ptr(), None if same else dc2.data_ptr(), b, h, w, C,
        num_cuts, search_range, int(same), float(leaky_slope), _dtype_code(a),
        _stream(a), device=a.device)
    return dc1, dc2


class SNCVFunction(torch.autograd.Function):
    """The SNCV kernel with its backward kernel, on inputs already rounded
    to the cost-volume dtype (the casts stay outside, so autograd casts the
    gradients back). When ``a is bb`` the backward kernel writes the sum of
    both gradients, and the Function returns it as ``a``'s alone."""

    @staticmethod
    def forward(ctx, a, bb, search_range: int, num_cuts: int,
                leaky_slope: float):
        out = _sncv_forward(a, bb, search_range, num_cuts, leaky_slope)
        ctx.save_for_backward(*((a, out) if a is bb else (a, bb, out)))
        ctx.args = (search_range, num_cuts, float(leaky_slope))
        return out

    @staticmethod
    def backward(ctx, grad):
        a, *bb, out = ctx.saved_tensors
        dc1, dc2 = _sncv_backward(grad, a, bb[0] if bb else a, out,
                                  *ctx.args)
        return dc1, dc2, None, None, None


def spatial_cost_volume_fused(
    c1: torch.Tensor,
    c2: torch.Tensor,
    search_range: int,
    num_cuts: int = 1,
    cv_dtype: torch.dtype = torch.bfloat16,
    leaky_slope: float = 0.1,
) -> torch.Tensor:
    """SNCV: the CUDA kernel on CUDA tensors, the plain version on CPU ones.

    Same arguments and result as :func:`spatial_cost_volume`. On CUDA
    tensors that require grad, the result carries ``SNCVFunction``'s graph.
    Under ``cost.counting()`` the call counts its work once.
    """
    def work():
        n_pix = c1.shape[0] * c1.shape[1] * c1.shape[2]
        args = (n_pix, c1.shape[3], num_cuts, search_range,
                torch.finfo(cv_dtype).bits // 8, c2 is c1)
        return cost.sncv_forward_work(*args), cost.sncv_backward_work(*args)

    with cost.counted_call("sncv", work, (c1, c2)) as done:
        return done(_sncv_fused(c1, c2, search_range, num_cuts, cv_dtype,
                                leaky_slope))


def _sncv_fused(c1, c2, search_range, num_cuts, cv_dtype, leaky_slope):
    if c1.device.type == "cpu" and c2.device.type == "cpu":
        return spatial_cost_volume(c1, c2, search_range, num_cuts, cv_dtype,
                                   leaky_slope)
    if c1.dim() != 4 or c1.shape != c2.shape:
        raise ValueError(f"sncv: c1 {tuple(c1.shape)} and c2 "
                         f"{tuple(c2.shape)} must both be [b, h, w, C]")
    C = c1.shape[3]
    if num_cuts <= 0 or C % num_cuts:
        raise ValueError(f"sncv: {C} channels do not split into "
                         f"{num_cuts} cuts")
    if cv_dtype not in KERNEL_DTYPES:
        raise TypeError(f"sncv: cv_dtype {cv_dtype} not in {KERNEL_DTYPES}")
    a = c1.to(cv_dtype)
    bb = a if c2 is c1 else c2.to(cv_dtype)
    check_kernel_inputs("sncv", (a, bb), (cv_dtype,), c1.device)
    return SNCVFunction.apply(a, bb, search_range, num_cuts, leaky_slope)

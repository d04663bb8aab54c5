"""Spatial-neighbourhood cost volume (SNCV): the CUDA kernel and its plain
PyTorch version.

``spatial_cost_volume_fused`` is what the model calls. On CPU tensors it
runs ``spatial_cost_volume``, the plain version (a port of
``m4depth_tpu/ops/cost_volume.py::spatial_cost_volume``); on CUDA tensors it
launches ``csrc/sncv.cu`` (which replaces the TPU kernel
``m4depth_tpu/ops/sncv_pallas.py::_sncv_kernel``) or raises.

Both round their inputs to ``cv_dtype`` and then multiply and sum in
float32, as the Pallas kernel does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from m4depth_tpu_torch.ops._build import CudaKernel, check_kernel_inputs

SNCV_KERNEL = CudaKernel(
    "sncv.cu", "sncv_forward",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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


def spatial_cost_volume_fused(
    c1: torch.Tensor,
    c2: torch.Tensor,
    search_range: int,
    num_cuts: int = 1,
    cv_dtype: torch.dtype = torch.bfloat16,
    leaky_slope: float = 0.1,
) -> torch.Tensor:
    """SNCV: the CUDA kernel on CUDA tensors, the plain version on CPU ones.

    Same arguments and result as :func:`spatial_cost_volume`.
    """
    if c1.device.type == "cpu" and c2.device.type == "cpu":
        return spatial_cost_volume(c1, c2, search_range, num_cuts, cv_dtype,
                                   leaky_slope)
    if c1.dim() != 4 or c1.shape != c2.shape:
        raise ValueError(f"sncv: c1 {tuple(c1.shape)} and c2 "
                         f"{tuple(c2.shape)} must both be [b, h, w, C]")
    b, h, w, C = c1.shape
    if num_cuts <= 0 or C % num_cuts:
        raise ValueError(f"sncv: {C} channels do not split into "
                         f"{num_cuts} cuts")
    if cv_dtype not in KERNEL_DTYPES:
        raise TypeError(f"sncv: cv_dtype {cv_dtype} not in {KERNEL_DTYPES}")
    a, bb = c1.to(cv_dtype), c2.to(cv_dtype)
    check_kernel_inputs("sncv", (a, bb), (cv_dtype,), c1.device)
    n_off = (2 * search_range + 1) ** 2
    out = torch.empty((b, h, w, n_off * num_cuts), dtype=torch.float32,
                      device=c1.device)
    SNCV_KERNEL.launch(
        a.data_ptr(), bb.data_ptr(), out.data_ptr(), b, h, w, C, num_cuts,
        search_range, float(leaky_slope), int(cv_dtype == torch.bfloat16),
        torch.cuda.current_stream(c1.device).cuda_stream)
    return out

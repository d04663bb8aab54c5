"""Cost volumes and warping: CUDA kernels on CUDA tensors, plain PyTorch
versions on CPU tensors. Importing builds nothing; a kernel is compiled at
its first launch."""

from m4depth_tpu_torch.ops.cost_volume import (
    DSCV_BACKWARD_KERNEL,
    DSCV_KERNEL,
    DSCVFunction,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
)
from m4depth_tpu_torch.ops.sncv import (
    SNCV_BACKWARD_KERNEL,
    SNCV_KERNEL,
    SNCVFunction,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops.warp import dense_image_warp

# every kernel of the port, by its C entry point
KERNELS = {k.symbol: k for k in (SNCV_KERNEL, DSCV_KERNEL,
                                 SNCV_BACKWARD_KERNEL, DSCV_BACKWARD_KERNEL)}

__all__ = [
    "DSCVFunction", "DSCV_BACKWARD_KERNEL", "DSCV_KERNEL", "KERNELS",
    "SNCVFunction", "SNCV_BACKWARD_KERNEL", "SNCV_KERNEL", "dense_image_warp",
    "parallax_sweeping_cv", "parallax_sweeping_cv_fused",
    "spatial_cost_volume", "spatial_cost_volume_fused",
]

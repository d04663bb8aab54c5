"""Cost volumes and warping: CUDA kernels on CUDA tensors, plain PyTorch
versions on CPU tensors. Importing builds nothing; a kernel is compiled at
its first launch."""

from m4depth_tpu_torch.ops.cost_volume import (
    DSCV_KERNEL,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
)
from m4depth_tpu_torch.ops.sncv import (
    SNCV_KERNEL,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops.warp import dense_image_warp

KERNELS = {"sncv": SNCV_KERNEL, "dscv": DSCV_KERNEL}

__all__ = [
    "DSCV_KERNEL", "KERNELS", "SNCV_KERNEL", "dense_image_warp",
    "parallax_sweeping_cv", "parallax_sweeping_cv_fused",
    "spatial_cost_volume", "spatial_cost_volume_fused",
]

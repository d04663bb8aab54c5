"""Cost volumes, warping, the decoder's glue and the convs' epilogue: CUDA
kernels on CUDA tensors, plain PyTorch versions on CPU tensors. Importing
builds nothing; a kernel is compiled at its first launch."""

from m4depth_tpu_torch.ops.conv_epilogue import (
    CONV_EPILOGUE_BACKWARD_KERNEL,
    CONV_EPILOGUE_FORWARD_KERNEL,
)
from m4depth_tpu_torch.ops.cost_volume import (
    DSCV_BACKWARD_KERNEL,
    DSCV_KERNEL,
    DSCVFunction,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
)
from m4depth_tpu_torch.ops.glue import (
    GLUE_ASSEMBLE_BACKWARD_KERNEL,
    GLUE_ASSEMBLE_KERNEL,
    GLUE_FINISH_BACKWARD_KERNEL,
    GLUE_FINISH_KERNEL,
    GLUE_PREP_BACKWARD_KERNEL,
    GLUE_PREP_KERNEL,
)
from m4depth_tpu_torch.ops.glue_v1 import (
    GLUE_V1_ASSEMBLE_KERNEL,
    GLUE_V1_FINISH_KERNEL,
    GLUE_V1_PREP_KERNEL,
)
from m4depth_tpu_torch.ops.sncv import (
    SNCV_BACKWARD_KERNEL,
    SNCV_KERNEL,
    SNCVFunction,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops.warp import dense_image_warp

# the hand-written kernels by their C entry points: the cost volumes', then
# the decoder glue's and their backwards, then V1's decoder glue's, then the
# convs' epilogue and its backward
KERNELS = {k.symbol: k for k in (
    SNCV_KERNEL, DSCV_KERNEL, SNCV_BACKWARD_KERNEL, DSCV_BACKWARD_KERNEL,
    GLUE_PREP_KERNEL, GLUE_ASSEMBLE_KERNEL, GLUE_FINISH_KERNEL,
    GLUE_PREP_BACKWARD_KERNEL, GLUE_ASSEMBLE_BACKWARD_KERNEL,
    GLUE_FINISH_BACKWARD_KERNEL, GLUE_V1_PREP_KERNEL,
    GLUE_V1_ASSEMBLE_KERNEL, GLUE_V1_FINISH_KERNEL,
    CONV_EPILOGUE_FORWARD_KERNEL, CONV_EPILOGUE_BACKWARD_KERNEL)}


def kernel_launches(prefix: str, since=None, calls: int = 1):
    """The runs on the device (``CudaKernel.launches``, replays counted)
    of each kernel whose C entry point starts with ``prefix``, by entry
    point: so far, or with ``since`` (an earlier result) since then over
    ``calls``. Which path a wrapper took reads from them."""
    now = {name: k.launches for name, k in KERNELS.items()
           if name.startswith(prefix)}
    if since is None:
        return now
    return {name: (n - since[name]) / calls for name, n in now.items()}


def glue_launches(since=None, calls: int = 1):
    """:func:`kernel_launches` of the decoder glues' kernels."""
    return kernel_launches("glue", since, calls)

__all__ = [
    "CONV_EPILOGUE_BACKWARD_KERNEL", "CONV_EPILOGUE_FORWARD_KERNEL",
    "DSCVFunction", "DSCV_BACKWARD_KERNEL", "DSCV_KERNEL",
    "GLUE_ASSEMBLE_BACKWARD_KERNEL", "GLUE_ASSEMBLE_KERNEL",
    "GLUE_FINISH_BACKWARD_KERNEL", "GLUE_FINISH_KERNEL",
    "GLUE_PREP_BACKWARD_KERNEL", "GLUE_PREP_KERNEL",
    "GLUE_V1_ASSEMBLE_KERNEL", "GLUE_V1_FINISH_KERNEL", "GLUE_V1_PREP_KERNEL",
    "KERNELS", "SNCVFunction", "SNCV_BACKWARD_KERNEL", "SNCV_KERNEL",
    "dense_image_warp", "glue_launches", "kernel_launches",
    "parallax_sweeping_cv",
    "parallax_sweeping_cv_fused",
    "spatial_cost_volume", "spatial_cost_volume_fused",
]

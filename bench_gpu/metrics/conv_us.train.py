"""conv_us.train: device time a step of the convolution and GEMM kernels
(cuDNN's and cuBLAS', by name), in us."""


def read(t):
    return 1e6 * t.by_class.get("conv", 0.0)

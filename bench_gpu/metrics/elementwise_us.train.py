"""elementwise_us.train: device time a step of the kernels that are not
convolutions or GEMMs, not the port's cost-volume kernels and not copies:
the encoder's, the decoder's and the geometry's elementwise work, in us."""


def read(t):
    return 1e6 * t.by_class.get("elementwise", 0.0)

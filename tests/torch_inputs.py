"""Cost-volume inputs for the PyTorch port's tests, made with numpy from a
seed. Imports no JAX, so the card-only tests can use it on a host without
JAX."""

import numpy as np


def norm_cuts(x, cuts):
    """Per-cut L2-normalized features, as the model feeds both ops."""
    b, h, w, c = x.shape
    blk = x.reshape(b, h, w, cuts, c // cuts)
    blk = blk / np.sqrt(np.maximum((blk * blk).sum(-1, keepdims=True), 1e-12))
    return blk.reshape(b, h, w, c).astype(np.float32)


def dscv_inputs(b=2, h=12, w=16, C=8, cuts=1, seed=0, rot_dim=4):
    """(c1, c2, para_prev_t, centre, rot, trans, f, c) as float32 arrays."""
    rng = np.random.RandomState(seed)
    c1 = norm_cuts(rng.randn(b, h, w, C), cuts)
    c2 = norm_cuts(rng.randn(b, h, w, C), cuts)
    para = (rng.rand(b, h, w, 1) * 3).astype(np.float32)
    # centres above the 1e-6 clip, which the model never goes below; a few
    # large ones push samples past the border clamp
    centre = (0.5 + rng.rand(b, h, w, 1) * 4).astype(np.float32)
    centre[:, ::5, ::7] = 150.0
    quat = [1.0, 0.002, -0.001, 0.0005]
    rot = np.tile([quat if rot_dim == 4 else quat[1:]], (b, 1))
    trans = np.tile([[0.05, 0.02, 0.4]], (b, 1))
    f = np.full((b, 2), w * 0.6)
    c = np.tile([[w / 2, h / 2]], (b, 1))
    return (c1, c2, para, centre) + tuple(
        x.astype(np.float32) for x in (rot, trans, f, c))

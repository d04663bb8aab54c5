"""The PyTorch port's CUDA kernels on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each
is marked ``cuda`` and skips with its reason where
``torch.cuda.is_available()`` is false. The file imports no JAX, so on a
GPU host without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Each kernel is held against its plain PyTorch version on the same inputs.
"""

import numpy as np
import pytest
import torch

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.ops import (
    DSCV_KERNEL,
    SNCV_KERNEL,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from torch_inputs import dscv_inputs, norm_cuts

pytestmark = pytest.mark.cuda

# Both sides round their inputs to the dtype and multiply and add in
# float32. The SNCV sums the same products in another order; the DSCV
# kernel also computes its sample positions inline, which moves them by a
# few float32 ulps, and the bilinear sample is continuous in the position.
SNCV_TOL = dict(rtol=1e-5, atol=1e-6)
DSCV_CV_TOL = dict(rtol=1e-4, atol=2e-5)
DSCV_PARA_TOL = dict(rtol=1e-4, atol=5e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dscv(fn, args, cuts, dtype, device):
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(a).to(device) for a in args)
    return fn(c1.to(dtype), c2.to(dtype), para, centre, rot, trans,
              Camera(f, c), 4, cuts, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("shape,cuts", [((2, 20, 24, 16), 1),
                                        ((1, 6, 6, 192), 8)])
def test_sncv_kernel_matches_plain(cuda, shape, cuts, same, dtype):
    rng = np.random.RandomState(0)
    c1 = torch.from_numpy(norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    c2 = c1 if same else torch.from_numpy(
        norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    before = SNCV_KERNEL.launches
    out = spatial_cost_volume_fused(c1, c2, 3, cuts, dtype)
    torch.cuda.synchronize()
    assert SNCV_KERNEL.launches == before + 1
    ref = spatial_cost_volume(c1, c2, 3, cuts, dtype)
    assert out.shape == shape[:3] + (49 * cuts,)
    torch.testing.assert_close(out, ref, **SNCV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rot_dim", [3, 4])
@pytest.mark.parametrize("cuts", [1, 4])
def test_dscv_kernel_matches_plain(cuda, cuts, rot_dim, dtype):
    args = dscv_inputs(h=24, w=20, C=16, cuts=cuts, rot_dim=rot_dim)
    before = DSCV_KERNEL.launches
    cv, para = _dscv(parallax_sweeping_cv_fused, args, cuts, dtype, cuda)
    torch.cuda.synchronize()
    assert DSCV_KERNEL.launches == before + 1
    cv_ref, para_ref = _dscv(parallax_sweeping_cv, args, cuts, dtype, cuda)
    assert cv.shape == (2, 24, 20, 9 * cuts) and para.shape == (2, 24, 20, 1)
    torch.testing.assert_close(cv, cv_ref, **DSCV_CV_TOL)
    torch.testing.assert_close(para, para_ref, **DSCV_PARA_TOL)


def test_kernel_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spatial_cost_volume_fused(x.transpose(1, 2), x.transpose(1, 2), 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        spatial_cost_volume_fused(x, x.cpu(), 3)
    args = dscv_inputs(b=1, h=8, w=8, C=4)
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(a).to(cuda) for a in args)
    with pytest.raises(ValueError, match="one CUDA device"):
        parallax_sweeping_cv_fused(c1, c2, para, centre, rot.cpu(), trans,
                                   Camera(f, c), 4, 1, torch.float32)
    with pytest.raises(ValueError, match="rot must be"):
        parallax_sweeping_cv_fused(c1, c2, para, centre, rot[:, :2], trans,
                                   Camera(f, c), 4, 1, torch.float32)


def test_model_on_card_matches_cpu(cuda):
    """The kernels inside the model: the card (kernels) against the CPU
    (plain versions) on the same weights, float32 with TF32 off, 3 frames
    with a per-element reset. The mostly lateral motion keeps the
    recurrence well conditioned, so op-level float32 differences stay at
    that size in depth."""
    cfg = ModelConfig(num_levels=4, encoder_channels=(8, 12, 16, 16),
                      refiner_prep_channels=(16, 16, 8),
                      refiner_est_channels=(8, 8, 5),
                      compute_dtype="float32", cv_dtype="float32")
    b, hw = 2, 64
    rng = np.random.RandomState(1)
    models = {d: M4Depth(cfg, device=d, seed=2) for d in ("cpu", "cuda")}
    states = {d: init_state(cfg, b, hw, hw, device=d) for d in models}
    before = (SNCV_KERNEL.launches, DSCV_KERNEL.launches)
    for t in range(3):
        rgb = torch.from_numpy(rng.rand(b, hw, hw, 3).astype(np.float32))
        rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
        trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
        f = torch.full((b, 2), hw / 2)
        new_traj = torch.tensor([t in (0, 2), t == 0])
        depth = {}
        for d, m in models.items():
            states[d], depth[d] = m.step(
                states[d], rgb.to(d), rot.to(d), trans.to(d),
                Camera(f.to(d), f.to(d)), new_traj.to(d))
        torch.testing.assert_close(depth["cuda"].cpu(), depth["cpu"],
                                   rtol=1e-3, atol=1e-4)
    assert (SNCV_KERNEL.launches - before[0],
            DSCV_KERNEL.launches - before[1]) == (12, 12)

"""The PyTorch port's CUDA kernels on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each
is marked ``cuda`` and skips with its reason where
``torch.cuda.is_available()`` is false. The file imports no JAX, so on a
GPU host without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Each kernel is held against its plain PyTorch version on the same inputs;
each backward kernel against autograd of the plain forward.
"""

import numpy as np
import pytest
import torch

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.ops import (
    DSCV_BACKWARD_KERNEL,
    DSCV_KERNEL,
    SNCV_BACKWARD_KERNEL,
    SNCV_KERNEL,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.testing import (
    DSCV_CV_TOL,
    DSCV_PARA_TOL,
    MODEL_TOL,
    SNCV_TOL,
    STEP_LOSS_RTOL,
    assert_dscv_grads_close,
    assert_sncv_grads_close,
    assert_train_step_close,
    tie_free_pixels,
)
from m4depth_tpu_torch.train import make_optimizer, make_train_step
from torch_inputs import dscv_inputs, norm_cuts

pytestmark = pytest.mark.cuda

# The tolerances, and why, are in m4depth_tpu_torch/testing.py: chip_smoke.py
# holds the kernels to the same ones.


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
                                   **MODEL_TOL)
    assert (SNCV_KERNEL.launches - before[0],
            DSCV_KERNEL.launches - before[1]) == (12, 12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("shape,cuts", [((2, 20, 24, 16), 1),
                                        ((3, 6, 6, 192), 8)])
def test_sncv_backward_kernel_matches_plain(cuda, shape, cuts, same, dtype):
    rng = np.random.RandomState(1)
    c1 = torch.from_numpy(norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    c2 = c1 if same else torch.from_numpy(
        norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    g = torch.from_numpy(rng.randn(*shape[:3], 49 * cuts).astype(
        np.float32)).to(cuda)
    grads, launched = [], []
    for fn in (spatial_cost_volume_fused, spatial_cost_volume):
        a = c1.detach().clone().requires_grad_()
        b = a if same else c2.detach().clone().requires_grad_()
        before = SNCV_BACKWARD_KERNEL.launches
        (fn(a, b, 3, cuts, dtype) * g).sum().backward()
        torch.cuda.synchronize()
        launched.append(SNCV_BACKWARD_KERNEL.launches - before)
        grads.append([a.grad] if same else [a.grad, b.grad])
    assert launched == [1, 0]
    assert_sncv_grads_close(*grads, dtype, same)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rot_dim", [3, 4])
@pytest.mark.parametrize("cuts", [1, 4])
def test_dscv_backward_kernel_matches_plain(cuda, cuts, rot_dim, dtype):
    """Every input gradient: c1, c2, the previous parallax, the centre."""
    args = dscv_inputs(h=24, w=20, C=16, cuts=cuts, rot_dim=rot_dim, seed=3)
    rng = np.random.RandomState(4)
    gcv = torch.from_numpy(rng.randn(2, 24, 20, 9 * cuts).astype(
        np.float32)).to(cuda)
    gpw = torch.from_numpy(rng.randn(2, 24, 20, 1).astype(np.float32)).to(cuda)
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(a).to(cuda) for a in args)
    cam = Camera(f, c)
    grads = []
    for fn in (parallax_sweeping_cv_fused, parallax_sweeping_cv):
        ins = [t.detach().clone().requires_grad_()
               for t in (c1.to(dtype), c2.to(dtype), para, centre)]
        before = DSCV_BACKWARD_KERNEL.launches
        cv, pw = fn(*ins, rot, trans, cam, 4, cuts, dtype)
        ((cv * gcv).sum() + (pw * gpw).sum()).backward()
        torch.cuda.synchronize()
        grads.append([t.grad for t in ins])
        if fn is parallax_sweeping_cv_fused:
            assert DSCV_BACKWARD_KERNEL.launches == before + 1
    mask = tie_free_pixels(centre, rot, trans, cam, 4)
    assert mask.float().mean() > 0.9
    assert_dscv_grads_close(*grads, dtype, mask)


def test_fused_wrappers_carry_gradients(cuda):
    """Both wrappers return a graph when an input requires grad (they once
    returned a bare tensor, so no gradient reached c1, c2 or the centre),
    and none under no_grad or when no input requires grad."""
    args = dscv_inputs(b=1, h=8, w=8, C=4)
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(a).to(cuda) for a in args)
    x = c1.clone().requires_grad_()
    assert spatial_cost_volume_fused(x, x, 3, 1, torch.float32).grad_fn
    cen = centre.clone().requires_grad_()
    cv, pw = parallax_sweeping_cv_fused(c1, c2, para, cen, rot, trans,
                                        Camera(f, c), 4, 1, torch.float32)
    assert cv.grad_fn is not None and pw.grad_fn is not None
    with torch.no_grad():
        assert spatial_cost_volume_fused(x, x, 3, 1, torch.float32).grad_fn \
            is None
    assert parallax_sweeping_cv_fused(
        c1, c2, para, centre, rot, trans, Camera(f, c), 4, 1,
        torch.float32)[0].grad_fn is None


def test_dscv_raises_when_motion_requires_grad(cuda):
    args = dscv_inputs(b=1, h=8, w=8, C=4)
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(a).to(cuda) for a in args)
    with pytest.raises(ValueError, match="no gradient for rot"):
        parallax_sweeping_cv_fused(
            c1.requires_grad_(), c2, para, centre, rot.requires_grad_(),
            trans, Camera(f, c), 4, 1, torch.float32)


def test_train_step_on_card_matches_cpu(cuda):
    """One training step of a d4 model at 64x64 (b=2, T=3), card (kernels)
    against CPU (plain versions), float32 with TF32 off: the loss, every
    gradient and the parameters after the Adam step. The encoder's
    gradient is non-zero on the card: it arrives through the kernels."""
    cfg = ModelConfig(num_levels=4, encoder_channels=(8, 12, 16, 16),
                      refiner_prep_channels=(16, 16, 8),
                      refiner_est_channels=(8, 8, 5),
                      compute_dtype="float32", cv_dtype="float32")
    b, T, hw = 2, 3, 64
    rng = np.random.RandomState(5)
    batch = {
        "rgb": rng.rand(b, T, hw, hw, 3).astype(np.float32),
        "depth": (1 + 60 * rng.rand(b, T, hw, hw, 1)).astype(np.float32),
        "rot": np.tile(np.array([1.0, 0.001, -0.002, 0.001], np.float32),
                       (b, T, 1)),
        "trans": np.tile(np.array([0.3, 0.1, 0.02], np.float32), (b, T, 1)),
        "camera_f": np.full((b, 2), hw / 2, np.float32),
        "camera_c": np.full((b, 2), hw / 2, np.float32),
    }
    out, grads, params = {}, {}, {}
    launches = [k.launches for k in (DSCV_BACKWARD_KERNEL,
                                     SNCV_BACKWARD_KERNEL)]
    for dev in ("cpu", "cuda"):
        model = M4Depth(cfg, device=dev, seed=7)
        opt = make_optimizer(model, TrainConfig(learning_rate=1e-4))
        out[dev] = make_train_step(model, opt)(
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        params[dev] = {n: p.detach().cpu()
                       for n, p in model.named_parameters()}
    assert [k.launches for k in (DSCV_BACKWARD_KERNEL,
                                 SNCV_BACKWARD_KERNEL)] == [
        n + 2 * cfg.num_levels for n in launches]
    torch.testing.assert_close(out["cuda"]["loss"].cpu(), out["cpu"]["loss"],
                               rtol=STEP_LOSS_RTOL, atol=0)
    assert_train_step_close(grads["cuda"], grads["cpu"], params["cuda"],
                            params["cpu"], lr=1e-4)
    assert float(grads["cuda"]["encoder.conv_s1.0.weight"].abs().max()) > 0

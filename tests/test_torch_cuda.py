"""The PyTorch port's CUDA kernels on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each
is marked ``cuda`` and skips with its reason where
``torch.cuda.is_available()`` is false. The file imports no JAX, so on a
GPU host without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Each kernel is held against its plain PyTorch version on the same inputs;
each backward kernel against autograd of the plain forward. The compiled
programs (CUDA graphs of the serving, eval and train steps) are held
against the eager steps, with their captures, replays and launch counts.
"""

import contextlib

import numpy as np
import pytest
import torch

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.ops import (
    DSCV_BACKWARD_KERNEL,
    DSCV_KERNEL,
    GLUE_ASSEMBLE_BACKWARD_KERNEL,
    GLUE_ASSEMBLE_KERNEL,
    GLUE_FINISH_BACKWARD_KERNEL,
    GLUE_FINISH_KERNEL,
    GLUE_PREP_BACKWARD_KERNEL,
    GLUE_PREP_KERNEL,
    GLUE_V1_ASSEMBLE_KERNEL,
    GLUE_V1_FINISH_KERNEL,
    GLUE_V1_PREP_KERNEL,
    SNCV_BACKWARD_KERNEL,
    SNCV_KERNEL,
    glue_launches,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops import glue, glue_v1
from m4depth_tpu_torch.ops.cost_volume import round_parallax
from m4depth_tpu_torch.ops.sncv import KERNEL_DTYPES, _sncv_backward
from m4depth_tpu_torch.testing import (
    DSCV_CV_TOL,
    DSCV_PARA_TOL,
    GLUE_BWD_TOL,
    MODEL_TOL,
    SNCV_TOL,
    STEP_LOSS_RTOL,
    V1_SNCV_EDGE_SHAPES,
    assert_bf16_depth_close,
    assert_dscv_grads_close,
    assert_glue_steps_close,
    assert_grad_close,
    assert_sncv_grads_close,
    assert_train_step_close,
    assert_within_ulps,
    plain_glue,
    sncv_plain_grads,
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


# The d6 model's decoder levels at 384x384, (h, w, C, cuts), finest first.
D6_LEVELS = ((192, 192, 16, 1), (96, 96, 32, 2), (48, 48, 64, 2),
             (24, 24, 96, 4), (12, 12, 128, 4), (6, 6, 192, 8))
# Each level shape at b=1 (serving) and b=3 (training); the ragged shapes
# below add sides that are multiples of no tile or segment.
LEVEL_SHAPES = [((b, h, w, C), cuts) for b in (1, 3)
                for h, w, C, cuts in D6_LEVELS]
LEVEL_IDS = [f"b{b}-{h}x{w}-C{C}-cuts{cuts}"
             for (b, h, w, C), cuts in LEVEL_SHAPES]


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize(
    "shape,cuts",
    LEVEL_SHAPES + [((2, 20, 24, 16), 1), ((2, 7, 5, 32), 2)],
    ids=LEVEL_IDS + ["ragged-20x24", "ragged-7x5"])
def test_sncv_kernel_matches_plain(cuda, shape, cuts, same, dtype):
    _check_sncv_forward(cuda, shape, cuts, same, dtype, radius=3)


def _check_sncv_forward(cuda, shape, cuts, same, dtype, radius):
    rng = np.random.RandomState(0)
    c1 = torch.from_numpy(norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    c2 = c1 if same else torch.from_numpy(
        norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    before = SNCV_KERNEL.launches
    out = spatial_cost_volume_fused(c1, c2, radius, cuts, dtype)
    torch.cuda.synchronize()
    assert SNCV_KERNEL.launches == before + 1
    ref = spatial_cost_volume(c1, c2, radius, cuts, dtype)
    assert out.shape == shape[:3] + ((2 * radius + 1) ** 2 * cuts,)
    torch.testing.assert_close(out, ref, **SNCV_TOL)


# The V1 model's SNCV: a 9x9 cross-correlation (radius 4) of one cut of the
# current features with the warped previous ones (c1 != c2), at the d6
# model's level shapes, b=1 and b=3.
V1_LEVEL_SHAPES = [((b, h, w, C), 1) for b in (1, 3)
                   for h, w, C, _ in D6_LEVELS]
V1_LEVEL_IDS = [f"v1-b{b}-{h}x{w}-C{C}" for (b, h, w, C), _ in V1_LEVEL_SHAPES]


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("shape,cuts", V1_LEVEL_SHAPES, ids=V1_LEVEL_IDS)
def test_sncv_radius4_kernel_matches_plain(cuda, shape, cuts, dtype):
    _check_sncv_forward(cuda, shape, cuts, False, dtype, radius=4)


V1_EDGE_IDS = [f"v1-b{b}-{h}x{w}-C{C}" for b, h, w, C in V1_SNCV_EDGE_SHAPES]


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("shape", V1_SNCV_EDGE_SHAPES, ids=V1_EDGE_IDS)
def test_sncv_radius4_edge_kernel_matches_plain(cuda, shape, dtype):
    _check_sncv_forward(cuda, shape, 1, False, dtype, radius=4)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("rot_dim", [3, 4])
@pytest.mark.parametrize(
    "shape,cuts",
    LEVEL_SHAPES + [((2, 24, 20, 16), 1), ((2, 24, 20, 16), 4),
                    ((2, 7, 5, 16), 2)],
    ids=LEVEL_IDS + ["ragged-24x20-cuts1", "ragged-24x20-cuts4",
                     "ragged-7x5"])
def test_dscv_kernel_matches_plain(cuda, shape, cuts, rot_dim, dtype):
    b, h, w, C = shape
    args = dscv_inputs(b=b, h=h, w=w, C=C, cuts=cuts, rot_dim=rot_dim)
    before = DSCV_KERNEL.launches
    cv, para = _dscv(parallax_sweeping_cv_fused, args, cuts, dtype, cuda)
    torch.cuda.synchronize()
    assert DSCV_KERNEL.launches == before + 1
    cv_ref, para_ref = _dscv(parallax_sweeping_cv, args, cuts, dtype, cuda)
    assert cv.shape == (b, h, w, 9 * cuts) and para.shape == (b, h, w, 1)
    torch.testing.assert_close(cv, cv_ref, **DSCV_CV_TOL)
    torch.testing.assert_close(para, para_ref, **DSCV_PARA_TOL)


def test_dscv_fp16_extreme_parallax_stays_finite(cuda):
    """A previous parallax of 1e6, past float16's 65504 (the JAX package's
    regression input): the wrapper saturates it before the kernel reads
    it, so every output is finite, the warped parallax at most 65504, and
    both equal the plain version's."""
    args = dscv_inputs(b=1, h=12, w=14, C=8, cuts=1, seed=3)
    args = args[:2] + (np.full_like(args[2], 1.0e6),) + args[3:]
    cv, para = _dscv(parallax_sweeping_cv_fused, args, 1, torch.float16,
                     cuda)
    cv_ref, para_ref = _dscv(parallax_sweeping_cv, args, 1, torch.float16,
                             cuda)
    torch.cuda.synchronize()
    assert torch.isfinite(cv).all() and torch.isfinite(para).all()
    assert para.max().item() <= 65504.0
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


def test_model_on_card_without_cudnn_matches_cudnn(cuda):
    """The decoder does not depend on cuDNN's layout: with cuDNN off the
    card's convs return NCHW memory, and the cost-volume kernels (which
    refuse strided inputs) must still get contiguous NHWC features. Three
    frames of a d4 model at 64x64, float32, against the same weights with
    cuDNN on."""
    cfg = ModelConfig(num_levels=4, encoder_channels=(8, 12, 16, 16),
                      refiner_prep_channels=(16, 16, 8),
                      refiner_est_channels=(8, 8, 5),
                      compute_dtype="float32", cv_dtype="float32")
    b, hw = 2, 64
    rng = np.random.RandomState(6)
    frames = [torch.from_numpy(rng.rand(b, hw, hw, 3).astype(np.float32)).to(
        cuda) for _ in range(3)]
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b, device=cuda)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b, device=cuda)
    f = torch.full((b, 2), hw / 2, device=cuda)
    model = M4Depth(cfg, device=cuda, seed=2)
    depths = {}
    for cudnn in (True, False):
        before = (SNCV_KERNEL.launches, DSCV_KERNEL.launches)
        # flags() sets every cuDNN flag: TF32 stays off as the fixture set it
        with (contextlib.nullcontext() if cudnn else
              torch.backends.cudnn.flags(enabled=False, allow_tf32=False)):
            state = init_state(cfg, b, hw, hw, device=cuda)
            depths[cudnn] = []
            for t, rgb in enumerate(frames):
                state, depth = model.step(
                    state, rgb, rot, trans, Camera(f, f.clone()),
                    torch.tensor([t == 0, t in (0, 2)], device=cuda))
                depths[cudnn].append(depth)
            torch.cuda.synchronize()
        assert (SNCV_KERNEL.launches - before[0],
                DSCV_KERNEL.launches - before[1]) == (12, 12)
    for off, on in zip(depths[False], depths[True]):
        assert bool(torch.isfinite(off).all())
        torch.testing.assert_close(off, on, **MODEL_TOL)


# The backward kernels at the same shapes as the forwards.
BACKWARD_SNCV_SHAPES = LEVEL_SHAPES + [((2, 20, 24, 16), 1), ((2, 7, 5, 32), 2)]
BACKWARD_SNCV_IDS = LEVEL_IDS + ["ragged-20x24", "ragged-7x5"]
BACKWARD_DSCV_SHAPES = LEVEL_SHAPES + [((2, 24, 20, 16), 1),
                                       ((2, 24, 20, 16), 4),
                                       ((2, 7, 5, 16), 2)]
BACKWARD_DSCV_IDS = LEVEL_IDS + ["ragged-24x20-cuts1", "ragged-24x20-cuts4",
                                 "ragged-7x5"]


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("shape,cuts", BACKWARD_SNCV_SHAPES,
                         ids=BACKWARD_SNCV_IDS)
def test_sncv_backward_kernel_matches_plain(cuda, shape, cuts, same, dtype):
    _check_sncv_backward(cuda, shape, cuts, same, dtype, radius=3)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("shape,cuts", V1_LEVEL_SHAPES, ids=V1_LEVEL_IDS)
def test_sncv_radius4_backward_kernel_matches_plain(cuda, shape, cuts,
                                                    dtype):
    _check_sncv_backward(cuda, shape, cuts, False, dtype, radius=4)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("shape", V1_SNCV_EDGE_SHAPES, ids=V1_EDGE_IDS)
def test_sncv_radius4_edge_backward_kernel_matches_plain(cuda, shape, dtype):
    _check_sncv_backward(cuda, shape, 1, False, dtype, radius=4)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("offset", [1, 2], ids=["g+4B", "g+8B"])
def test_sncv_radius4_backward_of_unaligned_grad(cuda, offset, dtype):
    """g and the forward's output 4 or 8 bytes off 16-byte alignment, and
    unaligned features: the backward stages g' with 4-byte loads and reads
    the features one element at a time."""
    rng = np.random.RandomState(2)
    shape = (2, 13, 37, 16)
    n = 81 * int(np.prod(shape[:3]))

    def unaligned(x, dt):
        flat = torch.zeros(x.numel() + offset, dtype=dt, device=cuda)
        flat[offset:] = x.flatten().to(cuda, dt)
        return flat[offset:].view(x.shape)

    c1, c2 = (unaligned(torch.from_numpy(norm_cuts(rng.randn(*shape), 1)),
                        dtype) for _ in range(2))
    g = unaligned(torch.from_numpy(rng.randn(n).astype(np.float32)),
                  torch.float32).view(*shape[:3], 81)
    out = unaligned(spatial_cost_volume_fused(c1, c2, 4, 1, dtype),
                    torch.float32).view(*shape[:3], 81)
    assert g.data_ptr() % 16 and out.data_ptr() % 16 and c1.data_ptr() % 16
    before = SNCV_BACKWARD_KERNEL.launches
    got = _sncv_backward(g, c1, c2, out, 4, 1, 0.1)
    torch.cuda.synchronize()
    assert SNCV_BACKWARD_KERNEL.launches == before + 1
    a, b = (t.detach().clone().requires_grad_() for t in (c1, c2))
    assert_sncv_grads_close(got, sncv_plain_grads(a, b, 4, 1, dtype, g, out),
                            dtype, False)


def _check_sncv_backward(cuda, shape, cuts, same, dtype, radius):
    rng = np.random.RandomState(1)
    c1 = torch.from_numpy(norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    c2 = c1 if same else torch.from_numpy(
        norm_cuts(rng.randn(*shape), cuts)).to(cuda, dtype)
    g = torch.from_numpy(rng.randn(
        *shape[:3], (2 * radius + 1) ** 2 * cuts).astype(np.float32)).to(cuda)
    a = c1.detach().clone().requires_grad_()
    b = a if same else c2.detach().clone().requires_grad_()
    before = SNCV_BACKWARD_KERNEL.launches
    out = spatial_cost_volume_fused(a, b, radius, cuts, dtype)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert SNCV_BACKWARD_KERNEL.launches == before + 1
    a2 = c1.detach().clone().requires_grad_()
    b2 = a2 if same else c2.detach().clone().requires_grad_()
    ref = sncv_plain_grads(a2, b2, radius, cuts, dtype, g, out.detach())
    torch.cuda.synchronize()
    assert SNCV_BACKWARD_KERNEL.launches == before + 1
    assert_sncv_grads_close([a.grad] if same else [a.grad, b.grad], ref,
                            dtype, same)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
def test_sncv_backward_of_autocorrelation_is_one_kernel(cuda, dtype):
    """With c1 is c2 the backward kernel writes the one gradient, the sum
    of both: the Function returns it for its first input alone, so autograd
    launches no add after the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(2)
    shape, cuts = (3, 24, 24, 96), 4
    a = torch.from_numpy(norm_cuts(rng.randn(*shape), cuts)).to(
        cuda, dtype).requires_grad_()
    g = torch.from_numpy(rng.randn(*shape[:3], 49 * cuts).astype(
        np.float32)).to(cuda)
    out = spatial_cost_volume_fused(a, a, 3, cuts, dtype)
    torch.cuda.synchronize()
    before = SNCV_BACKWARD_KERNEL.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (grad,) = torch.autograd.grad(out, a, g)
        torch.cuda.synchronize()
    assert SNCV_BACKWARD_KERNEL.launches == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "sncv_backward" in kernels[0], kernels
    ad = a.detach()
    direct, none = _sncv_backward(g, ad, ad, out.detach(), 3, cuts, 0.1)
    assert none is None and torch.equal(grad, direct)


@pytest.mark.parametrize("centres", ["moderate", "far"])
@pytest.mark.parametrize("want_dpara", [True, False],
                         ids=["dpara", "no_dpara"])
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("rot_dim", [3, 4])
@pytest.mark.parametrize("shape,cuts", BACKWARD_DSCV_SHAPES,
                         ids=BACKWARD_DSCV_IDS)
def test_dscv_backward_kernel_matches_plain(cuda, shape, cuts, rot_dim, dtype,
                                            want_dpara, centres):
    """Every input gradient: c1, c2, the previous parallax (when it requires
    grad), the centre. The far centres (400 on a sixth of the pixels, past
    the 150 of every input) put samples far from their tile and on the
    border clamp."""
    b, h, w, C = shape
    args = dscv_inputs(b=b, h=h, w=w, C=C, cuts=cuts, rot_dim=rot_dim, seed=3,
                       far=400.0 if centres == "far" else None)
    rng = np.random.RandomState(4)
    gcv = torch.from_numpy(rng.randn(b, h, w, 9 * cuts).astype(
        np.float32)).to(cuda)
    gpw = torch.from_numpy(rng.randn(b, h, w, 1).astype(np.float32)).to(cuda)
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(a).to(cuda) for a in args)
    cam = Camera(f, c)
    grads = []
    for fn in (parallax_sweeping_cv_fused, parallax_sweeping_cv):
        ins = [t.detach().clone().requires_grad_()
               for t in (c1.to(dtype), c2.to(dtype), para, centre)]
        ins[2].requires_grad_(want_dpara)
        before = DSCV_BACKWARD_KERNEL.launches
        cv, pw = fn(*ins, rot, trans, cam, 4, cuts, dtype)
        ((cv * gcv).sum() + (pw * gpw).sum()).backward()
        torch.cuda.synchronize()
        grads.append([t.grad for t in ins])
        if fn is parallax_sweeping_cv_fused:
            assert DSCV_BACKWARD_KERNEL.launches == before + 1
    if not want_dpara:
        assert grads[0][2] is None and grads[1][2] is None
        grads = [[g[0], g[1], torch.zeros_like(para), g[3]] for g in grads]
    mask = tie_free_pixels(centre, rot, trans, cam, 4)
    assert mask.float().mean() > 0.85
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


# -- the harness on the card ------------------------------------------------


D3 = dict(num_levels=3, encoder_channels=(8, 12, 16),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")


def test_fit_from_a_record_store_on_card(cuda, tmp_path):
    """``fit`` for 3 steps of d3 at 64x64 from a record store of synthetic
    scenes: each kernel launched every step, a checkpoint with finite
    weights and the count of 3."""
    from m4depth_tpu_torch.data.records import (
        RecordSequenceDataset,
        RecordStoreWriter,
    )
    from m4depth_tpu_torch.data.synthetic import make_sequence
    from m4depth_tpu_torch.train.loop import fit

    writer = RecordStoreWriter(str(tmp_path / "store"), num_shards=2)
    for t in range(3):
        seq = make_sequence(np.random.RandomState(t), 8, 64, 64)
        writer.write_trajectory([
            {k: (v[i] if k in ("RGB_im", "depth", "rot", "trans") else v)
             for k, v in seq.items()} for i in range(8)])
    writer.close()
    ds = RecordSequenceDataset(str(tmp_path / "store"), usecase="train",
                               db_seq_len=4, seq_len=3, batch_size=2,
                               augment=False, num_workers=2)
    assert len(ds) == 3
    before = {k.symbol: k.launches for k in (
        SNCV_KERNEL, DSCV_KERNEL, SNCV_BACKWARD_KERNEL, DSCV_BACKWARD_KERNEL)}
    state = fit(M4Depth(ModelConfig(**D3), device=cuda, seed=1), ds,
                TrainConfig(ckpt_dir=str(tmp_path / "ckpt")), total_steps=3)
    torch.cuda.synchronize()
    for k in (SNCV_KERNEL, DSCV_KERNEL, SNCV_BACKWARD_KERNEL,
              DSCV_BACKWARD_KERNEL):
        assert k.launches - before[k.symbol] == 3 * 2 * 3, k.symbol
    saved = torch.load(tmp_path / "ckpt" / "train" / "0.pt",
                       weights_only=True)
    assert saved["count"] == state.step == 3
    assert all(bool(torch.isfinite(v).all()) for v in saved["model"].values())


class _Frames:
    """Six frames of one batch element, mostly lateral motion (a well
    conditioned recurrence), a reset at frames 0 and 3."""

    db_seq_len = None

    def __init__(self, hw=64, seed=3):
        rng = np.random.RandomState(seed)
        self.items = [{
            "rgb": rng.rand(1, hw, hw, 3).astype(np.float32),
            "depth": (1 + 60 * rng.rand(1, hw, hw, 1)).astype(np.float32),
            "rot": np.array([[1.0, 0.001, -0.002, 0.001]], np.float32),
            "trans": np.array([[0.3, 0.1, 0.02]], np.float32),
            "new_traj": np.array([t in (0, 3)]),
            "camera_f": np.full((1, 2), hw / 2, np.float32),
            "camera_c": np.full((1, 2), hw / 2, np.float32)}
            for t in range(6)]

    def frames(self):
        return iter(self.items)


def test_evaluate_streaming_on_card_matches_cpu(cuda):
    """The CLI's streaming path on the card against the CPU: each frame's
    depth to MODEL_TOL, and the card's metrics against the CPU's
    accumulation of the card's own depths to EVAL_METRIC_TOL."""
    from m4depth_tpu_torch.cli.main import predict_stream
    from m4depth_tpu_torch.eval import evaluate_streaming
    from m4depth_tpu_torch.metrics import (
        MetricAccumulator,
        clip_for_eval,
        compute_metrics,
    )
    from m4depth_tpu_torch.testing import EVAL_METRIC_TOL

    ds = _Frames()
    models = {d: M4Depth(ModelConfig(**D3), device=d, seed=4)
              for d in ("cpu", "cuda")}
    depths = {d: [x.cpu() for _, x in predict_stream(m, ds)]
              for d, m in models.items()}
    acc = MetricAccumulator.zeros()
    for fr, got, ref in zip(ds.items, depths["cuda"], depths["cpu"]):
        torch.testing.assert_close(got, ref, **MODEL_TOL)
        acc = acc.update(compute_metrics(*clip_for_eval(
            torch.from_numpy(fr["depth"]), got)),
            weight=0.0 if fr["new_traj"][0] else 1.0)
    want = {k: float(v) for k, v in acc.result().items()}
    got = evaluate_streaming(models["cuda"], ds)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **EVAL_METRIC_TOL)


def test_augment_device_on_card_matches_cpu(cuda):
    """The same (seed, step) draws the same parameters on any device (the
    generators are on the CPU); the transforms agree to rtol 1e-5."""
    from m4depth_tpu_torch.data.augment_device import make_batch_augment

    rng = np.random.RandomState(8)
    b, T, hw = 3, 4, 48
    batch = {
        "rgb": rng.rand(b, T, hw, hw, 3).astype(np.float32),
        "depth": (1 + 60 * rng.rand(b, T, hw, hw, 1)).astype(np.float32),
        "rot": np.tile(np.array([0.9, 0.1, -0.2, 0.05], np.float32),
                       (b, T, 1)),
        "trans": np.tile(np.array([0.1, -0.05, 0.4], np.float32), (b, T, 1)),
        "camera_f": np.full((b, 2), hw / 2, np.float32),
        "camera_c": np.full((b, 2), hw / 2, np.float32)}
    for usecase, crop_to in (("train", None), ("finetune", (32, 48))):
        fn = make_batch_augment(dataset="midair", usecase=usecase,
                                crop_to=crop_to)
        for step in range(3):
            out = {d: fn({k: torch.from_numpy(v).to(d)
                          for k, v in batch.items()}, 42, step)
                   for d in ("cpu", cuda)}
            for k, v in out["cpu"].items():
                torch.testing.assert_close(out[cuda][k].cpu(), v, rtol=1e-5,
                                           atol=1e-6, msg=lambda m: f"{k}: {m}")


# -- parallel serving ----------------------------------------------------

D4_NARROW = dict(num_levels=4, encoder_channels=(8, 12, 16, 16),
                 refiner_prep_channels=(16, 16, 8),
                 refiner_est_channels=(8, 8, 5),
                 compute_dtype="float32", cv_dtype="float32")


def _stream_frames(n, hw, frames, seed):
    """``frames`` frames of ``n`` streams, mostly lateral motion scaled a
    stream (each stream its own depth scale)."""
    rng = np.random.RandomState(seed)
    rgb = rng.rand(frames, n, hw, hw, 3).astype(np.float32)
    rot = np.tile(np.array([1.0, 0.001, -0.002, 0.001], np.float32), (n, 1))
    trans = (np.array([0.3, 0.1, 0.02], np.float32)
             * (1 + np.arange(n, dtype=np.float32) / 4)[:, None])
    f = np.full((n, 2), hw / 2, np.float32)
    return rgb, rot, trans, f


def test_fresh_frame_stream_on_card_matches_sequential(cuda):
    """Frames pushed from numpy through the pinned buffers and the side
    stream: each depth, one push late, equals the sequential step's on
    the same frames (the same kernels on the same bytes)."""
    from m4depth_tpu_torch.parallel import FreshFrameStream

    cfg = ModelConfig(**D4_NARROW)
    b, hw, frames = 2, 64, 5
    rgb, rot, trans, f = _stream_frames(b, hw, frames, seed=9)
    model = M4Depth(cfg, device=cuda, seed=4)
    state = init_state(cfg, b, hw, hw, device=cuda)
    want = []
    for t in range(frames):
        state, depth = model.step(
            state, torch.from_numpy(rgb[t]).to(cuda),
            torch.from_numpy(rot).to(cuda), torch.from_numpy(trans).to(cuda),
            Camera(torch.from_numpy(f).to(cuda), torch.from_numpy(f).to(cuda)),
            torch.full((b,), t == 0, device=cuda))
        want.append(depth)
    sess = FreshFrameStream(model, init_state(cfg, b, hw, hw, device=cuda),
                            device=cuda)
    got = [sess.push(rgb[t], rot, trans, Camera(f, f.copy()),
                     np.full((b,), t == 0)) for t in range(frames)]
    got.append(sess.flush())
    assert got[0] is None and sess.flush() is None
    for t in range(frames):
        assert got[t + 1].device == want[t].device
        assert torch.equal(got[t + 1], want[t]), t


def test_sharded_stream_on_card_matches_single_streams(cuda):
    """4 streams batched on the card against each stream alone at b=1,
    float32: batched cuDNN may take other algorithms, so the model's
    card tolerance."""
    from m4depth_tpu_torch.parallel import shard_stream_inputs, sharded_stream

    cfg = ModelConfig(**D4_NARROW)
    n, hw, frames = 4, 64, 3
    rgb, rot, trans, f = _stream_frames(n, hw, frames, seed=10)
    model = M4Depth(cfg, device=cuda, seed=5)
    step = sharded_stream(model, [cuda])
    state = shard_stream_inputs(init_state(cfg, n, hw, hw, device=cuda),
                                [cuda])
    alone = [init_state(cfg, 1, hw, hw, device=cuda) for _ in range(n)]
    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    for t in range(frames):
        reset = torch.full((n,), t == 0, device=cuda)
        before = (SNCV_KERNEL.launches, DSCV_KERNEL.launches)
        state, depth = step(state, dev(rgb[t]), dev(rot), dev(trans),
                            Camera(dev(f), dev(f)), reset)
        # one launch of each kernel a level, whatever the number of streams
        assert (SNCV_KERNEL.launches - before[0],
                DSCV_KERNEL.launches - before[1]) == (4, 4)
        for i in range(n):
            s = slice(i, i + 1)
            alone[i], d1 = model.step(
                alone[i], dev(rgb[t, s]), dev(rot[s]), dev(trans[s]),
                Camera(dev(f[s]), dev(f[s])), reset[s])
            torch.testing.assert_close(depth[s], d1, **MODEL_TOL)


def test_kernels_launch_on_their_inputs_device(cuda):
    """With cuda:0 current, each kernel on tensors of cuda:1 matches its
    plain version there: the C side launches on the current device, so the
    wrapper makes the inputs' device current (two replicas of
    ``sharded_stream`` in one process run so)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    rng = np.random.RandomState(11)
    a, bb = (torch.from_numpy(norm_cuts(rng.randn(1, 24, 24, 16), 2)).to(
        other) for _ in range(2))
    c1, c2, para, centre, rot, trans, f, c = (
        torch.from_numpy(x).to(other)
        for x in dscv_inputs(b=1, h=24, w=24, C=16, cuts=2))
    with torch.cuda.device(0):
        got = spatial_cost_volume_fused(a, bb, 3, 2, torch.float32)
        cv, pc = parallax_sweeping_cv_fused(c1, c2, para, centre, rot, trans,
                                            Camera(f, c), 4, 2,
                                            torch.float32)
    assert got.device == cv.device == other
    torch.testing.assert_close(
        got, spatial_cost_volume(a, bb, 3, 2, torch.float32), **SNCV_TOL)
    ref_cv, ref_pc = parallax_sweeping_cv(c1, c2, para, centre, rot, trans,
                                          Camera(f, c), 4, 2, torch.float32)
    torch.testing.assert_close(cv, ref_cv, **DSCV_CV_TOL)
    torch.testing.assert_close(pc, ref_pc, **DSCV_PARA_TOL)


# -- compiled programs (CUDA graphs) ------------------------------------------


def _graph_frames(b, hw, t, seed):
    rgb, rot, trans, f = _stream_frames(b, hw, t + 1, seed)
    return rgb[t], rot, trans, f


def test_compiled_serving_replays_the_eager_chain(cuda):
    """``compile_step`` on the card: the first call runs eagerly, the
    second captures, every later one replays. Each frame's depth equals
    ``M4Depth.step``'s bit for bit (the same kernels on the same bytes),
    is not overwritten by later replays, and the state is the graph's own
    and updated in place. A reset replays the same graph; a new batch
    size captures a second. Each kernel counts its launches on the device:
    one a level a frame, captures adding none."""
    from m4depth_tpu_torch.parallel import compile_step

    cfg = ModelConfig(**D4_NARROW)
    b, hw = 2, 64
    model = M4Depth(cfg, device=cuda, seed=4)
    step = compile_step(model)
    state = init_state(cfg, b, hw, hw, device=cuda)
    eager = init_state(cfg, b, hw, hw, device=cuda)
    held, ids = [], None
    for t in range(6):
        rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                              for x in _graph_frames(b, hw, t, seed=12))
        cam = Camera(f, f.clone())
        reset = torch.tensor([t in (0, 3), t == 0], device=cuda)
        before = (SNCV_KERNEL.launches, DSCV_KERNEL.launches)
        state, depth = step(state, rgb, rot, trans, cam, reset)
        torch.cuda.synchronize()
        assert (SNCV_KERNEL.launches - before[0],
                DSCV_KERNEL.launches - before[1]) == (4, 4), t
        eager, want = model.step(eager, rgb, rot, trans, cam, reset)
        assert torch.equal(depth, want), t
        leaves = [id(x) for s in state for x in s]
        if t >= 2:
            assert ids is None or leaves == ids
            ids = leaves
        held.append((depth, want))
    assert step.graphs == 1 and step.pool_bytes() > 0
    for t, (depth, want) in enumerate(held):
        assert torch.equal(depth, want), f"frame {t} overwritten"
    small = init_state(cfg, 1, hw, hw, device=cuda)
    for t in range(2):
        rgb, rot, trans, f = (torch.from_numpy(x[:1]).to(cuda)
                              for x in _graph_frames(b, hw, t, seed=13))
        small, _ = step(small, rgb, rot, trans, Camera(f, f.clone()),
                        torch.tensor([t == 0], device=cuda))
    assert step.graphs == 2


def test_compiled_eval_steps_match_eager_on_card(cuda):
    """The compiled windowed eval step against the eager one over three
    windows on the card, to EVAL_METRIC_TOL; the streaming one is held by
    ``test_evaluate_streaming_on_card_matches_cpu``, which runs it."""
    from m4depth_tpu_torch.metrics import MetricAccumulator
    from m4depth_tpu_torch.testing import EVAL_METRIC_TOL
    from m4depth_tpu_torch.train.step import (
        compile_windowed_eval_step,
        make_windowed_eval_step,
    )

    model = M4Depth(ModelConfig(**D3), device=cuda, seed=6)
    steps = {"compiled": compile_windowed_eval_step(model),
             "eager": make_windowed_eval_step(model)}
    accs = {k: MetricAccumulator.zeros(cuda) for k in steps}
    with torch.no_grad():
        for seed in range(3):
            batch = train_batch_on(cuda, b=2, T=3, hw=64, seed=seed)
            for k, step in steps.items():
                accs[k] = step(batch, accs[k])
    got, want = (accs[k].result() for k in ("compiled", "eager"))
    assert float(accs["compiled"].count) == 3
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **EVAL_METRIC_TOL)


def train_batch_on(dev, b, T, hw, seed):
    from m4depth_tpu_torch.testing import train_batch

    return train_batch(b, T, hw, seed, [1.0, 0.001, -0.002, 0.001],
                       [0.3, 0.1, 0.02], dev)


def test_compiled_train_step_matches_eager_on_card(cuda):
    """Three compiled train steps (eager first step, capture, replay)
    against three eager ones from the same weights, float32, on the card:
    the first step's gradients and weights by the card-against-CPU rule
    (``assert_train_step_close``), each step's loss to STEP_LOSS_RTOL, the
    kernels launched once a level a frame every step, and the copied-out
    loss of step 1 unchanged by the later replays."""
    from m4depth_tpu_torch.train.step import compile_train_step

    cfg = ModelConfig(**D4_NARROW)
    batch = train_batch_on(cuda, b=2, T=3, hw=64, seed=7)
    models = {k: M4Depth(cfg, device=cuda, seed=8)
              for k in ("compiled", "eager")}
    steps = {"compiled": compile_train_step(
        models["compiled"], make_optimizer(models["compiled"],
                                           TrainConfig(learning_rate=1e-4))),
        "eager": make_train_step(models["eager"], make_optimizer(
            models["eager"], TrainConfig(learning_rate=1e-4)))}
    kernels = (SNCV_KERNEL, DSCV_KERNEL, SNCV_BACKWARD_KERNEL,
               DSCV_BACKWARD_KERNEL)
    first = None
    for i in range(3):
        before = [k.launches for k in kernels]
        got = steps["compiled"](batch)
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(kernels, before)] == [8] * 4
        want = steps["eager"](batch)
        torch.testing.assert_close(got["loss"], want["loss"],
                                   rtol=STEP_LOSS_RTOL, atol=0)
        if i == 0:
            first = (got["loss"], got["loss"].clone())
            assert_train_step_close(
                {n: p.grad for n, p in models["compiled"].named_parameters()},
                {n: p.grad for n, p in models["eager"].named_parameters()},
                dict(models["compiled"].named_parameters()),
                dict(models["eager"].named_parameters()), lr=1e-4)
    assert steps["compiled"].compiled.graphs == 1
    assert torch.equal(*first)


def test_capture_of_a_host_sync_raises(cuda):
    """A body that reads a device value on the host runs eagerly (the
    first call) and fails its capture (the second): no quiet eager run on
    the card. The device works on afterwards."""
    from m4depth_tpu_torch.utils.graphs import Compiled

    fn = Compiled(lambda x: x * x.sum().item())
    x = torch.ones(4, device=cuda)
    assert torch.equal(fn(x), 4 * x)
    with pytest.raises(RuntimeError):
        fn(x)
    assert fn.graphs == 0
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 8.0


# -- stage marks (utils/tracing.py) --------------------------------------------


def _frame_stages(levels):
    """The marks of one frame that runs every level's refiner."""
    return ["encoder", "glue"] + [s for k in range(levels, 0, -1)
                                  for s in (f"refiner{k}", f"glue{k}")]


def _replay_marks(run, want):
    """The stage marks in a profile of one call of ``run`` (a replay), in
    order, with the profile's device events. The profiler once missed a
    few graph kernels over a window of replays, so up to three one-replay
    windows are read until one holds ``want``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from m4depth_tpu_torch.utils import tracing

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(tracing.SPAN_PREFIX)]
        marks = [tracing.mark_stage(n) for n, _, _ in sorted(
            events, key=lambda e: e[1]) if tracing.mark_stage(n)]
        if marks == want:
            break
    return marks, events


def _check_marked_replay(run, want):
    """Each replay of ``run``'s graph runs as many marks as ``want``; one
    replay's profile holds them in order, as one complete unit whose
    stages' spans sum to its span."""
    from m4depth_tpu_torch.utils import tracing

    before = tracing.mark_launches()
    run()
    torch.cuda.synchronize()
    assert tracing.mark_launches() - before == len(want)
    marks, events = _replay_marks(run, want)
    assert marks == want
    (unit,) = tracing.units(events, want)
    assert unit.complete and unit.sequence == tuple(want)
    assert sum(sp for _, sp, _ in unit.stages) == pytest.approx(
        unit.span_us)
    assert 0 < unit.busy_us <= unit.span_us


def test_replayed_frame_holds_the_stage_marks_in_order(cuda):
    """The compiled serving step's graph carries the frame's marks (the
    encoder, the decoder's start, each level's refiner and glue from the
    deepest, the output) and ``end``; the marks compute nothing, so the
    replayed frame stays equal to the eager one bit for bit."""
    from m4depth_tpu_torch.parallel import compile_step

    cfg = ModelConfig(**D4_NARROW)
    b, hw = 2, 64
    model = M4Depth(cfg, device=cuda, seed=4)
    step = compile_step(model)
    holder = dict(state=init_state(cfg, b, hw, hw, device=cuda), calls=0)
    rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                          for x in _graph_frames(b, hw, 0, seed=14))
    cam = Camera(f, f.clone())
    reset = torch.tensor([True, False], device=cuda)

    def run():
        holder["state"], holder["depth"] = step(holder["state"], rgb, rot,
                                                trans, cam, reset)
        holder["calls"] += 1

    for _ in range(3):
        run()
    _check_marked_replay(run, _frame_stages(4) + ["output", "end"])
    eager = init_state(cfg, b, hw, hw, device=cuda)
    for _ in range(holder["calls"]):
        eager, want = model.step(eager, rgb, rot, trans, cam, reset)
    assert torch.equal(holder["depth"], want)


@pytest.mark.parametrize("remat", [False, True])
def test_replayed_train_step_holds_the_stage_marks_in_order(cuda, remat):
    """The compiled train step's graph carries the window's frames (the
    first runs no refiner), then ``loss``, ``backward``, ``optimizer``,
    ``metrics`` and ``end``; the backward is one stage, also where remat
    runs the decoder levels again inside it."""
    from m4depth_tpu_torch.train.step import compile_train_step

    cfg = ModelConfig(**D4_NARROW, remat=remat, remat_policy="all")
    model = M4Depth(cfg, device=cuda, seed=8)
    step = compile_train_step(model, make_optimizer(
        model, TrainConfig(learning_rate=1e-4)))
    batch = train_batch_on(cuda, b=2, T=3, hw=64, seed=7)
    for _ in range(3):
        step(batch)
    want = (["encoder", "glue"] + 2 * _frame_stages(4)
            + ["loss", "backward", "optimizer", "metrics", "end"])
    _check_marked_replay(lambda: step(batch), want)


# -- the decoder's glue kernels (ops/csrc/glue.cu) ----------------------------

# d6's levels as (b, level, h, w, C, cuts), finest first, at b=1 and b=3,
# and a 7x7 level (its deeper one 4x4: a resize scale of 4/7)
GLUE_SHAPES = [(b, i + 1, h, w, C, cuts) for b in (1, 3)
               for i, (h, w, C, cuts) in enumerate(D6_LEVELS)] + [
                   (2, 3, 7, 7, 64, 2)]
GLUE_IDS = [f"b{b}-level{lv}-{h}x{w}" for b, lv, h, w, _, _ in GLUE_SHAPES]
GLUE_OTHER = 4
GLUE_KERNELS = (GLUE_PREP_KERNEL, GLUE_ASSEMBLE_KERNEL, GLUE_FINISH_KERNEL)
GLUE_BACKWARD_KERNELS = (GLUE_PREP_BACKWARD_KERNEL,
                         GLUE_ASSEMBLE_BACKWARD_KERNEL,
                         GLUE_FINISH_BACKWARD_KERNEL)


def _glue_inputs(b, level, h, w, C, rot_dim, dev, deepest, seed=0,
                 dtype=torch.bfloat16):
    """(curr_f, deeper (None at the deepest level), state, rot, trans,
    full-resolution camera, new_traj) for a level, mostly lateral motion
    (a well-conditioned depth); new_traj resets every other element from
    the second."""
    rng = np.random.RandomState(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    curr_f = t(rng.randn(b, h, w, C)).to(dtype)
    deeper = None
    if not deepest:
        hd, wd = -(-h // 2), -(-w // 2)
        deeper = (t(rng.uniform(2, 40, (b, hd, wd, 1))),
                  t(rng.uniform(0.1, 3, (b, hd, wd, 1))),
                  t(rng.randn(b, hd, wd, GLUE_OTHER)))
    state = (t(rng.randn(b, h, w, C)).to(dtype),
             t(rng.uniform(2, 40, (b, h, w, 1))))
    if rot_dim == 3:
        rot = t(rng.randn(b, 3) * 0.01)
    else:
        q = np.concatenate([np.ones((b, 1)), rng.randn(b, 3) * 0.01], 1)
        rot = t(q / np.linalg.norm(q, axis=1, keepdims=True))
    trans = t(np.array([0.3, 0.1, 0.02]) + rng.randn(b, 3) * 0.01)
    full = 2.0 ** level
    f = t(np.tile([[w * full * 0.6, h * full * 0.7]], (b, 1)))
    c = t(np.tile([[w * full / 2 + 0.3, h * full / 2 - 0.2]], (b, 1)))
    new_traj = torch.arange(b, device=dev) % 2 == 1
    return curr_f, deeper, state, rot, trans, Camera(f, c), new_traj


def _close_f32(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape, (what, i)
        torch.testing.assert_close(g, w, **SNCV_TOL, msg=f"{what}[{i}]")


@pytest.mark.parametrize("rot_dim", [3, 4])
@pytest.mark.parametrize("cv_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", GLUE_SHAPES, ids=GLUE_IDS)
def test_glue_kernels_match_plain(cuda, shape, cv_dtype, rot_dim):
    """Each glue kernel against its plain version on the same inputs, with
    bfloat16 convs: the deeper estimate, the intrinsics, the parallax, the
    depth and the memory (float32) to SNCV_TOL; the features, the previous
    parallax and the refiner's input (bfloat16 or float16) within one ulp.
    The refiner's input's parallax channels meet the 1e-12 clamp."""
    b, level, h, w, C, cuts = shape
    deepest = level == len(D6_LEVELS)
    curr_f, deeper, state, rot, trans, cam, new_traj = _glue_inputs(
        b, level, h, w, C, rot_dim, cuda, deepest)
    lvl_mul = 2.0 ** (level - 3)
    before = [k.launches for k in GLUE_KERNELS]
    args = (curr_f, deeper, state, trans, cam, 2.0 ** level, cuts, True,
            GLUE_OTHER, 1000.0, cv_dtype)
    got, want = glue.glue_prep_fused(*args), glue.glue_prep(*args)
    _close_f32(got[0], want[0], "prev")
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    # features rounded to the convs' bfloat16, then to the cost volumes'
    coarse = max((torch.bfloat16, cv_dtype), key=lambda d: torch.finfo(d).eps)
    assert_within_ulps(got[2], want[2].to(cv_dtype), "curr_p",
                       spacing_dtype=coarse)
    assert_within_ulps(got[3], want[3].to(cv_dtype), "prev_p",
                       spacing_dtype=coarse)
    assert_within_ulps(got[4], round_parallax(want[4], cv_dtype), "para")

    rng = np.random.RandomState(1)
    cv = torch.from_numpy(rng.randn(b, h, w, 9 * cuts).astype(np.float32))
    sncv = torch.from_numpy(rng.randn(b, h, w, 49 * cuts).astype(np.float32))
    reproj = torch.from_numpy(rng.uniform(0, 5, (b, h, w, 1)).astype(
        np.float32))
    reproj[:, ::3] = 0.0
    cv, sncv, reproj = (x.to(cuda) for x in (cv, sncv, reproj))
    prev = want[0]
    args = (cv, prev[1], prev[2], sncv, reproj, lvl_mul, torch.bfloat16)
    f_input = glue.glue_assemble_fused(*args)
    assert f_input.shape == (b, h, w, 9 * cuts + 1 + GLUE_OTHER + 49 * cuts
                             + 1)
    assert_within_ulps(f_input, glue.glue_assemble(*args), "f_input")

    out = torch.from_numpy(rng.randn(b, h, w, 1 + GLUE_OTHER).astype(
        np.float32) * 3).to(cuda, torch.bfloat16)
    args = (out, prev, new_traj, rot, trans, want[1], lvl_mul, 1000.0)
    (est, depth), (west, wdepth) = (glue.glue_finish_fused(*args),
                                    glue.glue_finish(*args))
    _close_f32(tuple(est) + (depth,), tuple(west) + (wdepth,), "finish")
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(GLUE_KERNELS,
                                           before)] == [1, 1, 1]


@pytest.mark.parametrize("deepest", [True, False], ids=["deepest", "inner"])
def test_glue_kernels_take_every_flag(cuda, deepest):
    """The 7x7 level with float32 convs and cost volumes, the features
    copied (normalize_features off), the memory, the SNCV and the warped
    parallax left out of the refiner's input, no state (a window's first
    frame) and no reset: each kernel against its plain version."""
    b, level, h, w, C, cuts = GLUE_SHAPES[-1]
    curr_f, deeper, state, rot, trans, cam, _ = _glue_inputs(
        b, level, h, w, C, 4, cuda, deepest, seed=3, dtype=torch.float32)
    f32 = torch.float32
    for st in (state, None):
        args = (curr_f, deeper, st, trans, cam, 2.0 ** level, cuts, False,
                GLUE_OTHER, 1000.0, f32)
        got, want = glue.glue_prep_fused(*args), glue.glue_prep(*args)
        _close_f32(got[0], want[0], "prev")
        if st is None:
            assert got[2] is got[3] is got[4] is None
        else:
            assert torch.equal(got[2], want[2])
            assert torch.equal(got[3], want[3])
            _close_f32((got[4],), (want[4],), "para")
    prev = want[0]
    cv = torch.randn(b, h, w, 9 * cuts, device=cuda)
    reproj = torch.rand(b, h, w, 1, device=cuda)
    for memory, recurr in ((False, True), (True, False), (False, False)):
        args = (cv, prev[1], prev[2] if memory else None, None,
                reproj if recurr else None, 0.5, f32)
        f_input = glue.glue_assemble_fused(*args)
        assert f_input.shape[3] == 9 * cuts + 1 + memory * GLUE_OTHER + recurr
        _close_f32((f_input,), (glue.glue_assemble(*args),), "f_input")
    out = torch.randn(b, h, w, 1 + GLUE_OTHER, device=cuda)
    args = (out, prev, None, rot, trans, want[1], 0.5, 1000.0)
    (est, depth), (west, wdepth) = (glue.glue_finish_fused(*args),
                                    glue.glue_finish(*args))
    assert depth is est[0]
    _close_f32(tuple(est), tuple(west), "finish")


def _glue_backward_inputs(b, level, h, w, C, cuts, dev, dtype, seed=0):
    """A level's glue forward inputs (``_glue_inputs``, features in
    ``dtype``, some cuts zero: the norm's clamp) and the gradients of its
    outputs, as the training step hands them to the backward kernels: the
    features' in the cost volumes' dtype (``dtype``), the resized deeper
    estimate's parallax and memory (not its depth: only a reset reads it),
    the refiner input's in ``dtype``, the estimate's three; the refiner's
    output ``out`` with log parallaxes beyond the clip and on its bounds;
    the maps that the refiner's input reads, with the log's clamp met."""
    deepest = level == len(D6_LEVELS)
    curr_f, deeper, state, rot, trans, cam, _ = _glue_inputs(
        b, level, h, w, C, 4, dev, deepest, seed=seed, dtype=dtype)
    cc = C // cuts
    curr_f[:, ::5, ::3, :cc] = 0
    state[0][:, 1::4, ::2, -cc:] = 0
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    n = 9 * cuts + 1 + GLUE_OTHER + 49 * cuts + 1
    out = rnd(b, h, w, 1 + GLUE_OTHER) * 4
    out[:, ::7, ::5, 0] = 7.0
    out[:, 1::7, ::5, 0] = -7.0
    reproj = torch.rand(b, h, w, 1, generator=g, device=dev) * 5
    reproj[:, ::3] = 0.0
    return dict(
        curr_f=curr_f, deeper=deeper, state=state, rot=rot, trans=trans,
        cam=cam, g_curr=rnd(b, h, w, C, dt=dtype),
        g_prev_p=rnd(b, h, w, C, dt=dtype),
        g_prev=(None, rnd(b, h, w, 1), rnd(b, h, w, GLUE_OTHER)),
        cv=rnd(b, h, w, 9 * cuts), sncv=rnd(b, h, w, 49 * cuts),
        reproj=reproj, g_input=rnd(b, h, w, n, dt=dtype),
        out=out.to(dtype), g_est=(rnd(b, h, w, 1), rnd(b, h, w, 1),
                                  rnd(b, h, w, GLUE_OTHER)))


def _glue_grads_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, (what, i)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        assert bool(torch.isfinite(w).all()), (what, i)
        assert_grad_close(g, w, GLUE_BWD_TOL[w.dtype], f"{what}[{i}]")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", GLUE_SHAPES, ids=GLUE_IDS)
def test_glue_backward_kernels_match_plain(cuda, shape, dtype):
    """Each glue backward kernel against its plain version on the same
    inputs and gradients (``GLUE_BWD_TOL``), at d6's level shapes with
    b=1 and b=3 and the 7x7 level, features and cost volumes in
    ``dtype``: the features' gradients (bfloat16 or float32), the deeper
    estimate's, the maps' and the refiner output's; each kernel launches
    once."""
    b, level, h, w, C, cuts = shape
    x = _glue_backward_inputs(b, level, h, w, C, cuts, cuda, dtype)
    kernels = GLUE_BACKWARD_KERNELS
    before = [k.launches for k in kernels]
    hw = None if x["deeper"] is None else tuple(x["deeper"][0].shape[1:3])
    args = (x["g_curr"], x["g_prev_p"], x["g_prev"], x["curr_f"],
            x["state"][0], hw, cuts, True)
    got, want = (glue.glue_prep_backward_fused(*args),
                 glue.glue_prep_backward(*args))
    _glue_grads_close(got[:2], want[:2], "prep features")
    if hw is None:
        assert got[2] is None and want[2] is None
    else:
        _glue_grads_close(got[2], want[2], "prep deeper")
    prev, cam_l = glue.glue_prep(x["curr_f"], x["deeper"], x["state"],
                                 x["trans"], x["cam"], 2.0 ** level, cuts,
                                 True, GLUE_OTHER, 1000.0, dtype)[:2]
    lvl_mul = 2.0 ** (level - 3)
    args = (x["g_input"], prev[1], x["reproj"], 9 * cuts, GLUE_OTHER,
            49 * cuts, lvl_mul, (True,) * 5)
    _glue_grads_close(glue.glue_assemble_backward_fused(*args),
                      glue.glue_assemble_backward(*args), "assemble")
    for g_est in (x["g_est"], (None,) + x["g_est"][1:]):
        args = (g_est, x["out"], x["rot"], x["trans"], cam_l, lvl_mul)
        _glue_grads_close((glue.glue_finish_backward_fused(*args),),
                          (glue.glue_finish_backward(*args),), "finish")
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 2]


@pytest.mark.parametrize("cv_dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", [s for s in GLUE_SHAPES if s[0] == 3],
                         ids=[i for i, s in zip(GLUE_IDS, GLUE_SHAPES)
                              if s[0] == 3])
def test_glue_functions_match_autograd_of_plain(cuda, shape, cv_dtype):
    """A level's glue through the fused wrappers with grad (the autograd
    Functions: the kernels and their backwards), bfloat16 features, at
    d6's level shapes with b=3: every input's gradient against autograd
    of the plain glue on the same inputs and cotangents, by
    ``GLUE_BWD_TOL`` at twice its rtol (the forward's roundings, one ulp
    apart at most, feed the backward); each kernel launches once."""
    b, level, h, w, C, cuts = shape
    x = _glue_backward_inputs(b, level, h, w, C, cuts, cuda, torch.bfloat16,
                              seed=1)
    lvl_mul = 2.0 ** (level - 3)
    leaves = [t.clone().requires_grad_() for t in (
        x["curr_f"], x["state"][0], *(x["deeper"] or ()), x["cv"],
        x["sncv"], x["reproj"], x["out"])]
    grads = {}
    for key, fns in (("fused", (glue.glue_prep_fused,
                                glue.glue_assemble_fused,
                                glue.glue_finish_fused)),
                     ("plain", (glue.glue_prep, glue.glue_assemble,
                                glue.glue_finish))):
        curr_f, f_maps, *rest = leaves
        deeper = tuple(rest[:3]) if x["deeper"] is not None else None
        cv, sncv, reproj, out = rest[-4:]
        prev, cam_l, curr_p, prev_p, _ = fns[0](
            curr_f, deeper, (f_maps, x["state"][1]), x["trans"], x["cam"],
            2.0 ** level, cuts, True, GLUE_OTHER, 1000.0, cv_dtype)
        f_input = fns[1](cv, prev[1], prev[2], sncv, reproj, lvl_mul,
                         torch.bfloat16)
        est, _ = fns[2](out, prev, None, x["rot"], x["trans"], cam_l,
                        lvl_mul, 1000.0)
        outs = [curr_p.to(cv_dtype), prev_p.to(cv_dtype), prev[1], f_input,
                *est]
        cots = [x["g_curr"].to(cv_dtype), x["g_prev_p"].to(cv_dtype),
                x["g_prev"][1], x["g_input"], *x["g_est"]]
        keep = [i for i, o in enumerate(outs) if o.requires_grad]
        before = [k.launches for k in GLUE_KERNELS + GLUE_BACKWARD_KERNELS]
        grads[key] = torch.autograd.grad([outs[i] for i in keep], leaves,
                                         [cots[i] for i in keep],
                                         allow_unused=True)
        torch.cuda.synchronize()
        if key == "fused":
            assert [k.launches - n for k, n in zip(
                GLUE_KERNELS + GLUE_BACKWARD_KERNELS, before)] == [0] * 3 + [
                    1] * 3
    for i, (g, w) in enumerate(zip(grads["fused"], grads["plain"])):
        if w is None:
            # the deeper depth: only a reset reads the resized one
            assert g is None, i
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, i
        rtol, atol = GLUE_BWD_TOL[w.dtype]
        assert_grad_close(g, w, (2 * rtol, atol), f"leaf {i}")


@pytest.mark.parametrize("remat", ["", "all", "dscv"])
def test_compiled_train_step_with_glue_kernels_matches_plain_glue(cuda,
                                                                   remat):
    """Three compiled float32 training steps of d6 at 128x128 (b=2, T=3)
    with the glue kernels and their backwards, without remat and with each
    remat policy, each against an eager step with the plain glue from the
    same state, by ``assert_step_close``."""
    kw = dict(remat=True, remat_policy=remat) if remat else {}
    res = assert_glue_steps_close(cuda, **kw)
    assert len(res) == 3


def test_glue_wrappers_raise_on_inputs_that_require_grad(cuda):
    """Under grad, a CUDA motion or camera tensor that requires grad makes
    the fused wrappers raise, and so does a reset given to
    ``glue_finish_fused`` with an input that requires grad: the kernels
    give neither a gradient, and nothing falls back to the plain version.
    The features, the deeper estimate, the maps and the refiner's output
    may require grad (the Functions differentiate them), and without grad
    nothing raises."""
    b, level, h, w, C, cuts = GLUE_SHAPES[-1]
    curr_f, deeper, state, rot, trans, cam, new_traj = _glue_inputs(
        b, level, h, w, C, 4, cuda, False)
    args = (2.0 ** level, cuts, True, GLUE_OTHER, 1000.0, torch.bfloat16)
    with pytest.raises(ValueError, match="no gradient"):
        glue.glue_prep_fused(curr_f, deeper, state,
                             trans.clone().requires_grad_(), cam, *args)
    with pytest.raises(ValueError, match="no gradient"):
        glue.glue_prep_fused(curr_f, deeper, state, trans,
                             Camera(cam.f.clone().requires_grad_(), cam.c),
                             *args)
    prev, cam_l, _, _, _ = glue.glue_prep_fused(
        curr_f.clone().requires_grad_(), deeper, state, trans, cam, *args)
    assert prev[1].requires_grad is False and not cam_l.f.requires_grad
    out = torch.randn(b, h, w, 1 + GLUE_OTHER, device=cuda,
                      requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        glue.glue_finish_fused(out, prev, new_traj, rot, trans, cam_l, 1.0,
                               1000.0)
    with pytest.raises(ValueError, match="no gradient"):
        glue.glue_finish_fused(out, prev, None, rot.clone().requires_grad_(),
                               trans, cam_l, 1.0, 1000.0)
    est, _ = glue.glue_finish_fused(out, prev, None, rot, trans, cam_l, 1.0,
                                    1000.0)
    assert est[0].requires_grad
    with torch.no_grad():
        glue.glue_finish_fused(out, prev, new_traj, rot,
                               trans.clone().requires_grad_(), cam_l, 1.0,
                               1000.0)


D6_BF16 = dict(compute_dtype="bfloat16")


@pytest.mark.parametrize("widths,hw,b",
                         [(D4_NARROW, 64, 2), (D6_BF16, 384, 1)],
                         ids=["d4-float32-64", "d6-bf16-384"])
def test_no_grad_frame_with_fused_glue_matches_plain(cuda, widths, hw, b):
    """``M4Depth.step`` with the glue kernels against the same step with
    the plain glue, three frames with resets: float32 to MODEL_TOL,
    bfloat16 convs by the bfloat16 depth rule. Each glue kernel launches
    once a level a frame."""
    cfg = ModelConfig(**widths)
    model = M4Depth(cfg, device=cuda, seed=2)
    states = [init_state(cfg, b, hw, hw, device=cuda) for _ in range(2)]
    for t in range(3):
        rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                              for x in _graph_frames(b, hw, t, seed=15))
        args = (rgb, rot, trans, Camera(f, f.clone()),
                torch.arange(b, device=cuda) % 2 == t % 2)
        before = [k.launches for k in GLUE_KERNELS]
        states[0], got = model.step(states[0], *args)
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(GLUE_KERNELS,
                                               before)] == [cfg.num_levels] * 3
        with plain_glue():
            states[1], want = model.step(states[1], *args)
        if cfg.compute_dtype == "float32":
            torch.testing.assert_close(got, want, **MODEL_TOL)
        else:
            assert_bf16_depth_close(got, want, f"frame {t}")


def test_trajectory_with_fused_glue_matches_plain(cuda):
    """64 frames of d6 at 384x384, bfloat16 convs, with a reset at frames
    0 and 32: the glue kernels' recurrent state against the plain glue's,
    each frame's depth by the bfloat16 depth rule."""
    cfg = ModelConfig(**D6_BF16)
    model = M4Depth(cfg, device=cuda, seed=3)
    hw, frames = 384, 64
    rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                          for x in _stream_frames(1, hw, frames, seed=16))
    cam = Camera(f, f.clone())
    states = [init_state(cfg, 1, hw, hw, device=cuda) for _ in range(2)]
    worst = (0.0, 0.0)
    for t in range(frames):
        reset = torch.tensor([t % 32 == 0], device=cuda)
        states[0], got = model.step(states[0], rgb[t], rot, trans, cam, reset)
        with plain_glue():
            states[1], want = model.step(states[1], rgb[t], rot, trans, cam,
                                         reset)
        err = assert_bf16_depth_close(got, want, f"frame {t}")
        worst = tuple(map(max, worst, err))
    print(f"worst median, 99th percentile relative error: {worst}")


def test_compiled_d6_frame_replays_its_glue_kernels(cuda):
    """The compiled d6 frame (bfloat16 convs, 128x128) with the glue
    kernels: each replay equals the eager ``M4Depth.step`` bit for bit,
    and each glue kernel runs once a level every call (the eager first
    call, the capture's replay, replays) and no other glue kernel runs."""
    from m4depth_tpu_torch.parallel import compile_step

    cfg = ModelConfig(**D6_BF16)
    hw = 128
    model = M4Depth(cfg, device=cuda, seed=5)
    step = compile_step(model)
    state = init_state(cfg, 1, hw, hw, device=cuda)
    eager = init_state(cfg, 1, hw, hw, device=cuda)
    for t in range(5):
        rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                              for x in _graph_frames(1, hw, t, seed=17))
        cam = Camera(f, f.clone())
        reset = torch.tensor([t in (0, 3)], device=cuda)
        launches = glue_launches()
        state, depth = step(state, rgb, rot, trans, cam, reset)
        torch.cuda.synchronize()
        assert glue_launches(launches) == dict(
            dict.fromkeys(launches, 0),
            **{k.symbol: 6 for k in GLUE_KERNELS}), t
        eager, want = model.step(eager, rgb, rot, trans, cam, reset)
        assert torch.equal(depth, want), t
    assert step.graphs == 1


def test_compiled_train_step_runs_the_plain_glue(cuda):
    """The compiled train step runs with grad, and its glue through the
    kernels all the same (the plain glue runs on CPU tensors only): every
    call, replays included, launches each glue kernel and its backward as
    often as a window of 3 frames at 4 levels holds them (glue_prep on
    every frame, the rest from frame 1), and no V1 glue kernel."""
    from m4depth_tpu_torch.train.step import compile_train_step

    cfg = ModelConfig(**D4_NARROW)
    model = M4Depth(cfg, device=cuda, seed=8)
    step = compile_train_step(model, make_optimizer(
        model, TrainConfig(learning_rate=1e-4)))
    batch = train_batch_on(cuda, b=2, T=3, hw=64, seed=7)
    want = dict(dict.fromkeys(glue_launches(), 0), **dict(zip(
        (k.symbol for k in GLUE_KERNELS + GLUE_BACKWARD_KERNELS),
        [3 * 4, 2 * 4, 2 * 4] + [2 * 4] * 3)))
    for i in range(3):
        launches = glue_launches()
        step(batch)
        torch.cuda.synchronize()
        assert glue_launches(launches) == want, i


# -- V1's decoder glue kernels (ops/csrc/glue_v1.cu) -------------------------

# V1-d6's levels at 384x384 as (level, h, w, C), finest first, at b=1 and b=8
V1_D6_LEVELS = ((1, 192, 192, 16), (2, 96, 96, 32), (3, 48, 48, 64),
                (4, 24, 24, 96), (5, 12, 12, 128), (6, 6, 6, 192))
GLUE_V1_SHAPES = [(b, *lv) for b in (1, 8) for lv in V1_D6_LEVELS]
GLUE_V1_IDS = [f"b{b}-level{lv}-{h}x{w}" for b, lv, h, w, _ in GLUE_V1_SHAPES]
GLUE_V1_KERNELS = (GLUE_V1_PREP_KERNEL, GLUE_V1_ASSEMBLE_KERNEL,
                   GLUE_V1_FINISH_KERNEL)
V1_LEVELS = 6


def _glue_v1_inputs(b, level, h, w, C, rot_dim, dev, dtype, memory=True,
                    reset=None, nan=False, seed=0):
    """(curr_f, state (None without ``memory``), deeper (None at the
    deepest level), new_traj ([b] with the last element set where
    ``reset``, else None), rot, trans, full-resolution camera, scale) for a
    V1 level, mostly lateral motion; ``nan`` puts a NaN in the deeper depth,
    so the flow of the fine pixels that read it is NaN."""
    rng = np.random.RandomState(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    curr_f = t(rng.randn(b, h, w, C)).to(dtype)
    state = (t(rng.randn(b, h, w, C)).to(dtype),
             t(rng.uniform(2, 40, (b, h, w, 1)))) if memory else None
    deeper = None
    if level < V1_LEVELS:
        deeper = t(rng.uniform(2, 40, (b, -(-h // 2), -(-w // 2), 1)))
        if nan:
            deeper[0, 1, 2, 0] = float("nan")
    new_traj = (torch.arange(b, device=dev) == b - 1) if reset else None
    if rot_dim == 3:
        rot = t(rng.randn(b, 3) * 0.01)
    else:
        q = np.concatenate([np.ones((b, 1)), rng.randn(b, 3) * 0.01], 1)
        rot = t(q / np.linalg.norm(q, axis=1, keepdims=True))
    trans = t(np.array([0.3, 0.1, 0.02]) + rng.randn(b, 3) * 0.05)
    full = 2.0 ** level
    f = t(np.tile([[w * full * 0.6, h * full * 0.7]], (b, 1)))
    c = t(np.tile([[w * full / 2 + 0.3, h * full / 2 - 0.2]], (b, 1)))
    return (curr_f, state, deeper, new_traj, rot, trans, Camera(f, c),
            full)


def _close_v1(got, want, what):
    """A V1 glue output against its plain version's: NaN at the same
    elements; elsewhere float32 to SNCV_TOL, a rounded dtype within one of
    its ulps."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    got, want = got[~nan], want[~nan]
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, **SNCV_TOL, msg=what)
    else:
        assert_within_ulps(got, want, what)


@pytest.mark.parametrize("reset", [False, True], ids=["no_reset", "reset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", GLUE_V1_SHAPES, ids=GLUE_V1_IDS)
def test_glue_v1_kernels_match_plain(cuda, shape, dtype, reset):
    """Each V1 glue kernel against its plain version on the same inputs at
    V1-d6's level shapes, with the memory, quaternion rotations, the last
    element reset or none, and a NaN flow position below the deepest
    level: the warped features, the log depths and the refiner's input
    within one ulp of their dtype (float32 to SNCV_TOL), the depth to
    SNCV_TOL, the NaN where the plain version has it. Each kernel launches
    once."""
    b, level, h, w, C = shape
    args = _glue_v1_inputs(b, level, h, w, C, 4, cuda, dtype, reset=reset,
                           nan=True, seed=level)
    before = [k.launches for k in GLUE_V1_KERNELS]
    got, want = glue_v1.glue_v1_prep_fused(*args), glue_v1.glue_v1_prep(*args)
    for i, key in enumerate(("f0_w", "log_d0w", "log_dprev")):
        _close_v1(got[i], want[i], key)
    assert got[0].is_contiguous()
    curr_f, _, _, _, rot, trans, cam, scale = args
    g = torch.Generator(device=cuda).manual_seed(level)
    cv = torch.randn(b, h, w, 81, device=cuda, generator=g)
    asm = (curr_f, cv, want[1], want[2], rot, trans, cam, scale)
    f_input = glue_v1.glue_v1_assemble_fused(*asm)
    assert f_input.shape == (b, h, w, C + 81 + 2 + 4 + 3 + 2)
    _close_v1(f_input, glue_v1.glue_v1_assemble(*asm), "f_input")
    out = (torch.randn(b, h, w, 1, device=cuda, generator=g) * 4).to(dtype)
    out[:, ::5] = 0.0
    _close_v1(glue_v1.glue_v1_finish_fused(out, 0.1),
              glue_v1.glue_v1_finish(out, 0.1), "depth")
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(GLUE_V1_KERNELS,
                                           before)] == [1, 1, 1]


@pytest.mark.parametrize("rot_dim", [3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 1, 13, 9, 18), (3, 3, 7, 7, 64),
                                   (2, 6, 2, 3, 8)],
                         ids=["13x9-C18", "7x7-deeper4x4", "deepest-2x3"])
def test_glue_v1_prep_takes_every_case(cuda, shape, dtype, rot_dim):
    """``glue_v1_prep`` against its plain version without memory (a
    window's first frame) and with memory reset on every element or none,
    under small-angle and quaternion rotations, at shapes off the 16-byte
    path (C = 18), with a 4x4 deeper level under a 7x7 one (a resize scale
    of 4/7) and at the smallest level the warp takes (2x3)."""
    b, level, h, w, C = shape
    for memory, reset in ((False, None), (True, None), (True, "all")):
        args = list(_glue_v1_inputs(b, level, h, w, C, rot_dim, cuda, dtype,
                                    memory=memory, seed=C))
        if reset:
            args[3] = torch.ones(b, dtype=torch.bool, device=cuda)
        got = glue_v1.glue_v1_prep_fused(*args)
        want = glue_v1.glue_v1_prep(*args)
        for i, key in enumerate(("f0_w", "log_d0w", "log_dprev")):
            _close_v1(got[i], want[i], f"{key} memory={memory} {reset}")


def test_glue_v1_wrappers_raise_on_inputs_that_require_grad(cuda):
    """The V1 wrappers run the plain versions under grad: where grad is
    enabled and a CUDA input requires grad (the features, the cost volume,
    the rotation), each wrapper returns its plain version's result and
    launches no glue kernel, and autograd's gradients through the
    wrappers' chain equal those through the plain chain bit for bit.
    Inputs that need no gradient launch the kernels with grad enabled, and
    so do inputs that require grad under ``torch.no_grad``."""
    b, level, h, w, C = GLUE_V1_SHAPES[3]
    args = _glue_v1_inputs(b, level, h, w, C, 4, cuda, torch.bfloat16)
    curr_f, state, deeper, new_traj, rot, trans, cam, scale = args
    needs = curr_f.clone().requires_grad_()
    cv = torch.randn(b, h, w, 81, device=cuda, requires_grad=True)

    def chain(prep, assemble, finish, rot):
        f0_w, log_d0w, log_dprev = prep(needs, state, deeper, new_traj, rot,
                                        trans, cam, scale)
        x = assemble(needs, cv, log_d0w, log_dprev, rot, trans, cam, scale)
        return f0_w, log_d0w, log_dprev, x, finish(x[..., :1], 0.1)

    torch.cuda.synchronize()
    launches = glue_launches()
    for r in (rot, rot.clone().requires_grad_()):
        got = chain(glue_v1.glue_v1_prep_fused, glue_v1.glue_v1_assemble_fused,
                    glue_v1.glue_v1_finish_fused, r)
        want = chain(glue_v1.glue_v1_prep, glue_v1.glue_v1_assemble,
                     glue_v1.glue_v1_finish, r)
        for i, (g, w_) in enumerate(zip(got, want)):
            assert torch.equal(g, w_), i
        leaves = (needs, cv) + ((r,) if r.requires_grad else ())
        grads = [torch.autograd.grad(out[3].float().sum() + out[4].sum(),
                                     leaves) for out in (got, want)]
        for i, (g, w_) in enumerate(zip(*grads)):
            assert torch.equal(g, w_), f"gradient {i}"
    torch.cuda.synchronize()
    assert glue_launches() == launches
    out = torch.randn(b, h, w, 1, device=cuda, requires_grad=True)
    f0_w, log_d0w, log_dprev = glue_v1.glue_v1_prep_fused(*args)
    with torch.no_grad():
        glue_v1.glue_v1_prep_fused(needs, *args[1:])
        glue_v1.glue_v1_assemble_fused(needs, cv, log_d0w, log_dprev, rot,
                                       trans, cam, scale)
        glue_v1.glue_v1_finish_fused(out, 0.1)
    torch.cuda.synchronize()
    assert glue_launches(launches) == dict(
        dict.fromkeys(launches, 0), glue_v1_prep=2, glue_v1_assemble=1,
        glue_v1_finish=1)


@pytest.mark.parametrize("dtype,hw,b", [("float32", 128, 2),
                                        ("bfloat16", 384, 8)],
                         ids=["f32-128-b2", "bf16-384-b8"])
def test_compiled_v1_step_with_glue_kernels_matches_plain(cuda, dtype, hw,
                                                          b):
    """The compiled V1 serving step (``compile_step``: the eager first
    call, the capture, replays) with the glue kernels against the eager
    ``M4DepthV1.step`` with the plain glue (``plain_glue``), five frames
    with single elements reset: float32 to MODEL_TOL, bfloat16 convs by
    the bfloat16 depth rule. Each V1 glue kernel launches once a level
    every call (the eager first call, the capture's replay, replays), and
    no other glue kernel."""
    from m4depth_tpu_torch.models import M4DepthV1
    from m4depth_tpu_torch.parallel import compile_step

    cfg = ModelConfig(compute_dtype=dtype, cv_dtype=dtype)
    model = M4DepthV1(cfg, device=cuda, seed=6)
    step = compile_step(model)
    states = [init_state(cfg, b, hw, hw, device=cuda) for _ in range(2)]
    rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                          for x in _stream_frames(b, hw, 5, seed=18))
    cam = Camera(f, f.clone())
    for t in range(5):
        reset = (torch.arange(b, device=cuda) == t % b) | (t == 0)
        launches = glue_launches()
        states[0], got = step(states[0], rgb[t], rot, trans, cam, reset)
        torch.cuda.synchronize()
        assert glue_launches(launches) == dict(
            dict.fromkeys(launches, 0),
            **{k.symbol: V1_LEVELS for k in GLUE_V1_KERNELS}), t
        with plain_glue():
            states[1], want = model.step(states[1], rgb[t], rot, trans, cam,
                                         reset)
        if dtype == "float32":
            torch.testing.assert_close(got, want, **MODEL_TOL)
        else:
            assert_bf16_depth_close(got, want, f"frame {t}")
    assert step.graphs == 1


def test_v1_frame_dispatches_no_gather_or_cat(cuda):
    """A V1 serving frame on the card (bf16, 128x128, b=2) dispatches
    neither the warp's ``gather``s nor the refiner input's ``cat``: the
    glue kernels replace them. The same frame with the plain glue
    dispatches both, so the probe sees them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from m4depth_tpu_torch.models import M4DepthV1

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    cfg = ModelConfig(compute_dtype="bfloat16")
    b, hw = 2, 128
    model = M4DepthV1(cfg, device=cuda, seed=7)
    rgb, rot, trans, f = (torch.from_numpy(x).to(cuda)
                          for x in _stream_frames(b, hw, 1, seed=19))
    args = (rgb[0], rot, trans, Camera(f, f.clone()),
            torch.tensor([True, False], device=cuda))
    state = init_state(cfg, b, hw, hw, device=cuda)
    with Ops() as fused:
        model.step(state, *args)
    with plain_glue(), Ops() as plain:
        model.step(state, *args)
    assert {"gather", "cat"} <= plain.names
    assert not {"gather", "cat"} & fused.names, fused.names


def test_compiled_v1_train_step_runs_the_plain_glue(cuda):
    """The compiled V1 training step runs with grad, so the V1 wrappers
    take the plain versions: no glue kernel launches in any call (the
    eager first call, the capture's replay, replays)."""
    from m4depth_tpu_torch.models import M4DepthV1
    from m4depth_tpu_torch.train.step import compile_train_step

    cfg = ModelConfig(**D4_NARROW)
    model = M4DepthV1(cfg, device=cuda, seed=8)
    step = compile_train_step(model, make_optimizer(
        model, TrainConfig(learning_rate=1e-4)))
    batch = train_batch_on(cuda, b=2, T=3, hw=64, seed=7)
    for i in range(3):
        launches = glue_launches()
        step(batch)
        torch.cuda.synchronize()
        assert glue_launches() == launches, i

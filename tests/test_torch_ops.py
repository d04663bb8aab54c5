"""The PyTorch port's cost volumes and warp against the JAX package's.

On the CPU the port's wrappers run their plain versions; those are held
against the JAX XLA functions in float32 and against the Pallas kernels in
interpret mode, on inputs made with numpy from a seed. The CUDA kernels
themselves are held against their plain versions on the card by
``test_torch_cuda.py``.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.ops import cost_volume as jcv
from m4depth_tpu.ops.sncv_pallas import spatial_cost_volume_pallas
from m4depth_tpu.ops.warp import dense_image_warp as jax_warp
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.ops import (
    DSCV_KERNEL,
    SNCV_KERNEL,
    _build,
    dense_image_warp,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.testing import (
    assert_dscv_grads_close,
    assert_sncv_grads_close,
    tie_free_pixels,
)
from torch_inputs import dscv_inputs as _dscv_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_dscv(fn, args, cuts, cv_dtype, **kw):
    c1, c2, para, centre, rot, trans, f, c = (jnp.asarray(a) for a in args)
    return fn(c1, c2, para, centre, rot, trans, JCamera(f, c), 4,
              num_cuts=cuts, cv_dtype=cv_dtype, **kw)


def _torch_dscv(fn, args, cuts, cv_dtype, device="cpu"):
    c1, c2, para, centre, rot, trans, f, c = (_t(a).to(device) for a in args)
    return fn(c1, c2, para, centre, rot, trans, Camera(f, c), 4, cuts,
              cv_dtype)


# -- warp ---------------------------------------------------------------


def test_dense_image_warp_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 9, 11, 5).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 3, 9, 11, 2)).astype(np.float32)
    np.testing.assert_allclose(
        dense_image_warp(_t(img), _t(flow)).numpy(),
        np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow))),
        rtol=1e-5, atol=1e-6)


# -- SNCV ---------------------------------------------------------------


@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("cuts", [1, 2, 4])
def test_sncv_plain_matches_xla(cuts, same):
    """float32 on both sides; only the channel-sum order differs."""
    rng = np.random.RandomState(cuts)
    c1 = rng.randn(2, 9, 10, 8).astype(np.float32)
    c2 = c1 if same else rng.randn(2, 9, 10, 8).astype(np.float32)
    j1 = jnp.asarray(c1)
    t1 = _t(c1)
    ref = jcv.spatial_cost_volume(j1, j1 if same else jnp.asarray(c2), 3,
                                  num_cuts=cuts, cv_dtype=jnp.float32)
    out = spatial_cost_volume(t1, t1 if same else _t(c2), 3, cuts,
                              torch.float32)
    assert out.shape == (2, 9, 10, 49 * cuts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("cuts", [1, 4])
def test_sncv_plain_matches_pallas_interpret(cuts, same):
    """The Pallas kernel in interpret mode, at the tolerance of the JAX
    package's own Pallas-vs-XLA test."""
    rng = np.random.RandomState(10 + cuts)
    c1 = rng.randn(1, 8, 12, 8).astype(np.float32)
    c2 = c1 if same else rng.randn(1, 8, 12, 8).astype(np.float32)
    ref = spatial_cost_volume_pallas(jnp.asarray(c1), jnp.asarray(c2), 3,
                                     num_cuts=cuts, cv_dtype=jnp.float32,
                                     interpret=True)
    t1 = _t(c1)
    out = spatial_cost_volume(t1, t1 if same else _t(c2), 3, cuts,
                              torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


# -- DSCV ---------------------------------------------------------------


@pytest.mark.parametrize("cuts", [1, 2])
def test_dscv_plain_matches_reference_formulation(cuts):
    """float32: the per-cut correlations and channel 4 (the centre
    hypothesis) of the JAX warped parallax, to float32 rounding."""
    args = _dscv_inputs(cuts=cuts, seed=cuts)
    cv_ref, pw_ref = _jax_dscv(jcv.parallax_sweeping_cv, args, cuts,
                               jnp.float32)
    cv, pw = _torch_dscv(parallax_sweeping_cv, args, cuts, torch.float32)
    assert cv.shape == (2, 12, 16, 9 * cuts) and pw.shape == (2, 12, 16, 1)
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pw.numpy(), np.asarray(pw_ref)[..., 4:5],
                               rtol=1e-5, atol=1e-5)


def test_dscv_plain_matches_pallas_fused_bf16():
    """bf16 against the serving path the port replaces, at 48x64 so the
    Pallas reduce runs (in interpret mode). Tolerance of the JAX package's
    fused-vs-split test: the Pallas path rounds its bilinear weights and
    partial products to bf16, the port keeps them in float32."""
    args = _dscv_inputs(b=1, h=48, w=64, C=16, cuts=2, seed=5)
    cv_ref, pw_ref = _jax_dscv(jcv.parallax_sweeping_cv_fused, args, 2,
                               jnp.bfloat16)
    cv, pw = _torch_dscv(parallax_sweeping_cv, args, 2, torch.bfloat16)
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_ref),
                               rtol=2e-2, atol=6e-3)
    np.testing.assert_allclose(pw.numpy(), np.asarray(pw_ref),
                               rtol=2e-2, atol=3e-2)


# -- gradients ------------------------------------------------------------


def _jax_sncv_grads(c1, c2, g, cuts, same):
    import jax

    def loss(a, b):
        cv = jcv.spatial_cost_volume(a, a if same else b, 3, num_cuts=cuts,
                                     cv_dtype=jnp.float32)
        return (cv * jnp.asarray(g)).sum()

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(c1), jnp.asarray(c2))


@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("cuts", [1, 2])
def test_sncv_gradients_match_jax(cuts, same):
    """Autograd of the plain SNCV (the plain version of the backward
    kernel) against jax.grad of the XLA SNCV, float32. With c1 is c2 the
    two gradients add up."""
    rng = np.random.RandomState(20 + cuts)
    c1 = rng.randn(2, 9, 10, 8).astype(np.float32)
    c2 = c1 if same else rng.randn(2, 9, 10, 8).astype(np.float32)
    g = rng.randn(2, 9, 10, 49 * cuts).astype(np.float32)
    jd1, jd2 = _jax_sncv_grads(c1, c2, g, cuts, same)
    ref = [np.asarray(jd1)] if same else [np.asarray(jd1), np.asarray(jd2)]

    t1 = _t(c1).requires_grad_()
    t2 = t1 if same else _t(c2).requires_grad_()
    out = spatial_cost_volume(t1, t2, 3, cuts, torch.float32)
    (out * _t(g)).sum().backward()
    got = [t1.grad] if same else [t1.grad, t2.grad]
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-5, atol=1e-6)


def _dscv_grad_inputs(cuts):
    """The JAX package's gradient-parity setup (test_cost_volume.py): 10x10,
    C=4, r=4, lateral-and-forward motion, centres in [0.5, 3]."""
    rng = np.random.RandomState(11 + cuts)
    b, h, w, C = 1, 10, 10, 4
    rot = np.array([[1.0, 0.01, -0.02, 0.0]], np.float32)
    rot /= np.linalg.norm(rot)
    return dict(
        c1=rng.randn(b, h, w, C).astype(np.float32),
        c2=rng.randn(b, h, w, C).astype(np.float32),
        para=rng.uniform(0.5, 2, (b, h, w, 1)).astype(np.float32),
        centre=rng.uniform(0.5, 3, (b, h, w, 1)).astype(np.float32),
        rot=rot, trans=np.array([[0.3, 0.1, 0.6]], np.float32),
        f=np.full((b, 2), 8.0, np.float32), c=np.full((b, 2), 5.0, np.float32),
        gcv=rng.randn(b, h, w, 9 * cuts).astype(np.float32),
        gpw=rng.randn(b, h, w, 1).astype(np.float32))


@pytest.mark.parametrize("cuts", [1, 2])
def test_dscv_gradients_match_jax(cuts):
    """Autograd of the plain DSCV (the reference the backward kernel is held
    to on the card) against jax.grad of the gather formulation and of the
    split formulation whose backward runs the Pallas ``_grad_kernel`` (in
    interpret mode), for c1, c2 and the sweep centre (and the previous
    parallax, against the gather formulation), float32. Tolerance of the
    JAX package's own gradient-parity test."""
    import jax

    x = _dscv_grad_inputs(cuts)
    cam = JCamera(jnp.asarray(x["f"]), jnp.asarray(x["c"]))

    def jloss(fn, c1, c2, para, centre):
        cv, pw = fn(c1, c2, para, centre, jnp.asarray(x["rot"]),
                    jnp.asarray(x["trans"]), cam, 4, num_cuts=cuts,
                    cv_dtype=jnp.float32)
        return (cv * x["gcv"]).sum() + (pw[..., 4:5] * x["gpw"]).sum()

    jin = [jnp.asarray(x[k]) for k in ("c1", "c2", "para", "centre")]
    ref_gather = jax.grad(lambda *a: jloss(jcv.parallax_sweeping_cv, *a),
                          argnums=(0, 1, 2, 3))(*jin)
    split = functools.partial(jcv.parallax_sweeping_cv_split, n_chunks=3,
                              bwd_impl="pallas")
    ref_pallas = jax.grad(lambda *a: jloss(split, *a),
                          argnums=(0, 1, 3))(*jin)

    tin = [_t(x[k]).requires_grad_() for k in ("c1", "c2", "para", "centre")]
    cv, pw = parallax_sweeping_cv(
        *tin, _t(x["rot"]), _t(x["trans"]), Camera(_t(x["f"]), _t(x["c"])),
        4, cuts, torch.float32)
    ((cv * _t(x["gcv"])).sum() + (pw * _t(x["gpw"])).sum()).backward()
    for t, r in zip(tin, ref_gather):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=1e-3, atol=1e-4)
    for t, r in zip((tin[0], tin[1], tin[3]), ref_pallas):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=1e-3, atol=1e-4)
    assert np.abs(tin[3].grad.numpy()).max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_comparison_rules(dtype):
    """The rules that hold the backward kernels against autograd on the
    card (``m4depth_tpu_torch.testing``), on CPU tensors. Without motion
    every DSCV sample lies on a pixel, so no pixel is tie-free; with the
    tests' motion most are. Equal gradients pass; a gradient off by more
    than its tolerance fails, named."""
    args = [_t(a) for a in _dscv_inputs(h=12, w=16, C=8, cuts=2)]
    c1, c2, para, centre, rot, trans, f, c = args
    cam = Camera(f, c)
    still = tie_free_pixels(centre, torch.tensor([[1.0, 0, 0, 0]] * 2),
                            torch.zeros(2, 3), cam, 4)
    assert not still.any()
    mask = tie_free_pixels(centre, rot, trans, cam, 4)
    assert mask.shape == (2, 12, 16, 1) and mask.float().mean() > 0.9

    ins = [t.to(dtype).requires_grad_() for t in (c1, c2)] + [
        t.clone().requires_grad_() for t in (para, centre)]
    cv, pw = parallax_sweeping_cv(*ins, rot, trans, cam, 4, 2, dtype)
    grads = torch.autograd.grad((cv.sum(), pw.sum()), ins)
    assert assert_dscv_grads_close(grads, grads, dtype, mask) == [0.0] * 4
    bumped = list(grads)
    bumped[1] = grads[1] + 0.05 * grads[1].abs().max()
    with pytest.raises(AssertionError, match="dscv dc2"):
        assert_dscv_grads_close(bumped, grads, dtype, mask)

    a = c1.to(dtype).requires_grad_()
    g = torch.autograd.grad(spatial_cost_volume(a, a, 3, 2, dtype).sum(), a)
    assert assert_sncv_grads_close(g, g, dtype, same=True) == [0.0]
    with pytest.raises(AssertionError, match="sncv dc1"):
        assert_sncv_grads_close([g[0] * 1.05], g, dtype, same=True)


# -- wrappers and build on the CPU ---------------------------------------


def test_wrappers_take_plain_path_on_cpu():
    sncv_before, dscv_before = SNCV_KERNEL.launches, DSCV_KERNEL.launches
    args = _dscv_inputs(cuts=2)
    c1 = _t(args[0])
    np.testing.assert_array_equal(
        spatial_cost_volume_fused(c1, c1, 3, 2, torch.bfloat16).numpy(),
        spatial_cost_volume(c1, c1, 3, 2, torch.bfloat16).numpy())
    for a, b in zip(_torch_dscv(parallax_sweeping_cv_fused, args, 2,
                                torch.bfloat16),
                    _torch_dscv(parallax_sweeping_cv, args, 2,
                                torch.bfloat16)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert SNCV_KERNEL.launches == sncv_before == 0
    assert DSCV_KERNEL.launches == dscv_before == 0


def test_kernel_modules_import_without_nvcc(tmp_path):
    """Importing builds nothing: no compiler is needed until a launch."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=REPO)
    code = ("import torch, m4depth_tpu_torch.ops as ops;"
            "x = torch.ones(1, 4, 4, 2);"
            "ops.spatial_cost_volume_fused(x, x, 1, 1, torch.float32);"
            "assert ops.SNCV_KERNEL.launches == 0")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and raises: no fallback."""
    failing = tmp_path / "nvcc"
    failing.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(failing))
    with pytest.raises(RuntimeError, match="sncv.cu: nvcc exited 1"):
        _build.build(["sncv.cu"])
    assert not list((tmp_path / "build").glob("*.so"))

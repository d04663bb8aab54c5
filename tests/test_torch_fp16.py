"""float16 cost volumes in the port against the JAX package, on the CPU.

The port's plain versions (what its wrappers run on CPU tensors) round
their inputs to float16 and compute in float32. The JAX Pallas SNCV does
the same (in interpret mode here), so it is the tight reference; the XLA
SNCV and the "rows" DSCV also round products, weights and sums to float16,
so they agree to a few float16 ulps. Inputs are made with numpy from a
seed. The kernels' float16 instantiations are held against these plain
versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.models import M4Depth as JaxM4Depth
from m4depth_tpu.models import init_state as jax_init_state
from m4depth_tpu.ops import cost_volume as jcv
from m4depth_tpu.ops.sncv_pallas import spatial_cost_volume_pallas
from m4depth_tpu_torch.cli.options import build_parser, model_config_from_args
from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.interop import load_jax_params
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.ops import (
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
)
from m4depth_tpu_torch.testing import assert_bf16_depth_close, sncv_plain_grads
from torch_inputs import dscv_inputs, norm_cuts

F16_ULP = 2.0 ** -10     # float16's ulp relative to a value, at most


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and more threads a worker only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sncv_inputs(radius, same, seed):
    """M4Depth's radius 3 with two cuts, V1's radius 4 with one."""
    cuts = 2 if radius == 3 else 1
    rng = np.random.RandomState(seed)
    c1 = norm_cuts(rng.randn(1, 8, 12, 16), cuts)
    c2 = c1 if same else norm_cuts(rng.randn(1, 8, 12, 16), cuts)
    return c1, c2, cuts


@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("radius", [3, 4])
def test_sncv_plain_and_gradients_match_jax(radius, same):
    """The forward against the Pallas kernel: the same rounded inputs and
    float32 products, summed in another order (rtol 1e-5, atol 1e-6); and
    against the XLA SNCV, which rounds each product and the mean to
    float16: within a float16 ulp of the value and 1e-4 (an ulp at the
    outputs' 0.125). The gradients (autograd of the plain version) against
    the Pallas SNCV's custom VJP through ``jax.vjp`` (the forward's sign
    mask, the unrounded features, float32): the port's use the rounded
    features and come back through the float16 cast, so within 2^-9 of the
    largest gradient and of their own value (two float16 ulps)."""
    c1, c2, cuts = _sncv_inputs(radius, same, seed=radius)
    g = np.random.RandomState(8).randn(
        1, 8, 12, (2 * radius + 1) ** 2 * cuts).astype(np.float32)
    j1, j2 = jnp.asarray(c1), jnp.asarray(c2)
    pallas, vjp = jax.vjp(
        lambda a, b: spatial_cost_volume_pallas(
            a, a if same else b, radius, num_cuts=cuts,
            cv_dtype=jnp.float16, interpret=True), j1, j2)
    ref_grads = vjp(jnp.asarray(g))
    xla = jcv.spatial_cost_volume(j1, j1 if same else j2, radius,
                                  num_cuts=cuts, cv_dtype=jnp.float16)
    t1 = _t(c1).requires_grad_()
    t2 = t1 if same else _t(c2).requires_grad_()
    out = spatial_cost_volume(t1, t2, radius, cuts, torch.float16)
    assert out.dtype == torch.float32
    assert out.shape == (1, 8, 12, (2 * radius + 1) ** 2 * cuts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(xla),
                               rtol=F16_ULP, atol=1e-4)
    (out * _t(g)).sum().backward()
    for got, r in zip([t1.grad] if same else [t1.grad, t2.grad], ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, rtol=2 * F16_ULP,
                                   atol=2 * F16_ULP * np.abs(r).max())


@pytest.mark.parametrize("same", [True, False], ids=["c1_is_c2", "c1_ne_c2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_sncv_plain_grads_equal_autograd_of_the_plain_forward(dtype, same):
    """``testing.sncv_plain_grads``, the reference the card holds the SNCV
    backward kernel to, takes the leaky ReLU's derivative at a given
    forward output; at the plain forward's own output it is autograd of
    the plain forward, bit for bit."""
    c1, c2, cuts = _sncv_inputs(3, same, seed=9)
    g = _t(np.random.RandomState(10).randn(1, 8, 12, 49 * cuts).astype(
        np.float32))
    a = _t(c1).to(dtype).requires_grad_()
    b = a if same else _t(c2).to(dtype).requires_grad_()
    ins = [a] if same else [a, b]
    out = spatial_cost_volume(a, b, 3, cuts, dtype)
    want = torch.autograd.grad(out, ins, g)
    got = sncv_plain_grads(a, b, 3, cuts, dtype, g, out.detach())
    for x, y in zip(got, want):
        assert x.dtype == dtype and torch.equal(x, y)


def _jax_dscv(fn, args, cuts, **kw):
    """``fn`` at float16 under ``jax.jit`` (op by op the rows DSCV takes
    several times as long to run once)."""
    def call(c1, c2, para, centre, rot, trans, f, c):
        return fn(c1, c2, para, centre, rot, trans, JCamera(f, c), 4,
                  num_cuts=cuts, cv_dtype=jnp.float16, **kw)

    return jax.jit(call)(*(jnp.asarray(a) for a in args))


def _port_dscv(fn, args, cuts):
    c1, c2, para, centre, rot, trans, f, c = (
        a if isinstance(a, torch.Tensor) else _t(a) for a in args)
    return fn(c1, c2, para, centre, rot, trans, Camera(f, c), 4, cuts,
              torch.float16)


@pytest.mark.parametrize("cuts", [1, 2])
def test_dscv_plain_matches_jax_rows(cuts):
    """Against the JAX "rows" DSCV at float16, which rounds its bilinear
    weights, products and partial sums to float16: the correlations within
    2^-9 of their value and 2^-11 (two ulps at their ~0.25), the warped
    parallax (the centre hypothesis) within 2^-8 of its value and 2^-10
    (an ulp or two at its ~3)."""
    args = dscv_inputs(b=1, h=12, w=16, C=8, cuts=cuts, seed=3 + cuts)
    cv_ref, pw_ref = _jax_dscv(jcv.parallax_sweeping_cv_rows, args, cuts)
    cv, pw = _port_dscv(parallax_sweeping_cv, args, cuts)
    assert cv.dtype == pw.dtype == torch.float32
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_ref),
                               rtol=2 * F16_ULP, atol=2.0 ** -11)
    np.testing.assert_allclose(pw.numpy(), np.asarray(pw_ref)[..., 4:5],
                               rtol=4 * F16_ULP, atol=F16_ULP)


def test_dscv_gradients_match_jax_rows():
    """Autograd of the plain float16 DSCV against ``jax.grad`` of the
    "rows" DSCV at float16, for c1, c2, the previous parallax and the sweep
    centre (the JAX package's gradient-parity inputs): float16 rounding of
    the two sides' different intermediates, within 2^-9 of each
    gradient's largest value and 2^-8 of its own."""
    rng = np.random.RandomState(11)
    b, h, w, C = 1, 10, 10, 4
    rot = np.array([[1.0, 0.01, -0.02, 0.0]], np.float32)
    rot /= np.linalg.norm(rot)
    x = dict(c1=norm_cuts(rng.randn(b, h, w, C), 2),
             c2=norm_cuts(rng.randn(b, h, w, C), 2),
             para=rng.uniform(0.5, 2, (b, h, w, 1)).astype(np.float32),
             centre=rng.uniform(0.5, 3, (b, h, w, 1)).astype(np.float32))
    motion = (rot, np.array([[0.3, 0.1, 0.6]], np.float32),
              np.full((b, 2), 8.0, np.float32),
              np.full((b, 2), 5.0, np.float32))
    gcv = rng.randn(b, h, w, 18).astype(np.float32)
    gpw = rng.randn(b, h, w, 1).astype(np.float32)
    keys = ("c1", "c2", "para", "centre")

    def jloss(*ins):
        cv, pw = _jax_dscv(jcv.parallax_sweeping_cv_rows, ins + motion, 2)
        return (cv * gcv).sum() + (pw[..., 4:5] * gpw).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x[k]) for k in keys))
    tin = [_t(x[k]).requires_grad_() for k in keys]
    cv, pw = _port_dscv(parallax_sweeping_cv, tuple(tin) + motion, 2)
    ((cv * _t(gcv)).sum() + (pw * _t(gpw)).sum()).backward()
    for k, t, r in zip(keys, tin, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=4 * F16_ULP,
                                   atol=2 * F16_ULP * np.abs(r).max(),
                                   err_msg=k)
    assert np.abs(tin[3].grad.numpy()).max() > 1e-3


def test_fp16_extreme_parallax_stays_finite():
    """The JAX package's regression input (``test_cost_volume.py``): a
    previous parallax of 1e6, past float16's 65504. The port saturates it
    before the cast, as the JAX ``_saturating_cast``: every output finite,
    the warped parallax at most 65504 (and gradients finite, zero for the
    clamped parallax, as ``jnp.clip``'s), the correlations those of a zero
    parallax (within the JAX test's 2e-3 of the JAX split DSCV's)."""
    rng = np.random.RandomState(3)
    b, h, w, C = 1, 12, 14, 8
    c1 = norm_cuts(rng.randn(b, h, w, C), 1)
    c2 = norm_cuts(rng.randn(b, h, w, C), 1)
    para = np.full((b, h, w, 1), 1.0e6, np.float32)
    centre = np.full((b, h, w, 1), 2.0, np.float32)
    motion = (np.array([[1.0, 0, 0, 0]], np.float32),
              np.array([[0.3, 0.1, 0.2]], np.float32),
              np.array([[10.0, 11.0]], np.float32),
              np.array([[7.0, 6.0]], np.float32))
    tin = [_t(a).requires_grad_() for a in (c1, c2, para, centre)]
    for fn in (parallax_sweeping_cv, parallax_sweeping_cv_fused):
        cv, pw = _port_dscv(fn, tuple(tin) + motion, 1)
        assert torch.isfinite(cv).all() and torch.isfinite(pw).all()
        assert pw.max().item() <= 65504.0
        (cv.sum() + pw.sum()).backward()
        assert all(torch.isfinite(t.grad).all() for t in tin)
        assert tin[2].grad.abs().max().item() == 0.0
        for t in tin:
            t.grad = None
    zero = (c1, c2, np.zeros_like(para), centre) + motion
    cv0, _ = _port_dscv(parallax_sweeping_cv, zero, 1)
    np.testing.assert_allclose(cv.detach().numpy(), cv0.numpy(), rtol=0,
                               atol=0)
    split, _ = _jax_dscv(jcv.parallax_sweeping_cv_split,
                         (c1, c2, para, centre) + motion, 1, n_chunks=3)
    np.testing.assert_allclose(cv0.numpy(), np.asarray(split), rtol=2e-3,
                               atol=2e-3)


def test_d3_window_at_float16_matches_jax():
    """A d3 model at narrow widths streams four 48x48 frames under mostly
    lateral motion with ``cv_dtype="float16"``, the port's plain versions
    against the JAX model (its "rows" DSCV, XLA SNCV) on the same weights,
    both float32 convs: float16 rounding at other places compounds through
    the recurrence as bfloat16's does, so ``testing.py``'s bf16 whole-model
    rule (median relative error <= 2^-6, 99th percentile <= 2^-3)."""
    widths = dict(num_levels=3, encoder_channels=(8, 12, 16),
                  refiner_prep_channels=(16, 16, 8),
                  refiner_est_channels=(8, 8, 5), compute_dtype="float32",
                  cv_dtype="float16")
    B, T, H, W = 2, 4, 48, 48
    rng = np.random.RandomState(0)
    rgb = rng.rand(B, T, H, W, 3).astype(np.float32)
    rot = np.tile(np.array([1.0, 0.001, -0.002, 0.001], np.float32),
                  (B, T, 1))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    trans = np.tile(np.array([0.3, 0.1, 0.02], np.float32), (B, T, 1))
    f = np.full((B, 2), W / 2, np.float32)
    c = np.full((B, 2), W / 2, np.float32)
    jcfg = JaxConfig(dscv_impl="rows", sncv_impl="xla", **widths)
    jmodel = JaxM4Depth(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), rgb[:, :2], rot[:, :2], trans[:, :2],
        JCamera(jnp.asarray(f), jnp.asarray(c)))
    model = M4Depth(ModelConfig(**widths), device="cpu", seed=1)
    load_jax_params(model, jax.device_get(params)["params"])
    step = jax.jit(lambda p, s, x, r, tr, nt: jmodel.apply(
        p, s, x, r, tr, JCamera(jnp.asarray(f), jnp.asarray(c)), nt,
        method=JaxM4Depth.step))
    jstate = jax_init_state(jcfg, B, H, W)
    tstate = init_state(model.cfg, B, H, W, device="cpu")
    cam = Camera(_t(f), _t(c))
    for t in range(T):
        new_traj = np.array([t == 0] * B)
        jstate, jdepth = step(params, jstate, rgb[:, t], rot[:, t],
                              trans[:, t], jnp.asarray(new_traj))
        with torch.no_grad():
            tstate, depth = model.step(tstate, _t(rgb[:, t]),
                                       _t(rot[:, t]), _t(trans[:, t]), cam,
                                       _t(new_traj))
        assert depth.shape == (B, H, W, 1)
        assert_bf16_depth_close(depth, _t(np.array(jdepth)),
                                f"frame {t}")


def test_cli_accepts_float16_cost_volumes():
    """``--cv_dtype=float16`` reaches the model config; the convs stay
    float32 or bfloat16, as in the JAX package."""
    parser = build_parser(argparse.ArgumentParser())
    cmd, _ = parser.parse_known_args(["--cv_dtype=float16"])
    cfg = model_config_from_args(cmd)
    assert cfg.cv_dtype == "float16"
    assert cfg.torch_cv_dtype == torch.float16
    with pytest.raises(SystemExit):
        parser.parse_known_args(["--compute_dtype=float16"])
    with pytest.raises(ValueError, match="compute_dtype"):
        ModelConfig(compute_dtype="float16")

"""The PyTorch port's V1 model family, ``recompute_depth`` and ``--remat``
against the JAX package, on the CPU.

Both V1 models run the same weights (the JAX tree converted by
``m4depth_tpu_torch.interop``) on inputs made with numpy from a seed, in
float32, at two levels of narrow widths on 16x16 frames; the port's SNCV
wrapper takes its plain version on CPU tensors, the JAX side its XLA SNCV.
Tolerances: the same float32 arithmetic summed in other orders, through a
recurrence of a few frames: depth to rtol 1e-4, gradients to rtol 1e-3
with an atol of 1e-4 of each leaf's largest value (as the M4Depth step's
test in ``test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.geometry import recompute_depth as jax_recompute_depth
from m4depth_tpu.models import init_state as jax_init_state
from m4depth_tpu.models.m4depth_v1 import M4DepthV1 as JaxM4DepthV1
from m4depth_tpu.models.m4depth_v1 import m4depth_v1_loss as jax_v1_loss
from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera, recompute_depth
from m4depth_tpu_torch.interop import load_jax_params, state_dict_from_jax
from m4depth_tpu_torch.models import (
    M4Depth,
    M4DepthV1,
    init_state,
    inverse_leaky_relu,
    leaky_relu,
    m4depth_v1_loss,
)
from m4depth_tpu_torch.train import make_optimizer, make_train_step

B, T, H, W = 2, 3, 16, 16
SMALL_ANGLE = [0.002, -0.001, 0.003]
QUATERNION = [1.0, 0.002, -0.001, 0.003]


def widths(search_range):
    return dict(num_levels=2, encoder_channels=(8, 12),
                search_range=search_range, compute_dtype="float32",
                cv_dtype="float32")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def make_window(rot, seed=0):
    """Frames, depth 1 + 60 U, one motion for every frame, f = c = w/2."""
    rng = np.random.RandomState(seed)
    rot = np.asarray(rot, np.float32)
    rot = rot / np.linalg.norm(rot) if rot.size == 4 else rot
    return {
        "rgb": rng.rand(B, T, H, W, 3).astype(np.float32),
        "depth": (1.0 + 60 * rng.rand(B, T, H, W, 1)).astype(np.float32),
        "rot": np.tile(rot, (B, T, 1)),
        "trans": np.tile(np.array([0.05, 0.02, 0.4], np.float32), (B, T, 1)),
        "camera_f": np.full((B, 2), W / 2, np.float32),
        "camera_c": np.full((B, 2), W / 2, np.float32),
    }


def v1_pair(search_range, rot, single_frame=False, seed=0):
    """A JAX V1 model with its parameters, the port with the same weights,
    and a window."""
    batch = make_window(rot, seed)
    jmodel = JaxM4DepthV1(JaxConfig(**widths(search_range)),
                          single_frame=single_frame)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), batch["rgb"], batch["rot"],
        batch["trans"], JCamera(jnp.asarray(batch["camera_f"]),
                                jnp.asarray(batch["camera_c"])))
    model = M4DepthV1(ModelConfig(**widths(search_range)), device="cpu",
                      seed=seed + 1, single_frame=single_frame,
                      rot_dim=len(rot))
    load_jax_params(model, jax.device_get(params)["params"])
    return dict(jmodel=jmodel, params=params, model=model, batch=batch)


@pytest.fixture(scope="module", params=[2, 4], ids=["r2", "r4"])
def pair(request):
    return v1_pair(request.param, SMALL_ANGLE)


def jax_window(p):
    b = p["batch"]
    return jax.jit(lambda params, rgb, rot, trans, f, c: p["jmodel"].apply(
        params, rgb, rot, trans, JCamera(f, c)))(
        p["params"], b["rgb"], b["rot"], b["trans"], b["camera_f"],
        b["camera_c"])


def port_window(p):
    tb = {k: _t(v) for k, v in p["batch"].items()}
    return p["model"](tb["rgb"], tb["rot"], tb["trans"],
                      Camera(tb["camera_f"], tb["camera_c"]))


# -- weights ---------------------------------------------------------------


def test_v1_converter_covers_every_parameter(pair):
    """Every JAX leaf (encoder/conv_s{1,2}_i, level_i/conv_j) sets one port
    parameter, and every port parameter is set."""
    tree = jax.device_get(pair["params"])["params"]
    sd = state_dict_from_jax(tree, pair["model"])
    assert set(sd) == set(pair["model"].state_dict())
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n_jax
    assert "levels.1.convs.6.weight" in sd


def test_v1_converter_rejects_unused_and_missing_keys(pair):
    tree = jax.device_get(pair["params"])["params"]
    with pytest.raises(KeyError, match="left unused"):
        state_dict_from_jax(dict(tree, stray={"bias": np.zeros(3)}),
                            pair["model"])
    missing = dict(tree)
    missing["level_2"] = {k: v for k, v in tree["level_2"].items()
                          if k != "conv_3"}
    with pytest.raises(KeyError, match="conv_3"):
        state_dict_from_jax(missing, pair["model"])


# -- forward ---------------------------------------------------------------


def assert_pyramids_close(out, ref):
    assert len(out) == len(ref) == T
    for t, (pyr, jpyr) in enumerate(zip(out, ref)):
        assert len(pyr) == len(jpyr) == 2
        for lvl, (d, jd) in enumerate(zip(pyr, jpyr)):
            assert d.shape == jd.shape
            np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"frame {t} level {lvl + 1}")


def test_v1_window_matches_jax(pair):
    """Every level's depth of every frame of a window, small-angle motion,
    at search ranges 2 and 4 (a 9x9 cross-correlation)."""
    with torch.no_grad():
        out = port_window(pair)
    assert_pyramids_close(out, jax_window(pair))


@pytest.mark.parametrize("single_frame", [False, True],
                         ids=["temporal", "single_frame"])
def test_v1_quaternion_window_matches_jax(single_frame):
    """Quaternion motion (the data path's), the JAX package's negated rot
    included, and the single-frame mode."""
    p = v1_pair(4, QUATERNION, single_frame=single_frame, seed=3)
    with torch.no_grad():
        out = port_window(p)
    assert_pyramids_close(out, jax_window(p))


def test_v1_streaming_step_matches_jax(pair):
    """Four frames of ``step`` from ``init_state``; element 0 restarts its
    trajectory at frame 2."""
    p, b = pair, pair["batch"]
    cfg = p["model"].cfg
    step = jax.jit(lambda params, s, rgb, rot, trans, f, c, nt: p["jmodel"]
                   .apply(params, s, rgb, rot, trans, JCamera(f, c), nt,
                          method=JaxM4DepthV1.step))
    jstate = jax_init_state(JaxConfig(**widths(cfg.search_range)), B, H, W)
    state = init_state(cfg, B, H, W, device="cpu")
    cam = Camera(_t(b["camera_f"]), _t(b["camera_c"]))
    for i in range(4):
        t = i % T
        new_traj = np.array([i in (0, 2), i == 0])
        jstate, jdepth = step(p["params"], jstate, b["rgb"][:, t],
                              b["rot"][:, t], b["trans"][:, t],
                              b["camera_f"], b["camera_c"],
                              jnp.asarray(new_traj))
        state, depth = p["model"].step(
            state, _t(b["rgb"][:, t]), _t(b["rot"][:, t]),
            _t(b["trans"][:, t]), cam, _t(new_traj))
        assert depth.shape == (B, H, W, 1)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth),
                                   rtol=1e-4, atol=1e-6, err_msg=f"frame {i}")
        for s, js in zip(state, jstate):
            np.testing.assert_allclose(s.depth.numpy(), np.asarray(js.depth),
                                       rtol=1e-4, atol=1e-6)


# -- loss and one training step ------------------------------------------


@pytest.mark.parametrize("single_frame", [False, True],
                         ids=["temporal", "single_frame"])
def test_v1_loss_matches_jax(single_frame):
    """The legacy pyramid log-L1 on random pyramids, including depths past
    both clip bounds; single-frame scores frames 0..T-2."""
    rng = np.random.RandomState(7)
    gt = (rng.rand(B, 4, 16, 16, 1) * 300).astype(np.float32)
    preds = [[(rng.rand(B, s, s, 1) * 250 + 0.01).astype(np.float32)
              for s in (8, 4, 2)] for _ in range(4)]
    ref = jax_v1_loss(jnp.asarray(gt), [[jnp.asarray(d) for d in p]
                                        for p in preds], single_frame)
    out = m4depth_v1_loss(_t(gt), [[_t(d) for d in p] for p in preds],
                          single_frame)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


def test_v1_train_step_matches_jax():
    """The loss and every parameter's gradient of a window with quaternion
    motion (the data path's) against ``jax.value_and_grad`` of the JAX loss
    (the gradient runs through the 9x9 SNCV cross-correlation, the warp of
    the previous features and the recomputed depth into the previous
    frame), then ``make_train_step``'s scalars and images."""
    p = v1_pair(4, QUATERNION, seed=5)
    jm, b = p["jmodel"], p["batch"]

    def loss_fn(params):
        preds = jm.apply(params, b["rgb"], b["rot"], b["trans"],
                         JCamera(jnp.asarray(b["camera_f"]),
                                 jnp.asarray(b["camera_c"])))
        return jm.loss(jnp.asarray(b["depth"]), preds)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(p["params"])
    model = p["model"]
    loss = model.loss(_t(b["depth"]), port_window(p))
    model.zero_grad(set_to_none=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = state_dict_from_jax(jax.device_get(jgrads)["params"], model)
    grads = dict(model.named_parameters())
    for name, g_ref in ref.items():
        scale = float(g_ref.abs().max())
        np.testing.assert_allclose(grads[name].grad.numpy(), g_ref.numpy(),
                                   rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)
    assert float(grads["encoder.conv_s2.0.weight"].grad.abs().max()) > 0

    out = make_train_step(model, make_optimizer(
        model, TrainConfig(learning_rate=1e-4)), with_images=True)(
        {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(out["loss"].item(), float(jloss), rtol=1e-5)
    assert torch.isfinite(out["RMSE_log"]) and torch.isfinite(
        out["grad_norm"])
    assert out["images"]["depth_lvl_0"].shape == (8, 8, 1)


# -- geometry and activations --------------------------------------------


@pytest.mark.parametrize("rot", [SMALL_ANGLE, QUATERNION],
                         ids=["small_angle", "quaternion"])
def test_recompute_depth_matches_jax(rot):
    """Depths spanning both clip bounds; the geometry factors are detached,
    so the gradient to the depth is the factor alone (float32 rounding:
    rtol 1e-6)."""
    rng = np.random.RandomState(2)
    depth = np.exp(rng.uniform(-4, 9, (B, 6, 8, 1))).astype(np.float32)
    r = np.tile(np.asarray(rot, np.float32), (B, 1))
    trans = np.tile(np.array([0.3, -0.2, 1.5], np.float32), (B, 1))
    f = np.full((B, 2), 5.0, np.float32)
    c = np.tile(np.array([[4.0, 3.0]], np.float32), (B, 1))
    ref = jax_recompute_depth(jnp.asarray(depth), jnp.asarray(r),
                              jnp.asarray(trans),
                              JCamera(jnp.asarray(f), jnp.asarray(c)))
    d = _t(depth).requires_grad_()
    rt = _t(r).requires_grad_()
    out = recompute_depth(d, rt, _t(trans), Camera(_t(f), _t(c)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    assert float(out.detach().min()) == pytest.approx(0.1)
    assert float(out.detach().max()) == pytest.approx(2000.0)
    out.sum().backward()
    assert rt.grad is None or float(rt.grad.abs().max()) == 0.0
    assert float(d.grad.abs().max()) > 0


def test_inverse_leaky_relu_inverts_leaky_relu():
    x = torch.tensor([-3.0, -0.5, 0.0, 0.25, 2.0])
    torch.testing.assert_close(inverse_leaky_relu(leaky_relu(x, 0.1), 0.1),
                               x)


# -- remat -----------------------------------------------------------------

D3 = dict(num_levels=3, encoder_channels=(8, 12, 16),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")


@pytest.mark.parametrize("policy", ["all", "dscv"])
def test_remat_gradients_equal_no_remat(policy):
    """Checkpointing recomputes the same float32 ops in the same order:
    the loss and every gradient equal those without remat, bitwise."""
    rng = np.random.RandomState(4)
    rot = np.array([1.0, 0.001, -0.002, 0.001], np.float32)
    batch = {
        "rgb": _t(rng.rand(2, 3, 32, 32, 3).astype(np.float32)),
        "depth": _t((1 + 60 * rng.rand(2, 3, 32, 32, 1)).astype(np.float32)),
        "rot": _t(np.tile(rot / np.linalg.norm(rot), (2, 3, 1))),
        "trans": _t(np.tile(np.array([0.3, 0.1, 0.02], np.float32),
                            (2, 3, 1))),
    }
    cam = Camera(torch.full((2, 2), 16.0), torch.full((2, 2), 16.0))
    grads = []
    for remat in (False, True):
        model = M4Depth(ModelConfig(remat=remat, remat_policy=policy, **D3),
                        device="cpu", seed=9)
        loss = model.loss(batch["depth"], model(
            batch["rgb"], batch["rot"], batch["trans"], cam))
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


def test_bad_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ModelConfig(remat=True, remat_policy="levels")
    ModelConfig(remat=False, remat_policy="levels")  # read only with remat

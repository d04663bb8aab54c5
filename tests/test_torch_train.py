"""The PyTorch port's training slice against the JAX package's, on the CPU.

Windowed forward, loss, gradients, Adam step, clip, learning-rate
schedules, metrics and the eval steps. Both packages get the same weights
(the JAX tree converted by ``m4depth_tpu_torch.interop``) and inputs made
with numpy from a seed, in float32. The JAX side runs its reference DSCV
(``dscv_impl="gather"``) and XLA SNCV; the port runs its plain versions,
which its kernel wrappers take on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m4depth_tpu import losses as jlosses
from m4depth_tpu import metrics as jmetrics
from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.models import M4Depth as JaxM4Depth
from m4depth_tpu.models.decoder import LevelEstimate as JLevelEstimate
from m4depth_tpu.train.step import make_lr_schedule as jax_lr_schedule
from m4depth_tpu_torch import losses, metrics
from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.interop import load_jax_params, state_dict_from_jax
from m4depth_tpu_torch.models import LevelEstimate, M4Depth, init_state
from m4depth_tpu_torch.models import decoder as port_decoder
from m4depth_tpu_torch.testing import assert_train_step_close
from m4depth_tpu_torch.train import (
    make_lr_schedule,
    make_optimizer,
    make_streaming_eval_step,
    make_train_step,
    make_windowed_eval_step,
)
from m4depth_tpu_torch.train.step import init_adam_state

# each level's channels divide into its cuts (1, 2, 2, 4)
D4 = dict(num_levels=4, encoder_channels=(8, 12, 16, 16),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")
D3 = dict(D4, num_levels=3, encoder_channels=(8, 12, 16))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def make_batch(b, T, hw, seed):
    """A window with mostly lateral motion (keeps the depth recurrence well
    conditioned with random weights) and depth 1 + 60 U, as the JAX
    package's training profile makes it."""
    rng = np.random.RandomState(seed)
    rot = np.tile(np.array([1.0, 0.001, -0.002, 0.001], np.float32),
                  (b, T, 1))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    return {
        "rgb": rng.rand(b, T, hw, hw, 3).astype(np.float32),
        "depth": (1.0 + 60 * rng.rand(b, T, hw, hw, 1)).astype(np.float32),
        "rot": rot,
        "trans": np.tile(np.array([0.3, 0.1, 0.02], np.float32), (b, T, 1)),
        "camera_f": np.full((b, 2), hw / 2, np.float32),
        "camera_c": np.full((b, 2), hw / 2, np.float32),
    }


def jax_pair(widths, batch, seed):
    """A JAX model with its parameters, and the port with the same
    weights."""
    jcfg = JaxConfig(dscv_impl="gather", sncv_impl="xla", **widths)
    jmodel = JaxM4Depth(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), batch["rgb"][:, :2], batch["rot"][:, :2],
        batch["trans"][:, :2],
        JCamera(jnp.asarray(batch["camera_f"]),
                jnp.asarray(batch["camera_c"])))
    model = M4Depth(ModelConfig(**widths), device="cpu", seed=seed + 1)
    load_jax_params(model, jax.device_get(params)["params"])
    return jmodel, params, model


def torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def jax_camera(batch):
    return JCamera(jnp.asarray(batch["camera_f"]),
                   jnp.asarray(batch["camera_c"]))


# -- window forward ------------------------------------------------------


def test_window_forward_matches_jax():
    """d4 at narrow widths, 64x64, b=2, T=3: every level's depth of every
    frame against JAX ``apply`` (rtol 1e-4, float32 rounding)."""
    batch = make_batch(2, 3, 64, seed=0)
    jmodel, params, model = jax_pair(D4, batch, seed=0)
    ref = jax.jit(lambda p, rgb, rot, trans, f, c: jmodel.apply(
        p, rgb, rot, trans, JCamera(f, c)))(
        params, batch["rgb"], batch["rot"], batch["trans"],
        batch["camera_f"], batch["camera_c"])
    tb = torch_batch(batch)
    with torch.no_grad():
        out = model(tb["rgb"], tb["rot"], tb["trans"],
                    Camera(tb["camera_f"], tb["camera_c"]))
    assert len(out) == len(ref) == 3
    for t, (pyr, jpyr) in enumerate(zip(out, ref)):
        assert len(pyr) == len(jpyr) == 4
        for lvl, (est, jest) in enumerate(zip(pyr, jpyr)):
            np.testing.assert_allclose(
                est.depth.numpy(), np.asarray(jest.depth), rtol=1e-4,
                atol=1e-6, err_msg=f"frame {t} level {lvl + 1}")


def test_window_frame0_runs_no_cost_volume(monkeypatch):
    """Frame 0 of a window is statically a reset: only frames 1..T-1 run
    the two cost volumes, once per level each."""
    calls = {"dscv": 0, "sncv": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_decoder, "parallax_sweeping_cv_fused", counting(
        "dscv", port_decoder.parallax_sweeping_cv_fused))
    monkeypatch.setattr(port_decoder, "spatial_cost_volume_fused", counting(
        "sncv", port_decoder.spatial_cost_volume_fused))
    model = M4Depth(ModelConfig(**D3), device="cpu")
    tb = torch_batch(make_batch(1, 4, 32, seed=1))
    with torch.no_grad():
        preds = model(tb["rgb"], tb["rot"], tb["trans"],
                      Camera(tb["camera_f"], tb["camera_c"]))
    assert len(preds) == 4
    assert calls == {"dscv": 3 * 3, "sncv": 3 * 3}
    assert torch.all(preds[0][0].depth == 1000.0)


# -- one training step ----------------------------------------------------


@pytest.fixture(scope="module")
def step_pair():
    """d3, 32x32, b=2, T=3: the JAX loss and gradients, and the port's."""
    batch = make_batch(2, 3, 32, seed=2)
    jmodel, params, model = jax_pair(D3, batch, seed=2)

    def loss_fn(p):
        preds = jmodel.apply(p, batch["rgb"], batch["rot"], batch["trans"],
                             jax_camera(batch))
        return jmodel.loss(jnp.asarray(batch["depth"]), preds)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(batch=batch, params=params, model=model, jloss=jloss,
                jgrads=jax.device_get(jgrads)["params"])


def test_train_step_loss_and_gradients_match_jax(step_pair):
    """The port's loss and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX train step's ``loss_fn`` (float32):
    the gradient runs through both cost volumes, the feature memory of the
    previous frame and the sweep centre into every deeper level."""
    p = step_pair
    model = p["model"]
    tb = torch_batch(p["batch"])
    preds = model(tb["rgb"], tb["rot"], tb["trans"],
                  Camera(tb["camera_f"], tb["camera_c"]))
    loss = model.loss(tb["depth"], preds)
    model.zero_grad(set_to_none=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(p["jloss"]), rtol=1e-5)
    ref = state_dict_from_jax(p["jgrads"], model)
    grads = dict(model.named_parameters())
    assert set(ref) == set(grads)
    top = max(float(g.abs().max()) for g in ref.values())
    for name, g_ref in ref.items():
        g = grads[name].grad
        assert g is not None, name
        scale = float(g_ref.abs().max())
        if scale < 1e-6 * top:
            # zero up to rounding on both sides: the first conv's bias
            # feeds the domain norm, which subtracts each channel's mean
            assert float(g.abs().max()) < 1e-6 * top, name
            continue
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)
    # the encoder's first conv is reached only through the cost volumes
    assert float(grads["encoder.conv_s1.0.weight"].grad.abs().max()) > 0


def test_train_step_returns_scalars_and_updates(step_pair):
    """``make_train_step``: the loss of the parameters before the update,
    RMSE_log of the last frame and the gradient norm, as 0-d tensors; the
    parameters move by Adam's first step (about lr per element)."""
    p = step_pair
    model = M4Depth(ModelConfig(**D3), device="cpu")
    model.load_state_dict(p["model"].state_dict())
    before = {n: t.detach().clone() for n, t in model.named_parameters()}
    opt = make_optimizer(model, TrainConfig(learning_rate=1e-4))
    out = make_train_step(model, opt)(torch_batch(p["batch"]))
    assert set(out) == {"loss", "RMSE_log", "grad_norm"}
    assert all(v.dim() == 0 and torch.isfinite(v) for v in out.values())
    np.testing.assert_allclose(out["loss"].item(), float(p["jloss"]),
                               rtol=1e-5)
    ref_norm = optax.global_norm(p["jgrads"])
    np.testing.assert_allclose(out["grad_norm"].item(), float(ref_norm),
                               rtol=1e-3)
    assert opt.count == 1
    moved = max(float((t.detach() - before[n]).abs().max())
                for n, t in model.named_parameters())
    assert 0 < moved <= 1e-4 * 1.01


def test_train_step_comparison_rule():
    """The rule that holds a training step on the card against the CPU
    (``m4depth_tpu_torch.testing``): equal steps pass; a leaf of ordinary
    size may differ by 1e-3 of its own largest gradient, a leaf under
    SMALL_LEAF of the model's largest by 1e-2 of its own; a difference
    beyond that fails and names the leaf."""
    rng = np.random.RandomState(0)
    ref = {"big": _t(rng.randn(64).astype(np.float32)),
           "small": _t(1e-5 * rng.randn(16).astype(np.float32))}
    top = float(ref["big"].abs().max())
    small = float(ref["small"].abs().max())
    params = {n: torch.zeros_like(g) for n, g in ref.items()}
    res = assert_train_step_close(ref, ref, params, params, lr=1e-4)
    assert res["small_leaves"] == ["small"]
    assert max(res["shares"].values()) == 0.0

    near_zero = {n: int(g.abs().argmin()) for n, g in ref.items()}
    for name, off, ok in (("small", 5e-3 * small, True),
                          ("small", 1e-1 * small, False),
                          ("big", 5e-4 * top, True),
                          ("big", 2e-3 * top, False)):
        got = dict(ref)
        got[name] = ref[name].clone()
        got[name][near_zero[name]] += off
        if ok:
            assert_train_step_close(got, ref, params, params, lr=1e-4)
        else:
            with pytest.raises(AssertionError, match=name):
                assert_train_step_close(got, ref, params, params, lr=1e-4)


# -- optimiser ---------------------------------------------------------------


def _update(opt):
    """One ``Optimizer.apply_gradients`` as a train step's host side runs
    it: at the schedule's rate for ``count``, as a 0-d tensor, then
    ``count += 1``. Returns the gradient norm."""
    init_adam_state(opt)
    norm = opt.apply_gradients(torch.tensor(opt.lr_schedule(opt.count)))
    opt.count += 1
    return norm


def _random_grads(model, seed):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*p.shape) * 0.05).astype(np.float32)
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3],
                         ids=["no_clip", "clipped", "under_limit"])
def test_optimizer_matches_optax(clip):
    """Two updates of ``make_optimizer`` (clip, then Adam at 1e-4) against
    ``optax.chain(clip_by_global_norm, adam)`` on the same gradients."""
    model = M4Depth(ModelConfig(**D3), device="cpu", seed=5)
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    tx = optax.chain(
        optax.clip_by_global_norm(clip) if clip > 0 else optax.identity(),
        optax.adam(jax_lr_schedule(1e-4)))
    state = tx.init(params)
    jparams = params
    opt = make_optimizer(
        model, TrainConfig(learning_rate=1e-4, grad_clip_norm=clip))
    for step in range(2):
        grads = _random_grads(model, seed=step)
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, prm in model.named_parameters():
            prm.grad = _t(grads[n]).clone()
        norm = _update(opt)
        np.testing.assert_allclose(norm.item(),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)
    for n, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(),
                                   np.asarray(jparams[n]), rtol=1e-5,
                                   atol=1e-8, err_msg=n)


@pytest.mark.parametrize("max_norm", [0.3, 1e3])
def test_clip_matches_optax(max_norm):
    """The clip alone: g |g|^-1 max once |g| >= max, else g untouched."""
    model = M4Depth(ModelConfig(**D3), device="cpu", seed=6)
    grads = _random_grads(model, seed=9)
    ref, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
    opt = make_optimizer(
        model, TrainConfig(learning_rate=0.0, grad_clip_norm=max_norm))
    for n, prm in model.named_parameters():
        prm.grad = _t(grads[n]).clone()
    _update(opt)
    for n, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), np.asarray(ref[n]),
                                   rtol=1e-6, atol=1e-9, err_msg=n)


@pytest.mark.parametrize("schedule", ["constant", "staircase", "cosine"])
def test_lr_schedules_match_optax(schedule):
    total = TrainConfig().total_steps
    ref = jax_lr_schedule(1e-4, schedule, total)
    port = make_lr_schedule(1e-4, schedule, total)
    for count in (0, 1, 199, 200, 999, 59_999, 60_000, 120_000):
        np.testing.assert_allclose(port(count), float(ref(count)),
                                   rtol=1e-5, atol=1e-12,
                                   err_msg=f"step {count}")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        make_lr_schedule(1e-4, "linear")


# -- loss and metrics ------------------------------------------------------


def _pyramids(rng, b, T, sizes):
    """Per frame, level depths in [0.005, 250] (both clip ends hit)."""
    return [[rng.uniform(0.005, 250, (b, s, s, 1)).astype(np.float32)
             for s in sizes] for _ in range(T)]


@pytest.mark.parametrize("depth_type", ["map", "velodyne"])
def test_loss_matches_jax(depth_type):
    rng = np.random.RandomState(3)
    b, T, hw = 2, 3, 16
    gt = rng.uniform(0.5, 80, (b, T, hw, hw, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.6] = 0.0        # velodyne holes
    gt[:, :, :4, :4] = 0.0                     # whole blocks without gt
    pyr = _pyramids(rng, b, T, (8, 4, 2))
    zero = np.zeros_like
    jpreds = [[JLevelEstimate(jnp.asarray(d), jnp.asarray(zero(d)),
                              jnp.asarray(zero(d))) for d in frame]
              for frame in pyr]
    tpreds = [[LevelEstimate(_t(d), _t(zero(d)), _t(zero(d))) for d in frame]
              for frame in pyr]
    ref = jlosses.m4depth_loss(jnp.asarray(gt), jpreds, depth_type)
    out = losses.m4depth_loss(_t(gt), tpreds, depth_type)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


def test_velodyne_loss_rejects_non_multiple_sizes():
    gt = torch.ones(1, 2, 10, 10, 1)
    preds = [[LevelEstimate(torch.ones(1, 4, 4, 1), None, None)]] * 2
    with pytest.raises(ValueError, match="integer multiple"):
        losses.m4depth_loss(gt, preds, "velodyne")


def test_l1_regularization_matches_jax(step_pair):
    p = step_pair
    ref = jlosses.l1_param_regularization(p["params"]["params"], 1e-3)
    out = losses.l1_param_regularization(p["model"], 1e-3)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    assert losses.l1_param_regularization(p["model"], 0.0).item() == 0.0


def test_metrics_and_accumulator_match_jax():
    """``compute_metrics`` on clipped depths with holes, and the running
    means over three updates, one of weight 0 whose metrics are NaN."""
    rng = np.random.RandomState(4)
    jacc = jmetrics.MetricAccumulator.zeros()
    tacc = metrics.MetricAccumulator.zeros()
    for step, weight in enumerate((1.0, 0.0, 1.0)):
        gt = rng.uniform(0.0, 100, (2, 12, 12, 1)).astype(np.float32)
        gt[rng.rand(*gt.shape) < 0.3] = 0.0
        est = rng.uniform(0.0, 100, (2, 12, 12, 1)).astype(np.float32)
        ref = jmetrics.compute_metrics(
            *jmetrics.clip_for_eval(jnp.asarray(gt), jnp.asarray(est)))
        out = metrics.compute_metrics(*metrics.clip_for_eval(_t(gt), _t(est)))
        assert tuple(out) == metrics.METRIC_NAMES == jmetrics.METRIC_NAMES
        for name in metrics.METRIC_NAMES:
            np.testing.assert_allclose(out[name].item(), float(ref[name]),
                                       rtol=1e-5, err_msg=name)
        if weight == 0.0:
            ref = {k: jnp.nan for k in ref}
            out = {k: torch.tensor(float("nan")) for k in out}
        jacc = jacc.update(ref, weight=weight)
        tacc = tacc.update(out, weight=weight)
    jres, tres = jacc.result(), tacc.result()
    for name in metrics.METRIC_NAMES:
        assert np.isfinite(tres[name].item())
        np.testing.assert_allclose(tres[name].item(), float(jres[name]),
                                   rtol=1e-5, err_msg=name)


# -- eval steps --------------------------------------------------------------


def test_windowed_and_streaming_eval_steps(step_pair):
    """The windowed eval scores the last frame of the window; the streaming
    eval gives a ``new_traj`` frame weight 0. Both against the metrics of
    the same depths computed directly."""
    p = step_pair
    model = p["model"]
    tb = torch_batch(p["batch"])
    cam = Camera(tb["camera_f"], tb["camera_c"])
    acc = make_windowed_eval_step(model)(tb, metrics.MetricAccumulator.zeros())
    with torch.no_grad():
        preds = model(tb["rgb"], tb["rot"], tb["trans"], cam)
        gt = tb["depth"][:, -1]
        ref = metrics.compute_metrics(*metrics.clip_for_eval(
            gt, model.final_depth(preds, gt.shape[1:3])))
    assert acc.count.item() == 1.0
    for name, v in acc.result().items():
        assert v.item() == pytest.approx(ref[name].item(), rel=1e-6)

    step = make_streaming_eval_step(model)
    b, T = tb["rgb"].shape[:2]
    state = init_state(model.cfg, b, 32, 32, device="cpu")
    acc = metrics.MetricAccumulator.zeros()
    for t in range(T):
        frame = {k: tb[k][:, t] for k in ("rgb", "depth", "rot", "trans")}
        frame.update(camera_f=tb["camera_f"], camera_c=tb["camera_c"],
                     new_traj=torch.tensor([t == 0] * b))
        state, acc = step(state, frame, acc)
    assert acc.count.item() == T - 1

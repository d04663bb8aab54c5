"""The port's compiled programs (``m4depth_tpu_torch/utils/graphs.py`` and
the compiled serving, eval and train steps) on the CPU.

On the card each compiled step is a CUDA graph; on the CPU it runs its
body eagerly, and these tests hold the bodies to what a capture needs and
to what the eager steps and the JAX package's jitted steps compute:

* no host sync: each graph body runs under a dispatch mode that raises on
  the aten ops that read a device value on the host (a capture refuses
  them on the card);
* donation: the state is updated in place and returned, and the depth of
  a frame is not overwritten by the next one;
* the compiled serving chain equals the eager ``model.step`` chain bit
  for bit, and the JAX jitted step at the tolerances of
  ``tests/test_torch_model.py``;
* the train steps' one Adam update (a tensor learning rate and device
  step counts) over the cosine warm-up against optax, and the compiled
  train step against the eager one bit for bit and the JAX jitted step at
  the tolerances of ``tests/test_torch_train.py``;
* checkpoints cross between the eager and the compiled steps bit for
  bit.

The card's side (capture, replay, recapture) is in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.models import M4Depth as JaxM4Depth
from m4depth_tpu.models import init_state as jax_init_state
from m4depth_tpu.train.step import create_train_state as jax_train_state
from m4depth_tpu.train.step import make_train_step as jax_train_step
from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.interop import load_jax_params
from m4depth_tpu_torch.metrics import MetricAccumulator
from m4depth_tpu_torch.models import M4Depth, M4DepthV1, init_state
from m4depth_tpu_torch.parallel import compile_step
from m4depth_tpu_torch.train import (
    TrainState,
    compile_streaming_eval_step,
    compile_train_step,
    compile_windowed_eval_step,
    make_optimizer,
    make_train_step,
)
from m4depth_tpu_torch.utils.graphs import assign_

D3 = dict(num_levels=3, encoder_channels=(8, 12, 16),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")
D2 = dict(D3, num_levels=2, encoder_channels=(8, 12))
V1 = dict(num_levels=2, encoder_channels=(8, 12), compute_dtype="float32",
          cv_dtype="float32")
B, HW = 2, 32
ROT = [1.0, 0.001, -0.002, 0.001]
TRANS = [0.3, 0.1, 0.02]

HOST_SYNCS = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::is_nonzero", "aten::equal", "aten::masked_select")
BOOL_INDEXING = ("aten::index", "aten::index_put", "aten::index_put_")


class NoHostSync(TorchDispatchMode):
    """Raise on every aten op that reads a tensor's value on the host
    (``.item()``, ``bool(t)``, ``nonzero``, ``torch.equal``, and indexing
    by a boolean mask, whose ``nonzero`` runs below the dispatcher): on
    the card each waits for the device, which a CUDA graph's capture
    refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        masks = name in BOOL_INDEXING and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in (args[1] if len(args) > 1 else ()) or ())
        if name in HOST_SYNCS or masks:
            raise AssertionError(f"host sync in a graph body: {func}")
        return func(*args, **(kwargs or {}))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def frames(n, b=B, hw=HW, seed=0):
    """``n`` frames of ``b`` streams, mostly lateral motion (a well
    conditioned recurrence with random weights): rgb [n, b, hw, hw, 3],
    rot [b, 4], trans [b, 3], f [b, 2]."""
    rng = np.random.RandomState(seed)
    rot = np.tile(np.asarray(ROT, np.float32), (b, 1))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    return (rng.rand(n, b, hw, hw, 3).astype(np.float32), rot,
            np.tile(np.asarray(TRANS, np.float32), (b, 1)),
            np.full((b, 2), hw / 2, np.float32))


def window(b=B, T=3, hw=HW, seed=2):
    rng = np.random.RandomState(seed)
    rgb, rot, trans, f = frames(T, b, hw, seed)
    return {
        "rgb": _t(rgb.transpose(1, 0, 2, 3, 4)),
        "depth": _t((1.0 + 60 * rng.rand(b, T, hw, hw, 1)).astype(
            np.float32)),
        "rot": _t(np.repeat(rot[:, None], T, 1)),
        "trans": _t(np.repeat(trans[:, None], T, 1)),
        "camera_f": _t(f), "camera_c": _t(f.copy()),
    }


def test_guard_catches_host_syncs():
    x = torch.ones(3)
    for read in (lambda: x.sum().item(), lambda: bool(x[0] > 0),
                 lambda: torch.nonzero(x), lambda: torch.equal(x, x),
                 lambda: x[x > 0]):
        with pytest.raises(AssertionError, match="host sync"):
            with NoHostSync():
                read()
    with NoHostSync():
        torch.where(x > 0, x, -x).sum()


@pytest.mark.parametrize("cv_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("family", [M4Depth, M4DepthV1],
                         ids=["m4depth", "v1"])
def test_serving_body_makes_no_host_sync(family, cv_dtype):
    """The compiled serving step of both families, with each cost-volume
    dtype, two frames (a reset, then the recurrence)."""
    widths = D3 if family is M4Depth else V1
    cfg = ModelConfig(**dict(widths, compute_dtype="bfloat16",
                             cv_dtype=cv_dtype))
    model = family(cfg, device="cpu", seed=0)
    step = compile_step(model)
    rgb, rot, trans, f = frames(2)
    state = init_state(cfg, B, HW, HW, device="cpu")
    with NoHostSync():
        for t in range(2):
            state, depth = step(state, _t(rgb[t]), _t(rot), _t(trans),
                                Camera(_t(f), _t(f)),
                                torch.full((B,), t == 0))
    assert bool(torch.isfinite(depth).all())


def test_eval_bodies_make_no_host_sync():
    """The compiled streaming eval step (a reset frame scored with weight
    0 on the device) and the compiled windowed one."""
    model = M4Depth(ModelConfig(**D3), device="cpu", seed=0)
    rgb, rot, trans, f = frames(3)
    depth = _t((1 + 60 * np.random.RandomState(1).rand(B, HW, HW, 1))
               .astype(np.float32))
    stream = compile_streaming_eval_step(model)
    windowed = compile_windowed_eval_step(model)
    state = init_state(model.cfg, B, HW, HW, device="cpu")
    acc, wacc = MetricAccumulator.zeros(), MetricAccumulator.zeros()
    with NoHostSync(), torch.no_grad():
        for t in range(3):
            frame = {"rgb": _t(rgb[t]), "rot": _t(rot), "trans": _t(trans),
                     "camera_f": _t(f), "camera_c": _t(f), "depth": depth,
                     "new_traj": torch.full((B,), t == 0)}
            state, acc = stream(state, frame, acc)
        wacc = windowed(window(), wacc)
    assert float(acc.count) == 2 and float(wacc.count) == 1
    assert bool(torch.isfinite(acc.totals).all())
    assert bool(torch.isfinite(wacc.totals).all())


@pytest.mark.parametrize("kw", [
    {}, {"grad_clip_norm": 0.5}, {"with_images": True},
    {"remat_policy": "all"}, {"remat_policy": "dscv"}],
    ids=["plain", "clip", "images", "remat-all", "remat-dscv"])
def test_train_body_makes_no_host_sync(kw):
    """Two compiled train steps (the cosine warm-up: a new rate each
    step), with and without the clip, the summary images and remat."""
    policy = kw.get("remat_policy")
    cfg = ModelConfig(**D3) if policy is None else ModelConfig(
        remat=True, remat_policy=policy, **D3)
    model = M4Depth(cfg, device="cpu", seed=0)
    opt = make_optimizer(model, TrainConfig(
        learning_rate=1e-3, lr_schedule="cosine",
        grad_clip_norm=kw.get("grad_clip_norm", 0.0)))
    step = compile_train_step(model, opt,
                              with_images=kw.get("with_images", False))
    batch = window()
    with NoHostSync():
        for _ in range(2):
            out = step(batch)
    assert set(out) == ({"loss", "RMSE_log", "grad_norm", "images"}
                        if kw.get("with_images") else
                        {"loss", "RMSE_log", "grad_norm"})
    assert bool(torch.isfinite(out["loss"])) and opt.count == 2


def test_assign_keeps_the_destination_and_refuses_other_structures():
    dst = (torch.zeros(2), {"a": torch.zeros(3)})
    src = (torch.ones(2), {"a": torch.full((3,), 2.0)})
    ids = [id(x) for x in tree_flatten(dst)[0]]
    out = assign_(dst, src)
    assert out is dst and ids == [id(x) for x in tree_flatten(out)[0]]
    assert torch.equal(dst[1]["a"], src[1]["a"])
    with pytest.raises(ValueError, match="structures differ"):
        assign_(dst, (torch.ones(2),))


def test_compiled_step_donates_and_matches_eager_and_jax():
    """Four frames, element 0 resetting at frame 2: the compiled chain
    updates the caller's state in place and returns it, a frame's depth
    is untouched by the next frame, the chain equals the eager
    ``M4Depth.step`` chain bit for bit and the JAX jitted step to float32
    rounding (``tests/test_torch_model.py``'s rtol 1e-4, atol 1e-6)."""
    cfg = ModelConfig(**D3)
    rgb, rot, trans, f = frames(4, seed=3)
    jcfg = JaxConfig(dscv_impl="gather", sncv_impl="xla", **D3)
    jmodel = JaxM4Depth(jcfg)
    jwin = lambda x: np.repeat(x[:, None], 2, 1)  # noqa: E731
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), rgb[:2].transpose(1, 0, 2, 3, 4), jwin(rot),
        jwin(trans), JCamera(jnp.asarray(f), jnp.asarray(f)))
    jstep = jax.jit(lambda p, s, x, r, tr, nt: jmodel.apply(
        p, s, x, r, tr, JCamera(jnp.asarray(f), jnp.asarray(f)), nt,
        method=JaxM4Depth.step))
    model = M4Depth(cfg, device="cpu", seed=1)
    load_jax_params(model, jax.device_get(params)["params"])
    step = compile_step(model)
    state = init_state(cfg, B, HW, HW, device="cpu")
    leaves = tree_flatten(state)[0]
    eager = init_state(cfg, B, HW, HW, device="cpu")
    jstate = jax_init_state(jcfg, B, HW, HW)
    cam = Camera(_t(f), _t(f))
    held = []
    for t in range(4):
        nt = np.array([t in (0, 2), t == 0])
        before = [x.clone() for x in leaves]
        state, depth = step(state, _t(rgb[t]), _t(rot), _t(trans), cam,
                            _t(nt))
        out_leaves = tree_flatten(state)[0]
        assert all(a is b for a, b in zip(out_leaves, leaves))
        assert any(not torch.equal(a, b) for a, b in zip(leaves, before))
        eager, want = model.step(eager, _t(rgb[t]), _t(rot), _t(trans), cam,
                                 _t(nt))
        assert torch.equal(depth, want), t
        assert all(torch.equal(a, b) for a, b in zip(
            out_leaves, tree_flatten(eager)[0])), t
        jstate, jdepth = jstep(params, jstate, rgb[t], rot, trans,
                               jnp.asarray(nt))
        np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth),
                                   rtol=1e-4, atol=1e-6, err_msg=f"frame {t}")
        held.append((depth, depth.clone()))
    for t, (depth, copy) in enumerate(held):
        assert torch.equal(depth, copy), f"frame {t}'s depth was overwritten"


def test_compiled_v1_step_equals_the_eager_chain():
    cfg = ModelConfig(**V1)
    model = M4DepthV1(cfg, device="cpu", seed=0)
    step = compile_step(model)
    rgb, rot, trans, f = frames(3, seed=4)
    state = init_state(cfg, B, HW, HW, device="cpu")
    eager = init_state(cfg, B, HW, HW, device="cpu")
    cam = Camera(_t(f), _t(f))
    for t in range(3):
        nt = torch.tensor([t == 0, t in (0, 1)])
        state, depth = step(state, _t(rgb[t]), _t(rot), _t(trans), cam, nt)
        eager, want = model.step(eager, _t(rgb[t]), _t(rot), _t(trans), cam,
                                 nt)
        assert torch.equal(depth, want), t
        assert all(torch.equal(a, b) for a, b in zip(
            tree_flatten(state)[0], tree_flatten(eager)[0])), t


def assert_params_close(got, want, applied_lr, what):
    """Weights of two runs whose gradients agree to rounding: Adam moves a
    weight by about lr times the sign of its gradient, so where a
    gradient is a rounding residue (the first conv's bias, which the
    domain norm centres) the two may step apart by up to twice the rates
    applied; every other weight agrees to float32 rounding."""
    got = torch.cat([p.detach().reshape(-1) for p in got])
    want = torch.cat([p.detach().reshape(-1) for p in want])
    diff = (got - want).abs()
    assert float(diff.max()) <= 2 * applied_lr + 1e-7, what
    close = diff <= 1e-8 + 1e-5 * want.abs()
    assert float(close.float().mean()) >= 0.99, what


def test_tensor_lr_optimizer_matches_eager_and_optax():
    """The update every train step runs (``Optimizer.apply_gradients``:
    the clip, then Adam at a device learning rate with device step counts)
    over four updates that cross the cosine schedule's end of warm-up
    (counts 198 to 201), against ``optax.chain(clip_by_global_norm,
    adam(schedule))`` on the same gradients (``tests/test_torch_train.py``'s
    learning rate and tolerances: the norm to rtol 1e-5, the weights to
    rtol 1e-5, atol 1e-8; optax takes 1 - 0.999^t in float32)."""
    import optax

    from m4depth_tpu.train.step import make_lr_schedule as jax_schedule
    from m4depth_tpu_torch.train.step import init_adam_state

    lr, clip, start = 1e-4, 0.5, 198
    tcfg = TrainConfig(learning_rate=lr, lr_schedule="cosine",
                       grad_clip_norm=clip, total_steps=1000)
    model = M4Depth(ModelConfig(**D2), device="cpu", seed=5)
    opt = make_optimizer(model, tcfg)
    opt.count = start
    init_adam_state(opt)
    jparams = {n: p.detach().numpy().copy()
               for n, p in model.named_parameters()}
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adam(jax_schedule(lr, "cosine", 1000)))
    jstate = jax.tree_util.tree_map(
        lambda x: x._replace(count=jnp.asarray(start, jnp.int32))
        if isinstance(x, optax.ScaleByScheduleState) else x,
        tx.init(jparams),
        is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
    device_lr = torch.zeros(())
    rng = np.random.RandomState(0)
    for i in range(4):
        grads = {n: (rng.randn(*p.shape) * 0.05).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = _t(grads[n]).clone()
        device_lr.fill_(opt.lr_schedule(opt.count))
        norm = opt.apply_gradients(device_lr)
        opt.count += 1
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)
        updates, jstate = jax.jit(tx.update)(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), rtol=1e-5,
                                       atol=1e-8,
                                       err_msg=f"{n} update {i}, optax")
    assert {float(s["step"]) for s in opt.adam.state.values()} == {4.0}


def assert_same_train_state(got: TrainState, want: TrainState, what):
    """Two train states bit for bit: the weights, the Adam state (its step
    counts included), the groups' rates and the schedule's count."""
    a, b = got.state_dict(), want.state_dict()
    assert a["count"] == b["count"], what
    assert a["model"].keys() == b["model"].keys(), what
    for n, t in b["model"].items():
        assert torch.equal(a["model"][n], t), f"{what}: {n}"
    assert a["adam"]["param_groups"] == b["adam"]["param_groups"], what
    assert a["adam"]["state"].keys() == b["adam"]["state"].keys(), what
    for i, state in b["adam"]["state"].items():
        assert a["adam"]["state"][i].keys() == state.keys(), what
        for k, t in state.items():
            assert torch.equal(a["adam"]["state"][i][k], t), \
                f"{what}: Adam state {i} {k}"


def test_compiled_train_step_matches_eager_and_jax():
    """Three whole steps from the cosine schedule's start (rates 0, lr/200
    and 2 lr/200: a rate frozen at the first step's would leave the
    weights where they are), clip 0.5: the compiled and the eager step run
    the same code on the CPU, so after each step their scalars, weights
    and Adam state are equal bit for bit; each step's scalars against the
    JAX jitted step's (``tests/test_torch_train.py``: loss and RMSE_log
    rtol 1e-5, the gradient norm rtol 1e-3), and the weights after each
    against its."""
    from m4depth_tpu_torch.interop import state_dict_from_jax

    lr, clip = 1e-3, 0.5
    batch = window()
    np_batch = {k: v.numpy() for k, v in batch.items()}
    jmodel = JaxM4Depth(JaxConfig(dscv_impl="gather", sncv_impl="xla", **D2))
    jstate = jax_train_state(jmodel, jax.random.PRNGKey(2), np_batch,
                             learning_rate=lr, lr_schedule="cosine",
                             grad_clip_norm=clip, total_steps=1000)
    jstep = jax.jit(jax_train_step(jmodel))
    tcfg = TrainConfig(learning_rate=lr, lr_schedule="cosine",
                       grad_clip_norm=clip, total_steps=1000)
    states, steps = {}, {}
    for name, make in (("compiled", compile_train_step),
                       ("eager", make_train_step)):
        model = M4Depth(ModelConfig(**D2), device="cpu")
        load_jax_params(model, jax.device_get(jstate.params)["params"])
        states[name] = TrainState(model, make_optimizer(model, tcfg))
        steps[name] = make(model, states[name].optimizer)
    model = states["compiled"].model
    start = [p.detach().clone() for p in model.parameters()]
    applied = 0.0
    for i in range(3):
        got = steps["compiled"](batch)
        want = steps["eager"](batch)
        jstate, jout = jstep(jstate, np_batch)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), f"{k} {i}"
        assert_same_train_state(states["compiled"], states["eager"],
                                f"step {i}")
        for k in ("loss", "RMSE_log"):
            np.testing.assert_allclose(float(got[k]), float(jout[k]),
                                       rtol=1e-5, err_msg=f"{k} {i}")
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(jout["grad_norm"]), rtol=1e-3)
        applied += tcfg.learning_rate * i / 200
        jparams = state_dict_from_jax(
            jax.device_get(jstate.params)["params"], model)
        named = dict(model.named_parameters())
        assert_params_close(named.values(), [jparams[n] for n in named],
                            applied, f"step {i} against JAX")
    moved = max(float((p.detach() - s).abs().max())
                for p, s in zip(model.parameters(), start))
    assert moved > 0.5 * applied


def test_checkpoints_cross_between_eager_and_compiled():
    """Two eager steps saved and loaded into a compiled step, and two
    compiled steps saved and loaded into an eager step: each resumed run's
    next two steps equal the run that went on without a save, bit for bit
    (both steps run one Adam update). A saved Adam state has the layout
    that ``torch.optim.Adam``'s own ``step`` writes, its step counts CPU
    float32 scalars, so a checkpoint written by it loads too."""
    tcfg = TrainConfig(learning_rate=1e-3, lr_schedule="cosine",
                       grad_clip_norm=0.5)
    batch = window(seed=5)
    ref = torch.nn.Parameter(torch.zeros(2))
    ref.grad = torch.ones(2)
    adam = torch.optim.Adam([ref])
    adam.step()
    torch_state = adam.state_dict()["state"][0]

    def run(first, then, n=2):
        model = M4Depth(ModelConfig(**D3), device="cpu", seed=4)
        opt = make_optimizer(model, tcfg)
        step = first(model, opt)
        for _ in range(n):
            step(batch)
        saved = TrainState(model, opt).state_dict()
        for state in saved["adam"]["state"].values():
            assert state.keys() == torch_state.keys()
            assert (state["step"].dtype, state["step"].device,
                    state["step"].dim()) == (torch_state["step"].dtype,
                                             torch_state["step"].device, 0)
        resumed = M4Depth(ModelConfig(**D3), device="cpu", seed=9)
        ropt = make_optimizer(resumed, tcfg)
        TrainState(resumed, ropt).load_state_dict(saved)
        assert ropt.count == n
        rstep = then(resumed, ropt)
        straight = [step(batch) for _ in range(n)]
        again = [rstep(batch) for _ in range(n)]
        for i, (a, b) in enumerate(zip(straight, again)):
            for k, v in a.items():
                assert torch.equal(b[k], v), f"{k} {i}"
        what = f"{first.__name__} to {then.__name__}"
        assert_same_train_state(TrainState(resumed, ropt),
                                TrainState(model, opt), what)
        return TrainState(resumed, ropt).state_dict()

    from_eager = run(make_train_step, compile_train_step)
    from_compiled = run(compile_train_step, make_train_step)
    for sd in (from_eager, from_compiled):
        steps = {float(s["step"]) for s in sd["adam"]["state"].values()}
        assert steps == {4.0} and sd["count"] == 4


@pytest.mark.parametrize("mesh", [None, "mesh"])
def test_fit_takes_the_ddp_step_with_a_mesh_and_the_compiled_one_without(
        tmp_path, monkeypatch, capsys, mesh):
    """``fit`` given a mesh (a launcher's run, world 1 included) builds the
    eager DDP step and says so; without one it builds the compiled step.
    ``data_parallel`` is stubbed to the model itself: no process group."""
    from m4depth_tpu_torch.data.synthetic import SyntheticGeometricDataset
    from m4depth_tpu_torch.train import loop

    built = []
    for name in ("make_train_step", "compile_train_step"):
        def counted(*a, _name=name, _fn=getattr(loop, name), **kw):
            built.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(loop, name, counted)
    monkeypatch.setattr(loop, "data_parallel", lambda model, mesh: model)
    ds = SyntheticGeometricDataset(n_batches=1, batch_size=1, T=2, h=HW,
                                   w=HW, seed=2)
    state = loop.fit(M4Depth(ModelConfig(**D2), device="cpu", seed=4), ds,
                     TrainConfig(ckpt_dir=str(tmp_path), log_dir=""),
                     total_steps=1, mesh=mesh)
    assert state.step == 1
    ddp = mesh is not None
    assert built == (["make_train_step"] if ddp else ["compile_train_step"])
    assert ("runs the eager DDP step" in capsys.readouterr().out) == ddp


def test_launch_recordings_close_by_identity():
    """Two nested recordings with equal (empty) counts: closing the inner
    one leaves the outer one recording, not the inner."""
    from m4depth_tpu_torch.ops import _build

    with _build.recording_launches() as outer:
        with _build.recording_launches() as inner:
            assert outer == inner and outer is not inner
        assert len(_build._recording) == 1
        assert _build._recording[0] is outer
    assert _build._recording == []

"""The port's harness (checkpoints, ``fit``, the evaluator, profiling and
logging) on the CPU, at small sizes (d3, 32x32), against the JAX package
where it has a counterpart that runs here. Inputs and weights are made
with numpy from a seed."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.eval import evaluate as jax_evaluate
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.geometry import reproject as jreproject
from m4depth_tpu.models import M4Depth as JaxM4Depth
from m4depth_tpu.train import checkpoints as jckpt
from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.data.pipeline import iter_frames
from m4depth_tpu_torch.data.synthetic import SyntheticGeometricDataset
from m4depth_tpu_torch.eval import evaluate
from m4depth_tpu_torch.geometry import Camera, reproject
from m4depth_tpu_torch.interop import load_jax_params, save_jax_checkpoint
from m4depth_tpu_torch.models import M4Depth
from m4depth_tpu_torch.train import create_train_state, make_train_step
from m4depth_tpu_torch.train.checkpoints import (
    BestCheckpointManager,
    TrainCheckpointManager,
    promote_best_to_train,
)
from m4depth_tpu_torch.train.loop import NaNStop, OutOfMemory, fit
from m4depth_tpu_torch.utils.logging import MetricLogger
from m4depth_tpu_torch.utils.profiling import TraceWindow, benchmark_fn

D3 = dict(num_levels=3, encoder_channels=(8, 12, 16),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")
HW = 32


def small_model(seed=0):
    return M4Depth(ModelConfig(**D3), device="cpu", seed=seed)


def state_after_steps(n, seed=0):
    """A train state after ``n`` Adam steps on synthetic windows."""
    model = small_model(seed)
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer)
    ds = SyntheticGeometricDataset(n, 1, 2, HW, HW, seed=seed)
    for batch in ds.batches(0):
        step({k: torch.from_numpy(v) for k, v in batch.items()})
    return state


def assert_states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["count"] == sb["count"]
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    assert sa["adam"]["param_groups"] == sb["adam"]["param_groups"]
    for i, st in sa["adam"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["adam"]["state"][i][k]), (i, k)


def perfs(abs_rel, a1):
    return {"abs_rel": abs_rel, "sq_rel": abs_rel, "rmse": abs_rel,
            "rmsel": abs_rel, "a1": a1, "a2": a1, "a3": a1}


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_round_trip_and_keep_last_5(tmp_path):
    state = state_after_steps(2)
    mgr = TrainCheckpointManager(str(tmp_path / "train"))
    assert mgr.resume_epoch == 0 and mgr.latest_epoch is None
    for epoch in range(7):
        mgr.save(epoch, state)
    assert mgr.epochs() == [2, 3, 4, 5, 6] and mgr.resume_epoch == 7
    fresh = create_train_state(small_model(seed=5))
    mgr.restore_latest(fresh)
    assert fresh.step == 2
    assert_states_equal(fresh, state)
    saved = torch.load(mgr.path(6), map_location="cpu", weights_only=True)
    assert saved["epoch"] == 6 and saved["count"] == 2
    # the saved tensors are copies: a later step does not change them
    w = "levels.0.refiner.prep.0.weight"
    before = saved["model"][w].clone()
    with torch.no_grad():
        state.model.levels[0].refiner.prep[0].weight.add_(1.0)
    mgr.save(7, state)
    assert torch.equal(torch.load(mgr.path(6), weights_only=True)["model"][w],
                       before)


def jax_tiny_state():
    import optax
    from flax.training.train_state import TrainState

    return TrainState.create(apply_fn=lambda *a: None,
                             params={"w": jnp.arange(4.0)},
                             tx=optax.sgd(0.1))


# (epoch, abs_rel, a1) updates, keep_top_n
VOTES = {
    "first_kept": ([(0, 0.5, 0.5)], 1),
    "majority_replaces": ([(0, 0.5, 0.5), (1, 0.4, 0.6)], 1),
    "worse_rejected": ([(0, 0.5, 0.5), (1, 0.6, 0.4)], 1),
    "mixed_needs_majority": ([(0, 0.5, 0.5), (1, 0.4, 0.4),
                              (2, 0.6, 0.6)], 1),
    "top_2": ([(0, 0.5, 0.5), (1, 0.6, 0.4), (2, 0.4, 0.6),
               (3, 0.3, 0.7)], 2),
    "ties_to_newest": ([(0, 0.5, 0.5), (1, 0.4, 0.4)], 2),
    "same_epoch_replaced": ([(0, 0.5, 0.5), (0, 0.4, 0.6)], 1),
}


@pytest.mark.parametrize("case", sorted(VOTES))
def test_best_manager_votes_as_jax(case, tmp_path):
    """The same updates through both managers: the same return values, the
    same ledger (as pandas reads either) and the same winner."""
    import pandas as pd

    updates, top_n = VOTES[case]
    ours = BestCheckpointManager(str(tmp_path / "t"), str(tmp_path / "b"),
                                 keep_top_n=top_n)
    ref = jckpt.BestCheckpointManager(str(tmp_path / "jt"),
                                      str(tmp_path / "jb"), keep_top_n=top_n)
    state, jstate = state_after_steps(1), jax_tiny_state()
    for epoch, abs_rel, a1 in updates:
        assert ours.update(epoch, perfs(abs_rel, a1), state) == \
            ref.update(epoch, perfs(abs_rel, a1), jstate), (epoch, abs_rel)
    got = pd.read_csv(ours.ledger_path)
    want = pd.read_csv(ref.ledger_path)
    pd.testing.assert_frame_equal(got[want.columns], want)
    assert ours.best_checkpoint_name() == ref.best_checkpoint_name()
    kept = sorted(n[:-3] for n in os.listdir(ours.best_dir)
                  if n.endswith(".pt"))
    assert kept == sorted(want["ckpt_name"])


@pytest.mark.parametrize("worse", [True, False])
def test_same_epoch_revalidation_warns_when_it_loses(worse, tmp_path,
                                                     capsys):
    best = BestCheckpointManager(str(tmp_path / "t"), str(tmp_path / "b"))
    state = state_after_steps(1)
    best.update(3, perfs(0.4, 0.6), state)
    capsys.readouterr()
    again = perfs(0.6, 0.4) if worse else perfs(0.3, 0.7)
    assert best.update(3, again, state)
    out = capsys.readouterr().out
    assert ("WARNING" in out and "lose the majority vote" in out) == worse
    with open(best.ledger_path) as f:
        rows = f.read().splitlines()
    assert len(rows) == 2 and rows[1].startswith(repr(again["abs_rel"]))


def test_promote_best_to_train(tmp_path):
    state = state_after_steps(2, seed=1)
    best = BestCheckpointManager(str(tmp_path / "t"), str(tmp_path / "best"))
    best.update(4, perfs(0.5, 0.5), state)
    target = create_train_state(small_model(seed=7))
    epoch = promote_best_to_train(str(tmp_path / "best"),
                                  str(tmp_path / "dest"), target)
    assert epoch == 4
    mgr = TrainCheckpointManager(str(tmp_path / "dest"))
    assert mgr.latest_epoch == 4 and mgr.resume_epoch == 5
    fresh = create_train_state(small_model(seed=8))
    assert_states_equal(mgr.restore_latest(fresh), state)
    assert promote_best_to_train(str(tmp_path / "none"),
                                 str(tmp_path / "d2"), target) is None


# -- fit ----------------------------------------------------------------------


def _tcfg(tmp_path, **kw):
    return TrainConfig(ckpt_dir=str(tmp_path), seed=3, **kw)


def test_fit_resume_is_bitwise(tmp_path):
    """Two epochs straight, and one epoch then a resumed second, give the
    same parameters, Adam state and count, bit for bit."""
    ds = SyntheticGeometricDataset(n_batches=2, batch_size=2, T=3, h=HW,
                                   w=HW, seed=2)
    straight = fit(small_model(), ds, _tcfg(tmp_path / "a"), total_steps=4,
                   resume=False)
    fit(small_model(), ds, _tcfg(tmp_path / "b"), total_steps=2)
    resumed = fit(small_model(), ds, _tcfg(tmp_path / "b"), total_steps=4)
    assert straight.step == resumed.step == 4
    assert_states_equal(straight, resumed)
    assert TrainCheckpointManager(str(tmp_path / "b" / "train")
                                  ).epochs() == [0, 1]


def test_fit_trains_from_a_device_stream(tmp_path):
    """A dataset whose batches are already tensors on the model's device
    (``DeviceSyntheticStream``) is used as it is; its epochs replay."""
    from m4depth_tpu_torch.data.synthetic import DeviceSyntheticStream

    ds = DeviceSyntheticStream(1, 2, HW, HW, steps_per_epoch=2, seed=3,
                               device="cpu")
    state = fit(small_model(), ds, _tcfg(tmp_path), total_steps=4)
    assert state.step == 4
    assert TrainCheckpointManager(str(tmp_path / "train")).epochs() == [0, 1]
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


class NaNAt:
    """A synthetic dataset whose batch number ``at`` (counted over the run)
    holds a NaN frame."""

    def __init__(self, at, fail=None):
        self.inner = SyntheticGeometricDataset(2, 1, 2, HW, HW, seed=1)
        self.batch_size = 1
        self.at, self.fail, self.n = at, fail, 0

    def __len__(self):
        return len(self.inner)

    def batches(self, epoch):
        for batch in self.inner.batches(epoch):
            if self.n == self.fail:
                raise torch.OutOfMemoryError("CUDA out of memory (test)")
            if self.n == self.at:
                batch = dict(batch, rgb=batch["rgb"] * np.nan)
            self.n += 1
            yield batch


@pytest.mark.parametrize("at,saved", [(0, []), (3, [0])])
def test_nan_loss_stops_without_saving_it(at, saved, tmp_path):
    with pytest.raises(NaNStop, match="non-finite loss"):
        fit(small_model(), NaNAt(at), _tcfg(tmp_path), total_steps=6)
    assert TrainCheckpointManager(str(tmp_path / "train")).epochs() == saved


def test_out_of_memory_surfaces_as_its_own_error(tmp_path):
    with pytest.raises(OutOfMemory, match="out of memory"):
        fit(small_model(), NaNAt(None, fail=1), _tcfg(tmp_path),
            total_steps=4)


def test_fit_logs_images_and_feeds_the_best_manager(tmp_path):
    calls = []

    def validation_fn(model):
        calls.append(model)
        return perfs(0.5 - 0.1 * len(calls), 0.5 + 0.1 * len(calls))

    ds = SyntheticGeometricDataset(2, 1, 2, HW, HW, seed=1)
    logs = tmp_path / "logs"
    fit(small_model(), ds, _tcfg(tmp_path, log_dir=str(logs),
                                 summary_interval=1),
        total_steps=4, validation_fn=validation_fn)
    assert len(calls) == 2
    records = [json.loads(line) for line in open(logs / "metrics.jsonl")]
    assert [r["step"] for r in records if "train/loss" in r] == [0, 1, 2, 3]
    assert all(r["train/loader_wait_ms"] >= 0 for r in records
               if "train/loss" in r)
    assert sum("epoch/step_ms_median" in r for r in records) == 2
    assert sum("val/abs_rel" in r for r in records) == 2
    best = BestCheckpointManager(str(tmp_path / "train"),
                                 str(tmp_path / "best"))
    assert best.best_checkpoint_name() == "ckpt-0001"


def test_train_step_images_come_from_the_same_forward():
    model = small_model()
    state = create_train_state(model)
    step = make_train_step(model, state.optimizer, with_images=True)
    batch = next(SyntheticGeometricDataset(1, 2, 3, HW, HW).batches(0))
    out = step({k: torch.from_numpy(v) for k, v in batch.items()})
    images = out["images"]
    assert set(images) == {"RGB_im", "camera_prev_t_reproj", "depth_gt",
                           "depth_lvl_0", "depth_lvl_1", "depth_lvl_2"}
    assert images["RGB_im"].shape == (HW, HW, 3)
    assert images["depth_lvl_2"].shape == (HW // 8, HW // 8, 1)
    for v in images.values():
        assert not v.requires_grad and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("rot", [[1.0, 0.01, -0.02, 0.005],
                                 [0.01, -0.02, 0.005]])
def test_reproject_matches_jax(rot):
    rng = np.random.RandomState(0)
    b = 2
    fmap = rng.rand(b, 20, 24, 3).astype(np.float32)
    depth = (2 + 20 * rng.rand(b, 20, 24, 1)).astype(np.float32)
    rot = np.tile(np.asarray(rot, np.float32), (b, 1))
    trans = np.tile(np.array([0.1, -0.05, 0.3], np.float32), (b, 1))
    f = np.full((b, 2), 12.0, np.float32)
    c = np.tile(np.array([[12.0, 10.0]], np.float32), (b, 1))
    jw, jflow = jreproject(fmap, depth, rot, trans, JCamera(f, c))
    tw, tflow = reproject(*(torch.from_numpy(x) for x in
                            (fmap, depth, rot, trans)),
                          Camera(torch.from_numpy(f), torch.from_numpy(c)))
    np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)


# -- the evaluator against JAX ---------------------------------------------


class Windows:
    """Evaluation windows of synthetic scenes, shaped as both packages'
    datasets yield them (batch 1)."""

    def __init__(self, db_seq_len, n=3, T=4):
        ds = SyntheticGeometricDataset(n, 1, T, HW, HW, seed=11)
        self.windows = list(ds.batches(0))
        self.db_seq_len = db_seq_len

    def batches(self, epoch=0):
        return iter(self.windows)

    def frames(self):
        return iter_frames(self.windows)


@pytest.fixture(scope="module")
def jax_and_port():
    jmodel = JaxM4Depth(JaxConfig(dscv_impl="gather", sncv_impl="xla", **D3))
    w = Windows(None).windows[0]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(4), w["rgb"][:, :2], w["rot"][:, :2],
        w["trans"][:, :2], JCamera(jnp.asarray(w["camera_f"]),
                                   jnp.asarray(w["camera_c"])))
    model = load_jax_params(small_model(), jax.device_get(params)["params"])
    return jmodel, params, model


@pytest.mark.parametrize("db_seq_len", [None, 4])
def test_evaluator_matches_jax(jax_and_port, db_seq_len):
    """Streaming (db_seq_len None) and windowed metrics on the same weights,
    float32, rtol 1e-4."""
    jmodel, params, model = jax_and_port
    ds = Windows(db_seq_len)
    want = jax_evaluate(jmodel, params, ds)
    got = evaluate(model, ds)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert evaluate(model, ds, max_steps=2) != got  # a bounded subset


def test_jax_weights_carried_as_a_checkpoint(jax_and_port, tmp_path):
    """``save_jax_checkpoint`` writes what the CLI loads: the same weights
    as ``load_jax_params``, and the JAX step as the schedule's count."""
    _, params, model = jax_and_port
    path = save_jax_checkpoint(jax.device_get(params), 37,
                               ModelConfig(**D3), str(tmp_path), epoch=2)
    mgr = TrainCheckpointManager(str(tmp_path / "train"))
    assert path == mgr.path(2) and mgr.latest_epoch == 2
    state = mgr.restore_latest(create_train_state(small_model(seed=9)))
    assert state.step == 37
    for k, v in model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


# -- profiling and logging --------------------------------------------------


def test_trace_window_and_benchmark(tmp_path):
    trace = TraceWindow(str(tmp_path / "trace"), 1, 3)
    for i in range(5):
        trace.on_step(i)
        torch.ones(8).sum()
    trace.close()
    assert len(os.listdir(tmp_path / "trace")) == 1
    stats = benchmark_fn(lambda: torch.ones(4).sum(), warmup=1, iters=4)
    assert set(stats) == {"mean_s", "p50_s", "mad_jitter_s", "stderr_s"}
    assert stats["p50_s"] > 0


def test_metric_logger_writes_jsonl_and_images(tmp_path):
    pytest.importorskip("cv2")
    logger = MetricLogger(str(tmp_path), use_tensorboard=False)
    logger.log_scalars(3, {"loss": 1.5}, prefix="train/")
    logger.log_images(3, {"rgb": np.zeros((4, 4, 3), np.float32),
                          "depth": np.ones((4, 4, 1), np.float32)})
    logger.close()
    record = json.loads(open(tmp_path / "metrics.jsonl").read())
    assert record["step"] == 3 and record["train/loss"] == 1.5
    assert sorted(os.listdir(tmp_path / "images")) == [
        "depth_00000003.png", "rgb_00000003.png"]

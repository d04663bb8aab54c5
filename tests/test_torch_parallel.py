"""The port's serving and mesh helpers (``m4depth_tpu_torch/parallel``)
against the JAX package's (``m4depth_tpu/parallel``), on the CPU.

Multi-stream serving over two CPU "devices" (two replicas of the model)
against the JAX ``jit_sharded_stream`` over two devices of the CPU mesh
and against each stream run alone; ``FreshFrameStream`` against
sequential steps; ``host_shard_indices`` and the host-sharded windows of a
record store against the JAX package's under the same (monkeypatched)
rank and world size. Weights come from the JAX package
(``interop.load_jax_params``), inputs from numpy with a seed, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m4depth_tpu.parallel.mesh as jmesh
from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.data import records as jrecords
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.models import M4Depth as JaxM4Depth
from m4depth_tpu.models import init_state as jax_init_state
from m4depth_tpu.parallel import jit_sharded_stream
from m4depth_tpu.parallel import make_mesh as jax_make_mesh
from m4depth_tpu.parallel import replicate_params as jax_replicate
from m4depth_tpu.parallel import shard_stream_inputs as jax_shard
from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.data import records
from m4depth_tpu_torch.data.synthetic import make_sequence
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.interop import load_jax_params
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.parallel import (
    FreshFrameStream,
    assert_collective_free,
    host_shard_indices,
    mesh as tmesh,
    replicate_params,
    shard_stream_inputs,
    sharded_stream,
)

D3 = dict(num_levels=3, encoder_channels=(8, 12, 16),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")
N, HW, FRAMES = 4, 32, 3
CPU2 = [torch.device("cpu")] * 2
# tests/test_serving.py's: another compilation of the same step, whose
# float32 rounding the recurrence carries over frames
TOL = dict(rtol=2e-3, atol=2e-3)
MEDIAN_REL = 1e-5


def assert_depth_close(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    rel = np.abs(got - want) / (np.abs(want) + 1e-6)
    assert np.median(rel) < MEDIAN_REL, f"{what}: median {np.median(rel)}"


@pytest.fixture(scope="module")
def streams():
    """A JAX model and the port with the same weights; 3 frames of 4
    streams with mostly lateral motion, one motion a stream."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(FRAMES, N, HW, HW, 3).astype(np.float32)
    rot = np.tile(np.array([1.0, 0.002, -0.001, 0.0], np.float32), (N, 1))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    trans = (np.array([0.3, 0.1, 0.02], np.float32)
             * (1 + 0.1 * np.arange(N, dtype=np.float32))[:, None])
    f = np.full((N, 2), HW / 2, np.float32)
    jcfg = JaxConfig(dscv_impl="gather", sncv_impl="xla", **D3)
    jmodel = JaxM4Depth(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(rgb[:2].swapaxes(0, 1)),
        jnp.tile(rot[:, None], (1, 2, 1)), jnp.tile(trans[:, None], (1, 2, 1)),
        JCamera(jnp.asarray(f), jnp.asarray(f)))
    model = M4Depth(ModelConfig(**D3), device="cpu", seed=1)
    load_jax_params(model, jax.device_get(params)["params"])
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, model=model,
                rgb=rgb, rot=rot, trans=trans, f=f)


def port_inputs(s, t, streams=slice(None)):
    f = torch.from_numpy(s["f"][streams])
    return (torch.from_numpy(s["rgb"][t, streams]),
            torch.from_numpy(s["rot"][streams]),
            torch.from_numpy(s["trans"][streams]), Camera(f, f.clone()),
            torch.full((len(s["f"][streams]),), t == 0))


def sequential(s, streams=slice(None)):
    """Each frame's depth from ``M4Depth.step`` on the streams given."""
    n = len(s["f"][streams])
    state = init_state(s["model"].cfg, n, HW, HW, device="cpu")
    out = []
    for t in range(FRAMES):
        state, depth = s["model"].step(state, *port_inputs(s, t, streams))
        out.append(depth.numpy())
    return out


def test_sharded_stream_matches_jax_and_single_streams(streams):
    """4 streams over two CPU replicas, frame by frame, against the JAX
    ``jit_sharded_stream`` over two CPU devices and against each stream
    stepped alone at b=1."""
    s = streams
    mesh = jax_make_mesh((2,), ("data",))
    jstep = jit_sharded_stream(s["jmodel"], mesh, donate_state=False)
    jparams = jax_replicate(s["params"], mesh)
    jstate = jax_shard(jax_init_state(s["jcfg"], N, HW, HW), mesh)
    step = sharded_stream(s["model"], CPU2)
    state = shard_stream_inputs(
        init_state(s["model"].cfg, N, HW, HW, device="cpu"), CPU2)
    alone = [sequential(s, slice(i, i + 1)) for i in range(N)]
    for t in range(FRAMES):
        f = jnp.asarray(s["f"])
        jin = jax_shard((s["rgb"][t], s["rot"], s["trans"], JCamera(f, f),
                         jnp.full((N,), t == 0)), mesh)
        jstate, jdepth = jstep(jparams, jstate, *jin)
        state, depth = step(state, *port_inputs(s, t))
        assert depth.shape == (N, HW, HW, 1)
        assert len(state) == 2 and state[0][0].f_maps.shape[0] == N // 2
        assert_depth_close(depth.numpy(), np.asarray(jdepth),
                           f"frame {t} against JAX")
        for i in range(N):
            assert_depth_close(depth[i:i + 1].numpy(), alone[i][t],
                               f"frame {t} stream {i} against it alone")


def test_replicas_and_shards():
    """One replica a device (the model itself on its own device); each
    shard a contiguous slice of the stream axis; N must divide."""
    model = M4Depth(ModelConfig(**D3), device="cpu", seed=0)
    reps = replicate_params(model, CPU2)
    assert reps[0] is model and reps[1] is not model
    assert all(torch.equal(a, b) for a, b in zip(
        reps[0].state_dict().values(), reps[1].state_dict().values()))
    x = torch.arange(24.0).reshape(4, 6)[:, ::2]  # strided columns
    halves = shard_stream_inputs({"x": x, "cam": Camera(x, x)}, CPU2)
    assert torch.equal(halves[1]["x"], x[2:])
    assert torch.equal(halves[0]["cam"].f, x[:2])
    y = torch.zeros(4, 3, 5)
    assert all(h.is_contiguous() for h in shard_stream_inputs(y, CPU2))
    step = sharded_stream(model, CPU2)
    state = shard_stream_inputs(init_state(model.cfg, 3, 16, 16,
                                           device="cpu"), CPU2[:1])
    f = torch.full((3, 2), 8.0)
    with pytest.raises(ValueError, match="split evenly"):
        step(state * 2, torch.rand(3, 16, 16, 3), torch.rand(3, 4),
             torch.rand(3, 3), Camera(f, f), torch.ones(3, dtype=torch.bool))


def test_fresh_frame_stream_is_sequential_one_frame_late(streams):
    """Distinct host arrays pushed each frame; the first push returns
    nothing, each later one the previous frame's depth, and a second flush
    returns nothing."""
    s = streams
    want = sequential(s)
    sess = FreshFrameStream(
        s["model"], init_state(s["model"].cfg, N, HW, HW, device="cpu"),
        device="cpu")
    outs = []
    for t in range(FRAMES):
        f = s["f"].copy()
        outs.append(sess.push(s["rgb"][t].copy(), s["rot"].copy(),
                              s["trans"].copy(), Camera(f, f.copy()),
                              np.full((N,), t == 0)))
    outs.append(sess.flush())
    assert outs[0] is None
    for t in range(FRAMES):
        np.testing.assert_array_equal(outs[t + 1].numpy(), want[t],
                                      err_msg=f"frame {t}")
    assert sess.flush() is None
    assert sess.state[0].f_maps.shape[0] == N


def test_serving_profile_is_collective_free(streams):
    from torch.profiler import ProfilerActivity, profile

    s = streams
    step = sharded_stream(s["model"], CPU2)
    state = shard_stream_inputs(
        init_state(s["model"].cfg, N, HW, HW, device="cpu"), CPU2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *port_inputs(s, 0))
    assert_collective_free(prof)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_host_shard_indices_match_jax(world, monkeypatch):
    monkeypatch.setattr(jmesh.jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jmesh.jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(tmesh, "rank_and_world",
                            lambda r=rank: (r, world))
        for n in range(13):
            got = host_shard_indices(n)
            assert got == jmesh.host_shard_indices(n), (n, rank)
            assert len(range(n)[got]) == n // world


def test_host_sharded_record_windows_match_jax(tmp_path, monkeypatch):
    """Each rank of 2 reads its own windows of a store (5 trajectories of 8
    frames, 10 windows of 4), the JAX dataset's, and the two ranks' shares
    are disjoint and equal in length."""
    writer = records.RecordStoreWriter(str(tmp_path / "s"), num_shards=2)
    for t in range(5):
        seq = make_sequence(np.random.RandomState(t), 8, 16, 16)
        writer.write_trajectory([
            {k: (v[i] if k in ("RGB_im", "depth", "rot", "trans") else v)
             for k, v in seq.items()} for i in range(8)])
    writer.close()
    kw = dict(usecase="train", db_seq_len=4, seq_len=2, batch_size=2,
              augment=False, num_workers=1, host_shard=True)
    monkeypatch.setattr(jmesh.jax, "process_count", lambda: 2)
    shares = []
    for rank in range(2):
        monkeypatch.setattr(jmesh.jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(tmesh, "rank_and_world", lambda r=rank: (r, 2))
        port = records.RecordSequenceDataset(str(tmp_path / "s"), **kw)
        ref = jrecords.RecordSequenceDataset(str(tmp_path / "s"), **kw)
        assert port.windows == ref.windows and len(port) == len(ref) == 2
        batch, jbatch = next(port.batches(0)), next(ref.batches(0))
        for k in jbatch:
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
        shares.append(set(port.windows))
    assert len(shares[0]) == len(shares[1]) == 5
    assert not shares[0] & shares[1]


def test_fresh_frame_bench_runs_every_variant(capsys):
    from m4depth_tpu_torch.tools import fresh_frame_bench

    fresh_frame_bench.main(["--device=cpu", "--size=32", "--levels=2",
                            "--frames=4"])
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split(":")[0] for ln in lines if "ms/frame" in ln]
    assert names == list(fresh_frame_bench.VARIANTS)


"""Data parallelism in the port over ``torch.distributed``, on the CPU: two
real processes (ranks) in one gloo group.

The ranks run, in one group: a DDP training step of d2 at 16x16 (local
b=2, global 4) against the JAX ``jit_data_parallel`` step and against one
port process on the global batch; the velodyne loss with ranks whose
valid pixels differ; the device augmentation of each rank's half; ``fit``
two epochs straight and one epoch plus a resumed one; a NaN in one rank's
batch. A second pair of ranks runs the CLI's train mode under the
launcher's environment variables. Weights come from the JAX package
(``interop.state_dict_from_jax``), inputs from numpy with a seed, float32.

Each rank is this file run as a script (``python test_torch_distributed.py
<scenario> <rank> <port> <dir>``); it writes what it saw to ``<dir>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL_B, HW, T = 2, 2, 16, 2
SEED_AUG, STEP_AUG = 7, 3
# the naive velodyne loss (each rank divides by its own count) must miss
# the global gradient by more than this many times the tolerance
NAIVE_GAP = 10
GRAD_RTOL = 1e-5    # of the largest gradient: sums in another order
LOSS_RTOL = 1e-5    # tests/test_torch_train.py's
NORM_RTOL = 1e-3    # tests/test_torch_train.py's, for the gradient norm
TIMEOUT_S = 300


def model_config(depth_type="map"):
    from m4depth_tpu_torch.config import ModelConfig

    return ModelConfig(num_levels=2, compute_dtype="float32",
                       cv_dtype="float32", depth_type=depth_type)


def global_batch(seed=0, holes=False):
    """A window of 4 sequences; with ``holes`` the first two keep one depth
    pixel in 20 and the last two one in 3, as velodyne depth with ranks
    whose counts of valid pixels differ."""
    r = np.random.RandomState(seed)
    b = WORLD * LOCAL_B
    rot = np.tile(np.array([1.0, 0.001, -0.002, 0.001], np.float32),
                  (b, T, 1))
    batch = {
        "rgb": r.rand(b, T, HW, HW, 3).astype(np.float32),
        "depth": (1.0 + 60 * r.rand(b, T, HW, HW, 1)).astype(np.float32),
        "rot": rot / np.linalg.norm(rot, axis=-1, keepdims=True),
        "trans": np.tile(np.array([0.3, 0.1, 0.02], np.float32), (b, T, 1)),
        "camera_f": np.full((b, 2), HW / 2, np.float32),
        "camera_c": np.full((b, 2), HW / 2, np.float32),
    }
    if holes:
        keep = np.concatenate([r.rand(LOCAL_B, T, HW, HW, 1) < 1 / 20,
                               r.rand(LOCAL_B, T, HW, HW, 1) < 1 / 3])
        batch["depth"] = batch["depth"] * keep
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def port_step(weights, batch, depth_type="map", ddp_mesh=None):
    """One port training step from ``weights``; returns its scalars, each
    parameter's gradient and the parameters after the update."""
    from m4depth_tpu_torch.config import TrainConfig
    from m4depth_tpu_torch.models import M4Depth
    from m4depth_tpu_torch.train import (
        data_parallel,
        make_optimizer,
        make_train_step,
    )

    model = M4Depth(model_config(depth_type), device="cpu")
    model.load_state_dict(weights)
    opt = make_optimizer(model, TrainConfig(learning_rate=1e-4))
    wrapped = data_parallel(model, ddp_mesh) if ddp_mesh else model
    out = make_train_step(wrapped, opt)(torch_batch(batch))
    return dict(scalars={k: v.item() for k, v in out.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


class ListDataset:
    """``fit``'s dataset protocol over a list of numpy batches."""

    batch_size = 1

    def __init__(self, batches):
        self.items = batches

    def __len__(self):
        return len(self.items)

    def batches(self, epoch=0):
        return iter(self.items)


# -- the ranks ------------------------------------------------------------


def rank_train(rank, tmp):
    """A DDP step (map and velodyne), the augmentation, fit, the NaN stop
    and the collective check, in one group of 2 ranks over gloo."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from m4depth_tpu_torch.config import TrainConfig
    from m4depth_tpu_torch.data.augment_device import make_batch_augment
    from m4depth_tpu_torch.data.records import RecordSequenceDataset
    from m4depth_tpu_torch.geometry import Camera
    from m4depth_tpu_torch.models import M4Depth, init_state
    from m4depth_tpu_torch.parallel import (
        assert_collective_free,
        data_axes,
        local_batch,
        make_hybrid_mesh,
        make_mesh,
        sharded_stream,
        shard_stream_inputs,
    )
    from m4depth_tpu_torch.train import checkpoints
    from m4depth_tpu_torch.train.loop import NaNStop, fit

    out = {}
    mesh = make_mesh()
    hybrid = make_hybrid_mesh()
    out["meshes"] = (tuple(mesh.shape), data_axes(mesh), tuple(hybrid.shape),
                     data_axes(hybrid))
    weights = torch.load(os.path.join(tmp, "weights.pt"), weights_only=True)
    for name, depth_type, holes in (("map", "map", False),
                                    ("velodyne", "velodyne", True)):
        res = port_step(weights, local_batch(global_batch(holes=holes), mesh),
                        depth_type, mesh)
        out[name] = res
    aug = make_batch_augment(dataset="midair")
    half = local_batch(torch_batch(global_batch(seed=1)), mesh)
    out["augmented"] = aug(half, SEED_AUG, STEP_AUG)

    # fit: 2 epochs straight, then 1 epoch and a resumed one
    saves = []
    save = checkpoints.TrainCheckpointManager.save

    def counted(self, epoch, state):
        saves.append(epoch)
        return save(self, epoch, state)

    checkpoints.TrainCheckpointManager.save = counted
    ds = RecordSequenceDataset(
        os.path.join(tmp, "store"), usecase="train", db_seq_len=4,
        seq_len=2, batch_size=1, augment=False, num_workers=1,
        host_shard=True)
    out["windows"] = ds.windows
    finals = {}
    for run, totals in (("straight", (4,)), ("resumed", (2, 4))):
        cfg = TrainConfig(ckpt_dir=os.path.join(tmp, run), log_dir="")
        for total in totals:
            state = fit(M4Depth(model_config(), device="cpu", seed=3), ds,
                        cfg, total_steps=total, mesh=mesh)
        finals[run] = {k: v.clone() for k, v in
                       state.model.state_dict().items()}
    out["fit"] = finals
    out["saves"] = saves

    # a NaN in rank 1's last batch of the epoch: rank 0's own loss stays
    # finite, so a rank-local tripwire would let rank 0 save the poisoned
    # weights and wait at the barrier for a rank 1 that has stopped
    batches = [{k: v[rank:rank + 1] for k, v in
                global_batch(seed=s).items()} for s in range(3)]
    if rank == 1:
        batches[2]["rgb"] = batches[2]["rgb"] * np.nan
    try:
        fit(M4Depth(model_config(), device="cpu", seed=3),
            ListDataset(batches),
            TrainConfig(ckpt_dir=os.path.join(tmp, "nan"), log_dir=""),
            total_steps=3, mesh=mesh)
        out["nan_stop"] = None
    except NaNStop as e:
        out["nan_stop"] = str(e)

    # the collective check: a DDP step's profile holds one, serving's none
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_step(weights, local_batch(global_batch(), mesh), "map", mesh)
    try:
        assert_collective_free(prof)
        out["ddp_collective_free"] = True
    except AssertionError:
        out["ddp_collective_free"] = False
    model = M4Depth(model_config(), device="cpu")
    devs = [torch.device("cpu")]
    step = sharded_stream(model, devs)
    frame = torch_batch(global_batch())
    f = frame["camera_f"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(shard_stream_inputs(init_state(model.cfg, 4, HW, HW,
                                            device="cpu"), devs),
             frame["rgb"][:, 0], frame["rot"][:, 0], frame["trans"][:, 0],
             Camera(f, f.clone()), torch.ones(4, dtype=torch.bool))
    assert_collective_free(prof)
    dist.barrier()
    return out


def rank_cli(rank, tmp):
    """The CLI's train mode under the launcher's environment variables;
    records the windows this rank's dataset holds."""
    from m4depth_tpu_torch.cli import main as cli

    seen = {}
    build = cli.build_dataset

    def recording(*a, **kw):
        ds = build(*a, **kw)
        seen["windows"] = list(ds.windows)
        return ds

    cli.build_dataset = recording
    rc = cli.main(cli_args(tmp))
    return dict(rc=rc, **seen)


def cli_args(tmp):
    return ["--mode=train", f"--ckpt_dir={os.path.join(tmp, 'ckpt')}",
            "--dataset=midair", f"--record_store={os.path.join(tmp, 'store')}",
            "--out_size", str(HW), str(HW), "--arch_depth=2",
            "--compute_dtype=float32", "--cv_dtype=float32",
            "--platform=cpu", f"--data_mesh={WORLD}", "--num_workers=1",
            "--db_seq_len=4", "--seq_len=2", "--batch_size=1",
            "--total_steps=2"]


def rank_main(argv):
    scenario, rank, port, tmp = argv[0], int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)  # two ranks beside the suite's other workers
    if scenario == "train":
        from m4depth_tpu_torch.parallel import distributed_init

        distributed_init(f"localhost:{port}", WORLD, rank, device="cpu")
        out = rank_train(rank, tmp)
    else:
        out = rank_cli(rank, tmp)
    torch.save(out, os.path.join(tmp, f"{scenario}{rank}.pt"))


# -- the tests ------------------------------------------------------------


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(scenario, tmp, launcher_env=False):
    """Both ranks of ``scenario``; each rank's results."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, LOCAL_WORLD_SIZE=str(WORLD))
    procs = []
    for rank in range(WORLD):
        renv = dict(env)
        if launcher_env:
            renv.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                        LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                        MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(rank),
             str(port), str(tmp)], env=renv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for proc in procs:
            errs.append(proc.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for proc in procs:
            proc.kill()
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {rank}:\n{errs[rank][-3000:]}"
    return [torch.load(os.path.join(tmp, f"{scenario}{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def write_store(path):
    """2 trajectories of 8 frames at 16x16: 4 windows of 4 frames."""
    from m4depth_tpu_torch.data.records import RecordStoreWriter
    from m4depth_tpu_torch.data.synthetic import make_sequence

    writer = RecordStoreWriter(path, num_shards=2)
    for t in range(2):
        seq = make_sequence(np.random.RandomState(t), 8, HW, HW)
        writer.write_trajectory([
            {k: (v[i] if k in ("RGB_im", "depth", "rot", "trans") else v)
             for k, v in seq.items()} for i in range(8)])
    writer.close()


@pytest.fixture(scope="module")
def jax_weights():
    """A JAX d2 model's parameters, and the same weights as the port's
    state dict."""
    import jax
    import jax.numpy as jnp

    from m4depth_tpu.config import ModelConfig as JaxConfig
    from m4depth_tpu.geometry import Camera as JCamera
    from m4depth_tpu.models import M4Depth as JaxM4Depth
    from m4depth_tpu_torch.interop import state_dict_from_jax
    from m4depth_tpu_torch.models import M4Depth

    gb = global_batch()
    jmodel = JaxM4Depth(JaxConfig(num_levels=2, compute_dtype="float32",
                                  cv_dtype="float32", dscv_impl="gather",
                                  sncv_impl="xla"))
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), gb["rgb"][:1], gb["rot"][:1],
        gb["trans"][:1], JCamera(jnp.asarray(gb["camera_f"][:1]),
                                 jnp.asarray(gb["camera_c"][:1])))
    weights = state_dict_from_jax(jax.device_get(params)["params"],
                                  M4Depth(model_config(), device="cpu"))
    return jmodel, params, weights


@pytest.fixture(scope="module")
def ranks(jax_weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    torch.save(jax_weights[2], tmp / "weights.pt")
    write_store(str(tmp / "store"))
    return tmp, run_ranks("train", tmp)


def test_meshes(ranks):
    _, outs = ranks
    for out in outs:
        assert out["meshes"] == ((2,), ("data",), (1, 2), ("dcn", "ici"))


def assert_grads_close(got, want, what):
    top = max(g.abs().max().item() for g in want.values())
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * top,
                                   msg=lambda m: f"{what} {n}: {m}")
    return top


def jax_data_parallel_step(params, gb, depth_type="map"):
    """The scalars of the JAX ``jit_data_parallel`` training step of a d2
    model with ``params`` over two CPU devices on the global batch."""
    import jax

    from m4depth_tpu.config import ModelConfig as JaxConfig
    from m4depth_tpu.models import M4Depth as JaxM4Depth
    from m4depth_tpu.parallel import make_mesh, shard_batch_pytree
    from m4depth_tpu.train.step import (
        create_train_state,
        jit_data_parallel,
        make_train_step,
    )

    jmodel = JaxM4Depth(JaxConfig(num_levels=2, compute_dtype="float32",
                                  cv_dtype="float32", dscv_impl="gather",
                                  sncv_impl="xla", depth_type=depth_type))
    state = create_train_state(jmodel, jax.random.PRNGKey(0),
                               {k: v[:1] for k, v in gb.items()})
    state = state.replace(params=params)
    mesh = make_mesh((2,), ("data",))
    step = jit_data_parallel(make_train_step(jmodel), mesh,
                             donate_state=False)
    _, ref = step(state, shard_batch_pytree(gb, mesh))
    return {k: float(v) for k, v in ref.items()}


def assert_scalars_match_jax(outs, name, ref):
    """Each rank's loss and grad_norm of its ``name`` step against the JAX
    data-parallel step's."""
    for rank, out in enumerate(outs):
        sc = out[name]["scalars"]
        np.testing.assert_allclose(sc["loss"], ref["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(sc["grad_norm"], ref["grad_norm"],
                                   rtol=NORM_RTOL, err_msg=f"rank {rank}")


def test_ddp_step_matches_jax_and_one_process(ranks, jax_weights):
    """The ranks' loss and grad_norm against the JAX data-parallel step
    over two CPU devices on the global batch; the gradients against one
    port process on it; both ranks' parameters equal after the step."""
    _, outs = ranks
    _, params, weights = jax_weights
    gb = global_batch()
    assert_scalars_match_jax(outs, "map", jax_data_parallel_step(params, gb))
    one = port_step(weights, gb)
    for rank, out in enumerate(outs):
        sc = out["map"]["scalars"]
        assert_grads_close(out["map"]["grads"], one["grads"],
                           f"rank {rank}")
        np.testing.assert_allclose(sc["loss"], one["scalars"]["loss"],
                                   rtol=LOSS_RTOL)
    for n, p in outs[0]["map"]["params"].items():
        assert torch.equal(p, outs[1]["map"]["params"][n]), n


def test_velodyne_loss_is_the_global_batch(ranks, jax_weights):
    """Ranks with 1 valid pixel in 20 and 1 in 3: the DDP gradient is the
    global batch's, and a per-rank normalisation would miss it by more
    than NAIVE_GAP times the tolerance."""
    _, outs = ranks
    weights = jax_weights[2]
    gb = global_batch(holes=True)
    one = port_step(weights, gb, "velodyne")
    halves = [port_step(weights, {k: v[r * LOCAL_B:(r + 1) * LOCAL_B]
                                  for k, v in gb.items()}, "velodyne")
              for r in range(WORLD)]
    naive = {n: (halves[0]["grads"][n] + halves[1]["grads"][n]) / 2
             for n in one["grads"]}
    for rank, out in enumerate(outs):
        top = assert_grads_close(out["velodyne"]["grads"], one["grads"],
                                 f"rank {rank}")
        np.testing.assert_allclose(out["velodyne"]["scalars"]["loss"],
                                   one["scalars"]["loss"], rtol=LOSS_RTOL)
    gap = max((naive[n] - g).abs().max().item()
              for n, g in one["grads"].items())
    assert gap > NAIVE_GAP * GRAD_RTOL * top, gap / (GRAD_RTOL * top)


def test_velodyne_ddp_step_matches_jax(ranks, jax_weights):
    """The velodyne ranks' loss and grad_norm, on the global batch with
    holes, against the JAX data-parallel step of a velodyne model."""
    params = jax_weights[1]
    assert_scalars_match_jax(ranks[1], "velodyne", jax_data_parallel_step(
        params, global_batch(holes=True), "velodyne"))


def test_augmentation_keys_sequences_by_global_index(ranks):
    """The two ranks' augmented halves, together, are the one-process
    augmentation of the global batch at the same (seed, step)."""
    from m4depth_tpu_torch.data.augment_device import make_batch_augment

    _, outs = ranks
    whole = make_batch_augment(dataset="midair")(
        torch_batch(global_batch(seed=1)), SEED_AUG, STEP_AUG)
    for k, v in whole.items():
        got = torch.cat([out["augmented"][k] for out in outs])
        assert torch.equal(got, v), k


def test_fit_on_two_ranks_straight_and_resumed(ranks):
    """Both runs end with the same weights on both ranks, the resumed one
    equal to the straight one; rank 0 alone saved, one checkpoint
    directory each; the ranks read disjoint windows."""
    tmp, outs = ranks
    assert not set(outs[0]["windows"]) & set(outs[1]["windows"])
    assert len(outs[0]["windows"]) == len(outs[1]["windows"]) == 2
    for run in ("straight", "resumed"):
        for k, v in outs[0]["fit"][run].items():
            assert torch.equal(v, outs[1]["fit"][run][k]), (run, k)
            assert torch.equal(v, outs[0]["fit"]["straight"][k]), (run, k)
        assert os.listdir(tmp / run) == ["train"]
        assert sorted(os.listdir(tmp / run / "train")) == ["0.pt", "1.pt"]
    assert outs[0]["saves"] == [0, 1, 0, 1] and outs[1]["saves"] == []


def test_nan_on_one_rank_stops_both(ranks):
    """Both ranks stop at the same step, and nothing is saved."""
    tmp, outs = ranks
    assert outs[0]["nan_stop"] == outs[1]["nan_stop"]
    assert "non-finite loss at step 2" in outs[0]["nan_stop"]
    assert os.listdir(tmp / "nan" / "train") == []


def test_collective_check_sees_the_ddp_all_reduce(ranks):
    for out in ranks[1]:
        assert out["ddp_collective_free"] is False


def test_cli_trains_data_parallel_under_the_launcher(tmp_path):
    write_store(str(tmp_path / "store"))
    outs = run_ranks("cli", tmp_path, launcher_env=True)
    assert [o["rc"] for o in outs] == [0, 0]
    assert os.listdir(tmp_path / "ckpt" / "train") == ["0.pt"]
    assert not set(outs[0]["windows"]) & set(outs[1]["windows"])
    assert len(outs[0]["windows"]) == len(outs[1]["windows"]) == 2


@pytest.mark.parametrize("flags,match", [
    (["--data_mesh=3"], "--data_mesh=3"),
    (["--mode=eval"], "runs on one device"),
])
def test_cli_refuses_a_mesh_that_is_not_the_world(flags, match, tmp_path,
                                                  monkeypatch):
    from m4depth_tpu_torch.cli import main as cli

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=match):
        cli.main(cli_args(str(tmp_path)) + flags)


if __name__ == "__main__":
    rank_main(sys.argv[1:])

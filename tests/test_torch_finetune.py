"""The port's KITTI finetune script (``m4depth_tpu_torch.cli.finetune_kitti``)
and ``build_dataset``'s overrides, on the CPU: ``JointSampler`` against the
JAX one, and ``main`` for two steps over tiny synthetic record stores."""

import argparse
import os

import numpy as np
import pytest
import torch

from m4depth_tpu.cli.finetune_kitti import JointSampler as JaxJointSampler
from m4depth_tpu_torch.cli import finetune_kitti
from m4depth_tpu_torch.cli.main import build_dataset
from m4depth_tpu_torch.cli.options import build_parser
from m4depth_tpu_torch.data.records import RecordStoreWriter
from m4depth_tpu_torch.data.synthetic import make_sequence
from m4depth_tpu_torch.train.checkpoints import TrainCheckpointManager


class Tagged:
    """A dataset of ``n`` batches that name their stream, epoch and index."""

    batch_size = 2

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __len__(self):
        return self.n

    def batches(self, epoch=0):
        for i in range(self.n):
            yield (self.name, epoch, i)


@pytest.mark.parametrize("seed,sizes", [(42, (3, 1)), (7, (4, 2)),
                                        (0, (2, 1))])
def test_joint_sampler_matches_jax(seed, sizes):
    """The same draws of stream a or b, the same restarts (at epoch
    (epoch+1) * RESTART_STRIDE + n) and the same length, for three epochs;
    stream b is short enough to run dry and restart."""
    got = []
    for epoch in (0, 1, 5):
        port = finetune_kitti.JointSampler(Tagged("a", sizes[0]),
                                           Tagged("b", sizes[1]), seed=seed)
        ref = JaxJointSampler(Tagged("a", sizes[0]), Tagged("b", sizes[1]),
                              seed=seed)
        draws = list(port.batches(epoch))
        assert draws == list(ref.batches(epoch))
        assert len(port) == len(ref) == len(draws) == 2 * sizes[0]
        assert port.batch_size == 2
        got += draws
    assert any(e >= port.RESTART_STRIDE for _, e, _ in got)


def write_store(path, n_traj, frames, h, w, sparse=False, seed=0):
    """A record store of ``n_traj`` synthetic trajectories; ``sparse`` keeps
    about one depth value in five, as KITTI's velodyne depth."""
    rng = np.random.RandomState(seed)
    writer = RecordStoreWriter(path, num_shards=2)
    for t in range(n_traj):
        seq = make_sequence(rng, frames, h, w)
        depth = seq["depth"]
        if sparse:
            depth = depth * (rng.rand(*depth.shape) < 0.2)
        writer.write_trajectory([dict(
            RGB_im=seq["RGB_im"][i], depth=depth[i], rot=seq["rot"][i],
            trans=seq["trans"][i], camera_f=seq["camera_f"],
            camera_c=seq["camera_c"], new_traj=np.bool_(i == 0))
            for i in range(frames)], name=f"traj_{t}")
    writer.close()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """KITTI-shaped frames at 16x48 with sparse depth, and Mid-Air frames
    at 48x48, the crop's square intermediate for KITTI's size."""
    root = tmp_path_factory.mktemp("finetune_stores")
    write_store(str(root / "kitti-raw"), 1, 4, 16, 48, sparse=True, seed=1)
    write_store(str(root / "midair"), 1, 8, 48, 48, seed=2)
    return str(root)


SMALL = ["--arch_depth=2", "--num_workers=2", "--compute_dtype=float32",
         "--cv_dtype=float32", "--platform=cpu", "--batch_size=1"]


def test_joint_datasets_from_the_stores(stores):
    """KITTI windows of 4 at the store's size; Mid-Air windows cropped from
    48x48 to KITTI's 16x48, with the principal point moved by the crop."""
    cmd = build_parser(argparse.ArgumentParser()).parse_args(SMALL)
    cmd.record_stores = stores
    kitti, midair = finetune_kitti.build_joint_datasets(cmd, {})
    assert kitti.adapter.out_size == (16, 48) and kitti.depth_type == \
        "velodyne"
    assert midair.adapter.crop and midair.adapter.out_size == (16, 48)
    for ds in (kitti, midair):
        batch = next(iter(ds.batches(0)))
        assert batch["rgb"].shape == (1, 4, 16, 48, 3)
        assert batch["depth"].shape == (1, 4, 16, 48, 1)
    holes = (next(iter(kitti.batches(0)))["depth"] == 0).mean()
    assert holes > 0.5, holes


def test_finetune_main_trains_two_steps(stores, tmp_path, capsys):
    """One epoch of the joint sampler (twice KITTI's one batch) from
    scratch: a checkpoint with finite weights at update 2; a second run
    resumes and adds one more epoch."""
    ckpt = str(tmp_path / "ckpt")
    argv = [f"--record_stores={stores}", f"--ckpt_dir={ckpt}",
            "--finetune_steps=0", "--summary_interval=1", *SMALL]
    assert finetune_kitti.main(argv) == 0
    mgr = TrainCheckpointManager(os.path.join(ckpt, "train"))
    assert mgr.latest_epoch == 0
    sd = torch.load(mgr.path(0), map_location="cpu", weights_only=True)
    assert sd["count"] == 2
    assert all(bool(torch.isfinite(v).all()) for v in sd["model"].values())
    assert finetune_kitti.main(argv) == 0
    sd = torch.load(mgr.path(1), map_location="cpu", weights_only=True)
    assert sd["count"] == 4
    assert "Resuming from epoch 1" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--no_augmentation", "--augment_device"])
def test_finetune_refuses_to_train_uncropped(stores, tmp_path, flag):
    with pytest.raises(ValueError, match="crops the Mid-Air frames"):
        finetune_kitti.main([f"--record_stores={stores}",
                             f"--ckpt_dir={tmp_path}", flag, *SMALL])


def test_build_dataset_overrides(stores, tmp_path):
    """``records_path`` replaces ``--records_path`` and ``db_seq_len``
    replaces ``--db_seq_len`` unless it is "unset"; None asks for no
    windows."""
    recs = tmp_path / "recs" / "traj_0"
    os.makedirs(recs)
    rows = ["id\tcamera_l\tdisp\tqw\tqx\tqy\tqz\ttx\tty\ttz"] + [
        f"{i}\tc_{i}.jpg\td_{i}.png\t1\t0\t0\t0\t0\t0\t0.4"
        for i in range(8)]
    (recs / "traj.csv").write_text("\n".join(rows))
    cmd = build_parser(argparse.ArgumentParser()).parse_args(
        ["--dataset=midair", "--records_path=/nonexistent", "--db_seq_len=4",
         *SMALL])
    recs = str(tmp_path / "recs")
    ds = build_dataset(cmd, "eval", {}, 1, records_path=recs)
    assert ds.db_seq_len == 4 and len(ds.windows) == 2
    ds = build_dataset(cmd, "eval", {}, 1,
                       records_path=str(tmp_path / "recs"), db_seq_len=None)
    assert ds.db_seq_len is None and len(ds.windows) == 8
    ds = build_dataset(cmd, "train", {}, 1,
                       records_path=str(tmp_path / "recs"), db_seq_len=8)
    assert ds.db_seq_len == 8 and len(ds.windows) == 1
    cmd.record_store = os.path.join(stores, "midair")
    ds = build_dataset(cmd, "train", {}, 1, db_seq_len=8)
    assert ds.db_seq_len == 8 and len(ds.windows) == 1

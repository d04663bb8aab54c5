"""KITTI finetuning: joint 50/50 KITTI and Mid-Air sampling with the
velodyne loss. Counterpart of ``m4depth_tpu/cli/finetune_kitti.py``: KITTI
windows (db_seq_len 4) and Mid-Air windows (db_seq_len 8) cropped to
KITTI's output size, sampled 50/50, depth_type "velodyne", resumed from
``--ckpt_dir`` (``--mode=promote`` puts the Mid-Air weights there) for
``--finetune_steps`` more steps.

Runs on the CUDA device unless ``--platform=cpu`` is given, and data
parallel under ``torch.distributed.run`` as the CLI's train mode. From CSV
manifests, as the JAX script (``--records_path`` holds
``kitti-raw-filtered/train_data`` and ``midair/train_data``):
  python -m m4depth_tpu_torch.cli.finetune_kitti --records_path=data \\
      --ckpt_dir=ckpt/kitti-finetune
or, on a host without an image decoder, from two record stores under one
root (``--mode=convert`` writes them: KITTI at its output size, Mid-Air at
the crop's square intermediate, KITTI's long edge):
  python -m m4depth_tpu_torch.cli.finetune_kitti --record_stores=stores \\
      --ckpt_dir=ckpt/kitti-finetune
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator

import numpy as np


class JointSampler:
    """50/50 stochastic mix of two batch streams; its length is twice the
    first stream's. An exhausted stream restarts at once, at a shuffle
    epoch outside the real epochs' range."""

    # (epoch + 1) * RESTART_STRIDE + restarts never equals a real epoch
    # index, so a restarted stream draws windows no real epoch draws
    RESTART_STRIDE = 1_000_003

    def __init__(self, ds_a, ds_b, seed: int = 42):
        self.ds_a = ds_a
        self.ds_b = ds_b
        self.seed = seed

    def __len__(self) -> int:
        return 2 * len(self.ds_a)

    @property
    def batch_size(self):
        return self.ds_a.batch_size

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed + epoch)
        it_a = self.ds_a.batches(epoch)
        it_b = self.ds_b.batches(epoch)
        restarts = 0
        n = 0
        while n < len(self):
            use_a = rng.uniform() < 0.5
            it = it_a if use_a else it_b
            try:
                yield next(it)
            except StopIteration:
                restart_epoch = (epoch + 1) * self.RESTART_STRIDE + restarts
                restarts += 1
                if use_a:
                    it_a = self.ds_a.batches(restart_epoch)
                    yield next(it_a)
                else:
                    it_b = self.ds_b.batches(restart_epoch)
                    yield next(it_b)
            n += 1


def build_joint_datasets(cmd, db_paths: dict, host_shard: bool = False):
    """The KITTI and the cropped Mid-Air training sets, from
    ``--record_stores`` if given, else from the CSV manifests under
    ``--records_path``; ``host_shard``: this rank's share of each."""
    from m4depth_tpu_torch.data import SequenceDataset, get_adapter

    common = dict(usecase="finetune", seq_len=4, batch_size=cmd.batch_size,
                  augment=True, seed=cmd.seed, num_workers=cmd.num_workers,
                  host_shard=host_shard)
    if cmd.record_stores:
        from m4depth_tpu_torch.data.records import RecordSequenceDataset

        kitti_adapter = get_adapter("kitti-raw")
        kitti_adapter.set_output_size(None)
        kitti = RecordSequenceDataset(
            os.path.join(cmd.record_stores, "kitti-raw"),
            adapter=kitti_adapter, db_seq_len=4, **common)
        midair_adapter = get_adapter("midair")
        midair_adapter.set_output_size(kitti_adapter.out_size, crop=True)
        midair = RecordSequenceDataset(
            os.path.join(cmd.record_stores, "midair"),
            adapter=midair_adapter, db_seq_len=8, **common)
        return kitti, midair
    kitti = SequenceDataset(
        get_adapter("kitti-raw"), db_paths.get("kitti-raw", ""),
        os.path.join(cmd.records_path, "kitti-raw-filtered", "train_data"),
        db_seq_len=4, **common)
    midair = SequenceDataset(
        get_adapter("midair"), db_paths.get("midair", ""),
        os.path.join(cmd.records_path, "midair", "train_data"),
        db_seq_len=8, out_size=kitti.adapter.out_size, crop=True, **common)
    return kitti, midair


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    from m4depth_tpu_torch.cli.main import (
        SubprocessValidator,
        build_model,
        launcher_mesh,
        make_validation_fn,
    )
    from m4depth_tpu_torch.cli.options import (
        build_parser,
        check_port_options,
        dataset_locations,
        device_from_args,
        finetune_total_steps,
        model_config_from_args,
        train_config_from_args,
    )

    build_parser(parser)
    parser.add_argument(
        "--record_stores", default=None, type=str,
        help="A directory holding two record stores, kitti-raw/ (at KITTI's "
             "output size) and midair/ (at the crop's square intermediate): "
             "the port's route to finetune on a host without an image "
             "decoder. Without it the CSV manifests under --records_path "
             "are read, as the JAX script reads them")
    cmd, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"WARNING: ignoring unrecognized arguments: {unknown}",
              flush=True)
    check_port_options(cmd, parser)
    if cmd.no_augmentation or cmd.augment_device:
        # the Mid-Air crop to KITTI's size runs in the host augmentation:
        # without it the frames would train uncropped
        raise ValueError(
            "finetune_kitti crops the Mid-Air frames in the host "
            "augmentation: drop --no_augmentation and --augment_device")
    db_paths = dataset_locations(cmd)
    device = device_from_args(cmd)

    from m4depth_tpu_torch.train.loop import fit

    mesh = launcher_mesh(device)
    kitti, midair = build_joint_datasets(cmd, db_paths,
                                         host_shard=mesh is not None)
    joint = JointSampler(kitti, midair, seed=cmd.seed)

    cfg = model_config_from_args(cmd, depth_type="velodyne")
    model = build_model(cmd, cfg, device)
    tcfg = train_config_from_args(cmd)
    total = finetune_total_steps(cmd.ckpt_dir, tcfg.finetune_steps,
                                 len(joint))

    validation_fn = None
    if tcfg.enable_validation:
        if cmd.validation_mode == "subprocess":
            validation_fn = SubprocessValidator(cmd)
        else:
            validation_fn = make_validation_fn(cmd, model, db_paths)

    try:
        fit(model, joint, tcfg, total_steps=total, resume=True,
            validation_fn=validation_fn, mesh=mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Entry point: train / finetune / eval / validation / predict / convert /
promote. Counterpart of ``m4depth_tpu/cli/main.py``: the same modes, flags,
checkpoint directories (ckpt_dir/train for the rolling training state,
ckpt_dir/best for validated backups) and output files
(perfs-<dataset>.txt, validation-perfs.txt).

Runs on the CUDA device unless ``--platform=cpu`` is given. Usage:
  python -m m4depth_tpu_torch.cli.main --mode=train --dataset=midair \\
      --records_path=data/midair/train_data --db_seq_len=8 --seq_len=4

Train and finetune modes train data parallel under a launcher that sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, one rank a card (``--batch_size`` is each rank's):
  python -m torch.distributed.run --nproc_per_node=4 \\
      -m m4depth_tpu_torch.cli.main --mode=train ...
The other modes run on one device and raise at a world size above 1.

A torch module and its Adam state are built without a sample batch, so the
JAX module's ``init_sample`` has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from m4depth_tpu_torch.cli.options import REPO_ROOT
from m4depth_tpu_torch.metrics import METRIC_NAMES

# what a launcher (torch.distributed.run) tells each rank
LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "GROUP_RANK", "GROUP_WORLD_SIZE", "ROLE_RANK",
                 "ROLE_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "TORCHELASTIC_USE_AGENT_STORE")


def build_model(cmd, cfg, device):
    """M4Depth, or M4DepthV1 for ``--model=m4depth-v1`` (fed the data
    path's quaternions), with weights from ``--seed``."""
    from m4depth_tpu_torch.models import M4Depth, M4DepthV1

    if cmd.model == "m4depth-v1":
        return M4DepthV1(cfg, device=device, seed=cmd.seed)
    return M4Depth(cfg, device=device, seed=cmd.seed)


def build_dataset(cmd, usecase: str, db_paths: dict, batch_size: int,
                  records_path=None, db_seq_len="unset",
                  host_shard: bool = False):
    """The dataset of ``cmd.dataset`` for ``usecase``: from
    ``--record_store`` if given, else from the CSV manifests under
    ``records_path`` (default ``--records_path``). ``db_seq_len`` overrides
    ``--db_seq_len`` unless it is ``"unset"`` (None is a value: no
    windows). ``host_shard``: this rank's share of the windows only."""
    from m4depth_tpu_torch.data import SequenceDataset, get_adapter

    adapter = get_adapter(cmd.dataset)
    seq = cmd.db_seq_len if db_seq_len == "unset" else db_seq_len
    # Mid-Air finetune decodes a SQUARE intermediate and random-crops it to
    # the (KITTI) out_size with the principal point shifted; the crop runs
    # in the host augmentation or on the device (--augment_device)
    crop = usecase == "finetune" and cmd.dataset == "midair"
    if crop and cmd.no_augmentation and not cmd.augment_device:
        raise ValueError(
            "Mid-Air finetuning crops the square intermediate frames in the "
            "augmentation, which --no_augmentation turns off: the frames "
            "would train uncropped. Drop --no_augmentation, or add "
            "--augment_device to crop on the device")
    if cmd.record_store and cmd.mode != "convert":
        from m4depth_tpu_torch.data.records import RecordSequenceDataset

        adapter.set_output_size(cmd.out_size, crop=crop)
        return RecordSequenceDataset(
            cmd.record_store,
            adapter=adapter,
            usecase=usecase,
            db_seq_len=seq,
            seq_len=cmd.seq_len,
            batch_size=batch_size,
            augment=not cmd.no_augmentation,
            seed=cmd.seed,
            num_workers=cmd.num_workers,
            host_shard=host_shard,
        )
    return SequenceDataset(
        adapter,
        db_path=db_paths.get(cmd.dataset, ""),
        records_path=records_path or cmd.records_path,
        usecase=usecase,
        db_seq_len=seq,
        seq_len=cmd.seq_len,
        batch_size=batch_size,
        augment=not cmd.no_augmentation,
        out_size=cmd.out_size,
        crop=crop,
        seed=cmd.seed,
        num_workers=cmd.num_workers,
        host_shard=host_shard,
    )


def launcher_mesh(device):
    """Under a launcher (``WORLD_SIZE`` set): join its process group and
    return a data mesh over every rank; ``None`` without one."""
    if "WORLD_SIZE" not in os.environ:
        return None
    from m4depth_tpu_torch.parallel import distributed_init, make_mesh

    distributed_init(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
        device=device)
    return make_mesh()


def kitti_val_records(cmd) -> str:
    """The KITTI validation manifests, beside the dataset-location file."""
    return os.path.join(os.path.dirname(os.path.abspath(cmd.db_path_config)),
                        "data", "kitti-raw-filtered", "val_data")


class SubprocessValidator:
    """Background-process validation: spawn ``--mode=validation`` after
    each epoch, on the KITTI validation set.

      * at most ONE child in flight: if the previous epoch's validation is
        still running, this epoch is skipped;
      * children are reaped (polled each call, waited on close), and a
        child that exits non-zero is counted and reported;
      * the evaluated subset is boundable (``--validation_max_batches``).

    The child runs on ``--validation_device`` (its ``--platform``), by
    default the trainer's own platform; ``cpu`` keeps it off the card.
    """

    def __init__(self, cmd, args=None, env=None):
        import subprocess

        self._subprocess = subprocess
        self._child = None
        self.spawned = 0
        self.skipped = 0
        self.failed = 0
        self._log_path = None
        if args is not None:
            self.args, self.env = args, env or dict(os.environ)
            return
        # the child imports this package from the repository it runs in,
        # and runs on one device outside the trainer's process group
        path = os.environ.get("PYTHONPATH")
        self.env = {k: v for k, v in os.environ.items()
                    if k not in LAUNCHER_VARS}
        self.env["PYTHONPATH"] = REPO_ROOT + (
            os.pathsep + path if path else "")
        self.args = [
            sys.executable, "-m", "m4depth_tpu_torch.cli.main",
            "--mode=validation",
            f"--platform={cmd.validation_device or cmd.platform or 'gpu'}",
            "--dataset=kitti-raw",
            f"--db_path_config={cmd.db_path_config}",
            f"--ckpt_dir={cmd.ckpt_dir}",
            f"--records_path={kitti_val_records(cmd)}",
            "--seq_len=4", "--db_seq_len=4",
            f"--keep_top_n={cmd.keep_top_n}",
            f"--validation_max_batches={cmd.validation_max_batches}",
            # the child must rebuild the SAME model to load the checkpoint
            f"--model={cmd.model}",
            f"--arch_depth={cmd.arch_depth}",
            f"--compute_dtype={cmd.compute_dtype}",
            f"--cv_dtype={cmd.cv_dtype}",
        ] + [f"--{flag}" for flag in (
            "no_DINL", "no_SNCV", "no_time_recurr",
            "no_feature_normalization", "no_feature_subdivision",
            "no_level_memory") if getattr(cmd, flag)]
        self._log_path = os.path.join(cmd.ckpt_dir,
                                      "validation-subprocess.log")

    @property
    def busy(self) -> bool:
        if self._child is None:
            return False
        if self._child.poll() is None:
            return True
        self._reap()
        return False

    def _reap(self):
        """Wait on the finished child and report a non-zero exit."""
        self._child.wait()
        rc = self._child.returncode
        self._child = None
        if rc:
            self.failed += 1
            print(f"WARNING: validation subprocess exited rc={rc} "
                  f"(see {self._log_path or 'its output'})", flush=True)

    def __call__(self, model):
        del model  # the child restores the latest checkpoint itself
        if self.busy:
            self.skipped += 1
            print("validation subprocess still running; skipping this epoch",
                  flush=True)
            return None
        if self._log_path:
            os.makedirs(os.path.dirname(self._log_path) or ".",
                        exist_ok=True)
            with open(self._log_path, "ab") as log:  # the child keeps its own
                self._child = self._subprocess.Popen(
                    self.args, env=self.env, stdout=log, stderr=log)
        else:
            self._child = self._subprocess.Popen(
                self.args, env=self.env, stdout=self._subprocess.DEVNULL,
                stderr=self._subprocess.DEVNULL)
        self.spawned += 1
        return None  # perfs land in the ledger asynchronously

    def close(self):
        """Wait for and reap any in-flight child."""
        if self._child is not None:
            self._reap()


def append_validation_perfs(ckpt_dir: str, metrics) -> None:
    """One line of the seven metrics in validation-perfs.txt."""
    line = "\t\t".join(format(metrics[k], ".4f") for k in METRIC_NAMES)
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "validation-perfs.txt"), "a") as f:
        f.write(line + "\n")


def make_validation_fn(cmd, model, db_paths):
    """Per-epoch KITTI validation run inline ('sync'), on the model being
    trained."""
    from m4depth_tpu_torch.eval import evaluate, metrics_to_validation_perfs

    cached = {}  # the dataset, built once and reused across epochs

    def validation_fn(model_):
        from m4depth_tpu_torch.data import SequenceDataset, get_adapter

        ds = cached.get("ds")
        if ds is None:
            ds = cached["ds"] = SequenceDataset(
                get_adapter("kitti-raw"), db_paths.get("kitti-raw", ""),
                kitti_val_records(cmd), usecase="eval", db_seq_len=4,
                seq_len=4, batch_size=1, augment=False,
                num_workers=cmd.num_workers)
        metrics = evaluate(model_, ds,
                           max_steps=cmd.validation_max_batches)
        append_validation_perfs(cmd.ckpt_dir, metrics)
        return metrics_to_validation_perfs(metrics)

    return validation_fn


def restore_params_for_eval(cmd, model, weights_subdir: str):
    """Load ckpt_dir/best's ledger winner into ``model``, else the latest
    checkpoint of ckpt_dir/<weights_subdir>, else keep its initial weights.
    Returns the model."""
    from m4depth_tpu_torch.train import create_train_state
    from m4depth_tpu_torch.train.checkpoints import (
        BestCheckpointManager,
        TrainCheckpointManager,
    )

    state = create_train_state(model)
    if weights_subdir == "best":
        best = BestCheckpointManager(
            os.path.join(cmd.ckpt_dir, "train"),
            os.path.join(cmd.ckpt_dir, "best"),
            keep_top_n=cmd.keep_top_n)
        if best.restore_best(state) is not None:
            return model
        weights_subdir = "train"  # fall back to the rolling store
    mgr = TrainCheckpointManager(os.path.join(cmd.ckpt_dir, weights_subdir))
    if mgr.latest_epoch is None:
        print("No checkpoint found; proceeding with scratch initialization")
    else:
        mgr.restore_latest(state)
    return model


def predict_stream(model, dataset, trace=None):
    """Streaming inference over ``dataset.frames()`` through the model's
    compiled step (``parallel.serving.compile_step``: one CUDA graph on
    the card, as the JAX CLI jits its step): yields each host frame with
    the model's depth for it, [1, h, w, 1] on the device, a tensor of its
    own."""
    import torch

    from m4depth_tpu_torch.geometry import Camera
    from m4depth_tpu_torch.models import init_state
    from m4depth_tpu_torch.parallel.serving import compile_step
    from m4depth_tpu_torch.train.loop import to_device

    device = next(model.parameters()).device
    step = compile_step(model)
    model_state = None
    try:
        for i, frame in enumerate(dataset.frames()):
            if trace is not None:
                trace.on_step(i)
            x = to_device(frame, device)
            if model_state is None:
                b, h, w = x["rgb"].shape[:3]
                model_state = init_state(model.cfg, b, h, w, device)
            with torch.no_grad():
                model_state, depth = step(
                    model_state, x["rgb"], x["rot"], x["trans"],
                    Camera(x["camera_f"], x["camera_c"]), x["new_traj"])
            yield frame, depth
    finally:
        if trace is not None:
            trace.close()  # streams shorter than the window still flush


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    from m4depth_tpu_torch.cli.options import (
        build_parser,
        check_port_options,
        dataset_locations,
        device_from_args,
        launcher_world,
        model_config_from_args,
        train_config_from_args,
    )

    build_parser(parser)
    cmd, unknown = parser.parse_known_args(argv)
    if unknown:
        # tolerated, never silent: a misspelled flag would otherwise change
        # a long run's behavior with no diagnostic anywhere
        print(f"WARNING: ignoring unrecognized arguments: {unknown}",
              flush=True)
    check_port_options(cmd, parser)
    world = launcher_world()
    if world > 1 and cmd.mode not in ("train", "finetune"):
        raise ValueError(
            f"--mode={cmd.mode} runs on one device, as the JAX CLI's does; "
            f"{world} ranks were started (WORLD_SIZE): only train and "
            "finetune run data parallel")
    db_paths = dataset_locations(cmd)

    if cmd.mode == "convert":
        from m4depth_tpu_torch.data import get_adapter
        from m4depth_tpu_torch.data.records import convert_csv_dataset

        if not cmd.record_store:
            parser.error("--mode=convert requires --record_store=<out_dir>")
        n = convert_csv_dataset(
            get_adapter(cmd.dataset),
            db_path=db_paths.get(cmd.dataset, ""),
            records_path=cmd.records_path,
            out_dir=cmd.record_store,
            num_workers=cmd.num_workers,
            out_size=cmd.out_size,
        )
        print(f"converted {n} trajectories into {cmd.record_store}")
        return 0

    if cmd.mode == "promote":
        from m4depth_tpu_torch.train import create_train_state
        from m4depth_tpu_torch.train.checkpoints import promote_best_to_train

        dest = cmd.promote_dest or cmd.ckpt_dir
        # promotion moves weights between files: built on the CPU
        model = build_model(cmd, model_config_from_args(cmd), "cpu")
        epoch = promote_best_to_train(
            os.path.join(cmd.ckpt_dir, "best"),
            os.path.join(dest, "train"), create_train_state(model),
            keep_top_n=cmd.keep_top_n)
        if epoch is None:
            print(f"no best checkpoint in {cmd.ckpt_dir}/best to promote")
            return 1
        print(f"promoted best checkpoint (epoch {epoch}) to {dest}/train")
        return 0

    device = device_from_args(cmd)
    if cmd.mode in ("train", "finetune"):
        from m4depth_tpu_torch.train.loop import fit

        usecase = "finetune" if cmd.mode == "finetune" else "train"
        if cmd.augment_device:
            cmd.no_augmentation = True  # the host pipeline only decodes
        mesh = launcher_mesh(device)
        dataset = build_dataset(cmd, usecase, db_paths, cmd.batch_size,
                                host_shard=mesh is not None)
        cfg = model_config_from_args(cmd, depth_type=dataset.depth_type)
        model = build_model(cmd, cfg, device)
        tcfg = train_config_from_args(cmd)

        validation_fn = None
        if tcfg.enable_validation:
            if cmd.validation_mode == "subprocess":
                validation_fn = SubprocessValidator(cmd)
            else:
                validation_fn = make_validation_fn(cmd, model, db_paths)

        if cmd.mode == "finetune":
            from m4depth_tpu_torch.cli.options import finetune_total_steps

            total = finetune_total_steps(cmd.ckpt_dir, tcfg.finetune_steps,
                                         len(dataset))
        else:
            total = cmd.total_steps
        augment_fn = None
        if cmd.augment_device:
            from m4depth_tpu_torch.data.augment_device import (
                make_batch_augment,
            )

            # with host augmentation off the loader yields the square
            # intermediate uncropped: the finetune crop runs here
            augment_fn = make_batch_augment(
                dataset=cmd.dataset, usecase=usecase,
                crop_to=(tuple(dataset.adapter.out_size)
                         if dataset.adapter.crop else None))
        try:
            fit(model, dataset, tcfg, total_steps=total, resume=True,
                validation_fn=validation_fn, augment_fn=augment_fn,
                mesh=mesh)
        finally:
            if mesh is not None:
                import torch.distributed as dist

                dist.destroy_process_group()

    elif cmd.mode in ("eval", "validation"):
        from m4depth_tpu_torch.eval import (
            evaluate,
            metrics_to_validation_perfs,
            write_perfs,
        )

        dataset = build_dataset(cmd, "eval", db_paths, 1)
        cfg = model_config_from_args(cmd, depth_type=dataset.depth_type)
        model = build_model(cmd, cfg, device)
        val_state = val_epoch = None
        if cmd.mode == "validation":
            # restore ONCE and reuse for both the eval and the backup: a
            # second read of "latest" after a long eval could pair this
            # eval's metrics with a newer epoch's weights
            from m4depth_tpu_torch.train import create_train_state
            from m4depth_tpu_torch.train.checkpoints import (
                TrainCheckpointManager,
            )

            mgr = TrainCheckpointManager(os.path.join(cmd.ckpt_dir, "train"))
            if mgr.latest_epoch is None:
                # scratch weights ledgered into ckpt_dir/best would be what
                # a later --mode=eval silently loads
                print("validation: no checkpoint in "
                      f"{os.path.join(cmd.ckpt_dir, 'train')}; nothing to "
                      "validate", flush=True)
                return 1
            val_epoch = mgr.latest_epoch
            val_state = mgr.restore_latest(create_train_state(model))
        else:
            restore_params_for_eval(cmd, model, "best")
        trace = None
        if cmd.log_dir and cmd.mode == "eval":
            from m4depth_tpu_torch.utils.profiling import TraceWindow

            trace = TraceWindow(cmd.log_dir, 10, 25)
        max_steps = (cmd.validation_max_batches
                     if cmd.mode == "validation" else 0)
        metrics = evaluate(model, dataset, progress_every=500,
                           trace=trace, max_steps=max_steps)
        print({k: round(v, 4) for k, v in metrics.items()})

        if cmd.mode == "validation":
            from m4depth_tpu_torch.train.checkpoints import (
                BestCheckpointManager,
            )

            best = BestCheckpointManager(
                os.path.join(cmd.ckpt_dir, "train"),
                os.path.join(cmd.ckpt_dir, "best"),
                keep_top_n=cmd.keep_top_n)
            best.update(val_epoch, metrics_to_validation_perfs(metrics),
                        val_state)
            append_validation_perfs(cmd.ckpt_dir, metrics)
        else:
            path = write_perfs(metrics, cmd.ckpt_dir, cmd.dataset)
            print(f"metrics written to {path}")

    elif cmd.mode == "predict":
        dataset = build_dataset(cmd, "predict", db_paths, 1)
        cfg = model_config_from_args(cmd, depth_type=dataset.depth_type)
        model = build_model(cmd, cfg, device)
        restore_params_for_eval(cmd, model, "best")
        trace = None
        if cmd.log_dir:
            from m4depth_tpu_torch.utils.profiling import TraceWindow

            trace = TraceWindow(cmd.log_dir, 10, 25)
        if cmd.output_dir:
            from m4depth_tpu_torch.data.decode import imwrite

            os.makedirs(cmd.output_dir, exist_ok=True)
        for i, (frame, depth) in enumerate(
                predict_stream(model, dataset, trace)):
            if i > 0 and frame["new_traj"][0]:
                print("End of trajectory")
            # depth[0] is the [h, w, 1] metric depth of this frame;
            # downstream consumers hook in here
            if cmd.output_dir:
                # 16-bit PNG, depth * 256 (the KITTI storage convention)
                d16 = np.clip(depth[0, :, :, 0].float().cpu().numpy()
                              * 256.0, 0, 65535).astype(np.uint16)
                imwrite(os.path.join(cmd.output_dir, f"depth_{i:06d}.png"),
                        d16)
    else:
        parser.print_help()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

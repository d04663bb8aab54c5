"""Training rehearsal at the reference geometry: the port's whole harness
over a long run. Counterpart of ``tools/rehearsal.py``.

Drives ``train.loop.fit`` (rolling checkpoints, the NaN tripwire, the
throughput meter, a validation child each epoch) at 384x384, d6, b=3,
T=4, bfloat16 convs and ``--cv_dtype`` cost volumes, Adam with a cosine
schedule and a global-norm clip at 1.0, on ``DeviceSyntheticStream``
(scenes made on the device from (seed, epoch, step): no frame crosses from
the host). The reference trains 220k steps at this geometry (its
main.py:105-109).

Validation: synthetic scenes exported once into ``--workdir/valdata`` in
the Mid-Air on-disk layout (``data/synthetic.py::export_midair_format``)
where cv2 or PIL imports, else into a record store (numpy alone). After
each epoch ``cli.main.SubprocessValidator`` runs the CLI's
``--mode=validation`` on them in a child process, on the trainer's device:
it restores the latest checkpoint, evaluates, and keeps the best-K ledger.

Kill and resume: relaunching with the same ``--workdir`` resumes from the
latest rolling checkpoint, and the stream replays the same scenes.
Extension: relaunching with a larger ``--steps`` resumes and trains on to
the new total; the cosine schedule is a function of (step, total), so the
learning rate restarts on the longer curve. Each run ends by evaluating
the weights on host-rendered scenes from an unseen seed and appending the
metrics to ``--workdir/heldout.json``.

  python -m m4depth_tpu_torch.tools.rehearsal --workdir <dir> --steps 50000
  python -m m4depth_tpu_torch.tools.rehearsal --workdir <dir> --steps 100000
  python -m m4depth_tpu_torch.tools.rehearsal --workdir <dir> --heldout_only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

VAL_TRAJ, VAL_FRAMES, VAL_SEED = 3, 8, 424242
HELDOUT_BATCHES, HELDOUT_SEED = 8, 7777


def parse_args(argv=None):
    from m4depth_tpu_torch.config import DTYPES

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=50000)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--lr", type=float, default=1.5e-4)
    p.add_argument("--lr_schedule", default="cosine")
    p.add_argument("--keep_top_n", type=int, default=3)
    p.add_argument("--val_max_batches", type=int, default=0,
                   help="bound the validation child's eval (0 = all frames)")
    p.add_argument("--cv_dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--heldout_only", action="store_true",
                   help="skip training; evaluate the latest checkpoint on "
                        "held-out host-rendered scenes")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def write_valdata(workdir: str, h: int, w: int) -> list:
    """Export the validation scenes once; return the validation child's
    data flags."""
    from m4depth_tpu_torch.data.synthetic import (
        export_midair_format,
        make_sequence,
    )
    from m4depth_tpu_torch.tools.io_bench import image_library

    root = os.path.join(workdir, "valdata")
    location = os.path.join(root, "datasets_location.json")
    store = os.path.join(root, "store")
    if image_library():
        if not os.path.isfile(location):
            db, recs = os.path.join(root, "db"), os.path.join(root, "records")
            n = export_midair_format(db, recs, VAL_TRAJ, VAL_FRAMES, h, w,
                                     seed=VAL_SEED)
            with open(location, "w") as f:
                json.dump({"midair": db}, f)
            print(f"exported {n} validation frames to {root}", flush=True)
        return [f"--db_path_config={location}",
                f"--records_path={os.path.join(root, 'records')}"]
    if not os.path.isdir(store):
        from m4depth_tpu_torch.data.records import RecordStoreWriter

        writer = RecordStoreWriter(store + ".tmp", num_shards=1)
        for t in range(VAL_TRAJ):
            seq = make_sequence(np.random.RandomState(
                (VAL_SEED * 9176 + t) % (2 ** 31 - 1)), VAL_FRAMES, h, w)
            writer.write_trajectory([dict(
                RGB_im=seq["RGB_im"][i], depth=seq["depth"][i],
                rot=seq["rot"][i], trans=seq["trans"][i],
                camera_f=seq["camera_f"], camera_c=seq["camera_c"],
                new_traj=np.bool_(i == 0)) for i in range(VAL_FRAMES)],
                name=f"traj_{t:04d}")
        writer.close()
        os.replace(store + ".tmp", store)
        print(f"wrote {VAL_TRAJ * VAL_FRAMES} validation frames to {store} "
              "(no image library here: a record store)", flush=True)
    return [f"--record_store={store}"]


@torch.no_grad()
def heldout_eval(model, batches, dev) -> dict:
    """The seven metrics on host-rendered scenes, averaged over batches,
    through the compiled windowed eval step (one CUDA graph on the card,
    as the JAX tool jits its eval)."""
    from m4depth_tpu_torch.metrics import MetricAccumulator
    from m4depth_tpu_torch.train.loop import to_device
    from m4depth_tpu_torch.train.step import compile_windowed_eval_step

    step = compile_windowed_eval_step(model)
    acc = MetricAccumulator.zeros(dev)
    for batch in batches:
        acc = step(to_device({k: v for k, v in batch.items()
                              if k != "new_traj"}, dev), acc)
    return {k: round(float(v), 4) for k, v in acc.result().items()}


def run(a) -> dict:
    """Train (unless ``--heldout_only``), then the held-out metrics."""
    from m4depth_tpu_torch import resolve_device
    from m4depth_tpu_torch.cli.main import SubprocessValidator
    from m4depth_tpu_torch.config import ModelConfig, TrainConfig
    from m4depth_tpu_torch.data.synthetic import (
        DeviceSyntheticStream,
        SyntheticGeometricDataset,
    )
    from m4depth_tpu_torch.models import M4Depth
    from m4depth_tpu_torch.train import create_train_state
    from m4depth_tpu_torch.train.checkpoints import TrainCheckpointManager
    from m4depth_tpu_torch.train.loop import fit

    dev = resolve_device(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    h = w = a.size
    ckpt_dir = os.path.join(a.workdir, "ckpt")
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16",
                      cv_dtype=a.cv_dtype)
    model = M4Depth(cfg, device=dev, seed=42)
    out = {}
    if not a.heldout_only:
        data_flags = write_valdata(a.workdir, h, w)
        dataset = DeviceSyntheticStream(
            a.batch, a.T, h, w, steps_per_epoch=a.steps_per_epoch,
            seed=1234, device=dev)
        tcfg = TrainConfig(
            learning_rate=a.lr, lr_schedule=a.lr_schedule,
            grad_clip_norm=1.0, total_steps=a.steps, seed=42,
            ckpt_dir=ckpt_dir, log_dir=None, keep_last_n=5,
            keep_top_n=a.keep_top_n, summary_interval=250)
        # the child runs the CLI's validation mode: it restores the latest
        # checkpoint, evaluates and votes the best-K ledger; the model
        # flags must rebuild this model
        validator = SubprocessValidator(cmd=None, args=[
            sys.executable, "-m", "m4depth_tpu_torch.cli.main",
            "--mode=validation",
            f"--platform={'gpu' if dev.type == 'cuda' else 'cpu'}",
            "--dataset=midair", *data_flags, "--out_size", str(h), str(w),
            f"--ckpt_dir={ckpt_dir}",
            f"--arch_depth={a.levels}", f"--keep_top_n={a.keep_top_n}",
            f"--validation_max_batches={a.val_max_batches}",
            "--compute_dtype=bfloat16", f"--cv_dtype={a.cv_dtype}",
            "--num_workers=2"])
        validator._log_path = os.path.join(a.workdir,
                                           "validation-subprocess.log")
        t0 = time.time()
        state = fit(model, dataset, tcfg, total_steps=a.steps, resume=True,
                    validation_fn=validator, log_every=250)
        out.update(train_s=time.time() - t0, step=int(state.step),
                   validations=validator.spawned,
                   validations_failed=validator.failed)
        print(f"rehearsal trained to step {out['step']} in "
              f"{out['train_s']:.0f} s", flush=True)
    else:
        mgr = TrainCheckpointManager(os.path.join(ckpt_dir, "train"))
        if mgr.latest_epoch is None:
            raise SystemExit(f"no checkpoint to evaluate in {ckpt_dir}")
        print(f"evaluating checkpoint epoch {mgr.latest_epoch}", flush=True)
        mgr.restore_latest(create_train_state(model))
    heldout = SyntheticGeometricDataset(
        n_batches=HELDOUT_BATCHES, batch_size=a.batch, T=a.T, h=h, w=w,
        seed=HELDOUT_SEED)
    out["heldout"] = heldout_eval(model, heldout.batches(0), dev)
    print("held-out:", out["heldout"], flush=True)
    with open(os.path.join(a.workdir, "heldout.json"), "a") as f:
        f.write(json.dumps({"ts": time.time(), **out["heldout"]}) + "\n")
    return out


def main(argv=None) -> int:
    r = run(parse_args(argv))
    return 1 if r.get("validations_failed") else 0


if __name__ == "__main__":
    sys.exit(main())

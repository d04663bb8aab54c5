"""Loader throughput of the training input: the record store (mmap) with
and without augmentation, and the JPEG/PNG decode path where an image
library imports. Counterpart of ``tools/io_bench.py``.

Writes a Mid-Air-shaped synthetic dataset (``data/synthetic.py``'s
scenes, ``--trajs`` trajectories of ``--frames`` frames at ``--size``) into
a record store with the port's ``RecordStoreWriter``, then times
``RecordSequenceDataset`` batches (``--batch`` windows of ``--seq_len``
frames cut from ``--db_seq_len`` blocks, ``--workers`` threads): one
warm-up epoch, then ``EPOCHS`` timed epochs, with augmentation and
without. The decode path (the same scenes as JPEG frames and float16
disparity PNGs, read by ``SequenceDataset``) runs only where cv2 or PIL
imports; elsewhere the tool says so. The loader runs on the host;
nothing here touches a card:

  python -m m4depth_tpu_torch.tools.io_bench
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

EPOCHS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trajs", type=int, default=4)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--seq_len", type=int, default=4)
    p.add_argument("--db_seq_len", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    return p.parse_args(argv)


def image_library() -> str:
    """The image library the data path decodes with ("cv2" or "pil"), or
    "" where neither imports."""
    from m4depth_tpu_torch.data.decode import _image_lib

    try:
        return _image_lib()[0]
    except ImportError:
        return ""


def write_store(root: str, a) -> str:
    from m4depth_tpu_torch.data.records import RecordStoreWriter
    from m4depth_tpu_torch.data.synthetic import make_sequence

    store = os.path.join(root, "store")
    writer = RecordStoreWriter(store, num_shards=4)
    for t in range(a.trajs):
        seq = make_sequence(np.random.RandomState(t), a.frames, a.size,
                            a.size)
        writer.write_trajectory([dict(
            RGB_im=seq["RGB_im"][i], depth=seq["depth"][i],
            rot=seq["rot"][i], trans=seq["trans"][i],
            camera_f=seq["camera_f"], camera_c=seq["camera_c"],
            new_traj=np.bool_(i == 0)) for i in range(a.frames)],
            name=f"traj_{t:04d}")
    writer.close()
    return store


def throughput(ds) -> dict:
    """One warm-up epoch (page cache, worker start), then EPOCHS timed."""
    n = sum(1 for _ in ds.batches(0))
    t0 = time.perf_counter()
    batches = windows = 0
    for e in range(1, EPOCHS + 1):
        for batch in ds.batches(e):
            batches += 1
            windows += batch["rgb"].shape[0]
    dt = time.perf_counter() - t0
    return dict(batches_per_s=batches / dt, windows_per_s=windows / dt,
                batches_per_epoch=n)


def run(a) -> dict:
    from m4depth_tpu_torch.data import SequenceDataset, get_adapter
    from m4depth_tpu_torch.data.records import RecordSequenceDataset
    from m4depth_tpu_torch.data.synthetic import export_midair_format

    root = tempfile.mkdtemp(prefix="m4depth_io_bench_")
    try:
        t0 = time.perf_counter()
        store = write_store(root, a)
        out = dict(write_s=time.perf_counter() - t0)
        for augment in (True, False):
            adapter = get_adapter("midair")
            adapter.set_output_size((a.size, a.size))
            ds = RecordSequenceDataset(
                store, adapter=adapter, usecase="train",
                db_seq_len=a.db_seq_len, seq_len=a.seq_len,
                batch_size=a.batch, augment=augment,
                num_workers=a.workers)
            out["record_store" + ("" if augment else "_no_augment")] = \
                throughput(ds)
        lib = image_library()
        out["image_library"] = lib
        if lib:
            db, recs = os.path.join(root, "db"), os.path.join(root, "recs")
            export_midair_format(db, recs, a.trajs, a.frames, a.size,
                                 a.size, image_format="jpg")
            ds = SequenceDataset(
                get_adapter("midair"), db_path=db, records_path=recs,
                usecase="train", db_seq_len=a.db_seq_len, seq_len=a.seq_len,
                batch_size=a.batch, augment=True,
                out_size=(a.size, a.size), num_workers=a.workers)
            out["decode"] = throughput(ds)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    a = parse_args(argv)
    r = run(a)
    print(f"{a.trajs}x{a.frames} frames at {a.size}^2, batch {a.batch}, "
          f"seq {a.seq_len} of {a.db_seq_len}-frame blocks, {a.workers} "
          f"workers, {r['record_store']['batches_per_epoch']} batches an "
          f"epoch; store written in {r['write_s']:.2f} s")
    for key in ("record_store", "record_store_no_augment", "decode"):
        if key in r:
            print(f"{key}: {r[key]['batches_per_s']:.2f} batches/s, "
                  f"{r[key]['windows_per_s']:.2f} windows/s")
    if not r["image_library"]:
        print("decode: not measured (neither cv2 nor PIL imports on this "
              "host, so JPEG/PNG frames cannot be written or read)")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())

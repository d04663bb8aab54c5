"""Host input pipeline: TSV manifests -> fixed-shape batches. Counterpart of
``m4depth_tpu/data/pipeline.py``.

Trajectories are indexed into fixed-length windows, the *window index* (not
pixels) is shuffled each epoch, then a thread pool decodes windows ahead of
consumption with bounded lookahead. Every output is a fixed-shape numpy
array; the training loop copies a batch to the device.

The manifests are read with the ``csv`` module (``read_manifest``), and
each row gets the types ``pandas.read_csv(sep="\\t")`` gives it: a column of
integers holds ints, one of numbers floats, any other column strings, and
an empty cell is NaN.
"""

from __future__ import annotations

import csv
import glob
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from m4depth_tpu_torch.data.datasets import DatasetAdapter
from m4depth_tpu_torch.parallel.mesh import host_shard_indices

# the strings pandas reads as NaN by default
_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"))


def _column(cells: Sequence[str]) -> list:
    """One column's cells with pandas' inferred type: all ints (no missing
    cell) -> int, all numbers -> float, else str; missing cells NaN."""
    present = [c for c in cells if c not in _NA]
    for cast in (int, float):
        if cast is int and len(present) < len(cells):
            continue  # a missing cell makes pandas' int column float
        try:
            return [cast(c) if c not in _NA else math.nan for c in cells]
        except ValueError:
            continue
    return [c if c not in _NA else math.nan for c in cells]


def read_manifest(path: str) -> List[Dict]:
    """The rows of a tab-separated manifest with a header line, as dicts."""
    with open(path, newline="") as f:
        lines = [r for r in csv.reader(f, delimiter="\t") if r]
    header, body = lines[0], lines[1:]
    columns = [_column([r[i] if i < len(r) else "" for r in body])
               for i in range(len(header))]
    return [{name: col[j] for name, col in zip(header, columns)}
            for j in range(len(body))]


def find_trajectory_csvs(records_path: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(records_path, "**", "*.csv"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(
            f"No csv manifests found under: {records_path}")
    return files


def _bounded_map(fn, items: Sequence, workers: int, ahead: int) -> Iterator:
    """Ordered parallel map with bounded lookahead (backpressure)."""
    if workers <= 1:
        for it in items:
            yield fn(it)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = []
        it = iter(items)
        try:
            for _ in range(ahead):
                futures.append(pool.submit(fn, next(it)))
        except StopIteration:
            it = None
        try:
            while futures:
                fut = futures.pop(0)
                if it is not None:
                    try:
                        futures.append(pool.submit(fn, next(it)))
                    except StopIteration:
                        it = None
                yield fut.result()
        finally:  # a consumer that stops early leaves no queued decode
            for fut in futures:
                fut.cancel()


def iter_frames(batches) -> Iterator[Dict[str, np.ndarray]]:
    """Unroll batched windows into single-frame batches [1, h, w, ...]
    along the time axis (shared by the CSV and record-store pipelines)."""
    for batch in batches:
        for t in range(batch["rgb"].shape[1]):
            yield {
                "rgb": batch["rgb"][:, t],
                "depth": batch["depth"][:, t],
                "rot": batch["rot"][:, t],
                "trans": batch["trans"][:, t],
                "new_traj": batch["new_traj"][:, t],
                "camera_f": batch["camera_f"],
                "camera_c": batch["camera_c"],
            }


def stack_batch(seqs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sequence dicts into a [b, T, ...] batch (shared by the CSV
    and record-store pipelines: one place for the batch schema)."""
    return {
        "rgb": np.stack([s["RGB_im"] for s in seqs]),
        "depth": np.stack([s["depth"] for s in seqs]),
        "rot": np.stack([s["rot"] for s in seqs]),
        "trans": np.stack([s["trans"] for s in seqs]),
        "new_traj": np.stack([s["new_traj"] for s in seqs]),
        "camera_f": np.stack([s["camera_f"] for s in seqs]),
        "camera_c": np.stack([s["camera_c"] for s in seqs]),
    }


class SequenceDataset:
    """Windowed sequence dataset over TSV trajectory manifests.

    usecase:
      * "train"/"finetune": random-offset windows of ``seq_len`` cut from
        consecutive ``db_seq_len`` blocks, shuffled per epoch, batched
        [b, T, ...].
      * "eval"/"predict" with db_seq_len: consecutive windows, batch 1
        (KITTI protocol).
      * "eval"/"predict" without db_seq_len: frame-at-a-time streaming,
        batch 1 (Mid-Air / TartanAir protocol).
    """

    def __init__(
        self,
        adapter: DatasetAdapter,
        db_path: str,
        records_path: str,
        usecase: str = "train",
        db_seq_len: Optional[int] = None,
        seq_len: int = 4,
        batch_size: int = 3,
        augment: bool = True,
        out_size: Optional[Sequence[int]] = None,
        crop: bool = False,
        seed: int = 42,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        host_shard: bool = False,
    ):
        self.adapter = adapter
        adapter.set_output_size(out_size, crop=crop)
        self.db_path = db_path
        self.usecase = usecase
        self.train_like = usecase in ("train", "finetune")
        if self.train_like and (db_seq_len is None or seq_len is None):
            raise ValueError("db_seq_len and seq_len are required for training")
        if db_seq_len is not None and seq_len is not None \
                and self.train_like and db_seq_len < seq_len:
            raise ValueError("db_seq_len must be >= seq_len")
        self.db_seq_len = db_seq_len
        self.seq_len = seq_len if self.train_like else (db_seq_len or 1)
        self.batch_size = batch_size if self.train_like else 1
        self.augment = augment and self.train_like
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches

        self.trajectories: List[List[Dict]] = [
            read_manifest(f) for f in find_trajectory_csvs(records_path)
        ]
        self._build_index()
        if host_shard:
            # data parallelism: each rank decodes only its strided share of
            # the windows (the same count on every rank)
            self.windows = self.windows[host_shard_indices(len(self.windows))]

    # ------------------------------------------------------------------ #

    def _build_index(self) -> None:
        """Windows = (traj_idx, start_row); frames for streaming eval."""
        self.windows: List[Tuple[int, int]] = []
        if self.train_like or self.db_seq_len is not None:
            block = self.db_seq_len if self.train_like else self.seq_len
            for ti, rows in enumerate(self.trajectories):
                for bi in range(len(rows) // block):
                    self.windows.append((ti, bi * block))
        else:
            for ti, rows in enumerate(self.trajectories):
                for ri in range(len(rows)):
                    self.windows.append((ti, ri))

    @property
    def num_batches(self) -> int:
        return len(self.windows) // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    @property
    def depth_type(self) -> str:
        return self.adapter.depth_type

    # ------------------------------------------------------------------ #

    def _decode_window(self, spec) -> Dict[str, np.ndarray]:
        (ti, start), rng_seed = spec
        rng = np.random.RandomState(rng_seed)
        traj = self.trajectories[ti]
        if self.train_like:
            offset = rng.randint(0, self.db_seq_len - self.seq_len + 1)
            rows = traj[start + offset:start + offset + self.seq_len]
        else:
            rows = traj[start:start + self.seq_len]

        frames = [self.adapter.decode_row(dict(r), self.db_path, self.usecase)
                  for r in rows]
        seq: Dict[str, np.ndarray] = {
            "RGB_im": np.stack([f["RGB_im"] for f in frames]),
            "rot": np.stack([f["rot"] for f in frames]),
            "trans": np.stack([f["trans"] for f in frames]),
            "camera_f": frames[0]["camera_f"],
            "camera_c": frames[0]["camera_c"],
        }
        if "depth" in frames[0]:
            seq["depth"] = np.stack([f["depth"] for f in frames])
        else:
            seq["depth"] = np.zeros(seq["RGB_im"].shape[:3] + (1,), np.float32)
        if self.train_like:
            # training windows always restart a trajectory at frame 0
            seq["new_traj"] = np.array(
                [i == 0 for i in range(self.seq_len)], bool)
        else:
            seq["new_traj"] = np.array(
                [bool(f["new_traj"]) for f in frames], bool)
        if self.augment:
            seq = self.adapter.augment_sequence(seq, rng, self.usecase)
        return seq

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield [b, T, ...] batches; train order reshuffles per epoch."""
        rng = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.windows))
        if self.train_like:
            rng.shuffle(order)
        specs = [(self.windows[i], int(rng.randint(0, 2 ** 31))) for i in order]

        ahead = max(self.num_workers,
                    self.prefetch_batches * self.batch_size)
        pending: List[Dict[str, np.ndarray]] = []
        for seq in _bounded_map(self._decode_window, specs,
                                self.num_workers, ahead):
            pending.append(seq)
            if len(pending) == self.batch_size:
                yield stack_batch(pending)
                pending = []

    def frames(self) -> Iterator[Dict[str, np.ndarray]]:
        """Streaming eval: single-frame batches [1, h, w, ...] in trajectory
        order (the caller carries the model state). Windowed datasets
        (db_seq_len set) are unrolled along the time axis."""
        if self.train_like:
            raise ValueError("frames() streams eval/predict datasets")
        yield from iter_frames(self.batches())

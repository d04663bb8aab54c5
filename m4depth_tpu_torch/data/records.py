"""Sharded binary record store for pre-decoded samples. Counterpart of
``m4depth_tpu/data/records.py``: the same shard format byte for byte, so
each package reads the other's stores. Needs numpy alone, so a host
without an image library or pandas trains and evaluates from a store.

Analog of the legacy TFRecord pipeline
(.legacy/multi_gpu_pipeline/protobuf_db.py:40-411): decode JPEG/PNG once,
store frames as raw tensors in sharded append-only record files, then stream
windows at memory bandwidth for every subsequent epoch. Compression tricks
match the legacy codecs: color as uint8, depth as float16 (the legacy stored
float16 matrices bitcast into PNG16, protobuf_db.py:207-213).

Shard format (little-endian):
  per record: magic 'M4R1' | uint32 header_len | header JSON | payload
  header: {"key": {"dtype": str, "shape": [...], "offset": int}}
An ``index.json`` at the store root maps trajectories to (shard, offset,
length) spans so the window sampler never touches pixel data.
"""

from __future__ import annotations

import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from m4depth_tpu_torch.parallel.mesh import host_shard_indices

MAGIC = b"M4R1"

_STORE_DTYPES = {
    "RGB_im": np.uint8,    # [0,1] float -> uint8
    "depth": np.float16,
    "rot": np.float32,
    "trans": np.float32,
    "camera_f": np.float32,
    "camera_c": np.float32,
}


def _encode_frame(frame: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in frame.items():
        v = np.asarray(v)
        if k == "new_traj":
            out[k] = v.astype(np.bool_)
            continue
        if k == "RGB_im":
            v = np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
        elif k in _STORE_DTYPES:
            v = v.astype(_STORE_DTYPES[k])
        out[k] = v
    return out


def _decode_frame(stored: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in stored.items():
        if k == "RGB_im":
            out[k] = v.astype(np.float32) / 255.0
        elif k == "new_traj":
            out[k] = v
        else:
            out[k] = v.astype(np.float32)
    return out


def _pack_record(arrays: Dict[str, np.ndarray]) -> bytes:
    header = {}
    payload = bytearray()
    for k, v in arrays.items():
        v = np.ascontiguousarray(v)
        header[k] = {"dtype": v.dtype.str, "shape": list(v.shape),
                     "offset": len(payload)}
        payload += v.tobytes()
    hjson = json.dumps(header).encode()
    return MAGIC + struct.pack("<II", len(hjson), len(payload)) + hjson + bytes(payload)


def _unpack_record(buf: memoryview, pos: int) -> Tuple[Dict[str, np.ndarray], int]:
    assert bytes(buf[pos:pos + 4]) == MAGIC, "corrupt record shard"
    hlen, plen = struct.unpack_from("<II", buf, pos + 4)
    hstart = pos + 12
    header = json.loads(bytes(buf[hstart:hstart + hlen]))
    pstart = hstart + hlen
    arrays = {}
    for k, meta in header.items():
        dt = np.dtype(meta["dtype"])
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        off = pstart + meta["offset"]
        arrays[k] = np.frombuffer(
            buf, dtype=dt, count=n, offset=off).reshape(meta["shape"])
    return arrays, pstart + plen


class RecordStoreWriter:
    """Writes trajectories round-robin across shards; one trajectory is
    always contiguous within a shard."""

    def __init__(self, out_dir: str, num_shards: int = 4):
        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.files = [open(os.path.join(self.out_dir, f"shard-{i:04d}.m4r"),
                           "wb") for i in range(num_shards)]
        self.index: List[dict] = []
        self._next = 0

    def write_trajectory(self, frames: Sequence[Dict[str, np.ndarray]],
                         name: str = "") -> None:
        shard = self._next % len(self.files)
        self._next += 1
        f = self.files[shard]
        offset = f.tell()
        frame_offsets = []
        for frame in frames:
            frame_offsets.append(f.tell() - offset)
            f.write(_pack_record(_encode_frame(frame)))
        self.index.append({
            "name": name, "shard": shard, "offset": offset,
            "length": f.tell() - offset, "num_frames": len(frames),
            "frame_offsets": frame_offsets,
        })

    def close(self) -> None:
        for f in self.files:
            f.close()
        with open(os.path.join(self.out_dir, "index.json"), "w") as f:
            json.dump({"shards": len(self.files), "trajectories": self.index},
                      f)


def convert_csv_dataset(adapter, db_path: str, records_path: str,
                        out_dir: str, num_shards: int = 4,
                        num_workers: int = 8, usecase: str = "train",
                        out_size=None) -> int:
    """Decode every trajectory under ``records_path`` and write the record
    store. Returns the number of trajectories written."""
    from m4depth_tpu_torch.data.pipeline import (
        find_trajectory_csvs,
        read_manifest,
    )

    adapter.set_output_size(out_size)
    csvs = find_trajectory_csvs(records_path)
    writer = RecordStoreWriter(out_dir, num_shards)

    def decode_traj(csv_path):
        rows = read_manifest(csv_path)
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            return list(pool.map(
                lambda row: adapter.decode_row(row, db_path, usecase), rows))

    for csv_path in csvs:
        frames = decode_traj(csv_path)
        writer.write_trajectory(frames, name=os.path.relpath(
            csv_path, records_path))
    writer.close()
    return len(csvs)


class RecordTrajectoryReader:
    """Random access to trajectories in a record store (mmap-backed)."""

    def __init__(self, store_dir: str):
        self.store_dir = os.path.abspath(store_dir)
        with open(os.path.join(self.store_dir, "index.json")) as f:
            meta = json.load(f)
        self.trajectories = meta["trajectories"]
        self._mmaps = []
        for i in range(meta["shards"]):
            path = os.path.join(self.store_dir, f"shard-{i:04d}.m4r")
            if os.path.getsize(path) == 0:  # shard received no trajectory
                self._mmaps.append(None)
            else:
                self._mmaps.append(np.memmap(path, dtype=np.uint8, mode="r"))

    def __len__(self) -> int:
        return len(self.trajectories)

    def num_frames(self, ti: int) -> int:
        return self.trajectories[ti]["num_frames"]

    def read_frames(self, ti: int, start: int, count: int
                    ) -> List[Dict[str, np.ndarray]]:
        meta = self.trajectories[ti]
        buf = memoryview(self._mmaps[meta["shard"]])
        offsets = meta.get("frame_offsets")
        frames = []
        if offsets is not None:                 # O(count) via the index
            pos = meta["offset"] + offsets[start]
            for _ in range(count):
                arrays, pos = _unpack_record(buf, pos)
                frames.append(_decode_frame(arrays))
        else:                                   # legacy store: scan
            pos = meta["offset"]
            for i in range(start + count):
                arrays, pos = _unpack_record(buf, pos)
                if i >= start:
                    frames.append(_decode_frame(arrays))
        return frames


class RecordSequenceDataset:
    """SequenceDataset-compatible window sampler over a record store.

    Skips JPEG/PNG decoding entirely — windows come straight off mmap at
    memory bandwidth. Interface parity with
    m4depth_tpu_torch.data.pipeline.SequenceDataset (batches()/frames()/len).
    """

    def __init__(self, store_dir: str, adapter=None, usecase: str = "train",
                 db_seq_len: Optional[int] = None, seq_len: int = 4,
                 batch_size: int = 3, augment: bool = True, seed: int = 42,
                 num_workers: int = 4, host_shard: bool = False):
        self.reader = RecordTrajectoryReader(store_dir)
        self.adapter = adapter
        if (adapter is not None and len(self.reader)
                and hasattr(adapter, "set_output_size")):
            # the store is pre-decoded at conversion-time resolution; size
            # the adapter to it (eval_crop_mask etc. must match the STORED
            # frames — a default-sized mask against a differently-sized
            # store broadcast-crashed mid-eval before this check)
            stored_hw = tuple(
                self.reader.read_frames(0, 0, 1)[0]["RGB_im"].shape[:2])
            # stores hold frames at the adapter's DECODE resolution — the
            # intermediate size (== out_size unless crop=True widens it)
            decode_hw = tuple(
                getattr(adapter, "intermediate_size", None)
                or getattr(adapter, "out_size", ()))
            if decode_hw != stored_hw:
                if getattr(adapter, "crop", False):
                    # set_output_size(stored_hw) would silently reset
                    # crop=False and change the training geometry; there is
                    # no way to infer the intended crop at a foreign size
                    raise ValueError(
                        f"record store frames are {stored_hw} but the "
                        f"adapter (crop=True) decodes at {decode_hw}; "
                        f"re-convert the store or fix the adapter size")
                print(f"record store frames are {stored_hw}; overriding "
                      f"adapter out_size "
                      f"{tuple(getattr(adapter, 'out_size', ()))}",
                      flush=True)
                adapter.set_output_size(stored_hw)
        self.usecase = usecase
        self.train_like = usecase in ("train", "finetune")
        if self.train_like and (db_seq_len is None or db_seq_len < seq_len):
            raise ValueError(
                "training from a record store requires db_seq_len >= "
                f"seq_len (got db_seq_len={db_seq_len}, seq_len={seq_len})")
        self.db_seq_len = db_seq_len
        self.seq_len = seq_len if self.train_like else (db_seq_len or 1)
        self.batch_size = batch_size if self.train_like else 1
        self.augment = augment and self.train_like and adapter is not None
        self.seed = seed
        self.num_workers = num_workers
        self.windows: List[Tuple[int, int]] = []
        # train_like guarantees db_seq_len; eval/predict use seq_len
        # (db_seq_len or 1) — block is always a positive int
        block = db_seq_len if self.train_like else self.seq_len
        for ti in range(len(self.reader)):
            for bi in range(self.reader.num_frames(ti) // block):
                self.windows.append((ti, bi * block))
        if host_shard:
            # data parallelism: each rank reads only its strided share of
            # the windows (the same count on every rank)
            self.windows = self.windows[host_shard_indices(len(self.windows))]

    def __len__(self) -> int:
        return len(self.windows) // self.batch_size

    @property
    def num_batches(self) -> int:
        return len(self)

    @property
    def depth_type(self) -> str:
        return self.adapter.depth_type if self.adapter is not None else "map"

    def _make_seq(self, spec) -> Dict[str, np.ndarray]:
        (ti, start), rng_seed = spec
        rng = np.random.RandomState(rng_seed)
        if self.train_like:
            offset = rng.randint(0, self.db_seq_len - self.seq_len + 1)
            frames = self.reader.read_frames(ti, start + offset, self.seq_len)
        else:
            frames = self.reader.read_frames(ti, start, self.seq_len)
        seq = {
            "RGB_im": np.stack([f["RGB_im"] for f in frames]),
            # depth-less (predict-style) stores: zeros, like the CSV
            # pipeline's fallback (pipeline.py:165-168)
            "depth": (np.stack([f["depth"] for f in frames])
                      if "depth" in frames[0] else
                      np.zeros(frames[0]["RGB_im"].shape[:2] + (1,),
                               np.float32)[None].repeat(len(frames), 0)),
            "rot": np.stack([f["rot"] for f in frames]),
            "trans": np.stack([f["trans"] for f in frames]),
            "camera_f": frames[0]["camera_f"],
            "camera_c": frames[0]["camera_c"],
        }
        if self.train_like:
            seq["new_traj"] = np.array(
                [i == 0 for i in range(self.seq_len)], bool)
        else:
            # honor per-frame trajectory breaks recorded from the manifest
            # (SequenceDataset parity, pipeline.py eval path); frame 0 of a
            # stored trajectory always starts one
            seq["new_traj"] = np.array(
                [bool(f.get("new_traj", False)) or (start + i == 0)
                 for i, f in enumerate(frames)], bool)
        if (self.usecase == "eval" and self.adapter is not None
                and hasattr(self.adapter, "eval_crop_mask")):
            # stores are decoded with the train usecase; the eval protocol
            # crop (Garg/Eigen, kitti.py:14-20) is applied at read time
            seq["depth"] = seq["depth"] * self.adapter.eval_crop_mask()
        if self.augment:
            seq = self.adapter.augment_sequence(seq, rng, self.usecase)
        return seq

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        from m4depth_tpu_torch.data.pipeline import _bounded_map, stack_batch

        rng = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.windows))
        if self.train_like:
            rng.shuffle(order)
        specs = [(self.windows[i], int(rng.randint(0, 2 ** 31)))
                 for i in order]
        pending = []
        for seq in _bounded_map(self._make_seq, specs, self.num_workers,
                                max(self.num_workers, 2 * self.batch_size)):
            pending.append(seq)
            if len(pending) == self.batch_size:
                yield stack_batch(pending)
                pending = []

    def frames(self) -> Iterator[Dict[str, np.ndarray]]:
        """Streaming eval: yield single-frame batches [1, h, w, ...] in
        trajectory order (interface parity with SequenceDataset.frames —
        windowed stores are unrolled along the time axis, as there)."""
        from m4depth_tpu_torch.data.pipeline import iter_frames

        if self.train_like:
            raise ValueError("frames() streams eval/predict datasets")
        yield from iter_frames(self.batches())

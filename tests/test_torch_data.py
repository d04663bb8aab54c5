"""The port's data path (``m4depth_tpu_torch/data``) against the JAX
package's, on the CPU: both are numpy, so batches must be identical, with
no tolerance. The fixture is a small Mid-Air layout (TSV manifests, JPEG
frames, float16-bitcast disparity PNGs) made with numpy from a seed; the
record stores come from either package's ``convert_csv_dataset``."""

import filecmp
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from m4depth_tpu.data import SequenceDataset as JSequenceDataset
from m4depth_tpu.data import get_adapter as jget_adapter
from m4depth_tpu.data import records as jrecords
from m4depth_tpu.data import synthetic as jsynthetic
from m4depth_tpu_torch.data import SequenceDataset, decode, get_adapter
from m4depth_tpu_torch.data import records, synthetic
from m4depth_tpu_torch.data.pipeline import read_manifest

cv2 = pytest.importorskip("cv2")

HW = 32


@pytest.fixture(scope="module")
def midair(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    db, recs = root / "db", root / "records"
    rng = np.random.RandomState(0)
    for t in range(3):
        os.makedirs(recs / f"traj_{t}")
        os.makedirs(db / f"traj_{t}")
        lines = ["id\tcamera_l\tdisp\tqw\tqx\tqy\tqz\ttx\tty\ttz"]
        for i in range(8):
            img = (rng.rand(HW, HW, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(db / f"traj_{t}/c_{i}.jpg"), img)
            depth = rng.uniform(5, 50, (HW, HW)).astype(np.float32)
            cv2.imwrite(str(db / f"traj_{t}/d_{i}.png"),
                        (512.0 / depth).astype(np.float16).view(np.uint16))
            q = rng.normal(size=4) * 0.02 + [1, 0, 0, 0]
            tr = rng.normal(size=3) * 0.1 + [0, 0, 0.4]
            lines.append(f"{i}\ttraj_{t}/c_{i}.jpg\ttraj_{t}/d_{i}.png\t"
                         + "\t".join(f"{v:.9g}" for v in (*q, *tr)))
        (recs / f"traj_{t}" / "traj.csv").write_text("\n".join(lines))
    return str(db), str(recs)


def _equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


CASES = [  # usecase, db_seq_len, augment
    ("train", 4, True), ("train", 4, False), ("finetune", 4, True),
    ("eval", None, False), ("eval", 4, False), ("predict", None, False)]


def test_manifest_rows_have_the_types_pandas_gives(midair, tmp_path):
    _, recs = midair
    odd = tmp_path / "odd.csv"  # a missing depth, a missing id, NA strings
    odd.write_text("id\tcamera_l\tdisp\tqw\tk\n0\ta.jpg\t\t1\tNA\n"
                   "\tb.jpg\td.png\t0.5\t3\n")
    for path in (os.path.join(recs, "traj_0", "traj.csv"), str(odd)):
        want = [dict(r) for _, r in pd.read_csv(path, sep="\t").iterrows()]
        got = read_manifest(path)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(w[k], float) and np.isnan(w[k]):
                    assert isinstance(g[k], float) and np.isnan(g[k]), k
                else:
                    assert g[k] == w[k] and type(g[k]) is type(w[k]), \
                        (k, g[k], w[k])


@pytest.mark.parametrize("usecase,db_seq_len,augment", CASES)
def test_sequence_dataset_matches_jax(midair, usecase, db_seq_len, augment):
    db, recs = midair
    kw = dict(usecase=usecase, db_seq_len=db_seq_len, seq_len=2,
              batch_size=2, augment=augment, out_size=(24, 24),
              crop=usecase == "finetune", seed=3, num_workers=2)
    ours = SequenceDataset(get_adapter("midair"), db, recs, **kw)
    ref = JSequenceDataset(jget_adapter("midair"), db, recs, **kw)
    assert len(ours) == len(ref) > 0 and ours.windows == ref.windows
    for epoch in range(2):
        got, want = list(ours.batches(epoch)), list(ref.batches(epoch))
        assert len(got) == len(want) == len(ref)
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{usecase} epoch {epoch} batch {i}")
    if not ours.train_like:
        for i, (a, b) in enumerate(zip(ours.frames(), ref.frames())):
            _equal(a, b, f"{usecase} frame {i}")


@pytest.fixture(scope="module")
def jax_store(midair, tmp_path_factory):
    db, recs = midair
    out = str(tmp_path_factory.mktemp("jstore") / "store")
    jrecords.convert_csv_dataset(jget_adapter("midair"), db, recs, out,
                                 num_shards=2, num_workers=2)
    return out


@pytest.mark.parametrize("usecase,db_seq_len,augment", CASES)
def test_record_dataset_matches_jax(jax_store, usecase, db_seq_len,
                                    augment):
    kw = dict(usecase=usecase, db_seq_len=db_seq_len, seq_len=2,
              batch_size=2, augment=augment, seed=5, num_workers=2)
    if usecase == "finetune":
        usecase = kw["usecase"] = "train"
    ours = records.RecordSequenceDataset(jax_store, get_adapter("midair"),
                                         **kw)
    ref = jrecords.RecordSequenceDataset(jax_store, jget_adapter("midair"),
                                         **kw)
    assert len(ours) == len(ref) > 0
    for epoch in range(2):
        for i, (a, b) in enumerate(zip(ours.batches(epoch),
                                       ref.batches(epoch))):
            _equal(a, b, f"{usecase} epoch {epoch} batch {i}")
    if not ours.train_like:
        for i, (a, b) in enumerate(zip(ours.frames(), ref.frames())):
            _equal(a, b, f"{usecase} frame {i}")


def test_stores_are_the_same_bytes_and_read_across(midair, jax_store,
                                                   tmp_path):
    """The port's converter writes the JAX converter's store byte for
    byte, and each package's reader reads the other's store."""
    db, recs = midair
    ours = str(tmp_path / "store")
    n = records.convert_csv_dataset(get_adapter("midair"), db, recs, ours,
                                    num_shards=2, num_workers=2)
    assert n == 3
    names = sorted(os.listdir(jax_store))
    assert names == sorted(os.listdir(ours))
    for name in names:
        assert filecmp.cmp(os.path.join(ours, name),
                           os.path.join(jax_store, name), shallow=False), name
    for writer_dir in (ours, jax_store):
        a = records.RecordTrajectoryReader(writer_dir)
        b = jrecords.RecordTrajectoryReader(writer_dir)
        for ti in range(len(a)):
            for fa, fb in zip(a.read_frames(ti, 1, 5), b.read_frames(ti, 1, 5)):
                _equal(fa, fb, f"trajectory {ti}")


def test_port_writer_store_reads_in_jax(tmp_path):
    """A store the port's ``RecordStoreWriter`` wrote from synthetic scenes
    (with trajectory breaks) reads identically in the JAX reader."""
    w = records.RecordStoreWriter(str(tmp_path / "s"), num_shards=3)
    for t in range(2):
        seq = synthetic.make_sequence(np.random.RandomState(t), 4, 16, 16)
        w.write_trajectory([
            dict(RGB_im=seq["RGB_im"][i], depth=seq["depth"][i],
                 rot=seq["rot"][i], trans=seq["trans"][i],
                 camera_f=seq["camera_f"], camera_c=seq["camera_c"],
                 new_traj=np.bool_(i == 2)) for i in range(4)])
    w.close()
    kw = dict(usecase="eval", seq_len=2, num_workers=1)
    ours = records.RecordSequenceDataset(str(tmp_path / "s"), **kw)
    ref = jrecords.RecordSequenceDataset(str(tmp_path / "s"), **kw)
    frames = list(ours.frames())
    assert len(frames) == 8
    assert [bool(f["new_traj"][0]) for f in frames] == [
        True, False, True, False] * 2
    for i, (a, b) in enumerate(zip(frames, ref.frames())):
        _equal(a, b, f"frame {i}")


def test_synthetic_host_scenes_match_jax(tmp_path):
    for seed in (0, 1):
        a = synthetic.make_sequence(np.random.RandomState(seed), 3, 16, 16)
        b = jsynthetic.make_sequence(np.random.RandomState(seed), 3, 16, 16)
        _equal(a, b, f"make_sequence seed {seed}")
    ds = synthetic.SyntheticGeometricDataset(2, 2, 3, 16, 16, seed=4)
    jds = jsynthetic.SyntheticGeometricDataset(2, 2, 3, 16, 16, seed=4)
    for a, b in zip(ds.batches(1), jds.batches(1)):
        _equal(a, b, "SyntheticGeometricDataset")
    # the Mid-Air export: the same files, written through either package
    assert synthetic.export_midair_format(
        str(tmp_path / "db"), str(tmp_path / "rec"), 2, 3, 16, 16) == 6
    jsynthetic.export_midair_format(
        str(tmp_path / "jdb"), str(tmp_path / "jrec"), 2, 3, 16, 16)
    for sub, jsub in (("db", "jdb"), ("rec", "jrec")):
        for d, _, files in os.walk(tmp_path / sub):
            for name in files:
                rel = os.path.relpath(os.path.join(d, name), tmp_path / sub)
                assert filecmp.cmp(os.path.join(d, name),
                                   tmp_path / jsub / rel, shallow=False), rel


def test_device_scenes_are_seeded_and_photometrically_consistent():
    """``DeviceSyntheticStream`` replays a (seed, epoch, step) exactly, and
    warping frame t-1 by the flow of frame t's depth and motion gives
    frame t (the scenes' invariant), through the port's ``reproject``."""
    from m4depth_tpu_torch.geometry import Camera, reproject

    ds = synthetic.DeviceSyntheticStream(2, 3, 48, 48, steps_per_epoch=2,
                                         seed=9, device="cpu")
    a, b = list(ds.batches(1)), list(ds.batches(1))
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert not torch.equal(a[0]["rgb"], next(iter(ds.batches(0)))["rgb"])
    batch = a[0]
    assert batch["depth"].min() > 1.0 and batch["depth"].max() < 100.0
    cam = Camera(batch["camera_f"], batch["camera_c"])
    for t in range(1, 3):
        warped, _ = reproject(batch["rgb"][:, t - 1], batch["depth"][:, t],
                              batch["rot"][:, t], batch["trans"][:, t], cam)
        err = (warped - batch["rgb"][:, t])[:, 6:-6, 6:-6].abs().mean()
        assert err < 0.015, err


def test_decoding_without_an_image_library_names_the_store(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    decode._image_lib.cache_clear()
    try:
        with pytest.raises(ImportError, match="--record_store"):
            decode.load_jpeg("any.jpg")
    finally:
        decode._image_lib.cache_clear()
    # resizing has a numpy path: it needs no image library
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    assert decode.resize_bilinear_np(img, (4, 6)).shape == (4, 6, 3)


def test_dataset_location_file(tmp_path):
    from m4depth_tpu.config import load_dataset_locations as jload
    from m4depth_tpu_torch.config import load_dataset_locations

    path = tmp_path / "loc.json"
    path.write_text(json.dumps({"midair": "data/midair", "kitti-raw": "/abs"}))
    assert load_dataset_locations(str(path)) == jload(str(path))

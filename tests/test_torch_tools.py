"""The port's tools (``python -m m4depth_tpu_torch.tools.<name>``) run
end to end on the CPU at a tiny size (d2, 32x32, a few frames or steps):
each ``main`` returns 0 and prints its headline numbers; the rehearsal
resumes a killed run and extends a finished one from its work
directory."""

import json

import pytest
import torch

from m4depth_tpu_torch.ops import glue_launches
from m4depth_tpu_torch.tools import (
    fps,
    io_bench,
    memory_footprint,
    rehearsal,
    train_prof,
)

TINY = ["--device", "cpu", "--size", "32", "--levels", "2"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and more threads a worker only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_memory_footprint(capsys):
    assert memory_footprint.main(TINY + ["--cv_dtype", "float16"]) == 0
    out = capsys.readouterr().out
    assert "params:" in out and "recurrent state:" in out
    assert "device memory: not measured" in out


@pytest.mark.parametrize("model", ["m4depth", "m4depth-v1"])
def test_fps_with_profile(capsys, tmp_path, model):
    assert fps.main(TINY + ["--n", "2", "--profile", "--model", model,
                            "--log_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "fps=" in out and "ms/frame=" in out and f"model={model}" in out
    # on the CPU every level runs its family's plain glue: no glue kernel
    # launches
    line = next(x for x in out.splitlines()
                if x.startswith("glue kernel launches a frame"))
    counts = dict(x.split() for x in line.split(": ", 1)[1].split(", "))
    assert counts == {name: "0" for name in glue_launches()}
    assert "device time: not measured" in out      # no device on the CPU
    assert list(tmp_path.glob("trace-*.json"))


def test_train_prof(capsys, tmp_path):
    argv = TINY + ["--batch", "1", "--seq", "2", "--steps", "1",
                   "--log_dir", str(tmp_path)]
    assert train_prof.main(argv) == 0
    out = capsys.readouterr().out
    assert "train step:" in out
    assert "glue kernel launches a step over the timed calls: " in out
    assert train_prof.main(argv + ["--remat", "--remat_policy", "all",
                                   "--no_profile"]) == 0
    assert "remat=True:all" in capsys.readouterr().out


def test_io_bench(capsys):
    assert io_bench.main(["--trajs", "2", "--frames", "8", "--size", "32",
                          "--batch", "2", "--seq_len", "2",
                          "--db_seq_len", "4", "--workers", "2"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("record_store", "record_store_no_augment"):
        assert r[key]["batches_per_s"] > 0
        assert r[key]["batches_per_epoch"] == 2
    assert ("decode" in r) == bool(r["image_library"])


def test_rehearsal_resumes_and_extends(capsys, tmp_path):
    """Two epochs of two steps, then a relaunch to six steps: it resumes
    at epoch 2 and trains one more; each run appends its held-out
    metrics."""
    argv = TINY + ["--workdir", str(tmp_path), "--steps_per_epoch", "2",
                   "--batch", "1", "--T", "2"]
    assert rehearsal.main(argv + ["--steps", "4"]) == 0
    first = capsys.readouterr().out
    assert "trained to step 4" in first and "held-out:" in first
    assert rehearsal.main(argv + ["--steps", "6"]) == 0
    second = capsys.readouterr().out
    assert "Resuming from epoch 2" in second
    assert "trained to step 6" in second
    assert sorted(p.name for p in (tmp_path / "ckpt" / "train").glob(
        "*.pt")) == ["0.pt", "1.pt", "2.pt"]
    lines = (tmp_path / "heldout.json").read_text().splitlines()
    assert len(lines) == 2 and "AbsRel" in json.loads(lines[-1])
    assert rehearsal.main(argv + ["--heldout_only"]) == 0
    assert "evaluating checkpoint epoch 2" in capsys.readouterr().out

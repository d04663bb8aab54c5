"""The port's command line (``python -m m4depth_tpu_torch.cli.main``) in
all seven modes on the CPU (``--platform=cpu``), on a small Mid-Air layout
and a KITTI validation set made with numpy from a seed; and the slice as a
whole: the JAX CLI's and the port's ``--mode=eval`` on the same weights
write the same ``perfs-midair.txt`` (rtol 1e-4, float32)."""

import argparse
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from m4depth_tpu_torch.cli import main as cli
from m4depth_tpu_torch.cli.options import build_parser
from m4depth_tpu_torch.train.checkpoints import TrainCheckpointManager

cv2 = pytest.importorskip("cv2")

SMALL = ["--arch_depth=2", "--num_workers=2", "--compute_dtype=float32",
         "--cv_dtype=float32", "--platform=cpu"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A Mid-Air layout (2 trajectories of 6 frames, 32x32) and, where the
    CLI looks for it beside the location file, a KITTI validation set (one
    4-frame trajectory with sparse depth and normalised intrinsics)."""
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.RandomState(0)
    db, recs = root / "db", root / "records"
    for t in range(2):
        os.makedirs(recs / f"traj_{t}")
        os.makedirs(db / f"traj_{t}")
        lines = ["id\tcamera_l\tdisp\tqw\tqx\tqy\tqz\ttx\tty\ttz"]
        for i in range(6):
            cv2.imwrite(str(db / f"traj_{t}/c_{i}.jpg"),
                        (rng.rand(32, 32, 3) * 255).astype(np.uint8))
            depth = rng.uniform(5, 50, (32, 32)).astype(np.float32)
            cv2.imwrite(str(db / f"traj_{t}/d_{i}.png"),
                        (512.0 / depth).astype(np.float16).view(np.uint16))
            lines.append(f"{i}\ttraj_{t}/c_{i}.jpg\ttraj_{t}/d_{i}.png\t"
                         "1\t0\t0\t0\t0.05\t0.01\t0.4")
        (recs / f"traj_{t}" / "traj.csv").write_text("\n".join(lines))
    kdb = root / "kitti"
    kval = root / "data" / "kitti-raw-filtered" / "val_data" / "seq"
    os.makedirs(kval)
    os.makedirs(kdb)
    lines = ["id\tcamera_l\tdepth\tqw\tqx\tqy\tqz\ttx\tty\ttz\tfx\tfy\tcx\tcy"]
    for i in range(4):
        cv2.imwrite(str(kdb / f"c_{i}.jpg"),
                    (rng.rand(16, 48, 3) * 255).astype(np.uint8))
        d = (rng.uniform(5, 50, (16, 48)) * 256).astype(np.uint16)
        d[rng.rand(16, 48) < 0.7] = 0  # sparse, as velodyne depth is
        cv2.imwrite(str(kdb / f"d_{i}.png"), d)
        lines.append(f"{i}\tc_{i}.jpg\td_{i}.png\t1\t0\t0\t0\t0.01\t0\t0.5"
                     "\t0.58\t1.92\t0.5\t0.5")
    (kval / "traj.csv").write_text("\n".join(lines))
    cfg = root / "datasets_location.json"
    cfg.write_text(json.dumps({"midair": str(db), "kitti-raw": str(kdb)}))
    return dict(root=root, records=str(recs), cfg=str(cfg))


def midair(env, *extra):
    return ["--dataset=midair", f"--db_path_config={env['cfg']}",
            f"--records_path={env['records']}", "--out_size", "32", "32",
            *SMALL, *extra]


def train_args(env, ckpt, *extra):
    return ["--mode=train", f"--ckpt_dir={ckpt}", "--db_seq_len=4",
            "--seq_len=2", "--batch_size=2", *midair(env, *extra)]


@pytest.fixture(scope="module")
def trained(env):
    """A checkpoint directory after 2 epochs of train mode."""
    ckpt = str(env["root"] / "ckpt")
    assert cli.main(train_args(env, ckpt, "--total_steps=2")) == 0
    return ckpt


def test_train_mode_saves_per_epoch_and_resumes(env, trained, capsys):
    mgr = TrainCheckpointManager(os.path.join(trained, "train"))
    assert mgr.epochs() == [0, 1]
    ckpt = str(env["root"] / "ckpt_resume")
    assert cli.main(train_args(env, ckpt, "--total_steps=2")) == 0
    capsys.readouterr()
    assert cli.main(train_args(env, ckpt, "--total_steps=3")) == 0
    assert "Resuming from epoch 2" in capsys.readouterr().out
    saved = torch.load(os.path.join(ckpt, "train", "2.pt"),
                       weights_only=True)
    assert saved["count"] == 3 and saved["epoch"] == 2


def test_eval_mode_writes_perfs(env, trained, tmp_path):
    logs = str(tmp_path / "logs")
    assert cli.main(["--mode=eval", f"--ckpt_dir={trained}",
                     f"--log_dir={logs}", *midair(env)]) == 0
    perfs = np.loadtxt(os.path.join(trained, "perfs-midair.txt"))
    assert perfs.shape == (7,) and np.all(np.isfinite(perfs))
    assert len(os.listdir(logs)) == 1  # the profiler's trace of steps 10-25


def test_validation_mode_ledgers_the_latest_checkpoint(env, trained):
    assert cli.main(["--mode=validation", f"--ckpt_dir={trained}",
                     "--validation_max_batches=5", *midair(env)]) == 0
    with open(os.path.join(trained, "best", "validation_perfs.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("abs_rel,") and rows[-1].endswith("ckpt-0001")
    with open(os.path.join(trained, "validation-perfs.txt")) as f:
        assert len(f.readline().split()) == 7


def test_v1_runs_every_mode(env, tmp_path):
    """``--model=m4depth-v1``: train 2 epochs, validation of the latest
    checkpoint, eval (7 finite metrics) and predict, on the CPU."""
    ckpt = str(tmp_path / "v1")
    v1 = "--model=m4depth-v1"
    assert cli.main(train_args(env, ckpt, v1, "--total_steps=2")) == 0
    assert TrainCheckpointManager(os.path.join(ckpt, "train")).epochs() == [
        0, 1]
    assert cli.main(["--mode=validation", f"--ckpt_dir={ckpt}",
                     "--validation_max_batches=2", *midair(env, v1)]) == 0
    with open(os.path.join(ckpt, "best", "validation_perfs.csv")) as f:
        assert f.read().splitlines()[-1].endswith("ckpt-0001")
    assert cli.main(["--mode=eval", f"--ckpt_dir={ckpt}",
                     *midair(env, v1)]) == 0
    perfs = np.loadtxt(os.path.join(ckpt, "perfs-midair.txt"))
    assert perfs.shape == (7,) and np.all(np.isfinite(perfs))
    out = str(tmp_path / "pred")
    assert cli.main(["--mode=predict", f"--ckpt_dir={ckpt}",
                     f"--output_dir={out}", *midair(env, v1)]) == 0
    assert len(os.listdir(out)) == 12


def test_validation_without_a_checkpoint_refuses(env, tmp_path):
    ckpt = str(tmp_path / "fresh")
    assert cli.main(["--mode=validation", f"--ckpt_dir={ckpt}",
                     *midair(env)]) == 1
    assert not os.path.exists(os.path.join(ckpt, "best",
                                           "validation_perfs.csv"))


def test_predict_mode_writes_depth_pngs(env, trained, tmp_path, capsys):
    out = str(tmp_path / "pred")
    assert cli.main(["--mode=predict", f"--ckpt_dir={trained}",
                     f"--output_dir={out}", *midair(env)]) == 0
    assert capsys.readouterr().out.count("End of trajectory") == 1
    names = sorted(os.listdir(out))
    assert len(names) == 12 and names[0] == "depth_000000.png"
    d16 = cv2.imread(os.path.join(out, names[0]), cv2.IMREAD_UNCHANGED)
    assert d16.dtype == np.uint16 and d16.shape == (32, 32)


def test_convert_then_train_from_the_store_on_device_augment(env, tmp_path):
    store = str(tmp_path / "store")
    assert cli.main(["--mode=convert", f"--record_store={store}",
                     *midair(env)]) == 0
    assert os.path.isfile(os.path.join(store, "index.json"))
    ckpt = str(tmp_path / "ckpt")
    args = ["--mode=train", f"--ckpt_dir={ckpt}", f"--record_store={store}",
            "--db_seq_len=4", "--seq_len=2", "--batch_size=2",
            "--total_steps=2", "--augment_device", *midair(env)]
    assert cli.main(args) == 0
    assert TrainCheckpointManager(os.path.join(ckpt, "train")).epochs() == \
        [0, 1]


def test_promote_then_finetune_resumes_from_it(env, trained, tmp_path,
                                               capsys):
    dest = str(tmp_path / "dest")
    assert cli.main(["--mode=promote", f"--ckpt_dir={trained}",
                     f"--promote_dest={dest}", *SMALL]) == 0
    assert TrainCheckpointManager(os.path.join(dest, "train")).epochs() == [1]
    capsys.readouterr()
    assert cli.main(["--mode=finetune", f"--ckpt_dir={dest}",
                     "--db_seq_len=4", "--seq_len=2", "--batch_size=2",
                     "--finetune_steps=1",
                     *midair(env, "--out_size", "24", "32")]) == 0
    assert "Resuming from epoch 2" in capsys.readouterr().out
    assert cli.main(["--mode=promote", f"--ckpt_dir={tmp_path / 'empty'}",
                     f"--promote_dest={dest}", *SMALL]) == 1


def test_finetune_crop_without_augmentation_raises(env, tmp_path):
    """The Mid-Air finetune crop lives in the augmentation: with it off and
    no --augment_device the frames would train uncropped."""
    with pytest.raises(ValueError, match="uncropped"):
        cli.main(["--mode=finetune", f"--ckpt_dir={tmp_path}",
                  "--db_seq_len=4", "--seq_len=2", "--batch_size=2",
                  "--no_augmentation", *midair(env)])


def test_sync_validation_feeds_the_best_manager(env, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(train_args(env, ckpt, "--total_steps=2",
                               "--enable_validation",
                               "--validation_max_batches=1")) == 0
    with open(os.path.join(ckpt, "validation-perfs.txt")) as f:
        assert len(f.read().splitlines()) == 2
    assert os.path.isfile(os.path.join(ckpt, "best", "validation_perfs.csv"))


def test_subprocess_validator_runs_the_ports_child(env, trained):
    cmd = build_parser(argparse.ArgumentParser()).parse_args(
        midair(env, f"--ckpt_dir={trained}", "--keep_top_n=2",
               "--validation_max_batches=1", "--mode=train"))
    v = cli.SubprocessValidator(cmd)
    assert v.args[1:3] == ["-m", "m4depth_tpu_torch.cli.main"]
    assert "--platform=cpu" in v.args
    # the child's flags are the port parser's, on the card as well; with no
    # --validation_device the child takes the trainer's platform
    on_card = [a for a in midair(env) if a != "--platform=cpu"]
    for args, device in ((midair(env, "--validation_device=cpu"), "cpu"),
                         (midair(env, "--validation_device=gpu"), "gpu"),
                         (midair(env), "cpu"), (on_card, "gpu")):
        child = cli.SubprocessValidator(build_parser(
            argparse.ArgumentParser()).parse_args(args))
        parsed, unknown = build_parser(argparse.ArgumentParser()
                                       ).parse_known_args(child.args[3:])
        assert not unknown and parsed.platform == device
    v(None)
    deadline = time.time() + 120
    while v.busy and time.time() < deadline:
        time.sleep(0.2)
    v.close()
    log = open(os.path.join(trained, "validation-subprocess.log")).read()
    assert v.spawned == 1 and v.failed == 0, log
    with open(os.path.join(trained, "best", "validation_perfs.csv")) as f:
        assert any(r.endswith("ckpt-0001") for r in f.read().splitlines())


def test_subprocess_validator_is_single_in_flight():
    v = cli.SubprocessValidator(
        cmd=None, args=[sys.executable, "-c", "import time; time.sleep(2)"])
    v(None)
    v(None)
    assert v.spawned == 1 and v.skipped == 1
    v.close()
    assert not v.busy
    bad = cli.SubprocessValidator(
        cmd=None, args=[sys.executable, "-c", "import sys; sys.exit(3)"])
    bad(None)
    bad.close()
    assert bad.failed == 1


@pytest.mark.parametrize("flag,effect", [
    ("--dscv_impl=split", "one implementation"),
    # ported: runs, and prints no "changes nothing" line
    ("--remat", None),
    ("--save_interval=5", "reads it nowhere"),
    ("--data_mesh=4", ValueError),
    ("--model=m4depth-v1", None),
])
def test_tpu_flags_are_accepted_and_unported_ones_raise(env, tmp_path, flag,
                                                        effect, capsys):
    args = ["--mode=predict", f"--ckpt_dir={tmp_path}", flag, *midair(env)]
    if effect is None:
        assert cli.main(args) == 0
        assert "changes nothing" not in capsys.readouterr().out
    elif isinstance(effect, str):
        assert cli.main(args) == 0
        assert effect in capsys.readouterr().out
    else:
        with pytest.raises(effect):
            cli.main(args)


def test_gpu_platform_raises_without_a_card(env, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in midair(env) if a != "--platform=cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode=eval", f"--ckpt_dir={tmp_path}", *args])


def test_jax_and_port_eval_modes_agree(env, tmp_path):
    """The slice as a whole: a JAX train state, saved by the JAX package
    and carried across with ``save_jax_checkpoint``; each package's CLI
    evaluates it on the same manifests."""
    import jax

    from m4depth_tpu.cli.main import init_sample
    from m4depth_tpu.cli.main import main as jax_main
    from m4depth_tpu.config import ModelConfig as JaxConfig
    from m4depth_tpu.models import M4Depth as JaxM4Depth
    from m4depth_tpu.train import create_train_state
    from m4depth_tpu.train.checkpoints import (
        TrainCheckpointManager as JaxManager,
    )
    from m4depth_tpu_torch.config import ModelConfig
    from m4depth_tpu_torch.interop import save_jax_checkpoint

    jcfg = JaxConfig(num_levels=2, compute_dtype="float32",
                     cv_dtype="float32")
    state = create_train_state(JaxM4Depth(jcfg), jax.random.PRNGKey(5),
                               init_sample(None)).replace(step=12)
    jckpt, pckpt = str(tmp_path / "jax"), str(tmp_path / "port")
    mgr = JaxManager(os.path.join(jckpt, "train"))
    mgr.save(0, state)
    mgr.close()
    save_jax_checkpoint(jax.device_get(state.params), int(state.step),
                        ModelConfig(num_levels=2, compute_dtype="float32",
                                    cv_dtype="float32"), pckpt)
    common = [a for a in midair(env) if a != "--platform=cpu"]
    assert jax_main(["--mode=eval", f"--ckpt_dir={jckpt}", *common]) == 0
    assert cli.main(["--mode=eval", f"--ckpt_dir={pckpt}",
                     "--platform=cpu", *common]) == 0
    want = np.loadtxt(os.path.join(jckpt, "perfs-midair.txt"))
    got = np.loadtxt(os.path.join(pckpt, "perfs-midair.txt"))
    assert want.shape == got.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=1e-4)

"""The port's geometry gate (``m4depth_tpu_torch.tools.synthetic_validation``)
on the CPU: its learning-rate schedule against optax's, and a few steps of
each mode and model family (the gate itself, 1000 steps at 64x64, runs on
the card in ``chip_smoke.py``)."""

import ast

import numpy as np
import optax
import pytest
import torch

from m4depth_tpu_torch.tools import synthetic_validation as tool


@pytest.mark.parametrize("steps", [50, 1000])
def test_schedule_matches_optax(steps):
    """At 1000 steps the JAX tool's own schedule, optax's warm-up over 200
    steps; at 50, where optax refuses a 200-step warm-up, its schedule with
    a 25-step one. optax computes in float32, its warm-up as
    (0 - peak) * (1 - t / w) + peak: rtol 1e-6 and an atol of two float32
    ulps of the peak."""
    lr = 2e-4
    warmup = 200 if steps >= 400 else steps // 2
    ref = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=steps, end_value=lr * 0.05)
    port = tool.warmup_cosine_schedule(lr, steps)
    counts = np.arange(steps + 10)
    np.testing.assert_allclose([port(int(c)) for c in counts],
                               np.asarray(ref(counts)), rtol=1e-6,
                               atol=lr * 2.0 ** -22)
    assert port(steps + 5) == pytest.approx(0.05 * lr)


def run_tool(argv, capsys):
    rc = tool.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("model", ["m4depth", "m4depth-v1"])
def test_overfit_mode_runs_on_the_cpu(model, capsys):
    """Five steps: finite metrics of the fitted batch and the gate's line
    (which fails this early: exit code 1)."""
    rc, out = run_tool(["--mode", "overfit", "--steps", "5", "--size", "16",
                        "--levels", "2", "--platform", "cpu", "--model",
                        model], capsys)
    line = next(s for s in out.splitlines() if s.startswith("fitted-batch:"))
    metrics = ast.literal_eval(line.split(":", 1)[1].strip())
    assert len(metrics) == 7 and all(np.isfinite(v) for v in metrics.values())
    assert "GEOMETRY VALIDATION FAILED" in out and rc == 1
    assert "trained 5 steps" in out


def test_generalize_mode_streams_device_scenes(capsys):
    """``--pool 0``: fresh scenes from ``device_batch_sampler`` each step;
    held-out metrics, no gate."""
    rc, out = run_tool(["--mode", "generalize", "--pool", "0", "--steps", "2",
                        "--batch", "2", "--size", "16", "--levels", "2",
                        "--platform", "cpu"], capsys)
    assert rc == 0 and "held-out:" in out and "GEOMETRY" not in out


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--steps", "1", "--size", "16", "--levels", "2"])

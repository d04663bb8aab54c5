"""Training-step profiler with non-overlapping attribution by stage.
Counterpart of ``tools/train_prof.py``.

Times ``compile_train_step`` (one CUDA graph replayed a step on the card,
as the JAX tool times its jitted step; d``--levels`` at ``--size``, batch
``--batch``, ``--seq`` frames, bfloat16 convs, ``--cv_dtype`` cost
volumes, Adam at 1e-4, weights from seed 0, a seeded batch; ``--remat``
with ``--remat_policy``): the first step, then the best of 3 runs of
``--steps`` steps, each decoder-glue and conv-epilogue kernel's launches
a step over those runs (``ops.kernel_launches``), and the host's time in
the compiled call a step, in the whole ``train_step`` call
(``train.step``), its eager first call and its capture
(``utils.tracing``'s counters). Then it records ``PROFILED_STEPS``
replayed steps with ``utils.profiling.device_trace``
and splits their device time without overlap by the stage marks captured
into the graph (``utils.tracing``): each device time point goes to the
innermost device event open at it, and each event to the stage of the
latest mark before it: the window's frames (encoder, each level's refiner
and glue), ``loss``, ``backward`` (the whole backward), ``optimizer``
(the clip and Adam) and ``metrics``. The stages sum to the profiled
device-busy time. On the card:

  python -m m4depth_tpu_torch.tools.train_prof --steps 10

``--device cpu`` runs the steps on the CPU, whose trace holds no device
time.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time

import torch

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import (
    DTYPES,
    REMAT_POLICIES,
    ModelConfig,
    TrainConfig,
)
from m4depth_tpu_torch.models import M4Depth
from m4depth_tpu_torch.testing import train_batch
from m4depth_tpu_torch.tools.fps import (
    dispatch,
    launches,
    print_breakdown,
    print_dispatch,
)
from m4depth_tpu_torch.train import compile_train_step, make_optimizer
from m4depth_tpu_torch.utils import tracing
from m4depth_tpu_torch.utils.profiling import device_breakdown, device_trace

WARMUP_STEPS = 3
REPEATS = 3
PROFILED_STEPS = 5
ROT, TRANS = [1.0, 0.001, -0.002, 0.0005], [0.05, 0.02, 0.4]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--seq", type=int, default=4)
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--remat", action="store_true",
                   help="recompute in the backward what --remat_policy "
                        "names instead of storing it")
    p.add_argument("--remat_policy", default="dscv", choices=REMAT_POLICIES)
    p.add_argument("--cv_dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--no_profile", action="store_true")
    p.add_argument("--log_dir", default=None,
                   help="where the profile's trace goes (default: a new "
                        "temporary directory)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def run(a) -> dict:
    """The first step's and the best ms/step, the last loss, the host's
    time in the compiled call a step (``dispatch``), the glue and epilogue
    kernels' launches a step, and unless
    ``--no_profile`` the breakdown (``device_breakdown``'s result, per
    replayed step)."""
    dev = resolve_device(a.device)
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16",
                      cv_dtype=a.cv_dtype, remat=a.remat,
                      remat_policy=a.remat_policy)
    model = M4Depth(cfg, device=dev, seed=0)
    step = compile_train_step(model, make_optimizer(model, TrainConfig()))
    start = tracing.counters()
    batch = train_batch(a.batch, a.seq, a.size, 0, ROT, TRANS, dev)

    def steps(n: int) -> float:
        for _ in range(n):
            scalars = step(batch)
        return float(scalars["loss"])          # waits for the device

    t0 = time.perf_counter()
    steps(1)
    first_s = time.perf_counter() - t0
    steps(WARMUP_STEPS)
    best = float("inf")
    before, launched = tracing.counters(), launches()
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        loss = steps(a.steps)
        best = min(best, (time.perf_counter() - t0) / a.steps)
    out = dict(first_step_s=first_s, ms_per_step=1e3 * best, loss=loss,
               device=str(dev), dispatch=dispatch(
                   start, before, tracing.counters(), "train.step"),
               launches=launches(launched, REPEATS * a.steps))
    if not a.no_profile:
        log_dir = a.log_dir or tempfile.mkdtemp(prefix="m4depth_train_prof_")
        with device_trace(log_dir) as trace:
            steps(PROFILED_STEPS)
        out["trace"] = trace.path
        out["breakdown"] = device_breakdown(trace.path, PROFILED_STEPS)
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    r = run(a)
    print(f"first step (allocation, cuDNN's algorithm search): "
          f"{r['first_step_s']:.1f} s", flush=True)
    print(f"train step: {r['ms_per_step']:.1f} ms (b={a.batch} T={a.seq} "
          f"{a.size}^2 d{a.levels} bf16/{a.cv_dtype} remat={a.remat}"
          f"{':' + a.remat_policy if a.remat else ''} device={r['device']}; "
          f"best of {REPEATS} runs of {a.steps}); loss {r['loss']:.5g}",
          flush=True)
    print_dispatch(r["dispatch"], r["launches"], "step")
    if "breakdown" in r:
        bd = r["breakdown"]
        print(f"trace: {r['trace']} ({PROFILED_STEPS} replayed steps)")
        print_breakdown(bd, "step")
        if bd["n_events"]:
            print(f"  the stages sum to {sum(bd['groups'].values()):.1f} of "
                  f"{bd['busy_us']:.1f} us busy")
    return 0 if math.isfinite(r["loss"]) else 1


if __name__ == "__main__":
    sys.exit(main())

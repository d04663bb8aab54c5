"""End-to-end geometric learning check on synthetic plane sequences.
Counterpart of ``tools/synthetic_validation.py``.

Trains a model from its seeded initial weights on analytically consistent
(frames, depth, motion) scenes (``data/synthetic.py``) and reports depth
metrics. A correct geometry, cost-volume and decoder stack fits them
quickly; a geometry fault caps the accuracy it can reach.

  --mode overfit      the geometry gate: fit ONE batch (1000 steps, lr
                      2e-4, batch 4) and pass iff AbsRel < 0.10 and
                      Delta1 > 0.95 on it; exit code 1 on failure.
  --mode generalize   train on a pool of scenes (``--pool 0``: fresh scenes
                      made on the device every step) and report held-out
                      metrics; no gate.

The d``--levels`` model runs in bfloat16 at ``--size`` x ``--size``, with
Adam after a global-norm clip at 1.0, at a linear warm-up from 0 and a
cosine decay to 5% at ``--steps`` (``warmup_cosine_schedule``). The
training and the evaluation run compiled (``compile_train_step``,
``compile_windowed_eval_step``: CUDA graphs on the card), as the JAX tool
jits both. Runs on the CUDA device unless ``--platform=cpu``:

  python -m m4depth_tpu_torch.tools.synthetic_validation --mode overfit
  python -m m4depth_tpu_torch.tools.synthetic_validation --mode overfit \\
      --model m4depth-v1 --steps 1200
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Callable

import torch

WARMUP_STEPS = 200
GATE_ABS_REL = 0.10
GATE_DELTA1 = 0.95


def warmup_cosine_schedule(peak: float, steps: int,
                           warmup: int = WARMUP_STEPS,
                           end_ratio: float = 0.05) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, w, steps, end_ratio *
    peak)`` with ``w = min(warmup, steps // 2)``: a linear warm-up from 0
    over ``w`` updates, then a cosine decay to ``end_ratio * peak`` at
    ``steps``. optax refuses a decay shorter than its warm-up, so a run
    shorter than ``2 * warmup`` steps warms up over its first half."""
    w = min(warmup, steps // 2)
    decay = steps - w

    def schedule(count: int) -> float:
        if count < w:
            return peak * count / w
        t = min(count - w, decay)
        cos = 0.5 * (1 + math.cos(math.pi * t / decay))
        return peak * ((1 - end_ratio) * cos + end_ratio)

    return schedule


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="overfit",
                   choices=["overfit", "generalize"],
                   help="overfit: the geometry gate, fit ONE batch to near-"
                        "zero error; generalize: train on a pool of scenes "
                        "and report held-out metrics (no gate)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--T", type=int, default=2,
                   help="frames per training window (the reference trains "
                        "T=4)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--pool", type=int, default=320,
                   help="pregenerated training batches (cycled); 0: fresh "
                        "scenes made on the device every step")
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--model", default="m4depth",
                   choices=["m4depth", "m4depth-v1"])
    p.add_argument("--platform", default="", choices=["", "cpu", "gpu"],
                   help="gpu (the default; raises without a CUDA device) or "
                        "cpu")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.mode == "overfit":
        a.steps = a.steps or 1000
        a.lr = a.lr or 2e-4
        a.pool = 1
        a.batch = 4
    else:
        a.steps = a.steps or 15000
        a.lr = a.lr or 1e-4

    from m4depth_tpu_torch import resolve_device
    from m4depth_tpu_torch.config import ModelConfig, TrainConfig
    from m4depth_tpu_torch.data.synthetic import (
        DeviceSyntheticStream,
        SyntheticGeometricDataset,
    )
    from m4depth_tpu_torch.metrics import MetricAccumulator
    from m4depth_tpu_torch.models import M4Depth, M4DepthV1
    from m4depth_tpu_torch.train import (
        compile_train_step,
        compile_windowed_eval_step,
        make_optimizer,
    )
    from m4depth_tpu_torch.train.loop import to_device

    dev = resolve_device("cpu" if a.platform == "cpu" else "cuda")
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16")
    family = M4DepthV1 if a.model == "m4depth-v1" else M4Depth
    model = family(cfg, device=dev, seed=0)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{a.model} d{a.levels} {a.size}x{a.size} bf16, batch {a.batch}, "
          f"T={a.T}, {a.steps} steps at lr {a.lr} on {name}", flush=True)

    h = w = a.size
    train_ds = SyntheticGeometricDataset(
        n_batches=a.pool, batch_size=a.batch, T=a.T, h=h, w=w, seed=0)
    if a.pool > 0:
        print(f"pregenerating {a.pool} batches...", flush=True)
        pool = [to_device(b, dev) for b in train_ds.batches(0)]
        stream = (pool[i % len(pool)] for i in range(a.steps))
    else:
        stream = DeviceSyntheticStream(a.batch, a.T, h, w,
                                       steps_per_epoch=a.steps, seed=1234,
                                       device=dev).batches(0)

    opt = make_optimizer(model, TrainConfig(learning_rate=a.lr,
                                            grad_clip_norm=1.0))
    opt.lr_schedule = warmup_cosine_schedule(a.lr, a.steps)
    step = compile_train_step(model, opt)

    t0 = time.perf_counter()
    for i, batch in enumerate(stream):
        out = step(batch)
        if i % 25 == 0:
            loss = out["loss"].item()  # bounds the queue of launches
        if i % 250 == 0:
            print(f"step {i}: loss={loss:.4f} "
                  f"RMSE_log={out['RMSE_log'].item():.4f}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"trained {a.steps} steps in {time.perf_counter() - t0:.1f}s",
          flush=True)

    if a.mode == "overfit":
        eval_ds = train_ds  # the gate: near-zero error on the fitted batch
    else:
        eval_ds = SyntheticGeometricDataset(
            n_batches=8, batch_size=a.batch, T=a.T, h=h, w=w, seed=7777)
    eval_step = compile_windowed_eval_step(model)
    acc = MetricAccumulator.zeros(dev)
    with torch.no_grad():
        for batch in eval_ds.batches(0):
            acc = eval_step(to_device(batch, dev), acc)
    results = {k: float(v) for k, v in acc.result().items()}
    label = "fitted-batch" if a.mode == "overfit" else "held-out"
    print(f"{label}:", {k: round(v, 4) for k, v in results.items()},
          flush=True)
    if a.mode == "overfit":
        ok = (results["AbsRel"] < GATE_ABS_REL
              and results["Delta1"] > GATE_DELTA1)
        print("GEOMETRY VALIDATION", "PASSED" if ok else "FAILED", flush=True)
        return 0 if ok else 1
    print("generalization study (no gate)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

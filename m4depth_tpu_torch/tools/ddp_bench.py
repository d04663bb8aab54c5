"""Data-parallel training across the cards of one host, under a launcher,
one rank a card (NCCL; gloo with ``--device=cpu``):

  python -m torch.distributed.run --nproc_per_node=4 \\
      -m m4depth_tpu_torch.tools.ddp_bench

Each rank runs one float32 step of d6 at CHECK_SIZE through
``train.data_parallel`` on its slice of a global batch, which rank 0 holds
against one process's step on the whole batch (``testing.
assert_step_close``); then the training cell (d6 at ``--size``, b=3 a
rank, T=4, bf16, Adam 1e-4) in turns with the plain step on the same card
(plain, data parallel, data parallel, plain: ms/step, the median of
STEPS), and a profile of one data-parallel step (the NCCL kernels' device
time). Rank 0 prints one line per rank.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.models import M4Depth
from m4depth_tpu_torch.testing import (
    assert_step_close,
    float32_step,
    train_batch,
)
from m4depth_tpu_torch.train import (
    data_parallel,
    make_optimizer,
    make_train_step,
)

LR = 1e-4
# the float32 check step: frames (d6 needs >= 128), window length, the
# seeds of the weights and of the batch
CHECK_SIZE, CHECK_T, CHECK_SEEDS = 128, 3, (3, 12)
BATCH, T, STEPS = 3, 4, 10  # the training cell's windows a rank; steps timed
# mostly lateral motion: a well-conditioned depth recurrence
ROT, TRANS = [1.0, 0.001, -0.002, 0.001], [0.3, 0.1, 0.02]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--size", type=int, default=384)
    return p.parse_args(argv)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_name(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def timed_steps(step, batch, n: int, dev) -> list:
    step(batch)
    sync(dev)
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def train(a) -> int:
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from m4depth_tpu_torch.parallel import (
        distributed_init,
        local_batch,
        make_mesh,
    )

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    distributed_init(f"{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}", world, rank, device=dev)
    try:
        mesh = make_mesh()

        def wrap(model):
            return data_parallel(model, mesh)

        gb = train_batch(2 * world, CHECK_T, CHECK_SIZE, CHECK_SEEDS[1], ROT,
                         TRANS, dev)
        got = float32_step(dev, local_batch(gb, mesh), CHECK_SEEDS[0], LR,
                           wrap)
        if rank == 0:
            ref = float32_step(dev, gb, CHECK_SEEDS[0], LR)
            res = assert_step_close(got, ref, LR, "the data-parallel step")
            print(f"float32 step, d6 {CHECK_SIZE}x{CHECK_SIZE} T={CHECK_T}, "
                  f"local b=2 on {world} ranks, against one process on b="
                  f"{2 * world}: loss {got['scalars']['loss']:.7f} against "
                  f"{ref['scalars']['loss']:.7f}; largest |grad - ref| as a "
                  "share of its tolerance "
                  f"{next(iter(res['shares'].values())):.3e}", flush=True)

        cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
        batch = train_batch(BATCH, T, a.size, rank, ROT, TRANS, dev)
        ms = {"plain": [], "ddp": []}
        for name in ("plain", "ddp", "ddp", "plain"):
            model = M4Depth(cfg, device=dev, seed=0)
            step = make_train_step(
                model if name == "plain" else wrap(model),
                make_optimizer(model, TrainConfig(learning_rate=LR)))
            ms[name].append(statistics.median(
                timed_steps(step, batch, STEPS, dev)))
            if name == "ddp":
                ddp_step = step
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                        else [])) as prof:
            t0 = time.perf_counter()
            ddp_step(batch)
            sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        comm_us = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
            for e in prof.key_averages()
            if "nccl" in e.key.lower() and e.device_type == DeviceType.CUDA)
        mine = dict(rank=rank, device=str(dev), plain=ms["plain"],
                    ddp=ms["ddp"], wall_us=wall_us, comm_us=comm_us)
        found = [None] * world
        dist.all_gather_object(found, mine)
        if rank == 0:
            name = card_name(dev)
            for r in found:
                plain = sum(r["plain"]) / 2
                ddp = sum(r["ddp"]) / 2
                print(f"[{name}] rank {r['rank']} of {world} ({r['device']}"
                      f"), d6 {a.size}x{a.size} b={BATCH} a rank T={T} "
                      "bf16: "
                      "data parallel "
                      f"{', '.join(f'{v:.3f}' for v in r['ddp'])} ms/step, "
                      "plain on the same card "
                      f"{', '.join(f'{v:.3f}' for v in r['plain'])} in turns "
                      f"({100 * (ddp / plain - 1):+.2f}%); "
                      f"{1e3 * BATCH * world / ddp:.2f} windows/s across "
                      f"the {world} ranks; NCCL kernels {r['comm_us']:.1f} "
                      f"us of device time in a profiled step of "
                      f"{r['wall_us']:.1f} us", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    return train(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())

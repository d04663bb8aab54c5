"""Fresh-frame streaming: ms/frame with each frame's host-to-device copy.
Counterpart of ``tools/fresh_frame_bench.py``.

The online use case feeds one camera frame at a time: every frame is a
distinct host array that must reach the device before its step. Five loop
shapes are timed, each over ``--frames`` frames in BLOCKS blocks
(ms/frame: the median of the blocks, with the smallest and largest), each
through its own compiled step (``parallel.serving.compile_step``: a CUDA
graph on the card, as the JAX tool jits its steps):

  * serial    -- copy the frame (and its motion) to the device, step;
  * pipelined -- ``parallel.FreshFrameStream``: frame t's copy from pinned
    memory on a side stream, under frame t-1's step;
  * u8        -- the frame copied as uint8 and cast on the device;
  * delayed   -- frame t's depth read only after frame t+1's step is
    launched;
  * kblock    -- 16 copies, then 16 steps.

``--consume every`` reads each depth back to the host (the online predict
loop); ``last`` only at the end of each block. The host frames come from a
pool of 32 distinct arrays. Defaults: d6 at 384x384, b=1, bf16 compute, on
the card, with weights from seed 0:

  python -m m4depth_tpu_torch.tools.fresh_frame_bench --frames 200
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.parallel import FreshFrameStream, compile_step

VARIANTS = ("serial", "pipelined", "u8", "delayed", "kblock")
KBLOCK = 16
POOL = 32
BLOCKS = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--consume", choices=("every", "last"), default="every")
    p.add_argument("--variant", choices=VARIANTS + ("all",), default="all")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def make_bench(a):
    """``{variant: run(first, n) -> last depth}``: each loop over frames
    [first, first + n)."""
    dev = resolve_device(a.device)
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16")
    model = M4Depth(cfg, device=dev, seed=0)
    b, hw = 1, a.size
    rng = np.random.RandomState(0)
    pool = [rng.rand(b, hw, hw, 3).astype(np.float32)
            for _ in range(min(a.frames, POOL))]
    pool_u8 = [(f * 255).astype(np.uint8) for f in pool]
    rot = np.tile(np.array([[1.0, 0.001, -0.002, 0.0005]], np.float32),
                  (b, 1))
    trans = np.tile(np.array([[0.05, 0.02, 0.4]], np.float32), (b, 1))
    f = np.full((b, 2), hw / 2.0, np.float32)
    cam = Camera(f, f.copy())
    go = np.zeros((b,), bool)
    every = a.consume == "every"

    def put(x):
        return torch.from_numpy(x).to(dev)

    def motion():
        return (put(rot), put(trans), Camera(put(cam.f), put(cam.c)),
                put(go))

    def read(depth):
        return depth.float().cpu().numpy()

    # each loop carries its own model state across its blocks
    states = {name: init_state(cfg, b, hw, hw, device=dev)
              for name in ("serial", "u8", "delayed", "kblock")}
    # one compiled step a loop: each donates its own loop's state
    steps = {name: compile_step(model) for name in states}
    sess = FreshFrameStream(model, init_state(cfg, b, hw, hw, device=dev),
                            device=dev)

    def stepped(name, rgb):
        states[name], depth = steps[name](states[name], rgb, *motion())
        return depth

    def serial(first, n):
        for i in range(first, first + n):
            depth = stepped("serial", put(pool[i % len(pool)]))
            if every:
                read(depth)
        return depth

    def pipelined(first, n):
        depth = None
        for i in range(first, first + n):
            d = sess.push(pool[i % len(pool)], rot, trans, cam, go)
            if d is not None:
                depth = d
                if every:
                    read(d)
        return depth

    def u8(first, n):
        for i in range(first, first + n):
            rgb = put(pool_u8[i % len(pool)]).float() / 255.0
            depth = stepped("u8", rgb)
            if every:
                read(depth)
        return depth

    def delayed(first, n):
        prev = None
        for i in range(first, first + n):
            depth = stepped("delayed", put(pool[i % len(pool)]))
            if prev is not None and every:
                read(prev)
            prev = depth
        return prev

    def kblock(first, n):
        for k in range(first, first + n, KBLOCK):
            rgbs = [put(pool[i % len(pool)])
                    for i in range(k, min(k + KBLOCK, first + n))]
            for rgb in rgbs:
                depth = stepped("kblock", rgb)
            if every:
                read(depth)
        return depth

    return dict(serial=serial, pipelined=pipelined, u8=u8, delayed=delayed,
                kblock=kblock), dev


def main(argv=None) -> int:
    a = parse_args(argv)
    runs, dev = make_bench(a)
    names = VARIANTS if a.variant == "all" else (a.variant,)
    per_block = max(a.frames // BLOCKS, 1)
    for name in names:
        run = runs[name]
        run(0, 2)  # warm-up: the first launches and allocations
        block_ms = []
        for blk in range(BLOCKS):
            t0 = time.perf_counter()
            run(blk * per_block, per_block).float().cpu()
            block_ms.append((time.perf_counter() - t0) * 1e3 / per_block)
        med = statistics.median(block_ms)
        print(f"{name}: {med:.4f} ms/frame median of {BLOCKS} blocks of "
              f"{per_block} (min {min(block_ms):.4f}, max "
              f"{max(block_ms):.4f}); {1e3 / med:.2f} frames/s; "
              f"consume={a.consume} size={a.size} levels={a.levels} "
              f"device={dev}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

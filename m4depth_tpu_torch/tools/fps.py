"""Streaming frames per second of the compiled ``M4Depth.step``, with an
optional device-time breakdown by component. Counterpart of
``tools/fps.py``.

The d``--levels`` model (bfloat16 convs, ``--cv_dtype`` cost volumes,
weights from seed 0) streams one frame after another at ``--size`` (or
``--height`` x ``--width``), batch ``--batch``, under bench.py's motion
(``--trans`` sets the translation, and with it the epipolar field),
through ``parallel.serving.compile_step`` (one CUDA graph replayed a frame
on the card, as the JAX tool times its jitted step). After 10 frames of
warm-up, the best of 3 runs of ``--n`` frames, each ending in a
synchronise, gives ms/frame and frames/s.

``--profile`` then records ``PROFILED_FRAMES`` frames of the eager
``M4Depth.step`` (a replay has no Python stack to attribute its kernels
by) with ``utils.profiling.device_trace`` (with the Python stack) and
splits their device time by component: the cost-volume kernels by name
(``sncv``, ``dscv``), the other kernels by the module they were launched
under (``encoder``, ``refiner``), else ``other``; and lists the kernels
that take most, with the aten op that launched each. On the card:

  python -m m4depth_tpu_torch.tools.fps --n 200 --profile

``--device cpu`` runs the same loop on the CPU, whose trace holds no
device time.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import DTYPES, ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.parallel.serving import compile_step
from m4depth_tpu_torch.utils.profiling import device_breakdown, device_trace

WARMUP_FRAMES = 10
REPEATS = 3
PROFILED_FRAMES = 10
TOP_OPS = 16


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trans", default="0.05,0.02,0.4",
                   help="camera translation (sets the epipolar field the "
                        "DSCV samples along)")
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--height", type=int, default=0,
                   help="overrides --size for non-square frames (KITTI "
                        "256x768)")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--cv_dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--log_dir", default=None,
                   help="where --profile writes its trace (default: a new "
                        "temporary directory)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def make_stream(a):
    """(run(n, new_traj, eager) -> last depth, device): ``n`` streamed
    frames of the compiled step (``eager``: of ``M4Depth.step``), the
    recurrent state carried across calls."""
    dev = resolve_device(a.device)
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16",
                      cv_dtype=a.cv_dtype)
    model = M4Depth(cfg, device=dev, seed=0)
    b, h, w = a.batch, a.height or a.size, a.width or a.size
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32)).to(dev)
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.0005]] * b, device=dev)
    trans = torch.tensor([[float(x) for x in a.trans.split(",")]] * b,
                         device=dev)
    f = torch.full((b, 2), min(h, w) / 2.0, device=dev)
    c = torch.tensor([[w / 2.0, h / 2.0]] * b, device=dev)
    cam = Camera(f, c)
    go = torch.zeros((b,), dtype=torch.bool, device=dev)
    start = torch.ones((b,), dtype=torch.bool, device=dev)
    holder = dict(state=init_state(cfg, b, h, w, device=dev))
    compiled = compile_step(model)

    @torch.no_grad()
    def run(n: int, new_traj: bool = False, eager: bool = False):
        step = model.step if eager else compiled
        for i in range(n):
            nt = start if new_traj and i == 0 else go
            holder["state"], depth = step(holder["state"], rgb, rot, trans,
                                          cam, nt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return depth

    return run, dev


def print_breakdown(r: dict, groups: dict, unit: str) -> None:
    """A ``device_breakdown`` result ``r``: its busy time, ``groups`` (us
    by name) and the top kernels."""
    if not r["n_events"]:
        print("device time: not measured (the trace holds no device events: "
              "no CUDA device in this run)")
        return
    busy = r["busy_us"]
    print(f"device busy {busy:.1f} us/{unit} ({r['n_events']} device "
          "events in the trace)")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us:10.1f} us {100 * us / busy:5.1f}%  {name}")
    print("  -- top kernels (launching aten op) --")
    for (name, op), us in sorted(r["ops"].items(),
                                 key=lambda kv: -kv[1])[:TOP_OPS]:
        print(f"  {us:10.1f} us {100 * us / busy:5.1f}%  {name} ({op or '-'})")


def components(r: dict) -> dict:
    """The groups summed over direction: {component: us}."""
    out = {}
    for (_, comp), us in r["groups"].items():
        out[comp] = out.get(comp, 0.0) + us
    return out


def run(a) -> dict:
    """ms/frame and frames/s, and with ``--profile`` the breakdown (us a
    frame by component, and ``device_breakdown``'s result)."""
    stream, dev = make_stream(a)
    depth = stream(1, new_traj=True)
    stream(WARMUP_FRAMES)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        depth = stream(a.n)
        best = min(best, time.perf_counter() - t0)
    out = dict(ms_per_frame=1e3 * best / a.n, fps=a.n * a.batch / best,
               finite=bool(torch.isfinite(depth).all()), device=str(dev))
    if a.profile:
        log_dir = a.log_dir or tempfile.mkdtemp(prefix="m4depth_fps_")
        with device_trace(log_dir, with_stack=True) as trace:
            stream(PROFILED_FRAMES, eager=True)
        out["trace"] = trace.path
        out["breakdown"] = device_breakdown(trace.path, PROFILED_FRAMES)
        out["components_us"] = components(out["breakdown"])
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    r = run(a)
    h, w = a.height or a.size, a.width or a.size
    print(f"fps={r['fps']:.2f}  ms/frame={r['ms_per_frame']:.3f}  "
          f"batch={a.batch} size={h}x{w} levels={a.levels} "
          f"cv_dtype={a.cv_dtype} device={r['device']} (best of {REPEATS} "
          f"runs of {a.n} frames)", flush=True)
    if a.profile:
        print(f"trace: {r['trace']} (the eager step: a CUDA graph's replay "
              "has no Python stack to attribute kernels by)")
        print_breakdown(r["breakdown"], r["components_us"], "frame")
    return 0 if r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Streaming frames per second of the compiled ``M4Depth.step``, with an
optional device-time breakdown by stage. Counterpart of ``tools/fps.py``.

The d``--levels`` model (``--model``: M4Depth or M4Depth-V1; bfloat16
convs, ``--cv_dtype`` cost volumes, weights from seed 0) streams one
frame after another at ``--size`` (or ``--height`` x ``--width``), batch
``--batch``, under bench.py's motion (``--trans`` sets the translation,
and with it the epipolar field), through ``parallel.serving.compile_step``
(one CUDA graph replayed a frame on the card, as the JAX tool times its
jitted step). After 10 frames of warm-up, the best of 3 runs of ``--n``
frames, each ending in a synchronise, gives ms/frame and frames/s; each
decoder-glue kernel's and conv-epilogue kernel's launches a frame over
those runs come from ``ops.kernel_launches``, the host's time in the
compiled call a frame from ``utils.tracing``'s ``compiled.replays``
counter (prepare, launch, finish), and the eager first call's and the
capture's from ``compiled.warmups`` and ``compiled.captures``.

``--profile`` then records ``PROFILED_FRAMES`` replayed frames with
``utils.profiling.device_trace`` and splits their device time by the
stage marks captured into the graph (``utils.tracing``): the encoder, each
decoder level's refiner and glue, the output; then each stage's span from
its mark to the next over the complete replays, the graph's span and the
gaps inside it; and the kernels that take most, with their stage. On the
card:

  python -m m4depth_tpu_torch.tools.fps --n 200 --profile

``--device cpu`` runs the same loop on the CPU, whose trace holds no
device time.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import DTYPES, ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, M4DepthV1, init_state
from m4depth_tpu_torch.ops import kernel_launches
from m4depth_tpu_torch.parallel.serving import compile_step
from m4depth_tpu_torch.utils import tracing
from m4depth_tpu_torch.utils.profiling import device_breakdown, device_trace

WARMUP_FRAMES = 10
REPEATS = 3
PROFILED_FRAMES = 10
TOP_OPS = 16
FAMILIES = {"m4depth": M4Depth, "m4depth-v1": M4DepthV1}
# the hand-written kernels whose launches a frame or step the tools print,
# by family: the prefix of their C entry points
LAUNCH_FAMILIES = {"glue": "glue", "conv epilogue": "conv_epilogue"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trans", default="0.05,0.02,0.4",
                   help="camera translation (sets the epipolar field the "
                        "DSCV samples along)")
    p.add_argument("--model", choices=sorted(FAMILIES), default="m4depth")
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
    """(run(n, new_traj) -> last depth, device): ``n`` streamed frames of
    the compiled step, the recurrent state carried across calls."""
    dev = resolve_device(a.device)
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16",
                      cv_dtype=a.cv_dtype)
    model = FAMILIES[a.model](cfg, device=dev, seed=0)
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
    def run(n: int, new_traj: bool = False):
        for i in range(n):
            nt = start if new_traj and i == 0 else go
            holder["state"], depth = compiled(holder["state"], rgb, rot,
                                              trans, cam, nt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return depth

    return run, dev


def print_breakdown(r: dict, unit: str) -> None:
    """A ``device_breakdown`` result ``r``: its busy time by stage (the
    decoder's refiner and glue stages as a table of levels), the marked
    units' spans, and the top kernels."""
    if not r["n_events"]:
        print("device time: not measured (the trace holds no device events: "
              "no CUDA device in this run)")
        return
    busy = r["busy_us"]
    print(f"device busy {busy:.1f} us/{unit} ({r['n_events']} device "
          "events in the trace), by stage:")
    levels = {}
    for stage, us in r["groups"].items():
        level, kind = tracing.stage_of_level(stage)
        if level is not None:
            levels.setdefault(level, {})[kind] = us
    for stage, us in sorted(r["groups"].items(), key=lambda kv: -kv[1]):
        if tracing.stage_of_level(stage)[0] is None:
            print(f"  {us:10.1f} us {100 * us / busy:5.1f}%  {stage}")
    if levels:
        print("  level    refiner us      glue us   (glue<k>: level k after "
              "its refiner, level k-1 up to its own)")
        for level in sorted(levels, reverse=True):
            ref, glue = (levels[level].get(k, 0.0)
                         for k in ("refiner", "glue"))
            print(f"  {level:5d} {ref:12.1f} {glue:12.1f}")
    u = r["units"]
    if u.get("complete"):
        print(f"  marked units: {u['complete']} complete of {u['seen']}; "
              f"span {u['span_us']:.1f} us, busy {u['busy_us']:.1f} us, "
              f"gaps inside {u['gap_pct']:.2f}%")
    else:
        print(f"  marked units: none complete of {u['seen']}")
    print("  -- top kernels (stage) --")
    for (name, stage), us in sorted(r["ops"].items(),
                                    key=lambda kv: -kv[1])[:TOP_OPS]:
        print(f"  {us:10.1f} us {100 * us / busy:5.1f}%  {name} ({stage})")


def launches(since: Optional[dict] = None, calls: int = 1) -> dict:
    """``ops.kernel_launches`` of each of ``LAUNCH_FAMILIES``, by family:
    so far, or since ``since`` (an earlier result) over ``calls``."""
    return {family: kernel_launches(prefix, since and since[family], calls)
            for family, prefix in LAUNCH_FAMILIES.items()}


def print_dispatch(d: dict, launched: dict, unit: str) -> None:
    """Each family's kernel launches a ``unit`` (``launches``), the host's
    time in the compiled call a ``unit``, and the warm-up's and the
    capture's (``dispatch``)."""
    for family, counts in launched.items():
        print(f"{family} kernel launches a {unit} over the timed calls: "
              + ", ".join(f"{name} {n:g}" for name, n in counts.items()))
    if d.get("ns") is None:
        print("host time in the compiled call: no replay timed")
        return
    print(f"host time in the compiled call: {d['ns']:.1f} us/{unit} "
          f"(prepare {d['prepare_ns']:.1f}, launch {d['launch_ns']:.1f}, "
          f"finish {d['finish_ns']:.1f}); its eager first call "
          f"{1e-3 * d['warm_up']:.1f} ms, its capture {1e-3 * d['capture']:.1f}"
          " ms")
    if d.get("entry") is not None:
        print(f"host time in the whole step call: {d['entry']:.1f} us/{unit}")


def dispatch(start: dict, before: dict, after: dict,
             entry: Optional[str] = None) -> dict:
    """From three ``tracing.counters()`` snapshots (before the first
    call, before the timed calls, after them): the ``compiled.replays``
    counter's mean host time a timed replay, by part, the mean
    ``compiled.warmups`` and ``compiled.captures`` call since the start,
    and with ``entry`` that counter's mean timed call (us; None where no
    such call ran)."""
    out = {key: tracing.mean_us(after, "compiled.replays", before, key)
           for key in ("ns", "prepare_ns", "launch_ns", "finish_ns")}
    out.update(warm_up=tracing.mean_us(after, "compiled.warmups", start),
               capture=tracing.mean_us(after, "compiled.captures", start),
               entry=entry and tracing.mean_us(after, entry, before))
    return out


def run(a) -> dict:
    """ms/frame and frames/s, the host's time in the compiled call a frame
    (``dispatch``), the glue and epilogue kernels' launches a frame, and with
    ``--profile`` ``device_breakdown``'s result over replayed frames."""
    stream, dev = make_stream(a)
    start = tracing.counters()
    depth = stream(1, new_traj=True)
    stream(WARMUP_FRAMES)
    best = float("inf")
    before, launched = tracing.counters(), launches()
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        depth = stream(a.n)
        best = min(best, time.perf_counter() - t0)
    out = dict(ms_per_frame=1e3 * best / a.n, fps=a.n * a.batch / best,
               finite=bool(torch.isfinite(depth).all()), device=str(dev),
               dispatch=dispatch(start, before, tracing.counters()),
               launches=launches(launched, REPEATS * a.n))
    if a.profile:
        log_dir = a.log_dir or tempfile.mkdtemp(prefix="m4depth_fps_")
        with device_trace(log_dir) as trace:
            stream(PROFILED_FRAMES)
        out["trace"] = trace.path
        out["breakdown"] = device_breakdown(trace.path, PROFILED_FRAMES)
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    r = run(a)
    h, w = a.height or a.size, a.width or a.size
    print(f"fps={r['fps']:.2f}  ms/frame={r['ms_per_frame']:.3f}  "
          f"model={a.model} batch={a.batch} size={h}x{w} levels={a.levels} "
          f"cv_dtype={a.cv_dtype} device={r['device']} (best of {REPEATS} "
          f"runs of {a.n} frames)", flush=True)
    print_dispatch(r["dispatch"], r["launches"], "frame")
    if a.profile:
        print(f"trace: {r['trace']} ({PROFILED_FRAMES} replayed frames)")
        print_breakdown(r["breakdown"], "frame")
    return 0 if r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())

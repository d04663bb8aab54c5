#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``m4depth_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``m4depth_tpu_torch/ops/csrc`` with ``nvcc``
and then runs these phases in order; each raises on failure, so the script
exits non-zero and prints no result line:

1. environment: the card's name and power limit, the torch and CUDA
   versions, the kernels' build time and ``ptxas`` resource use;
2. each kernel against its plain PyTorch version on the card, at the six
   decoder-level shapes of the d6 model at 384x384 (b=1), in float32 and
   in bfloat16;
3. the d6 model at 128x128 (b=2, 3 frames, one per-element reset) on the
   card (kernels) against the same weights on the CPU (plain versions),
   in float32;
4. the main path: streaming ``M4Depth.step`` of the d6 model at 384x384,
   b=1, bfloat16 compute, with seeded random weights; ms/frame over 5
   timed blocks, peak memory, and each kernel's launches (6 per frame);
5. a ``torch.profiler`` window over main-path frames: device time by
   kernel and the device's busy share;
6. each kernel's device time at each level shape, beside its plain
   version's time and its bound;
7. one JSON line listing both kernels, then the result line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before running anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera, scale_camera
from m4depth_tpu_torch.models import M4Depth, init_state, level_shape
from m4depth_tpu_torch.ops import (
    DSCV_KERNEL,
    KERNELS,
    SNCV_KERNEL,
    _build,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)

# H100 SXM published peaks: HBM3 bandwidth, and float32 outside the tensor
# cores (both kernels multiply and add float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SIZE = 384            # the main path: d6 at 384x384, b=1 (bench.py)
FOCAL = 192.0         # f = c = 192 px at 384x384 (bench.py)
ROT = [1.0, 0.001, -0.002, 0.0005]      # bench.py's motion
TRANS = [0.05, 0.02, 0.4]

WARMUP_FRAMES = 10
TIMED_BLOCKS = 5
FRAMES_PER_BLOCK = 50
PROFILED_FRAMES = 10

# Tolerances of the kernel-vs-plain checks (phase 2). Both sides round
# their inputs to the same dtype and multiply and add in float32.
#   SNCV: the same products summed in another order (and with FMA):
#     float32 rounding of sums of at most 24 terms of size <= 1.
#   DSCV: the kernel computes each sample position inline, the plain version
#     through tensor ops; positions differ by a few float32 ulps of a pixel
#     coordinate (< 1.2e-4 px below 512). Bilinear sampling is continuous
#     in the position, so outputs differ by at most that times their
#     per-pixel slope: 2/cc for the per-cut mean of unit cuts, and up to
#     the random parallax map's step (<= 4 per px here) for the parallax.
TOL = {
    "sncv": dict(rtol=1e-5, atol=1e-6),
    "dscv_cv": dict(rtol=1e-4, atol=2e-5),
    "dscv_para": dict(rtol=1e-4, atol=5e-4),
}
# Phase 3: the card runs the kernels and cuDNN (TF32 off), the CPU the plain
# versions. Under the mostly lateral motion used there the recurrence is
# well conditioned (depth 1-3 m, no parallax near zero), so op-level
# float32 differences of ~1e-4 stay ~1e-4 in depth.
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)

SPATIAL_SEARCH = 3    # SNCV 7x7 window
DEPTH_SEARCH = 4      # DSCV 9 hypotheses
LEAKY = 0.1


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    """Raise unless ``ok``: the script's checks survive ``python -O``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- phase 1 ----------------------------------------------------------------


def phase_environment() -> None:
    log(gpu_name_and_power_limit())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s "
        f"(one nvcc per source, in parallel): "
        + ", ".join(p.name for p in libs.values()))
    for src in libs:
        build_log = _build.BUILD_DIR / f"{src.rsplit('.', 1)[0]}.log"
        if build_log.exists():
            for line in build_log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {src}: {line.strip()}")


# -- level shapes and inputs --------------------------------------------------


def level_specs(cfg: ModelConfig):
    """(level, h, w, C, cuts, camera) for each decoder level of the main
    path, finest first."""
    f = torch.full((1, 2), FOCAL)
    cam = Camera(f, f.clone())
    specs = []
    for idx in range(cfg.num_levels):
        h, w = level_shape(SIZE, SIZE, idx)
        specs.append((idx + 1, h, w, cfg.channels[idx], cfg.num_cuts(idx + 1),
                      scale_camera(cam, 2.0 ** (idx + 1))))
    return specs


def unit_cuts(g: torch.Generator, shape, cuts: int) -> torch.Tensor:
    """Random features, L2-normalised per cut as the model feeds both ops."""
    b, h, w, C = shape
    x = torch.randn(b, h, w, cuts, C // cuts, generator=g)
    x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return x.reshape(shape)


def op_inputs(spec, dev, seed: int):
    """Inputs of one level's SNCV and DSCV, made on the CPU from a seed."""
    _, h, w, C, cuts, cam = spec
    g = torch.Generator().manual_seed(seed)
    c1 = unit_cuts(g, (1, h, w, C), cuts)
    c2 = unit_cuts(g, (1, h, w, C), cuts)
    para = torch.rand(1, h, w, 1, generator=g) * 3.0 + 0.1
    # sweep centres in [0.5, 4.5], and some far out so that samples fall
    # past the border and the clamp is exercised
    centre = torch.rand(1, h, w, 1, generator=g) * 4.0 + 0.5
    centre[:, ::5, ::7] = 150.0
    out = dict(c1=c1, c2=c2, para=para, centre=centre,
               rot=torch.tensor([ROT]), trans=torch.tensor([TRANS]),
               f=cam.f, c=cam.c)
    return {k: v.to(dev).contiguous() for k, v in out.items()}


def dscv_args(x, dtype, rot=None):
    return (x["c1"].to(dtype), x["c2"].to(dtype), x["para"], x["centre"],
            x["rot"] if rot is None else rot, x["trans"],
            Camera(x["f"], x["c"]), DEPTH_SEARCH)


# -- phase 2 ----------------------------------------------------------------


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_kernels_vs_plain(cfg: ModelConfig, dev) -> dict:
    """Each kernel against its plain version at every level shape, in
    float32 and bfloat16; returns the largest error seen per kernel."""
    worst = {"sncv": 0.0, "dscv": 0.0}
    for spec in level_specs(cfg):
        level, h, w, C, cuts = spec[:5]
        x = op_inputs(spec, dev, seed=level)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            c1, c2 = x["c1"].to(dtype), x["c2"].to(dtype)
            errs = []
            # the model's autocorrelation, and a cross-correlation
            for a, b in ((c1, c1), (c1, c2)):
                out = spatial_cost_volume_fused(a, b, SPATIAL_SEARCH, cuts,
                                                dtype, LEAKY)
                ref = spatial_cost_volume(a, b, SPATIAL_SEARCH, cuts, dtype,
                                          LEAKY)
                torch.cuda.synchronize()
                check(out.shape == (1, h, w, 49 * cuts), f"sncv {out.shape}")
                torch.testing.assert_close(out, ref, **TOL["sncv"])
                errs.append(max_err(out, ref))
            worst["sncv"] = max(worst["sncv"], *errs)
            # the main path's quaternion, and the small-angle form
            d_errs = []
            for rot in (x["rot"], x["rot"][:, 1:]):
                args = dscv_args(x, dtype, rot)
                cv, para = parallax_sweeping_cv_fused(*args, cuts, dtype)
                cv_ref, para_ref = parallax_sweeping_cv(*args, cuts, dtype)
                torch.cuda.synchronize()
                check(cv.shape == (1, h, w, 9 * cuts)
                      and para.shape == (1, h, w, 1),
                      f"dscv {cv.shape} {para.shape}")
                torch.testing.assert_close(cv, cv_ref, **TOL["dscv_cv"])
                torch.testing.assert_close(para, para_ref, **TOL["dscv_para"])
                d_errs.append((max_err(cv, cv_ref), max_err(para, para_ref)))
            worst["dscv"] = max(worst["dscv"], *(e for p in d_errs for e in p))
            log(f"  level {level} {h}x{w} C={C} cuts={cuts} {name}: "
                f"sncv max|err| {errs[0]:.3e} (c1 is c2), {errs[1]:.3e} "
                f"(c1 != c2); dscv cv, parallax max|err| "
                f"{d_errs[0][0]:.3e}, {d_errs[0][1]:.3e} (quaternion), "
                f"{d_errs[1][0]:.3e}, {d_errs[1][1]:.3e} (small angle)")
    return worst


# -- phase 3 ----------------------------------------------------------------


def phase_model_card_vs_cpu(dev) -> None:
    """d6 at 128x128, b=2, 3 frames, element 0 reset at frame 2: depth from
    the card (kernels) against the CPU (plain versions), same weights."""
    cfg = ModelConfig(compute_dtype="float32", cv_dtype="float32")
    b, hw = 2, 128
    g = torch.Generator().manual_seed(11)
    frames = [torch.rand(b, hw, hw, 3, generator=g) for _ in range(3)]
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
    f = torch.full((b, 2), hw / 2.0)
    models = {d: M4Depth(cfg, device=d, seed=2) for d in ("cpu", dev)}
    states = {d: init_state(cfg, b, hw, hw, device=d) for d in models}
    before = {k: kern.launches for k, kern in KERNELS.items()}
    for t in range(3):
        new_traj = torch.tensor([t in (0, 2), t == 0])
        depth = {}
        for d, m in models.items():
            states[d], depth[d] = m.step(
                states[d], frames[t].to(d), rot.to(d), trans.to(d),
                Camera(f.to(d), f.to(d)), new_traj.to(d))
        card = depth[dev].cpu()
        check(card.shape == (b, hw, hw, 1)
              and bool(torch.isfinite(card).all()),
              f"card depth {card.shape}, finite")
        torch.testing.assert_close(card, depth["cpu"], **MODEL_TOL)
        log(f"  frame {t}: max|depth card - cpu| {max_err(card, depth['cpu']):.3e}"
            f" (depth {depth['cpu'].min().item():.4g}.."
            f"{depth['cpu'].max().item():.4g})")
    for k, kern in KERNELS.items():
        n = kern.launches - before[k]
        check(n == 3 * cfg.num_levels, f"{k}: {n} launches in 3 frames")


# -- phase 4 ----------------------------------------------------------------


def main_path_inputs(dev):
    g = torch.Generator().manual_seed(0)
    rgb = torch.rand(1, SIZE, SIZE, 3, generator=g).to(dev)
    f = torch.full((1, 2), FOCAL, device=dev)
    return dict(rgb=rgb, rot=torch.tensor([ROT], device=dev),
                trans=torch.tensor([TRANS], device=dev),
                camera=Camera(f, f.clone()))


def phase_main_path(dev):
    """Streaming d6 384x384 bf16. The launch counts are zeroed just before
    the first frame and read just after the last one."""
    cfg = ModelConfig(compute_dtype="bfloat16")
    model = M4Depth(cfg, device=dev, seed=0)
    x = main_path_inputs(dev)
    go = torch.zeros(1, dtype=torch.bool, device=dev)
    reset = torch.ones(1, dtype=torch.bool, device=dev)

    def frame(state, new_traj):
        return model.step(state, x["rgb"], x["rot"], x["trans"], x["camera"],
                          new_traj)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    state = init_state(cfg, 1, SIZE, SIZE, device=dev)
    state, depth = frame(state, reset)
    for _ in range(WARMUP_FRAMES):
        state, depth = frame(state, go)
    torch.cuda.synchronize()
    block_ms = []
    for _ in range(TIMED_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(FRAMES_PER_BLOCK):
            state, depth = frame(state, go)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3 / FRAMES_PER_BLOCK)
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    n_frames = 1 + WARMUP_FRAMES + TIMED_BLOCKS * FRAMES_PER_BLOCK
    check(depth.shape == (1, SIZE, SIZE, 1), f"depth shape {depth.shape}")
    check(bool(torch.isfinite(depth).all()), "finite depth on the main path")
    for k, n in launches.items():
        check(n == cfg.num_levels * n_frames,
              f"{k}: {n} launches in {n_frames} frames, expected "
              f"{cfg.num_levels} per frame")
    med = statistics.median(block_ms)
    log(f"  {n_frames} frames; ms/frame median {med:.4f} "
        f"(blocks {', '.join(f'{v:.4f}' for v in block_ms)}; "
        f"min {min(block_ms):.4f}, max {max(block_ms):.4f}); "
        f"{1e3 / med:.2f} frames/s")
    log(f"  peak device memory {peak} bytes ({peak / 2**20:.1f} MiB)")
    log(f"  launches: " + ", ".join(
        f"{k} {n} ({n // n_frames}/frame)" for k, n in launches.items()))
    log(f"  depth range {depth.min().item():.4g}..{depth.max().item():.4g}")
    return dict(state=state, frame=frame, go=go, launches=launches,
                n_frames=n_frames)


# -- phase 5 ----------------------------------------------------------------


def phase_profile(main) -> None:
    """Device time by kernel over a few main-path frames, and the device's
    busy share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, frame, go = main["state"], main["frame"], main["go"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_FRAMES):
            state, _ = frame(state, go)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        rows.append((us, evt.count, evt.key))
    busy = sum(r[0] for r in rows)
    if not rows or busy <= 0:
        log("  profiler recorded no device time: device breakdown not "
            "measured")
        return
    rows.sort(reverse=True)
    log(f"  {PROFILED_FRAMES} frames, wall {wall_us / PROFILED_FRAMES:.1f} "
        f"us/frame, device busy {busy / PROFILED_FRAMES:.1f} us/frame "
        f"({100 * busy / wall_us:.1f}% busy, "
        f"{100 - 100 * busy / wall_us:.1f}% idle), "
        f"{sum(r[1] for r in rows) / PROFILED_FRAMES:.0f} kernels/frame")
    for us, count, key in rows[:15]:
        log(f"    {us / PROFILED_FRAMES:9.2f} us/frame "
            f"{100 * us / busy:5.1f}%  x{count / PROFILED_FRAMES:g}/frame  "
            f"{key[:90]}")
    main["state"] = state


# -- phase 6 ----------------------------------------------------------------


def device_ms(fn, n: int) -> float:
    """Device time of one call of ``fn``, from ``n`` calls queued behind a
    spin kernel: the spin lasts longer than the host takes to enqueue them
    all, so host overhead between the calls does not count. Raises if the
    spin ended before the last call was enqueued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    # 3x the host's time, in cycles at the H100's top clock (1.98 GHz); a
    # lower clock only makes the spin longer
    torch.cuda._sleep(int((3 * host_s + 0.01) * 2.0e9))
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    spin_ms = spin.elapsed_time(start)
    check(host_ms < spin_ms, f"host enqueue {host_ms:.1f} ms outlasted the "
          f"{spin_ms:.1f} ms spin: the time would include host gaps")
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_times(cfg: ModelConfig, dev) -> dict:
    """Each kernel's device time per call at each level shape, in the main
    path's dtype (bf16) and with its inputs (the SNCV's c1 is c2), beside
    its plain version's time and its bound."""
    dtype = cfg.torch_cv_dtype
    es = torch.finfo(dtype).bits // 8
    totals = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                      t_ops=0.0) for k in ("sncv", "dscv")}
    levels = []
    for spec in level_specs(cfg):
        level, h, w, C, cuts = spec[:5]
        x = op_inputs(spec, dev, seed=level)
        n_pix = h * w
        c1 = x["c1"].to(dtype)
        sn = dict(
            kernel=lambda: spatial_cost_volume_fused(
                c1, c1, SPATIAL_SEARCH, cuts, dtype, LEAKY),
            plain=lambda: spatial_cost_volume(
                c1, c1, SPATIAL_SEARCH, cuts, dtype, LEAKY),
            # c1 is c2: one feature map read, 49*cuts float32 written; one
            # multiply-add per channel per offset, one compare per output
            nbytes=n_pix * (C * es + 49 * cuts * 4),
            flops=n_pix * 49 * (2 * C + cuts))
        args = dscv_args(x, dtype)
        ds = dict(
            kernel=lambda: parallax_sweeping_cv_fused(*args, cuts, dtype),
            plain=lambda: parallax_sweeping_cv(*args, cuts, dtype),
            # c1, c2 and the previous parallax in the cv dtype, the float32
            # centre; 9*cuts + 1 float32 out. Per hypothesis and channel:
            # 3 lerps (2 flops each) and a multiply-add; ~40 flops of
            # geometry per hypothesis and cut
            nbytes=n_pix * ((2 * C + 1) * es + 4 + (9 * cuts + 1) * 4),
            flops=n_pix * 9 * (8 * C + 40 * cuts))
        row = dict(level=level, h=h, w=w, C=C, cuts=cuts)
        for name, d in (("sncv", sn), ("dscv", ds)):
            ms = device_ms(d["kernel"], 100)
            # a plain call queues ~100 small kernels; few calls keep them
            # inside the launch queue, so the host is not held up while the
            # spin runs
            plain_ms = device_ms(d["plain"], 3)
            b_ms, b_by = bound(d["nbytes"], d["flops"])
            t = totals[name]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["bound_ms"] += b_ms
            t["t_bytes"] += d["nbytes"] / HBM_BYTES_PER_S * 1e3
            t["t_ops"] += d["flops"] / FP32_FLOPS_PER_S * 1e3
            row[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=d["nbytes"],
                             flops=d["flops"])
            log(f"  level {level} {h}x{w} C={C} cuts={cuts} {name}: kernel "
                f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.3f} us ({b_by}; {d['nbytes']} B, "
                f"{d['flops']} flop), {100 * b_ms / ms:.1f}% of bound")
        levels.append(row)
    log(json.dumps({"kernel_levels": levels}))
    return totals


# -- main -------------------------------------------------------------------


KERNEL_INFO = {
    "sncv": dict(name="sncv_forward", source="m4depth_tpu_torch/ops/csrc/sncv.cu",
                 replaces="m4depth_tpu/ops/sncv_pallas.py:28"),
    "dscv": dict(name="dscv_forward", source="m4depth_tpu_torch/ops/csrc/dscv.cu",
                 replaces="m4depth_tpu/ops/dscv_pallas.py:120"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    serving = ModelConfig(compute_dtype="bfloat16")
    t_start = time.perf_counter()

    log("== phase 1: environment")
    phase_environment()
    log("== phase 2: kernels against their plain versions (d6 384x384 "
        "level shapes, b=1)")
    worst = phase_kernels_vs_plain(serving, dev)
    log("== phase 3: d6 128x128 model, card (kernels) against CPU (plain), "
        "float32")
    phase_model_card_vs_cpu(dev)
    log("== phase 4: main path, streaming M4Depth.step d6 384x384 b=1 bf16")
    main_run = phase_main_path(dev)
    log("== phase 5: profile of the main path")
    phase_profile(main_run)
    log("== phase 6: kernel device times per level shape (bf16); no single "
        "PyTorch call computes either op, so library_ms is null")
    totals = phase_kernel_times(serving, dev)

    per_frame = serving.num_levels
    kernels = []
    for key, info in KERNEL_INFO.items():
        t = totals[key]
        kernels.append(dict(
            info, route="cuda", launches=main_run["launches"][key],
            launches_per_frame=main_run["launches"][key] // main_run["n_frames"],
            max_abs_err=worst[key],
            # per frame: the sum over the six level shapes of one launch each
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_bytes"] >= t["t_ops"] else "operations",
            library_ms=None, passed=True))
        check(kernels[-1]["launches_per_frame"] == per_frame,
              f"{key} launches per frame")
    log(f"smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

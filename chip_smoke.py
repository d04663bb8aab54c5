#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``m4depth_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``m4depth_tpu_torch/ops/csrc`` with ``nvcc``
and then runs these phases in order; each raises on failure, so the script
exits non-zero and prints no result line:

1. environment: the card's name and power limit, the torch and CUDA
   versions, the kernels' build time and ``ptxas`` resource use;
2. each forward kernel against its plain PyTorch version on the card, at
   the six decoder-level shapes of the d6 model at 384x384 (b=1), in
   float32 and in bfloat16;
3. each backward kernel against autograd of the plain forward, at the six
   level shapes with b=3 (the training batch), float32 and bfloat16, for
   every input gradient;
4. the d6 model at 128x128 (b=2, 3 frames, one per-element reset) on the
   card (kernels) against the same weights on the CPU (plain versions),
   in float32;
5. one training step of the d6 model at 128x128 (b=2, T=3), card against
   CPU, float32, from four seeds: the loss, every gradient, the parameters
   after Adam; and, to show where a gap comes from, the card's step with
   the plain cost volumes and with the frames one float32 ulp off;
6. the serving path: streaming ``M4Depth.step`` of the d6 model at
   384x384, b=1, bfloat16 compute, with seeded random weights; ms/frame
   over 5 timed blocks, peak memory, and each kernel's launches (6 per
   frame of each forward kernel, none of the backward ones);
7. a ``torch.profiler`` window over serving frames: device time by kernel
   and the device's busy share;
8. the training path: ``make_train_step`` of the d6 model at 384x384,
   b=3, T=4, bfloat16 compute and cost volumes, Adam at 1e-4, on a seeded
   batch; ms/step over timed blocks, peak memory, each step's loss, and
   each kernel's launches (18 per step of each of the four); then a
   profiler window over training steps;
9. each forward kernel's device time at each level shape (b=1, serving),
   beside its plain version's time and its bound;
10. each kernel's device time at each level shape with b=3 (training),
   beside its plain version's time and its bound;
11. one JSON line listing the four kernels, then the result line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before running anything.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

import numpy as np

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera, scale_camera
from m4depth_tpu_torch.models import M4Depth, decoder, init_state, level_shape
from m4depth_tpu_torch.ops import (
    KERNELS,
    _build,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops.cost_volume import _dscv_backward
from m4depth_tpu_torch.ops.sncv import _sncv_backward
from m4depth_tpu_torch.testing import (
    DSCV_CV_TOL,
    DSCV_PARA_TOL,
    MODEL_TOL,
    SNCV_TOL,
    STEP_LOSS_RTOL,
    assert_dscv_grads_close,
    assert_sncv_grads_close,
    assert_train_step_close,
    max_abs_err,
    tie_free_pixels,
)
from m4depth_tpu_torch.train import make_optimizer, make_train_step

FORWARD = ("sncv_forward", "dscv_forward")
BACKWARD = ("sncv_backward", "dscv_backward")

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

# the training path: d6 at 384x384, b=3, T=4 (train_prof.py's recipe)
TRAIN_B, TRAIN_T = 3, 4
TRAIN_WARMUP_STEPS = 1
TRAIN_BLOCKS = 4
STEPS_PER_BLOCK = 3
PROFILED_STEPS = 2
LEARNING_RATE = 1e-4

# The tolerances of phases 2 to 5, and why, are in m4depth_tpu_torch/testing.py
# (tests/test_torch_cuda.py holds the kernels to the same ones).
# Phase 5 runs one training step from each of these seeds (weights, batch).
STEP_SEEDS = ((3, 12), (4, 13), (5, 14), (6, 15))
# In its report phase 5 lists apart the leaves whose gradient is under this
# share of the model's largest: zero in exact arithmetic, rounding residue.
ZERO_LEAF = 1e-6

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


def level_specs(cfg: ModelConfig, b: int = 1):
    """(level, h, w, C, cuts, camera) for each decoder level of the d6
    model at SIZE x SIZE and batch b, finest first."""
    f = torch.full((b, 2), FOCAL)
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
    """Inputs of one level's SNCV and DSCV, made on the CPU from a seed,
    with the upstream gradients of both ops' outputs."""
    _, h, w, C, cuts, cam = spec
    b = cam.f.shape[0]
    g = torch.Generator().manual_seed(seed)
    c1 = unit_cuts(g, (b, h, w, C), cuts)
    c2 = unit_cuts(g, (b, h, w, C), cuts)
    para = torch.rand(b, h, w, 1, generator=g) * 3.0 + 0.1
    # sweep centres in [0.5, 4.5], and some far out so that samples fall
    # past the border and the clamp is exercised
    centre = torch.rand(b, h, w, 1, generator=g) * 4.0 + 0.5
    centre[:, ::5, ::7] = 150.0
    out = dict(c1=c1, c2=c2, para=para, centre=centre,
               rot=torch.tensor([ROT] * b), trans=torch.tensor([TRANS] * b),
               f=cam.f, c=cam.c,
               g_sncv=torch.randn(b, h, w, 49 * cuts, generator=g),
               g_cv=torch.randn(b, h, w, 9 * cuts, generator=g),
               g_para=torch.randn(b, h, w, 1, generator=g))
    return {k: v.to(dev).contiguous() for k, v in out.items()}


def dscv_args(x, dtype, rot=None):
    return (x["c1"].to(dtype), x["c2"].to(dtype), x["para"], x["centre"],
            x["rot"] if rot is None else rot, x["trans"],
            Camera(x["f"], x["c"]), DEPTH_SEARCH)


# -- phase 2 ----------------------------------------------------------------


def phase_kernels_vs_plain(cfg: ModelConfig, dev) -> dict:
    """Each kernel against its plain version at every level shape, in
    float32 and bfloat16; returns the largest error seen per kernel."""
    worst = dict.fromkeys(FORWARD, 0.0)
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
                torch.testing.assert_close(out, ref, **SNCV_TOL)
                errs.append(max_abs_err(out, ref))
            worst["sncv_forward"] = max(worst["sncv_forward"], *errs)
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
                torch.testing.assert_close(cv, cv_ref, **DSCV_CV_TOL)
                torch.testing.assert_close(para, para_ref, **DSCV_PARA_TOL)
                d_errs.append((max_abs_err(cv, cv_ref),
                               max_abs_err(para, para_ref)))
            worst["dscv_forward"] = max(worst["dscv_forward"],
                                        *(e for p in d_errs for e in p))
            log(f"  level {level} {h}x{w} C={C} cuts={cuts} {name}: "
                f"sncv max|err| {errs[0]:.3e} (c1 is c2), {errs[1]:.3e} "
                f"(c1 != c2); dscv cv, parallax max|err| "
                f"{d_errs[0][0]:.3e}, {d_errs[0][1]:.3e} (quaternion), "
                f"{d_errs[1][0]:.3e}, {d_errs[1][1]:.3e} (small angle)")
    return worst


# -- phase 3 ----------------------------------------------------------------


def phase_backward_vs_plain(cfg: ModelConfig, dev) -> dict:
    """Each backward kernel (through its autograd Function) against
    autograd of the plain forward, at every level shape with b=3, in
    float32 and bfloat16, for every input gradient; returns the largest
    error per kernel."""
    worst = dict.fromkeys(BACKWARD, 0.0)
    for spec in level_specs(cfg, TRAIN_B):
        level, h, w, C, cuts = spec[:5]
        x = op_inputs(spec, dev, seed=100 + level)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            line = []
            for same in (True, False):
                grads = []
                for fn in (spatial_cost_volume_fused, spatial_cost_volume):
                    a = x["c1"].to(dtype).requires_grad_()
                    b = a if same else x["c2"].to(dtype).requires_grad_()
                    ins = [a] if same else [a, b]
                    out = fn(a, b, SPATIAL_SEARCH, cuts, dtype, LEAKY)
                    grads.append(torch.autograd.grad(out, ins, x["g_sncv"]))
                torch.cuda.synchronize()
                errs = assert_sncv_grads_close(*grads, dtype, same,
                                               f"sncv {name}")
                worst["sncv_backward"] = max(worst["sncv_backward"], *errs)
                line.append(f"sncv {'c1 is c2' if same else 'c1 != c2'} "
                            + ", ".join(f"{e:.3e}" for e in errs))
            for rot_name, rot in (("quaternion", x["rot"]),
                                  ("small angle", x["rot"][:, 1:])):
                grads = []
                for fn in (parallax_sweeping_cv_fused, parallax_sweeping_cv):
                    ins = [x["c1"].to(dtype).requires_grad_(),
                           x["c2"].to(dtype).requires_grad_(),
                           x["para"].clone().requires_grad_(),
                           x["centre"].clone().requires_grad_()]
                    cv, pw = fn(*ins, rot, x["trans"], Camera(x["f"], x["c"]),
                                DEPTH_SEARCH, cuts, dtype)
                    grads.append(torch.autograd.grad(
                        (cv, pw), ins, (x["g_cv"], x["g_para"])))
                torch.cuda.synchronize()
                mask = tie_free_pixels(x["centre"], rot, x["trans"],
                                       Camera(x["f"], x["c"]), DEPTH_SEARCH)
                check(mask.float().mean().item() > 0.75,
                      f"level {level}: too many DSCV samples near ties")
                errs = assert_dscv_grads_close(*grads, dtype, mask,
                                               f"dscv {name}")
                worst["dscv_backward"] = max(worst["dscv_backward"], *errs)
                line.append(f"dscv {rot_name} " + ", ".join(
                    f"{e:.3e}" for e in errs) + f" ({int((~mask).sum())} "
                    "tie pixels left out of dcentre)")
            log(f"  level {level} {h}x{w} C={C} cuts={cuts} {name}, "
                f"max|kernel - plain| of dc1[, dc2][, dpara, dcentre]: "
                + "; ".join(line))
    return worst


# -- phase 4 ----------------------------------------------------------------


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
        log(f"  frame {t}: max|depth card - cpu| "
            f"{max_abs_err(card, depth['cpu']):.3e} (depth "
            f"{depth['cpu'].min().item():.4g}.."
            f"{depth['cpu'].max().item():.4g})")
    for k, kern in KERNELS.items():
        n = kern.launches - before[k]
        want = 3 * cfg.num_levels if k in FORWARD else 0
        check(n == want, f"{k}: {n} launches in 3 frames, expected {want}")


# -- phase 5 ----------------------------------------------------------------


def train_batch(b: int, T: int, hw: int, seed: int, rot, trans, dev):
    """A training window made with numpy from a seed: frames in [0, 1],
    depth 1 + 60 U, one motion for every frame, f = c = hw / 2."""
    rng = np.random.RandomState(seed)
    batch = {
        "rgb": rng.rand(b, T, hw, hw, 3).astype(np.float32),
        "depth": (1.0 + 60 * rng.rand(b, T, hw, hw, 1)).astype(np.float32),
        "rot": np.tile(np.asarray(rot, np.float32), (b, T, 1)),
        "trans": np.tile(np.asarray(trans, np.float32), (b, T, 1)),
        "camera_f": np.full((b, 2), hw / 2.0, np.float32),
        "camera_c": np.full((b, 2), hw / 2.0, np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@contextlib.contextmanager
def plain_cost_volumes():
    """The decoder calls the plain cost volumes in place of the kernel
    wrappers, on any device."""
    fused = (decoder.parallax_sweeping_cv_fused,
             decoder.spatial_cost_volume_fused)
    decoder.parallax_sweeping_cv_fused = parallax_sweeping_cv
    decoder.spatial_cost_volume_fused = spatial_cost_volume
    try:
        yield
    finally:
        (decoder.parallax_sweeping_cv_fused,
         decoder.spatial_cost_volume_fused) = fused


def phase_train_card_vs_cpu(dev) -> None:
    """d6 at 128x128, b=2, T=3, float32: one training step on the card
    (kernels) against the CPU (plain versions) from the same weights and
    batch, for each of STEP_SEEDS. Two more card steps say where a gap
    comes from: one with the plain cost volumes in place of the kernels
    (the gap the rest of the card's arithmetic makes alone), one with
    every frame value one float32 ulp off (how far rounding moves a
    gradient). The gradients reach the encoder only through the cost
    volumes, so a non-zero encoder gradient on the card shows they
    flow."""
    cfg = ModelConfig(compute_dtype="float32", cv_dtype="float32")
    b, T, hw = 2, 3, 128
    train_cfg = TrainConfig(learning_rate=LEARNING_RATE)
    for weight_seed, batch_seed in STEP_SEEDS:
        runs = []
        for d, plain, nudge in (("cpu", True, False), (dev, False, False),
                                (dev, True, False), (dev, False, True)):
            model = M4Depth(cfg, device=d, seed=weight_seed)
            opt = make_optimizer(model, train_cfg)
            batch = train_batch(b, T, hw, batch_seed,
                                [1.0, 0.001, -0.002, 0.001], [0.3, 0.1, 0.02],
                                d)
            if nudge:
                # every frame value moved by one float32 ulp, up or down
                g = torch.Generator().manual_seed(batch_seed)
                sign = torch.randint(0, 2, batch["rgb"].shape, generator=g)
                batch["rgb"] = batch["rgb"] * (
                    1 + (2.0 * sign.to(d) - 1) * 2.0 ** -24)
            before = {k: kern.launches for k, kern in KERNELS.items()}
            with (plain_cost_volumes() if plain and d != "cpu"
                  else contextlib.nullcontext()):
                out = {k: v.item() for k, v in
                       make_train_step(model, opt)(batch).items()}
            for k, kern in KERNELS.items():
                n = kern.launches - before[k]
                want = 0 if plain else (T - 1) * cfg.num_levels
                check(n == want, f"{k}: {n} launches in one step on {d}, "
                      f"expected {want}")
            runs.append(dict(
                out=out,
                grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                params={n: p.detach().cpu()
                        for n, p in model.named_parameters()}))
        cpu, card, card_plain, nudged = runs
        check(all(np.isfinite(v) for v in card["out"].values()),
              "finite scalars")
        check(abs(card["out"]["loss"] - cpu["out"]["loss"])
              <= STEP_LOSS_RTOL * abs(cpu["out"]["loss"]), f"loss {runs}")
        log(f"  seeds {weight_seed}, {batch_seed}: loss card "
            f"{card['out']['loss']:.7f}, cpu {cpu['out']['loss']:.7f}; "
            f"grad_norm card {card['out']['grad_norm']:.7f}, cpu "
            f"{cpu['out']['grad_norm']:.7f}")
        res = assert_train_step_close(card["grads"], cpu["grads"],
                                      card["params"], cpu["params"],
                                      LEARNING_RATE)
        enc = card["grads"]["encoder.conv_s1.0.weight"].abs().max().item()
        check(enc > 0, "the encoder's gradient is zero on the card")
        worst = list(res["shares"].items())[:3]
        log(f"  {len(cpu['grads'])} parameters, largest |grad| "
            f"{res['top']:.4g}; largest |grad card - cpu| as a share of its "
            "tolerance: " + ", ".join(f"{n} {v:.3e}" for n, v in worst)
            + f"; largest |param card - cpu| after Adam where the "
            f"gradient's sign is sure {res['worst_param']:.3e}; max|grad| of "
            f"the first encoder conv on the card {enc:.3e}")

        def moved(a, b, n):
            ref = cpu["grads"][n].abs().max().item()
            return ((a["grads"][n] - b["grads"][n]).abs().max().item()
                    / max(ref, 1e-30))

        small = res["small_leaves"]
        residue = [n for n in small if cpu["grads"][n].abs().max().item()
                   < ZERO_LEAF * res["top"]]
        groups = (("small", [n for n in small if n not in residue]),
                  ("ordinary", [n for n in res["rel"] if n not in small]),
                  ("zero up to rounding", residue))
        for name, leaves in groups:
            if not leaves:
                continue
            gap = max(leaves, key=res["rel"].get)
            kern = max(leaves, key=lambda n: moved(card, card_plain, n))
            log(f"  {len(leaves)} {name} leaves, as shares of each leaf's "
                f"max|grad|: largest |card - cpu| {res['rel'][gap]:.3e} "
                f"({gap}; card with the plain cost volumes - cpu "
                f"{moved(card_plain, cpu, gap):.3e}, card - the same "
                f"{moved(card, card_plain, gap):.3e}, card - card with the "
                f"frames one ulp off {moved(card, nudged, gap):.3e}); "
                f"largest |card - card with the plain cost volumes| "
                f"{moved(card, card_plain, kern):.3e} ({kern}; card - card "
                f"with the frames one ulp off "
                f"{moved(card, nudged, kern):.3e})")


# -- phase 6 ----------------------------------------------------------------


def main_path_inputs(dev):
    g = torch.Generator().manual_seed(0)
    rgb = torch.rand(1, SIZE, SIZE, 3, generator=g).to(dev)
    f = torch.full((1, 2), FOCAL, device=dev)
    return dict(rgb=rgb, rot=torch.tensor([ROT], device=dev),
                trans=torch.tensor([TRANS], device=dev),
                camera=Camera(f, f.clone()))


def zero_launch_counts() -> None:
    for kern in KERNELS.values():
        kern.launches = 0


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
    zero_launch_counts()
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
        want = cfg.num_levels * n_frames if k in FORWARD else 0
        check(n == want, f"{k}: {n} launches in {n_frames} frames, "
              f"expected {want}")
    med = statistics.median(block_ms)
    log(f"  {n_frames} frames; ms/frame median {med:.4f} "
        f"(blocks {', '.join(f'{v:.4f}' for v in block_ms)}; "
        f"min {min(block_ms):.4f}, max {max(block_ms):.4f}); "
        f"{1e3 / med:.2f} frames/s")
    log(f"  peak device memory {peak} bytes ({peak / 2**20:.1f} MiB)")
    log(f"  launches: " + ", ".join(
        f"{k} {n} ({n // n_frames}/frame)" for k, n in launches.items()))
    log(f"  depth range {depth.min().item():.4g}..{depth.max().item():.4g}")
    state_box = [state]

    def run_frame():
        state_box[0], _ = frame(state_box[0], go)

    return dict(run=run_frame, launches=launches, n_frames=n_frames)


# -- phase 7 ----------------------------------------------------------------


def phase_profile(run, n: int, unit: str) -> None:
    """Device time by kernel over ``n`` calls of ``run`` (one frame or one
    step each), the device's busy share of the window's wall time, and the
    kernel launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        # a user annotation ("Optimizer.step#Adam.step") spans kernels
        # already counted: it is no device work of its own. (Kernel names
        # hold "#" too, in "{lambda()#3}", but always with a parenthesis.)
        if evt.device_type != DeviceType.CUDA or (
                "#" in evt.key and "(" not in evt.key):
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
    log(f"  {n} {unit}s, wall {wall_us / n:.1f} us/{unit}, device busy "
        f"{busy / n:.1f} us/{unit} ({100 * busy / wall_us:.1f}% busy, "
        f"{100 - 100 * busy / wall_us:.1f}% idle), "
        f"{sum(r[1] for r in rows) / n:.0f} kernels/{unit}")
    for us, count, key in rows[:15]:
        log(f"    {us / n:9.2f} us/{unit} {100 * us / busy:5.1f}%  "
            f"x{count / n:g}/{unit}  {key[:90]}")
    for us, count, key in rows[15:]:
        if any(k in key for k in ("sncv", "dscv")):
            log(f"    {us / n:9.2f} us/{unit} {100 * us / busy:5.1f}%  "
                f"x{count / n:g}/{unit}  {key[:90]}")


# -- phase 8 ----------------------------------------------------------------


def phase_train_path(dev):
    """The training path: ``make_train_step`` of the d6 model at 384x384,
    b=3, T=4, bf16/bf16, Adam at 1e-4, on a seeded batch with bench's
    motion. The launch counts are zeroed just before the first step and
    read just after the last one."""
    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
    model = M4Depth(cfg, device=dev, seed=0)
    step = make_train_step(model, make_optimizer(
        model, TrainConfig(learning_rate=LEARNING_RATE)))
    batch = train_batch(TRAIN_B, TRAIN_T, SIZE, 0, ROT, TRANS, dev)
    check(float(batch["camera_f"][0, 0]) == FOCAL, "f = c = 192")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    outs = [step(batch) for _ in range(TRAIN_WARMUP_STEPS)]
    torch.cuda.synchronize()
    block_ms = []
    for _ in range(TRAIN_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(STEPS_PER_BLOCK):
            outs.append(step(batch))
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3 / STEPS_PER_BLOCK)
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    n_steps = len(outs)
    per_step = (TRAIN_T - 1) * cfg.num_levels
    for k, n in launches.items():
        check(n == per_step * n_steps, f"{k}: {n} launches in {n_steps} "
              f"steps, expected {per_step} per step")
    scalars = [{k: v.item() for k, v in o.items()} for o in outs]
    check(all(np.isfinite(v) for sc in scalars for v in sc.values()),
          "finite loss, RMSE_log and grad_norm at every step")
    med = statistics.median(block_ms)
    log(f"  {n_steps} steps ({TRAIN_WARMUP_STEPS} warm-up, {TRAIN_BLOCKS} "
        f"blocks of {STEPS_PER_BLOCK}); ms/step median {med:.4f} (blocks "
        f"{', '.join(f'{v:.4f}' for v in block_ms)}; min "
        f"{min(block_ms):.4f}, max {max(block_ms):.4f}); "
        f"{1e3 / med * TRAIN_B:.2f} windows/s")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"  launches: " + ", ".join(
        f"{k} {n} ({n // n_steps}/step)" for k, n in launches.items()))
    log("  loss by step: " + ", ".join(f"{sc['loss']:.6f}" for sc in scalars))
    log("  grad_norm by step: " + ", ".join(
        f"{sc['grad_norm']:.5g}" for sc in scalars))
    log(f"  RMSE_log of the last step {scalars[-1]['RMSE_log']:.6f}")
    return dict(run=lambda: step(batch), launches=launches, n_steps=n_steps,
                per_step=per_step, ms_per_step=med)


# -- phases 9 and 10 -------------------------------------------------------


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


def kernel_cases(x, cuts: int, C: int, n_pix: int, dtype, with_backward):
    """For each kernel at one level shape: the kernel's call, its plain
    version's call, and the bytes and flops the function needs. As the
    model calls them: the SNCV with c1 is c2, the DSCV with the quaternion;
    the backward of the previous parallax is not asked for."""
    es = torch.finfo(dtype).bits // 8
    c1 = x["c1"].to(dtype)
    args = dscv_args(x, dtype)
    cases = {
        "sncv_forward": dict(
            kernel=lambda: spatial_cost_volume_fused(
                c1, c1, SPATIAL_SEARCH, cuts, dtype, LEAKY),
            plain=lambda: spatial_cost_volume(
                c1, c1, SPATIAL_SEARCH, cuts, dtype, LEAKY),
            plain_calls=3,
            # one feature map read, 49*cuts float32 written; one
            # multiply-add per channel per offset, one compare per output
            nbytes=n_pix * (C * es + 49 * cuts * 4),
            flops=n_pix * 49 * (2 * C + cuts)),
        "dscv_forward": dict(
            kernel=lambda: parallax_sweeping_cv_fused(*args, cuts, dtype),
            plain=lambda: parallax_sweeping_cv(*args, cuts, dtype),
            plain_calls=3,
            # c1, c2 and the previous parallax in the cv dtype, the float32
            # centre; 9*cuts + 1 float32 out. Per hypothesis and channel:
            # 3 lerps (2 flops each) and a multiply-add; ~40 flops of
            # geometry per hypothesis and cut
            nbytes=n_pix * ((2 * C + 1) * es + 4 + (9 * cuts + 1) * 4),
            flops=n_pix * 9 * (8 * C + 40 * cuts)),
    }
    if not with_backward:
        return cases
    with torch.no_grad():
        out = spatial_cost_volume_fused(c1, c1, SPATIAL_SEARCH, cuts, dtype,
                                        LEAKY)
    c1g = c1.clone().requires_grad_()
    out_plain = spatial_cost_volume(c1g, c1g, SPATIAL_SEARCH, cuts, dtype,
                                    LEAKY)
    cam = Camera(x["f"], x["c"])
    motion = (x["rot"], x["trans"], x["f"], x["c"])
    a, b, para = c1, x["c2"].to(dtype), x["para"].to(dtype)
    ins = [t.clone().requires_grad_() for t in (a, b, x["centre"])]
    cv_p, pw_p = parallax_sweeping_cv(ins[0], ins[1], x["para"], ins[2],
                                      x["rot"], x["trans"], cam,
                                      DEPTH_SEARCH, cuts, dtype)
    cases["sncv_backward"] = dict(
        kernel=lambda: _sncv_backward(x["g_sncv"], c1, c1, out,
                                      SPATIAL_SEARCH, cuts, LEAKY),
        plain=lambda: torch.autograd.grad(out_plain, c1g, x["g_sncv"],
                                          retain_graph=True),
        plain_calls=1,
        # g and the forward's output (49*cuts float32 each) and one feature
        # map read, dc1 and dc2 written; per offset and channel two
        # multiply-adds, per output gradient a select and a scale
        nbytes=n_pix * (2 * 49 * cuts * 4 + 3 * C * es),
        flops=n_pix * 49 * (4 * C + 2 * cuts))
    cases["dscv_backward"] = dict(
        kernel=lambda: _dscv_backward(a, b, para, x["centre"], *motion,
                                      x["g_cv"], x["g_para"], DEPTH_SEARCH,
                                      cuts, want_dpara=False),
        plain=lambda: torch.autograd.grad(
            (cv_p, pw_p), ins, (x["g_cv"], x["g_para"]), retain_graph=True),
        plain_calls=1,
        # c1, c2, the previous parallax (cv dtype), the centre, dcv and
        # dpara_out read; dc1, dc2 (cv dtype) and dcentre written. Per
        # hypothesis and channel ~27 flops (the sample, its two position
        # derivatives, four corner weights and atomic adds, the dc1 sum);
        # ~40 flops of geometry per hypothesis
        nbytes=n_pix * ((2 * C + 1) * es + 4 + (9 * cuts + 1) * 4
                        + 2 * C * es + 4),
        flops=n_pix * 9 * (27 * C + 40))
    return cases


def phase_kernel_times(cfg: ModelConfig, dev, b: int, with_backward: bool,
                       calls_per_level: int) -> dict:
    """Each kernel's device time per call at each level shape with batch b,
    in the paths' dtype (bf16), beside its plain version's time and its
    bound; totals are per frame (b=1) or per step (b=3: each level runs
    ``calls_per_level`` times a step)."""
    dtype = cfg.torch_cv_dtype
    names = FORWARD + (BACKWARD if with_backward else ())
    totals = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                      t_ops=0.0) for k in names}
    levels = []
    for spec in level_specs(cfg, b):
        level, h, w, C, cuts = spec[:5]
        x = op_inputs(spec, dev, seed=level)
        cases = kernel_cases(x, cuts, C, b * h * w, dtype, with_backward)
        row = dict(level=level, b=b, h=h, w=w, C=C, cuts=cuts)
        for name in names:
            d = cases[name]
            ms = device_ms(d["kernel"], 100)
            # a plain call queues ~100 small kernels (a plain backward
            # several hundred); few calls keep them inside the launch queue,
            # so the host is not held up while the spin runs
            plain_ms = device_ms(d["plain"], d["plain_calls"])
            b_ms, b_by = bound(d["nbytes"], d["flops"])
            t = totals[name]
            t["ms"] += ms * calls_per_level
            t["plain_ms"] += plain_ms * calls_per_level
            t["bound_ms"] += b_ms * calls_per_level
            t["t_bytes"] += d["nbytes"] / HBM_BYTES_PER_S * 1e3 * calls_per_level
            t["t_ops"] += d["flops"] / FP32_FLOPS_PER_S * 1e3 * calls_per_level
            row[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=d["nbytes"],
                             flops=d["flops"])
            log(f"  level {level} b={b} {h}x{w} C={C} cuts={cuts} {name}: "
                f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                f"bound {b_ms * 1e3:.3f} us ({b_by}; {d['nbytes']} B, "
                f"{d['flops']} flop), {100 * b_ms / ms:.1f}% of bound")
        levels.append(row)
    log(json.dumps({"kernel_levels": levels}))
    return totals


# -- main -------------------------------------------------------------------


KERNEL_INFO = {
    "sncv_forward": dict(source="m4depth_tpu_torch/ops/csrc/sncv.cu",
                         replaces="m4depth_tpu/ops/sncv_pallas.py:28"),
    "dscv_forward": dict(source="m4depth_tpu_torch/ops/csrc/dscv.cu",
                         replaces="m4depth_tpu/ops/dscv_pallas.py:120"),
    # the JAX SNCV's backward is its custom VJP in XLA, not a Pallas kernel
    "sncv_backward": dict(source="m4depth_tpu_torch/ops/csrc/sncv.cu",
                          replaces="m4depth_tpu/ops/sncv_pallas.py:134"),
    "dscv_backward": dict(source="m4depth_tpu_torch/ops/csrc/dscv.cu",
                          replaces="m4depth_tpu/ops/dscv_bwd_pallas.py:49"),
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
    log("== phase 2: forward kernels against their plain versions (d6 "
        "384x384 level shapes, b=1)")
    worst = phase_kernels_vs_plain(serving, dev)
    log("== phase 3: backward kernels against autograd of the plain "
        f"forward (d6 384x384 level shapes, b={TRAIN_B})")
    worst.update(phase_backward_vs_plain(serving, dev))
    log("== phase 4: d6 128x128 model, card (kernels) against CPU (plain), "
        "float32")
    phase_model_card_vs_cpu(dev)
    log("== phase 5: one training step, d6 128x128 b=2 T=3, card against "
        "CPU, float32")
    phase_train_card_vs_cpu(dev)
    log("== phase 6: serving path, streaming M4Depth.step d6 384x384 b=1 "
        "bf16")
    serve = phase_main_path(dev)
    log("== phase 7: profile of the serving path")
    phase_profile(serve["run"], PROFILED_FRAMES, "frame")
    log(f"== phase 8: training path, d6 384x384 b={TRAIN_B} T={TRAIN_T} "
        "bf16/bf16, Adam 1e-4")
    train = phase_train_path(dev)
    log("   profile of the training path")
    phase_profile(train["run"], PROFILED_STEPS, "step")
    log("== phase 9: forward kernel device times per level shape, b=1 "
        "(serving), bf16; no single PyTorch call computes either op, so "
        "library_ms is null")
    serving_totals = phase_kernel_times(serving, dev, 1, False, 1)
    log(f"== phase 10: kernel device times per level shape, b={TRAIN_B} "
        f"(training), bf16; per step each level runs {TRAIN_T - 1} times")
    totals = phase_kernel_times(serving, dev, TRAIN_B, True, TRAIN_T - 1)

    kernels = []
    for key, info in KERNEL_INFO.items():
        t = totals[key]
        n_train = train["launches"][key]
        n_serve = serve["launches"][key]
        kernels.append(dict(
            name=key, route="cuda", **info,
            # the training path's count: it runs all four kernels
            launches=n_train, launches_per_step=n_train // train["n_steps"],
            serving_launches=n_serve,
            serving_launches_per_frame=n_serve // serve["n_frames"],
            max_abs_err=worst[key],
            # per training step: the sum over the six level shapes at b=3
            # of one call each, times the 3 frames that run cost volumes
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_bytes"] >= t["t_ops"] else "operations",
            library_ms=None,
            # per serving frame (b=1), forward kernels only
            serving_ms=serving_totals[key]["ms"] if key in FORWARD else None,
            serving_bound_ms=(serving_totals[key]["bound_ms"]
                              if key in FORWARD else None),
            passed=True))
        check(kernels[-1]["launches_per_step"] == train["per_step"],
              f"{key} launches per step")
    log(f"smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

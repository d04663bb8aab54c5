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
   float32, bfloat16 and float16; and the V1 model's SNCV (a 9x9 cross-
   correlation of one cut, c1 != c2) at the same six shapes, b=1 and b=3,
   and at the edge shapes of its launch plans
   (``testing.V1_SNCV_EDGE_SHAPES``);
3. each backward kernel against its plain version (the SNCV's on the
   kernel forward's output, the DSCV's autograd of the plain forward), at
   the six level shapes with b=3 (the training batch), in the three
   dtypes, for every input gradient; and V1's SNCV backward (two
   gradients) at b=1 and b=3 and at the edge shapes;
4. the d6 model at 128x128 (b=2, 3 frames, one per-element reset) on the
   card (kernels) against the same weights on the CPU (plain versions),
   in float32, on the card once with cuDNN and once without it;
5. one training step of the d6 model at 128x128 (b=2, T=3), card against
   CPU, float32, from four seeds: the loss, every gradient, the parameters
   after Adam; and, to show where a gap comes from, the card's step with
   the plain cost volumes, glue and conv epilogue and with the frames one
   float32 ulp off;
6. the serving path: streaming ``M4Depth.step`` of the d6 model at
   384x384, b=1, bfloat16 compute, with seeded random weights; ms/frame
   over 5 timed blocks, peak memory, and each kernel's launches (6 per
   frame of each forward kernel and of each glue kernel, none of the
   backward ones);
7. a ``torch.profiler`` window over serving frames: device time by kernel
   and the device's busy share;
8. the training path: ``make_train_step`` of the d6 model at 384x384,
   b=3, T=4, bfloat16 compute and cost volumes, Adam at 1e-4, on a seeded
   batch; ms/step over timed blocks, peak memory, each step's loss, and
   each kernel's launches (18 per step of each of the four cost-volume
   kernels, of glue_assemble, glue_finish and the glue's three backward
   kernels, 24 of glue_prep: ``m4depth_launches``); then a profiler
   window over training steps;
9. each forward kernel's device time at each level shape (b=1, serving),
   beside its plain version's time and its bound, and the DSCV forward's
   time on the inputs one serving frame gave it; then V1's SNCV forward;
10. each kernel's device time at each level shape with b=3 (training),
   beside its plain version's time and its bound; each backward kernel
   both as called directly and through autograd of its fused wrapper, as
   the model calls it (the SNCV with c1 is c2); then V1's SNCV, forward
   and backward;
11. the command line, ``m4depth_tpu_torch.cli.main.main(argv)`` in this
   process, on a synthetic Mid-Air record store written with the port's
   ``make_sequence`` and ``RecordStoreWriter`` (4 trajectories of 32
   frames at 384x384): train d6 b=3 T=4 bf16 for 10 steps over 2 epochs
   (each kernel's launches counted), resume to 15 steps, train with
   ``--augment_device``, validation (ledger and validation-perfs.txt),
   eval (perfs-midair.txt, the forward kernels' launches), the CLI's
   streaming depth against ``M4Depth.step`` on one trajectory (bitwise),
   predict; then the record-store loader alone; then
   ``m4depth_tpu_torch.cli.finetune_kitti`` on a synthetic 256x768 KITTI
   store with sparse depth and a 768x768 Mid-Air store, ``--model=
   m4depth-v1`` in train and eval mode, and train mode with ``--remat`` at
   T=8. It prints, each beside the card's name and power limit, the train
   mode's ms/step beside phase 8's (no loading), the loader's batches/s,
   the eval mode's ms/frame and the peak device memory above the phase's
   baseline. Its modes run the compiled programs (``fit``'s
   ``compile_train_step``, the evaluator's compiled eval steps, predict's
   ``compile_step``), whose replays count their kernels' launches;
12. the V1 model: d6 at 128x128 on the card against the CPU (as phase 4),
   streaming ``M4DepthV1.step`` at 384x384 b=1 bf16 (as phase 6: 6 SNCV
   forwards a frame and 6 of each V1 glue kernel, no DSCV) and its
   training step at b=3 T=4 (as phase
   8: 24 SNCV forwards and backwards a step, no DSCV), each with a
   profiler window as phase 7's (device busy, launches, the SNCV's share
   of the busy time, beside the card's name and power limit); then the
   training step at T=8 without and with remat (``remat_policy`` "all",
   then "dscv"): ms/step and peak memory;
13. the geometry gates: ``m4depth_tpu_torch.tools.synthetic_validation
   --mode overfit`` with M4Depth (1000 steps) and with V1 (1200 steps),
   each of which must print ``GEOMETRY VALIDATION PASSED`` (the tool
   trains and evaluates through the compiled steps);
14. parallel serving (``m4depth_tpu_torch.parallel``), d6 384x384 bf16:
   ``sharded_stream`` on the card at 1, 4 and 8 streams (before N=4
   and N=8 the two forward kernels against their plain versions at the six
   level shapes at b=N, as phase 2; ms a step,
   frames/s, peak memory, the live allocations and their requested bytes
   equal after frame 10 and after the last, 6 launches of each forward
   kernel a step, each stream's first 5 frames against it alone at b=1,
   no collective in a profile; each replica runs ``compile_step``);
   ``FreshFrameStream`` (``compile_step``) against the eager serial
   loop, bitwise, one frame late;
   the port's ``tools/fresh_frame_bench.py``, its five loops at 200 frames;
15. data-parallel training: ``distributed_init`` of a world of one over
   NCCL in this process, the training path of phase 8 through
   ``data_parallel`` and a float32 step against the plain one; two ranks
   on the one card over gloo (``torch.multiprocessing.spawn``), a float32
   step against one process on the global batch and timed bf16 steps;
   the CLI's train mode under ``python -m torch.distributed.run``;
16. float16 cost volumes: the JAX package's extreme-parallax input (1e6)
   through the DSCV kernel, finite and saturated at 65504; streaming
   ``M4Depth.step`` (with a profile) and ``M4DepthV1.step`` and both
   training steps with ``cv_dtype="float16"``, each path's launches
   counted; each kernel's float16 device time per frame and per step (as
   phases 9 and 10); phase 11 also runs the CLI's eval mode of both
   families at ``--cv_dtype=float16``;
17. ``utils.profiling.compiled_cost`` of one serving frame and one training
   step: flops and bytes accessed, the convolutions' flops held against
   the count from the layer shapes;
18. ``m4depth_tpu_torch.native``: built with g++ on this host, held against
   the plain warp and its autograd gradient, timed;
19. the port's tools at reduced counts: ``memory_footprint``, ``fps --n 50
   --profile``, ``train_prof --steps 3``, ``io_bench`` (record store), and
   ``rehearsal`` for 2 epochs of 10 steps, then relaunched to 30 steps
   (resume and extension); each times the compiled step, and ``fps
   --profile`` and ``train_prof`` profile its replays, whose device time
   they split by the stage marks captured into the graph
   (``utils.tracing``);
20. the compiled programs (``utils.graphs``, the counterparts of the JAX
   package's jitted, state-donating steps; CUDA graphs): ``compile_step``
   of M4Depth and V1 at d6 384x384 b=1 bf16 over 50 distinct frames with
   a reset, held against the eager ``model.step`` chain (maximum error,
   bitwise or not) and timed against it in turns (5 blocks of 50 frames),
   each with a profile (busy share, host launches; each kernel's runs on
   the device in one replayed frame's profile), peak memory under the
   reference's
   500 MB; ``compile_train_step`` of both families at b=3 T=4 bf16
   against ``make_train_step`` (launches, peak memory, in turns, a
   profile of each), three float32 compiled steps held to three eager
   ones by ``testing.assert_step_close`` (each eager step from the
   compiled run's weights and Adam state), three compiled steps at T=8
   with remat "all"; the CLI's eval mode (compiled) against the eager
   evaluator to ``testing.EVAL_METRIC_TOL``;
21. the decoder glue's three kernels (``ops/csrc/glue.cu``), each against
   its plain version (``ops/glue.py``) on the same inputs at the six level
   shapes of d6 at 384x384 (b=1, bf16 convs and cost volumes): float32
   outputs to ``SNCV_TOL``, bfloat16 ones within one ulp; then each
   kernel's device time beside its plain version's and its bound. Their
   three backward kernels (``ops/csrc/glue_backward.cu``) against their
   plain versions at the six level shapes with b=3, in float32 and
   bfloat16 (``testing.GLUE_BWD_TOL``), each timed directly and through
   autograd beside its plain version and its bound; one training step's
   glue (24 glue_prep, 18 of the others) replayed in a CUDA graph, plain
   and through the kernels, forward and backward apart; compiled float32
   d6 steps with the kernels against eager steps with the plain glue
   (``testing.assert_glue_steps_close``), without remat and with each
   policy. V1's three glue kernels (``ops/csrc/glue_v1.cu``) against their
   plain versions (``ops/glue_v1.py``) at the six level shapes with b=8
   (v1-stream8's batch), timed beside their plain versions and bounds.
   The launch checks of every phase count these kernels too: once a
   level where an M4Depth level runs its cost volumes (glue_prep on every
   frame), with grad or without, and each backward once where the cost
   volumes' backwards run; V1's once a level where a V1 level runs
   without grad, none in V1's training steps;
22. the convs' epilogue kernels (``ops/csrc/conv_epilogue.cu``) against the
   plain chain on the card at every conv call of a d6 serving frame (b=1),
   a V1 serving step (b=8) and a d6 training step (b=3): the forward and
   dx bit for bit, the float32 bias gradient to ``EPILOGUE_BIAS_RTOL``,
   each timed beside the plain chain and its bound, summed a unit. The
   launch checks of every phase count them too: the forward once a conv
   call, the backward once more in training;
23. one JSON line listing the kernels (the four cost-volume kernels, their
   float16 instantiations, the glue's three kernels and their three
   backward kernels, V1's three glue kernels, then the epilogue's two),
   then the result
   line ``{"ok": true, "device":
   {...}}``.

Without a CUDA device it exits with code 2 before running anything.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

import numpy as np

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera, scale_camera
from m4depth_tpu_torch.models import (
    M4Depth,
    M4DepthV1,
    decoder,
    init_state,
    level_shape,
)
from m4depth_tpu_torch.ops import (
    KERNELS,
    _build,
    cost,
    glue,
    glue_v1,
    parallax_sweeping_cv,
    parallax_sweeping_cv_fused,
    spatial_cost_volume,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops.cost_volume import _dscv_backward, round_parallax
from m4depth_tpu_torch.ops.sncv import KERNEL_DTYPES, _sncv_backward
from m4depth_tpu_torch.testing import (
    DSCV_CV_TOL,
    DSCV_PARA_TOL,
    EPILOGUE_BIAS_RTOL,
    EVAL_METRIC_TOL,
    GLUE_BWD_TOL,
    MODEL_TOL,
    SNCV_TOL,
    STEP_LOSS_RTOL,
    V1_SNCV_EDGE_SHAPES,
    assert_bf16_depth_close,
    assert_dscv_grads_close,
    assert_glue_steps_close,
    assert_grad_close,
    assert_sncv_grads_close,
    assert_step_close,
    assert_train_step_close,
    assert_within_ulps,
    float32_step,
    max_abs_err,
    plain_epilogue,
    plain_glue,
    sncv_plain_grads,
    tie_free_pixels,
    train_batch,
)
from m4depth_tpu_torch.train import make_optimizer, make_train_step
from m4depth_tpu_torch.utils.profiling import compiled_cost

FORWARD = ("sncv_forward", "dscv_forward")
BACKWARD = ("sncv_backward", "dscv_backward")
# the decoder glue's kernels (ops/csrc/glue.cu): an M4Depth level launches
# glue_prep on every frame and the other two where it launches the two
# forward kernels, with grad or without; their backward kernels
# (ops/csrc/glue_backward.cu) where the training step runs the cost
# volumes' backward kernels
GLUE = ("glue_prep", "glue_assemble", "glue_finish")
GLUE_BACKWARD = ("glue_prep_backward", "glue_assemble_backward",
                 "glue_finish_backward")
SERVING = FORWARD + GLUE
# V1's decoder glue (ops/csrc/glue_v1.cu): a V1 level launches each without
# grad, where it launches the SNCV forward; with grad (training) none
GLUE_V1 = ("glue_v1_prep", "glue_v1_assemble", "glue_v1_finish")
V1_SERVING = ("sncv_forward",) + GLUE_V1
# the convs' epilogue (ops/csrc/conv_epilogue.cu): each Conv3x3 call
# launches the forward kernel, with grad or without, and the backward
# kernel in training. A frame runs each level's two encoder convs, and the
# seven convs of the level's refiner where the level runs its cost volumes
# (M4Depth: every frame but a training window's first; V1: every frame)
EPILOGUE = ("conv_epilogue_forward", "conv_epilogue_backward")
ENCODER_CONVS, REFINER_CONVS = 2, 7

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
V1_SEARCH = 4         # V1's SNCV: a 9x9 cross-correlation of one cut
LEAKY = 0.1

# the training step's window with and without remat
REMAT_T = 8
# the geometry gates: steps of each family's overfit run (VALIDATION.md)
GATE_STEPS = {"m4depth": 1000, "m4depth-v1": 1200}


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


def m4depth_launches(T: int, levels: int = 6, train: bool = True,
                     remat: str = "") -> dict:
    """Each kernel's launches in one M4Depth window of T frames whose
    frame 0 starts every sequence, at ``levels`` levels: a training step
    (``remat`` its policy, "" for none) or, without ``train``, a window
    without grad. A level launches glue_prep on every frame, and the cost
    volumes' forwards, glue_assemble and glue_finish on every frame but
    the first; a training step each backward kernel once where those ran;
    remat "all" runs those levels' forwards again in the backward (their
    glue_prep and refiner included), "dscv" the DSCV forward. The
    epilogue's forward runs once a conv call, its backward once more in a
    training step."""
    cv = (T - 1) * levels
    out = {k: 0 for k in KERNELS}
    out.update({k: cv for k in FORWARD + GLUE}, glue_prep=T * levels,
               conv_epilogue_forward=ENCODER_CONVS * T * levels
               + REFINER_CONVS * cv)
    if train:
        out.update({k: cv for k in BACKWARD + GLUE_BACKWARD},
                   conv_epilogue_backward=out["conv_epilogue_forward"])
        for k in {"all": FORWARD + GLUE, "dscv": ("dscv_forward",),
                  "": ()}[remat]:
            out[k] += cv
        if remat == "all":
            out["conv_epilogue_forward"] += REFINER_CONVS * cv
    return out


def m4depth_serving_launches(frames: int = 1, levels: int = 6) -> dict:
    """An M4Depth serving path's launches in ``frames`` frames without grad
    (every frame runs its cost volumes): each cost-volume forward and glue
    kernel once a level, the epilogue's forward once a conv."""
    out = {k: levels * frames if k in SERVING else 0 for k in KERNELS}
    out["conv_epilogue_forward"] = ((ENCODER_CONVS + REFINER_CONVS)
                                    * levels * frames)
    return out


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
        if not build_log.exists():
            continue
        # per kernel: "Function properties for <name>", its stack and spill
        # line, then its registers
        name = spill = ""
        for line in build_log.read_text().splitlines():
            if "Function properties for" in line:
                name = line.split("Function properties for", 1)[1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"  ptxas {src} {name}: "
                    f"{line.split(':', 1)[1].strip()}; {spill}")


# -- level shapes and inputs --------------------------------------------------


def level_specs(cfg: ModelConfig, b: int = 1, v1: bool = False):
    """(level, h, w, C, cuts, camera) for each decoder level of the d6
    model at SIZE x SIZE and batch b, finest first; V1's SNCV takes one
    cut."""
    f = torch.full((b, 2), FOCAL)
    cam = Camera(f, f.clone())
    specs = []
    for idx in range(cfg.num_levels):
        h, w = level_shape(SIZE, SIZE, idx)
        specs.append((idx + 1, h, w, cfg.channels[idx],
                      1 if v1 else cfg.num_cuts(idx + 1),
                      scale_camera(cam, 2.0 ** (idx + 1))))
    return specs


def v1_specs(cfg: ModelConfig):
    """V1's SNCV shapes as ``level_specs`` gives them: the level shapes at
    b=1 and b=TRAIN_B, then the edge shapes of its launch plans
    (``testing.V1_SNCV_EDGE_SHAPES``) as level 0."""
    specs = [s for b in (1, TRAIN_B) for s in level_specs(cfg, b, v1=True)]
    for b, h, w, C in V1_SNCV_EDGE_SHAPES:
        f = torch.full((b, 2), FOCAL)
        specs.append((0, h, w, C, 1, Camera(f, f.clone())))
    return specs


def unit_cuts(g: torch.Generator, shape, cuts: int) -> torch.Tensor:
    """Random features, L2-normalised per cut as the model feeds both ops."""
    b, h, w, C = shape
    x = torch.randn(b, h, w, cuts, C // cuts, generator=g)
    x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return x.reshape(shape)


def op_inputs(spec, dev, seed: int, sncv_radius: int = SPATIAL_SEARCH):
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
               g_sncv=torch.randn(b, h, w, (2 * sncv_radius + 1) ** 2 * cuts,
                                  generator=g),
               g_cv=torch.randn(b, h, w, 9 * cuts, generator=g),
               g_para=torch.randn(b, h, w, 1, generator=g))
    return {k: v.to(dev).contiguous() for k, v in out.items()}


def err_key(kernel: str, dtype) -> str:
    """Where a kernel's largest error is kept: float16's apart, for the
    float16 entries of the kernels line."""
    return f"{kernel}[float16]" if dtype == torch.float16 else kernel


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def dscv_args(x, dtype, rot=None):
    return (x["c1"].to(dtype), x["c2"].to(dtype), x["para"], x["centre"],
            x["rot"] if rot is None else rot, x["trans"],
            Camera(x["f"], x["c"]), DEPTH_SEARCH)


# -- phase 2 ----------------------------------------------------------------


def forwards_vs_plain(cfg: ModelConfig, dev, b: int) -> dict:
    """M4Depth's two forward kernels against their plain versions at every
    level shape at batch b, in float32, bfloat16 and float16; returns the
    largest error seen per kernel (``err_key``)."""
    worst = {err_key(k, d): 0.0 for k in FORWARD for d in KERNEL_DTYPES}
    for spec in level_specs(cfg, b):
        level, h, w, C, cuts = spec[:5]
        x = op_inputs(spec, dev, seed=level)
        for dtype in KERNEL_DTYPES:
            name = dtype_name(dtype)
            c1, c2 = x["c1"].to(dtype), x["c2"].to(dtype)
            errs = []
            # the model's autocorrelation, and a cross-correlation
            for u, v in ((c1, c1), (c1, c2)):
                out = spatial_cost_volume_fused(u, v, SPATIAL_SEARCH, cuts,
                                                dtype, LEAKY)
                ref = spatial_cost_volume(u, v, SPATIAL_SEARCH, cuts, dtype,
                                          LEAKY)
                torch.cuda.synchronize()
                check(out.shape == (b, h, w, 49 * cuts), f"sncv {out.shape}")
                torch.testing.assert_close(out, ref, **SNCV_TOL)
                errs.append(max_abs_err(out, ref))
            sk = err_key("sncv_forward", dtype)
            worst[sk] = max(worst[sk], *errs)
            # the main path's quaternion, and the small-angle form
            d_errs = []
            for rot in (x["rot"], x["rot"][:, 1:]):
                args = dscv_args(x, dtype, rot)
                cv, para = parallax_sweeping_cv_fused(*args, cuts, dtype)
                cv_ref, para_ref = parallax_sweeping_cv(*args, cuts, dtype)
                torch.cuda.synchronize()
                check(cv.shape == (b, h, w, 9 * cuts)
                      and para.shape == (b, h, w, 1),
                      f"dscv {cv.shape} {para.shape}")
                torch.testing.assert_close(cv, cv_ref, **DSCV_CV_TOL)
                torch.testing.assert_close(para, para_ref, **DSCV_PARA_TOL)
                d_errs.append((max_abs_err(cv, cv_ref),
                               max_abs_err(para, para_ref)))
            dk = err_key("dscv_forward", dtype)
            worst[dk] = max(worst[dk], *(e for p in d_errs for e in p))
            log(f"  level {level} b={b} {h}x{w} C={C} cuts={cuts} {name}: "
                f"sncv max|err| {errs[0]:.3e} (c1 is c2), {errs[1]:.3e} "
                f"(c1 != c2); dscv cv, parallax max|err| "
                f"{d_errs[0][0]:.3e}, {d_errs[0][1]:.3e} (quaternion), "
                f"{d_errs[1][0]:.3e}, {d_errs[1][1]:.3e} (small angle)")
    return worst


def phase_kernels_vs_plain(cfg: ModelConfig, dev) -> dict:
    """Each kernel against its plain version at every level shape, in
    float32, bfloat16 and float16; returns the largest error seen per
    kernel (``err_key``)."""
    worst = forwards_vs_plain(cfg, dev, 1)
    # V1: radius 4, one cut, the current features against the warped ones,
    # at the level shapes and at the edge shapes of its launch plans
    for i, spec in enumerate(v1_specs(cfg)):
        level, h, w, C = spec[:4]
        b = spec[5].f.shape[0]
        x = op_inputs(spec, dev, seed=level or 50 + i, sncv_radius=V1_SEARCH)
        errs = []
        for dtype in KERNEL_DTYPES:
            c1, c2 = x["c1"].to(dtype), x["c2"].to(dtype)
            out = spatial_cost_volume_fused(c1, c2, V1_SEARCH, 1, dtype,
                                            LEAKY)
            ref = spatial_cost_volume(c1, c2, V1_SEARCH, 1, dtype, LEAKY)
            torch.cuda.synchronize()
            check(out.shape == (b, h, w, 81), f"v1 sncv {out.shape}")
            torch.testing.assert_close(out, ref, **SNCV_TOL)
            errs.append(max_abs_err(out, ref))
            sk = err_key("sncv_forward", dtype)
            worst[sk] = max(worst[sk], errs[-1])
        log(f"  V1 {f'level {level}' if level else 'edge'} b={b} {h}x{w} "
            f"C={C} r={V1_SEARCH} cuts=1 c1 != c2: sncv max|err| "
            f"{errs[0]:.3e} (float32), {errs[1]:.3e} (bfloat16), "
            f"{errs[2]:.3e} (float16)")
    return worst


# -- phase 3 ----------------------------------------------------------------


def phase_backward_vs_plain(cfg: ModelConfig, dev) -> dict:
    """Each backward kernel (through its autograd Function) against its
    plain version (the SNCV's: ``sncv_plain_grads`` on the kernel
    forward's output; the DSCV's: autograd of the plain forward), at every
    level shape with b=3, in float32, bfloat16 and float16, for every input
    gradient; returns the largest error per kernel (``err_key``)."""
    worst = {err_key(k, d): 0.0 for k in BACKWARD for d in KERNEL_DTYPES}
    for spec in level_specs(cfg, TRAIN_B):
        level, h, w, C, cuts = spec[:5]
        x = op_inputs(spec, dev, seed=100 + level)
        for dtype in KERNEL_DTYPES:
            name = dtype_name(dtype)
            line = []
            for same in (True, False):
                grads = []
                a = x["c1"].to(dtype).requires_grad_()
                b = a if same else x["c2"].to(dtype).requires_grad_()
                out = spatial_cost_volume_fused(a, b, SPATIAL_SEARCH, cuts,
                                                dtype, LEAKY)
                grads.append(torch.autograd.grad(
                    out, [a] if same else [a, b], x["g_sncv"]))
                grads.append(sncv_plain_grads(
                    a, b, SPATIAL_SEARCH, cuts, dtype, x["g_sncv"],
                    out.detach(), LEAKY))
                torch.cuda.synchronize()
                errs = assert_sncv_grads_close(*grads, dtype, same,
                                               f"sncv {name}")
                sk = err_key("sncv_backward", dtype)
                worst[sk] = max(worst[sk], *errs)
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
                dk = err_key("dscv_backward", dtype)
                worst[dk] = max(worst[dk], *errs)
                line.append(f"dscv {rot_name} " + ", ".join(
                    f"{e:.3e}" for e in errs) + f" ({int((~mask).sum())} "
                    "tie pixels left out of dcentre)")
            log(f"  level {level} {h}x{w} C={C} cuts={cuts} {name}, "
                f"max|kernel - plain| of dc1[, dc2][, dpara, dcentre]: "
                + "; ".join(line))
    for i, spec in enumerate(v1_specs(cfg)):
        level, h, w, C = spec[:4]
        b = spec[5].f.shape[0]
        x = op_inputs(spec, dev, seed=200 + (level or 50 + i),
                      sncv_radius=V1_SEARCH)
        line = []
        for dtype in KERNEL_DTYPES:
            ins = [x["c1"].to(dtype).requires_grad_(),
                   x["c2"].to(dtype).requires_grad_()]
            out = spatial_cost_volume_fused(*ins, V1_SEARCH, 1, dtype, LEAKY)
            grads = [torch.autograd.grad(out, ins, x["g_sncv"]),
                     sncv_plain_grads(*ins, V1_SEARCH, 1, dtype,
                                      x["g_sncv"], out.detach(), LEAKY)]
            torch.cuda.synchronize()
            errs = assert_sncv_grads_close(*grads, dtype, False,
                                           f"v1 sncv {dtype}")
            sk = err_key("sncv_backward", dtype)
            worst[sk] = max(worst[sk], *errs)
            line.append(f"{str(dtype)[6:]} " + ", ".join(
                f"{e:.3e}" for e in errs))
        log(f"  V1 {f'level {level}' if level else 'edge'} b={b} {h}x{w} "
            f"C={C} r={V1_SEARCH} cuts=1, max|kernel - plain| of dc1, dc2: "
            + "; ".join(line))
    return worst


# -- phase 4 ----------------------------------------------------------------


def phase_model_card_vs_cpu(dev) -> None:
    """d6 at 128x128, b=2, 3 frames, element 0 reset at frame 2: depth from
    the card (kernels) against the CPU (plain versions), same weights. The
    card runs twice: with cuDNN, and with cuDNN off, where the convs return
    NCHW memory and the decoder must still hand the kernels (which refuse
    strided inputs) contiguous NHWC features."""
    cfg = ModelConfig(compute_dtype="float32", cv_dtype="float32")
    b, hw = 2, 128
    g = torch.Generator().manual_seed(11)
    frames = [torch.rand(b, hw, hw, 3, generator=g) for _ in range(3)]
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
    f = torch.full((b, 2), hw / 2.0)
    # (name, device, cuDNN context); flags() sets every cuDNN flag, so TF32
    # is named to stay off
    runs = (("cpu", "cpu", contextlib.nullcontext),
            ("card", dev, contextlib.nullcontext),
            ("card, cuDNN off", dev, lambda: torch.backends.cudnn.flags(
                enabled=False, allow_tf32=False)))
    models = {name: M4Depth(cfg, device=d, seed=2) for name, d, _ in runs}
    states = {name: init_state(cfg, b, hw, hw, device=d)
              for name, d, _ in runs}
    before = {k: kern.launches for k, kern in KERNELS.items()}
    for t in range(3):
        new_traj = torch.tensor([t in (0, 2), t == 0])
        depth = {}
        for name, d, ctx in runs:
            with ctx():
                states[name], depth[name] = models[name].step(
                    states[name], frames[t].to(d), rot.to(d), trans.to(d),
                    Camera(f.to(d), f.to(d)), new_traj.to(d))
        errs = []
        for name in ("card", "card, cuDNN off"):
            card = depth[name].cpu()
            check(card.shape == (b, hw, hw, 1)
                  and bool(torch.isfinite(card).all()),
                  f"{name} depth {card.shape}, finite")
            torch.testing.assert_close(card, depth["cpu"], **MODEL_TOL)
            errs.append(f"{name} {max_abs_err(card, depth['cpu']):.3e}")
        log(f"  frame {t}: max|depth card - cpu| " + ", ".join(errs)
            + f" (depth {depth['cpu'].min().item():.4g}.."
            f"{depth['cpu'].max().item():.4g})")
    want_frames = m4depth_serving_launches(2 * 3, cfg.num_levels)
    for k, kern in KERNELS.items():
        n = kern.launches - before[k]
        want = want_frames[k]
        check(n == want, f"{k}: {n} launches in 2 x 3 frames on the card, "
              f"expected {want}")


# -- phase 5 ----------------------------------------------------------------


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


@contextlib.contextmanager
def captured_dscv_inputs(calls: dict):
    """The decoder's DSCV calls record their arguments in ``calls``, by the
    level's (h, w), and run as before."""
    fused = decoder.parallax_sweeping_cv_fused

    def record(*args):
        calls[tuple(args[0].shape[1:3])] = args
        return fused(*args)

    decoder.parallax_sweeping_cv_fused = record
    try:
        yield
    finally:
        decoder.parallax_sweeping_cv_fused = fused


def phase_train_card_vs_cpu(dev) -> None:
    """d6 at 128x128, b=2, T=3, float32: one training step on the card
    (kernels) against the CPU (plain versions) from the same weights and
    batch, for each of STEP_SEEDS. Two more card steps say where a gap
    comes from: one with the plain cost volumes, glue and conv epilogue
    in place of the kernels (the gap the rest of the card's arithmetic
    makes alone), one with every frame value one float32 ulp off (how
    far rounding moves a gradient). The gradients reach the encoder only
    through the cost volumes, so a non-zero encoder gradient on the card
    shows they flow."""
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
            on_card_plain = plain and d != "cpu"
            with (plain_cost_volumes() if on_card_plain
                  else contextlib.nullcontext()), (
                      plain_glue() if on_card_plain
                      else contextlib.nullcontext()), (
                      plain_epilogue() if on_card_plain
                      else contextlib.nullcontext()):
                out = {k: v.item() for k, v in
                       make_train_step(model, opt)(batch).items()}
            want_step = m4depth_launches(T, cfg.num_levels)
            for k, kern in KERNELS.items():
                n = kern.launches - before[k]
                want = 0 if plain else want_step[k]
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


def phase_main_path(dev, family=M4Depth, per_frame=None,
                    cv_dtype: str = "bfloat16", blocks: int = TIMED_BLOCKS):
    """Streaming d6 384x384 bf16 of ``family`` with ``cv_dtype`` cost
    volumes, whose frame launches ``per_frame`` of each kernel (default:
    M4Depth's, each forward kernel once a level), over ``blocks`` timed
    blocks. The launch counts are zeroed just before the first frame and
    read just after the last one."""
    # what earlier phases left allocated (the cuBLAS workspace of phase 4's
    # cuDNN-off convs, say) counts in the peak; the path's own memory
    # (weights, inputs, state, activations) is the peak above it
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype=cv_dtype)
    if per_frame is None:
        per_frame = m4depth_serving_launches(1, cfg.num_levels)
    model = family(cfg, device=dev, seed=0)
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
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(FRAMES_PER_BLOCK):
            state, depth = frame(state, go)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3 / FRAMES_PER_BLOCK)
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    n_frames = 1 + WARMUP_FRAMES + blocks * FRAMES_PER_BLOCK
    check(depth.shape == (1, SIZE, SIZE, 1), f"depth shape {depth.shape}")
    check(bool(torch.isfinite(depth).all()), "finite depth on the main path")
    for k, n in launches.items():
        want = per_frame[k] * n_frames
        check(n == want, f"{k}: {n} launches in {n_frames} frames, "
              f"expected {want}")
    med = statistics.median(block_ms)
    log(f"  {n_frames} frames; ms/frame median {med:.4f} "
        f"(blocks {', '.join(f'{v:.4f}' for v in block_ms)}; "
        f"min {min(block_ms):.4f}, max {max(block_ms):.4f}); "
        f"{1e3 / med:.2f} frames/s")
    log(f"  peak device memory {peak} bytes ({peak / 2**20:.1f} MiB), "
        f"{peak - base} bytes ({(peak - base) / 2**20:.1f} MiB) above the "
        f"{base} allocated before the model was made")
    log(f"  launches: " + ", ".join(
        f"{k} {n} ({n // n_frames}/frame)" for k, n in launches.items()))
    log(f"  depth range {depth.min().item():.4g}..{depth.max().item():.4g}")
    state_box = [state]

    def run_frame():
        state_box[0], _ = frame(state_box[0], go)

    return dict(run=run_frame, launches=launches, n_frames=n_frames,
                ms_per_frame=med, peak_above_base=peak - base, model=model)


# -- phase 7 ----------------------------------------------------------------


def phase_profile(run, n: int, unit: str) -> dict:
    """Device time by kernel over ``n`` calls of ``run`` (one frame or one
    step each), the device's busy share of the window's wall time, the
    kernel launches per call and the cost-volume kernels' share of the busy
    time; returns those per call (empty if the profiler saw no device
    time)."""
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
        return {}
    rows.sort(reverse=True)
    log(f"  {n} {unit}s, wall {wall_us / n:.1f} us/{unit}, device busy "
        f"{busy / n:.1f} us/{unit} ({100 * busy / wall_us:.1f}% busy, "
        f"{100 - 100 * busy / wall_us:.1f}% idle), "
        f"{sum(r[1] for r in rows) / n:.0f} kernels/{unit}")
    cv = {k: sum(r[0] for r in rows if k in r[2]) / n
          for k in ("sncv", "dscv")}
    log(f"  [{gpu_name_and_power_limit()}] cost-volume kernels: " + ", ".join(
        f"{k} {us:.1f} us/{unit} ({100 * us * n / busy:.1f}% of busy)"
        for k, us in cv.items()))
    for us, count, key in rows[:15]:
        log(f"    {us / n:9.2f} us/{unit} {100 * us / busy:5.1f}%  "
            f"x{count / n:g}/{unit}  {key[:90]}")
    for us, count, key in rows[15:]:
        if any(k in key for k in ("sncv", "dscv")):
            log(f"    {us / n:9.2f} us/{unit} {100 * us / busy:5.1f}%  "
                f"x{count / n:g}/{unit}  {key[:90]}")
    return dict(wall_us=wall_us / n, busy_us=busy / n,
                kernels=sum(r[1] for r in rows) / n,
                **{f"{k}_us": us for k, us in cv.items()})


# -- phase 8 ----------------------------------------------------------------


def phase_train_path(dev, family=M4Depth, T: int = TRAIN_T,
                     per_step=None, wrap=None, **cfg_kw):
    """The training path: ``make_train_step`` of the d6 ``family`` at
    384x384, b=3, T frames, bf16/bf16 (``cfg_kw`` adds model settings),
    Adam at 1e-4, on a seeded batch with bench's motion; each step must
    launch ``per_step`` of each kernel (default: M4Depth's, each kernel
    once a level of each frame after the first). ``wrap`` (phase 15:
    ``data_parallel``) wraps the model that the step runs. The launch
    counts are zeroed just before the first step and read just after the
    last one."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = ModelConfig(**{"compute_dtype": "bfloat16",
                         "cv_dtype": "bfloat16", **cfg_kw})
    if per_step is None:
        per_step = m4depth_launches(T, cfg.num_levels,
                                    remat=cfg.remat_policy if cfg.remat
                                    else "")
    model = family(cfg, device=dev, seed=0)
    step = make_train_step(model if wrap is None else wrap(model),
                           make_optimizer(model, TrainConfig(
                               learning_rate=LEARNING_RATE)))
    batch = train_batch(TRAIN_B, T, SIZE, 0, ROT, TRANS, dev)
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
    for k, n in launches.items():
        check(n == per_step[k] * n_steps, f"{k}: {n} launches in {n_steps} "
              f"steps, expected {per_step[k]} per step")
    scalars = [{k: v.item() for k, v in o.items()} for o in outs]
    check(all(np.isfinite(v) for sc in scalars for v in sc.values()),
          "finite loss, RMSE_log and grad_norm at every step")
    med = statistics.median(block_ms)
    log(f"  {n_steps} steps ({TRAIN_WARMUP_STEPS} warm-up, {TRAIN_BLOCKS} "
        f"blocks of {STEPS_PER_BLOCK}); ms/step median {med:.4f} (blocks "
        f"{', '.join(f'{v:.4f}' for v in block_ms)}; min "
        f"{min(block_ms):.4f}, max {max(block_ms):.4f}); "
        f"{1e3 / med * TRAIN_B:.2f} windows/s")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB), "
        f"{peak - base} bytes ({(peak - base) / 2**30:.2f} GiB) above the "
        f"{base} allocated before the model was made")
    log(f"  launches: " + ", ".join(
        f"{k} {n} ({n // n_steps}/step)" for k, n in launches.items()))
    log("  loss by step: " + ", ".join(f"{sc['loss']:.6f}" for sc in scalars))
    log("  grad_norm by step: " + ", ".join(
        f"{sc['grad_norm']:.5g}" for sc in scalars))
    log(f"  RMSE_log of the last step {scalars[-1]['RMSE_log']:.6f}")
    return dict(run=lambda: step(batch), launches=launches, n_steps=n_steps,
                per_step=per_step, ms_per_step=med,
                peak_above_base=peak - base, model=model)


# -- phase 12 ---------------------------------------------------------------


def phase_v1_card_vs_cpu(dev) -> None:
    """The V1 model, d6 at 128x128, b=2, 3 frames, element 0 reset at frame
    2 (as phase 4): depth from the card (the SNCV kernel at radius 4)
    against the CPU (its plain version), same weights, float32."""
    cfg = ModelConfig(compute_dtype="float32", cv_dtype="float32")
    b, hw = 2, 128
    g = torch.Generator().manual_seed(12)
    frames = [torch.rand(b, hw, hw, 3, generator=g) for _ in range(3)]
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
    f = torch.full((b, 2), hw / 2.0)
    models = {d: M4DepthV1(cfg, device=d, seed=2) for d in ("cpu", dev)}
    states = {d: init_state(cfg, b, hw, hw, device=d) for d in models}
    before = launch_counts()
    for t in range(3):
        new_traj = torch.tensor([t in (0, 2), t == 0])
        depth = {}
        for d, model in models.items():
            states[d], depth[d] = model.step(
                states[d], frames[t].to(d), rot.to(d), trans.to(d),
                Camera(f.to(d), f.to(d)), new_traj.to(d))
        card = depth[dev].cpu()
        check(card.shape == (b, hw, hw, 1)
              and bool(torch.isfinite(card).all()), "V1 card depth")
        torch.testing.assert_close(card, depth["cpu"], **MODEL_TOL)
        log(f"  frame {t}: max|depth card - cpu| "
            f"{max_abs_err(card, depth['cpu']):.3e} (depth "
            f"{depth['cpu'].min().item():.4g}.."
            f"{depth['cpu'].max().item():.4g})")
    for k, n in launch_counts().items():
        n -= before[k]
        want = v1_serving_launches(3, cfg.num_levels)[k]
        check(n == want, f"V1 {k}: {n} launches in 3 frames on the card, "
              f"expected {want}")


def v1_launches(frames: int, levels: int = 6) -> dict:
    """V1's training step over ``frames`` frames launches the SNCV forward
    and backward once a level a frame, the epilogue and its backward once
    a conv a frame, no DSCV and no glue kernel (its glue runs plain under
    grad)."""
    out = {k: levels * frames if k.startswith("sncv") else 0
           for k in KERNELS}
    out.update(dict.fromkeys(
        EPILOGUE, (ENCODER_CONVS + REFINER_CONVS) * levels * frames))
    return out


def v1_serving_launches(frames: int = 1, levels: int = 6) -> dict:
    """A V1 serving path's launches in ``frames`` frames without grad: the
    SNCV forward and each V1 glue kernel once a level, the epilogue's
    forward once a conv."""
    out = {k: levels * frames if k in V1_SERVING else 0 for k in KERNELS}
    out["conv_epilogue_forward"] = ((ENCODER_CONVS + REFINER_CONVS)
                                    * levels * frames)
    return out


def phase_remat(dev) -> dict:
    """The training step at T=REMAT_T (b=3, d6 384x384 bf16) without remat,
    with ``remat_policy`` "all" (each decoder level runs its forward again
    in the backward: each forward kernel launches twice a level) and
    "dscv" (the DSCV alone again)."""
    runs = {}
    for name, kw in (("none", {}),
                     ("all", dict(remat=True, remat_policy="all")),
                     ("dscv", dict(remat=True, remat_policy="dscv"))):
        log(f"  remat {name}:")
        runs[name] = phase_train_path(dev, T=REMAT_T, **kw)
        del runs[name]["run"]                 # frees the model and batch
        torch.cuda.empty_cache()
    return runs


# -- phase 13 ---------------------------------------------------------------


def phase_gates() -> dict:
    """Each family's geometry gate, ``m4depth_tpu_torch.tools.
    synthetic_validation --mode overfit`` in this process on the card;
    raises unless it passes. Returns AbsRel, Delta1, the wall time and the
    kernels' launches of each."""
    from m4depth_tpu_torch.tools import synthetic_validation

    card = gpu_name_and_power_limit()
    out = {}
    for model, steps in GATE_STEPS.items():
        argv = ["--mode", "overfit", "--model", model, "--steps", str(steps)]
        text = io.StringIO()
        zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = synthetic_validation.main(argv)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        for line in text.getvalue().splitlines():
            log(f"    | {line}")
        metrics = parsed(r"AbsRel': ([0-9.e-]+)", text.getvalue(), "AbsRel"
                         ), parsed(r"Delta1': ([0-9.e-]+)", text.getvalue(),
                                   "Delta1")
        check(rc == 0 and "GEOMETRY VALIDATION PASSED" in text.getvalue(),
              f"the {model} geometry gate: AbsRel {metrics[0]}, Delta1 "
              f"{metrics[1]}")
        # d4, T=2: M4Depth's cost volumes run on frame 1 of each window, V1's
        # on both frames; the evaluation adds one window's forwards (and
        # their glue: M4Depth's glue_prep on both frames, V1's on both)
        if model == "m4depth-v1":
            train, evaluate = v1_launches(2, 4), v1_serving_launches(2, 4)
        else:
            train = m4depth_launches(2, 4)
            evaluate = m4depth_launches(2, 4, train=False)
        for k, n in launches.items():
            want = steps * train[k] + evaluate[k]
            check(n == want, f"{model} gate: {k} {n} launches, expected "
                  f"{want}")
        log(f"  [{card}] {model} geometry gate (d4 64x64 bf16, b=4, T=2, "
            f"{steps} steps): AbsRel {metrics[0]}, Delta1 {metrics[1]}, "
            f"{wall:.1f} s wall including the evaluation; launches "
            + ", ".join(f"{k} {n}" for k, n in launches.items()))
        out[model] = dict(abs_rel=metrics[0], delta1=metrics[1], wall_s=wall,
                          launches=launches)
    return out


# -- phase 11 ---------------------------------------------------------------

# the CLI's path: a synthetic Mid-Air record store of STORE_TRAJ
# trajectories of STORE_FRAMES frames at SIZE x SIZE, each trajectory made
# of scenes of SCENE_FRAMES frames (a scene starts with new_traj)
STORE_TRAJ, STORE_FRAMES, SCENE_FRAMES = 4, 32, 8
CLI_TRAIN_STEPS, CLI_RESUME_STEPS, CLI_AUGMENT_STEPS = 10, 15, 5
CLI_VALIDATION_WINDOWS = 8
CHILD_TIMEOUT_S = 300
CLI_LOG_EVERY = 5
# one epoch each of V1's train mode and of --remat at T=REMAT_T (the store's
# 16 windows of 8 frames make 5 batches of 3)
CLI_V1_STEPS = CLI_REMAT_STEPS = 5
# the finetune's stores: KITTI-shaped trajectories at 256x768 with sparse
# depth, Mid-Air at the crop's 768x768 intermediate; one epoch of the joint
# sampler is twice KITTI's 3 batches
KITTI_HW, KITTI_TRAJ, KITTI_FRAMES = (256, 768), 3, 12
MIDAIR_FT_FRAMES = 24
FINETUNE_STEPS = 6


def write_synthetic_store(root: str) -> str:
    """A record store written with the port's ``make_sequence`` and
    ``RecordStoreWriter``, and a dataset-location file naming it; returns
    the location file's path."""
    from m4depth_tpu_torch.data.records import RecordStoreWriter
    from m4depth_tpu_torch.data.synthetic import make_sequence

    store = os.path.join(root, "store")
    writer = RecordStoreWriter(store, num_shards=4)
    for t in range(STORE_TRAJ):
        frames = []
        for s in range(STORE_FRAMES // SCENE_FRAMES):
            seq = make_sequence(np.random.RandomState(100 * t + s),
                                SCENE_FRAMES, SIZE, SIZE)
            for i in range(SCENE_FRAMES):
                frames.append(dict(
                    RGB_im=seq["RGB_im"][i], depth=seq["depth"][i],
                    rot=seq["rot"][i], trans=seq["trans"][i],
                    camera_f=seq["camera_f"], camera_c=seq["camera_c"],
                    new_traj=np.bool_(i == 0)))
        writer.write_trajectory(frames, name=f"traj_{t:04d}")
    writer.close()
    location = os.path.join(root, "datasets_location.json")
    with open(location, "w") as f:
        json.dump({"midair": store}, f)
    return location


def write_finetune_stores(root: str) -> None:
    """Record stores ``root/kitti-raw`` (KITTI-shaped, depth kept at one
    pixel in five, as velodyne depth) and ``root/midair`` (at the square
    intermediate of the Mid-Air crop to KITTI's size)."""
    from m4depth_tpu_torch.data.records import RecordStoreWriter
    from m4depth_tpu_torch.data.synthetic import make_sequence

    for name, n, frames, (h, w), sparse in (
            ("kitti-raw", KITTI_TRAJ, KITTI_FRAMES, KITTI_HW, True),
            ("midair", 1, MIDAIR_FT_FRAMES, (KITTI_HW[1],) * 2, False)):
        writer = RecordStoreWriter(os.path.join(root, name), num_shards=2)
        for t in range(n):
            rng = np.random.RandomState(500 + t)
            seq = make_sequence(rng, frames, h, w)
            depth = seq["depth"]
            if sparse:
                depth = depth * (rng.rand(*depth.shape) < 0.2)
            writer.write_trajectory([dict(
                RGB_im=seq["RGB_im"][i], depth=depth[i], rot=seq["rot"][i],
                trans=seq["trans"][i], camera_f=seq["camera_f"],
                camera_c=seq["camera_c"], new_traj=np.bool_(i == 0))
                for i in range(frames)], name=f"traj_{t:04d}")
        writer.close()


def run_cli(argv, entry=None) -> str:
    """``entry(argv)`` (default ``m4depth_tpu_torch.cli.main.main``) in this
    process; raises unless it returns 0. Returns what it printed (also
    echoed, indented)."""
    from m4depth_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = (entry or cli_main)(argv)
    for line in out.getvalue().splitlines():
        log(f"    | {line}")
    check(rc == 0, f"CLI {argv[0]} returned {rc}")
    return out.getvalue()


def launch_counts() -> dict:
    return {k: kern.launches for k, kern in KERNELS.items()}


def parsed(pattern: str, text: str, what: str) -> float:
    found = re.findall(pattern, text)
    check(bool(found), f"{what} in the CLI's output")
    return float(found[-1])


def phase_cli(dev, train_ms_no_loading: float) -> dict:
    """The CLI's train (twice: fresh, then resumed), train with
    --augment_device, eval and predict modes, in process, and its
    validation mode in the child that ``SubprocessValidator`` spawns on the
    card, on a synthetic record store at d6 384x384; then the CLI's
    streaming path against ``M4Depth.step`` on one trajectory, and the
    loader alone."""
    from m4depth_tpu_torch.cli.main import (
        SubprocessValidator,
        build_dataset,
        build_model,
        predict_stream,
        restore_params_for_eval,
    )
    from m4depth_tpu_torch.cli.options import (
        build_parser,
        model_config_from_args,
    )
    from m4depth_tpu_torch.data.records import RecordTrajectoryReader
    from m4depth_tpu_torch.train.loop import to_device

    t_phase = time.perf_counter()
    card = gpu_name_and_power_limit()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        location = write_synthetic_store(root)
        store = os.path.join(root, "store")
        log(f"  store: {STORE_TRAJ} trajectories x {STORE_FRAMES} frames at "
            f"{SIZE}x{SIZE}, {sum(os.path.getsize(os.path.join(store, n)) for n in os.listdir(store))} "
            f"bytes, written in {time.perf_counter() - t0:.3f} s")
        common = ["--dataset=midair", f"--db_path_config={location}",
                  f"--record_store={store}", "--arch_depth=6",
                  "--out_size", str(SIZE), str(SIZE), "--num_workers=8"]
        # a loss printed every CLI_LOG_EVERY steps; fit's tripwire checks
        # every loss and raises on one that is not finite
        train_args = common + ["--batch_size=3", "--seq_len=4",
                               "--db_seq_len=8",
                               f"--summary_interval={CLI_LOG_EVERY}"]
        ckpt = os.path.join(root, "ckpt")

        # 1. train 2 epochs; the counts are zeroed just before, read after
        zero_launch_counts()
        text = run_cli(["--mode=train", f"--ckpt_dir={ckpt}",
                        f"--total_steps={CLI_TRAIN_STEPS}"] + train_args)
        out["train_launches"] = launch_counts()
        per_step = m4depth_launches(TRAIN_T)
        for k, n in out["train_launches"].items():
            check(n == per_step[k] * CLI_TRAIN_STEPS,
                  f"CLI train: {k} {n} launches in {CLI_TRAIN_STEPS} steps")
        ms_step = parsed(r"step ms median ([0-9.]+)", text, "step time")
        losses = [float(v) for v in re.findall(r"loss=([^ ]+)", text)]
        saved = sorted(os.listdir(os.path.join(ckpt, "train")))
        check(saved == ["0.pt", "1.pt"], f"checkpoints after 2 epochs: {saved}")

        # 2. resume to a larger total: epoch 2 only, from step 10
        text = run_cli(["--mode=train", f"--ckpt_dir={ckpt}",
                        f"--total_steps={CLI_RESUME_STEPS}"] + train_args)
        check("Resuming from epoch 2" in text, "the second run resumed")
        resumed = torch.load(os.path.join(ckpt, "train", "2.pt"),
                             map_location="cpu", weights_only=True)
        check(resumed["count"] == CLI_RESUME_STEPS and resumed["epoch"] == 2,
              f"resumed run ended at update {resumed['count']}, epoch "
              f"{resumed['epoch']}")
        for name in ("0.pt", "1.pt", "2.pt"):
            sd = torch.load(os.path.join(ckpt, "train", name),
                            map_location="cpu", weights_only=True)
            check(all(bool(torch.isfinite(v).all())
                      for v in sd["model"].values()),
                  f"finite weights in {name}")

        # 3. train with the augmentation on the device
        zero_launch_counts()
        run_cli(["--mode=train", f"--ckpt_dir={os.path.join(root, 'aug')}",
                 f"--total_steps={CLI_AUGMENT_STEPS}", "--augment_device"]
                + train_args)
        aug = launch_counts()
        check(all(n == per_step[k] * CLI_AUGMENT_STEPS
                  for k, n in aug.items()),
              f"CLI train --augment_device launches {aug}")

        # 4. validation of the latest checkpoint, by the child process that
        # per-epoch subprocess validation spawns, on the card
        vcmd = build_parser(argparse.ArgumentParser()).parse_args(
            ["--mode=train", f"--ckpt_dir={ckpt}", "--validation_device=gpu",
             f"--validation_max_batches={CLI_VALIDATION_WINDOWS}"] + common)
        child = SubprocessValidator(vcmd)
        check("--platform=gpu" in child.args, "the validation child's "
              f"platform: {child.args}")
        # its KITTI set is not in the repository, and this host could not
        # decode its PNGs: the store's flags, appended, win in its parser
        child.args += ["--dataset=midair", f"--db_path_config={location}",
                       f"--record_store={store}",
                       "--out_size", str(SIZE), str(SIZE)]
        t0 = time.perf_counter()
        child(None)
        while child.busy and time.perf_counter() - t0 < CHILD_TIMEOUT_S:
            time.sleep(0.2)
        if child.busy:
            child._child.kill()  # stopped before the check fails the phase
        child.close()
        out["child_s"] = time.perf_counter() - t0
        with open(os.path.join(ckpt, "validation-subprocess.log")) as f:
            for line in f.read().splitlines():
                log(f"    child | {line}")
        check(child.spawned == 1 and child.failed == 0,
              f"validation child on the card: {child.failed} failed")
        log(f"  validation child on the card ({CLI_VALIDATION_WINDOWS} "
            f"windows of 4 frames): {out['child_s']:.3f} s from spawn to "
            "exit")
        with open(os.path.join(ckpt, "best", "validation_perfs.csv")) as f:
            rows = f.read().splitlines()
        check(len(rows) == 2 and rows[1].endswith("ckpt-0002"),
              f"best-checkpoint ledger {rows}")
        with open(os.path.join(ckpt, "validation-perfs.txt")) as f:
            check(len(f.read().split()) == 7, "validation-perfs.txt")

        # 5. eval (streaming, every frame of the store)
        zero_launch_counts()
        text = run_cli(["--mode=eval", f"--ckpt_dir={ckpt}"] + common)
        out["eval_launches"] = launch_counts()
        n_frames = STORE_TRAJ * STORE_FRAMES
        for k, n in out["eval_launches"].items():
            want = m4depth_serving_launches(n_frames)[k]
            check(n == want, f"CLI eval: {k} {n} launches, expected {want}")
        ms_frame = parsed(r"evaluated \d+ frames in [0-9.]+ s \(([0-9.]+) "
                          r"ms/frame", text, "eval time")
        perfs = np.loadtxt(os.path.join(ckpt, "perfs-midair.txt"))
        check(perfs.shape == (7,) and bool(np.isfinite(perfs).all()),
              f"perfs-midair.txt {perfs}")
        log(f"  perfs-midair.txt: {perfs.tolist()}")
        # the same checkpoint with float16 cost volumes
        zero_launch_counts()
        text = run_cli(["--mode=eval", f"--ckpt_dir={ckpt}",
                        "--cv_dtype=float16"] + common)
        out["eval_f16_launches"] = launch_counts()
        check(out["eval_f16_launches"] == out["eval_launches"],
              f"CLI eval at float16: {out['eval_f16_launches']}")
        out["ms_frame_f16"] = parsed(
            r"evaluated \d+ frames in [0-9.]+ s \(([0-9.]+) ms/frame", text,
            "float16 eval time")
        perfs16 = np.loadtxt(os.path.join(ckpt, "perfs-midair.txt"))
        check(perfs16.shape == (7,) and bool(np.isfinite(perfs16).all()),
              f"perfs-midair.txt at float16 {perfs16}")
        log(f"  perfs-midair.txt at --cv_dtype=float16: {perfs16.tolist()}")

        # the CLI's streaming path against M4Depth.step on trajectory 0
        cmd = build_parser(argparse.ArgumentParser()).parse_args(
            ["--mode=eval", f"--ckpt_dir={ckpt}"] + common)
        model = build_model(cmd, model_config_from_args(cmd), dev)
        restore_params_for_eval(cmd, model, "best")
        stream = predict_stream(model, build_dataset(cmd, "eval", {}, 1))
        cli_depths = [d for _, (_, d) in zip(range(STORE_FRAMES), stream)]
        stream.close()
        frames = RecordTrajectoryReader(store).read_frames(0, 0, STORE_FRAMES)
        state = init_state(model.cfg, 1, SIZE, SIZE, device=dev)
        for i, fr in enumerate(frames):
            # stacked, as the loader batches frames: a [None] view has a
            # zero batch stride, and cuDNN may take another engine for it
            x = to_device({k: np.stack([fr[k]]) for k in (
                "RGB_im", "rot", "trans", "camera_f", "camera_c")}, dev)
            # a stored flag reads back as shape [1]; the step takes [b]
            reset = torch.tensor([bool(fr["new_traj"]) or i == 0],
                                 device=dev)
            state, depth = model.step(state, x["RGB_im"], x["rot"],
                                      x["trans"],
                                      Camera(x["camera_f"], x["camera_c"]),
                                      reset)
            check(torch.equal(depth, cli_depths[i]),
                  f"CLI streaming depth of frame {i} equals M4Depth.step's")
        log(f"  the CLI's streaming depth equals M4Depth.step's on all "
            f"{STORE_FRAMES} frames of trajectory 0 (bitwise)")

        # 6. predict
        zero_launch_counts()
        run_cli(["--mode=predict", f"--ckpt_dir={ckpt}"] + common)
        n = KERNELS["sncv_forward"].launches
        check(n == 6 * n_frames, f"CLI predict: {n} SNCV launches")

        # the loader alone, as the train mode builds it: two epochs
        tcmd = build_parser(argparse.ArgumentParser()).parse_args(
            ["--mode=train"] + train_args)
        ds = build_dataset(tcmd, "train", {}, tcmd.batch_size)
        loader = {}
        for name, copy in (("loader", False), ("loader + copy", True)):
            t0, n = time.perf_counter(), 0
            for epoch in range(2):
                for batch in ds.batches(epoch):
                    if copy:
                        to_device(batch, dev)
                    n += 1
            torch.cuda.synchronize()
            loader[name] = n / (time.perf_counter() - t0)

        # 7. the V1 family: train mode, then eval mode, on the same store
        v1 = ["--model=m4depth-v1"]
        v1_ckpt = os.path.join(root, "v1")
        zero_launch_counts()
        text = run_cli(["--mode=train", f"--ckpt_dir={v1_ckpt}",
                        f"--total_steps={CLI_V1_STEPS}"] + train_args + v1)
        out["v1_train_launches"] = launch_counts()
        out["v1_ms_step"] = parsed(r"step ms median ([0-9.]+)", text,
                                   "V1 step time")
        for k, count in out["v1_train_launches"].items():
            want = v1_launches(TRAIN_T)[k] * CLI_V1_STEPS
            check(count == want, f"CLI V1 train: {k} {count} launches, "
                  f"expected {want}")
        zero_launch_counts()
        text = run_cli(["--mode=eval", f"--ckpt_dir={v1_ckpt}"] + common + v1)
        out["v1_eval_launches"] = launch_counts()
        out["v1_ms_frame"] = parsed(
            r"evaluated \d+ frames in [0-9.]+ s \(([0-9.]+) ms/frame", text,
            "V1 eval time")
        for k, count in out["v1_eval_launches"].items():
            want = v1_serving_launches(n_frames)[k]
            check(count == want, f"CLI V1 eval: {k} {count} launches, "
                  f"expected {want}")
        perfs = np.loadtxt(os.path.join(v1_ckpt, "perfs-midair.txt"))
        check(perfs.shape == (7,) and bool(np.isfinite(perfs).all()),
              f"V1 perfs-midair.txt {perfs}")
        zero_launch_counts()
        run_cli(["--mode=eval", f"--ckpt_dir={v1_ckpt}",
                 "--cv_dtype=float16"] + common + v1)
        out["v1_eval_f16_launches"] = launch_counts()
        check(out["v1_eval_f16_launches"] == out["v1_eval_launches"],
              f"CLI V1 eval at float16: {out['v1_eval_f16_launches']}")
        perfs = np.loadtxt(os.path.join(v1_ckpt, "perfs-midair.txt"))
        check(perfs.shape == (7,) and bool(np.isfinite(perfs).all()),
              f"V1 perfs-midair.txt at float16 {perfs}")
        log(f"  V1 perfs-midair.txt at --cv_dtype=float16: {perfs.tolist()}")

        # 8. --remat (each decoder level again in the backward) at T=8
        zero_launch_counts()
        text = run_cli(["--mode=train",
                        f"--ckpt_dir={os.path.join(root, 'remat')}",
                        f"--total_steps={CLI_REMAT_STEPS}", "--remat",
                        "--remat_policy=all", "--batch_size=3",
                        f"--seq_len={REMAT_T}", f"--db_seq_len={REMAT_T}",
                        f"--summary_interval={CLI_LOG_EVERY}"] + common)
        check("changes nothing" not in text, "--remat is a flag of the port")
        out["remat_launches"] = launch_counts()
        out["remat_ms_step"] = parsed(r"step ms median ([0-9.]+)", text,
                                      "remat step time")
        remat_step = m4depth_launches(REMAT_T, remat="all")
        for k, count in out["remat_launches"].items():
            want = remat_step[k] * CLI_REMAT_STEPS
            check(count == want, f"CLI --remat: {k} {count} launches, "
                  f"expected {want}")

        # 9. the KITTI finetune from two record stores
        from m4depth_tpu_torch.cli import finetune_kitti

        t0 = time.perf_counter()
        stores = os.path.join(root, "finetune")
        write_finetune_stores(stores)
        log(f"  finetune stores written in {time.perf_counter() - t0:.3f} s")
        zero_launch_counts()
        text = run_cli([f"--record_stores={stores}",
                        f"--ckpt_dir={os.path.join(root, 'ft')}",
                        "--finetune_steps=0", "--arch_depth=6",
                        "--num_workers=8", "--batch_size=3",
                        f"--summary_interval={CLI_LOG_EVERY}"],
                       entry=finetune_kitti.main)
        out["finetune_launches"] = launch_counts()
        out["finetune_ms_step"] = parsed(r"step ms median ([0-9.]+)", text,
                                         "finetune step time")
        for k, count in out["finetune_launches"].items():
            check(count == per_step[k] * FINETUNE_STEPS,
                  f"finetune: {k} {count} launches in {FINETUNE_STEPS} steps")
        ft = torch.load(os.path.join(root, "ft", "train", "0.pt"),
                        map_location="cpu", weights_only=True)
        check(ft["count"] == FINETUNE_STEPS and all(
            bool(torch.isfinite(v).all()) for v in ft["model"].values()),
            f"finetune checkpoint at update {ft['count']}, finite weights")
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  [{card}] train mode, d6 {SIZE}x{SIZE} b=3 T=4 bf16 from the "
        f"store (host augmentation): {ms_step:.3f} ms/step, median of the "
        f"steps after the first of {CLI_TRAIN_STEPS}")
    log(f"  [{card}] the same step without loading (phase 8, one batch "
        f"reused): {train_ms_no_loading:.3f} ms/step")
    log(f"  [{card}] record-store loader, no model, b=3 T=4 with host "
        f"augmentation, {n} batches: {loader['loader']:.3f} batches/s "
        f"({1e3 / loader['loader']:.3f} ms/batch); with the pinned copy to "
        f"the card {loader['loader + copy']:.3f} batches/s")
    log(f"  [{card}] eval mode, streaming d6 {SIZE}x{SIZE} b=1 bf16, "
        f"{n_frames} frames: {ms_frame:.3f} ms/frame, loading included; "
        f"with float16 cost volumes {out['ms_frame_f16']:.3f} ms/frame")
    log(f"  [{card}] V1 train mode, d6 {SIZE}x{SIZE} b=3 T=4 bf16 from the "
        f"store: {out['v1_ms_step']:.3f} ms/step; V1 eval mode "
        f"{out['v1_ms_frame']:.3f} ms/frame")
    log(f"  [{card}] train mode with --remat (all) at T={REMAT_T}: "
        f"{out['remat_ms_step']:.3f} ms/step with loading")
    log(f"  [{card}] finetune_kitti, d6 {KITTI_HW[0]}x{KITTI_HW[1]} b=3 T=4 "
        f"bf16, KITTI and cropped Mid-Air stores: "
        f"{out['finetune_ms_step']:.3f} ms/step, {FINETUNE_STEPS} steps")
    log(f"  [{card}] peak device memory above the phase's baseline: "
        f"{peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    log(f"  CLI train losses logged (every {CLI_LOG_EVERY} steps; the "
        "tripwire checked every step's): "
        + ", ".join(f"{v:.5g}" for v in losses))
    check(losses and all(np.isfinite(v) for v in losses),
          "finite train losses")
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    out.update(ms_step=ms_step, ms_frame=ms_frame, loader=loader, peak=peak)
    return out


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
    # 3x the host's time and 50 ms (autograd's enqueue of a backward varies
    # by that much from one loop to the next), in cycles at the H100's top
    # clock (1.98 GHz); a lower clock only makes the spin longer
    torch.cuda._sleep(int((3 * host_s + 0.05) * 2.0e9))
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


def sncv_cases(x, radius: int, cuts: int, C: int, n_pix: int, dtype,
               same: bool, with_backward: bool) -> dict:
    """The SNCV's forward (and backward) cases at one level shape, as a
    model calls it: M4Depth with c1 is c2 (radius 3), V1 with the current
    features against the warped ones (radius 4, one cut)."""
    work = (n_pix, C, cuts, radius, torch.finfo(dtype).bits // 8, same)
    c1 = x["c1"].to(dtype)
    c2 = c1 if same else x["c2"].to(dtype)
    cases = {"sncv_forward": dict(
        kernel=lambda: spatial_cost_volume_fused(c1, c2, radius, cuts, dtype,
                                                 LEAKY),
        plain=lambda: spatial_cost_volume(c1, c2, radius, cuts, dtype,
                                          LEAKY),
        plain_calls=3,
        **dict(zip(("nbytes", "flops"), cost.sncv_forward_work(*work))))}
    if not with_backward:
        return cases
    with torch.no_grad():
        out = spatial_cost_volume_fused(c1, c2, radius, cuts, dtype, LEAKY)
    ins = [c1.clone().requires_grad_()]
    if not same:
        ins.append(c2.clone().requires_grad_())
    pair = (ins[0], ins[0]) if same else tuple(ins)
    out_plain = spatial_cost_volume(*pair, radius, cuts, dtype, LEAKY)
    out_fused = spatial_cost_volume_fused(*pair, radius, cuts, dtype, LEAKY)
    cases["sncv_backward"] = dict(
        kernel=lambda: _sncv_backward(x["g_sncv"], c1, c2, out, radius, cuts,
                                      LEAKY),
        # as the model runs it: autograd through the fused wrapper (with
        # c1 is c2, an add of two gradients counts where one is made)
        autograd=lambda: torch.autograd.grad(out_fused, ins, x["g_sncv"],
                                             retain_graph=True),
        plain=lambda: torch.autograd.grad(out_plain, ins, x["g_sncv"],
                                          retain_graph=True),
        plain_calls=1,
        **dict(zip(("nbytes", "flops"), cost.sncv_backward_work(*work))))
    return cases


def kernel_cases(x, cuts: int, C: int, n_pix: int, dtype, with_backward):
    """For each kernel at one level shape: the kernel's call, its plain
    version's call, and the bytes and flops the function needs
    (``ops.cost``). As the model calls them: the SNCV with c1 is c2, the
    DSCV with the quaternion; the backward of the previous parallax is not
    asked for."""
    work = (n_pix, C, cuts, DEPTH_SEARCH, torch.finfo(dtype).bits // 8)
    c1 = x["c1"].to(dtype)
    args = dscv_args(x, dtype)
    cases = sncv_cases(x, SPATIAL_SEARCH, cuts, C, n_pix, dtype, True,
                       with_backward)
    cases.update({
        "dscv_forward": dict(
            kernel=lambda: parallax_sweeping_cv_fused(*args, cuts, dtype),
            plain=lambda: parallax_sweeping_cv(*args, cuts, dtype),
            plain_calls=3,
            **dict(zip(("nbytes", "flops"), cost.dscv_forward_work(*work)))),
    })
    if not with_backward:
        return cases
    cam = Camera(x["f"], x["c"])
    motion = (x["rot"], x["trans"], x["f"], x["c"])
    a, b, para = c1, x["c2"].to(dtype), x["para"].to(dtype)
    ins = [t.clone().requires_grad_() for t in (a, b, x["centre"])]
    cv_p, pw_p = parallax_sweeping_cv(ins[0], ins[1], x["para"], ins[2],
                                      x["rot"], x["trans"], cam,
                                      DEPTH_SEARCH, cuts, dtype)
    cv_f, pw_f = parallax_sweeping_cv_fused(ins[0], ins[1], x["para"], ins[2],
                                            x["rot"], x["trans"], cam,
                                            DEPTH_SEARCH, cuts, dtype)
    cases["dscv_backward"] = dict(
        kernel=lambda: _dscv_backward(a, b, para, x["centre"], *motion,
                                      x["g_cv"], x["g_para"], DEPTH_SEARCH,
                                      cuts, want_dpara=False),
        # as the model runs it: autograd through the fused wrapper, with the
        # wrapper's zeroing and cast of dc2
        autograd=lambda: torch.autograd.grad(
            (cv_f, pw_f), ins, (x["g_cv"], x["g_para"]), retain_graph=True),
        plain=lambda: torch.autograd.grad(
            (cv_p, pw_p), ins, (x["g_cv"], x["g_para"]), retain_graph=True),
        plain_calls=1,
        **dict(zip(("nbytes", "flops"), cost.dscv_backward_work(*work))))
    return cases


def phase_kernel_times(cfg: ModelConfig, dev, b: int, with_backward: bool,
                       calls_per_level: int, model_dscv=None,
                       v1: bool = False) -> dict:
    """Each kernel's device time per call at each level shape with batch b,
    in the paths' dtype (bf16), beside its plain version's time and its
    bound; totals are per frame (b=1) or per step (b=3: each level runs
    ``calls_per_level`` times a step). The inputs are random, with sweep
    centres in [0.5, 4.5] and some far out; ``model_dscv`` (the DSCV's
    arguments from one serving frame, by level shape) adds the DSCV
    forward's time on the inputs the model gave it. ``v1``: the SNCV alone,
    as V1 calls it (radius 4, one cut, c1 != c2)."""
    dtype = cfg.torch_cv_dtype
    names = FORWARD + (BACKWARD if with_backward else ())
    if v1:
        names = tuple(k for k in names if k.startswith("sncv"))
    totals = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                      t_ops=0.0) for k in names}
    for k in names:
        if k in BACKWARD:
            totals[k]["autograd_ms"] = 0.0
    levels = []
    for spec in level_specs(cfg, b, v1=v1):
        level, h, w, C, cuts = spec[:5]
        if v1:
            x = op_inputs(spec, dev, seed=level, sncv_radius=V1_SEARCH)
            cases = sncv_cases(x, V1_SEARCH, 1, C, b * h * w, dtype, False,
                               with_backward)
        else:
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
            extra = ""
            if "autograd" in d:
                # few calls, as for the plain version: each queues a handful
                # of small kernels besides the kernel
                ag_ms = device_ms(d["autograd"], 20)
                t["autograd_ms"] += ag_ms * calls_per_level
                row[name]["autograd_ms"] = ag_ms
                extra = f", through autograd {ag_ms * 1e3:.2f} us"
            log(f"  {'V1 ' if v1 else ''}level {level} b={b} {h}x{w} C={C} "
                f"cuts={cuts} {name}: "
                f"kernel {ms * 1e3:.2f} us{extra}, plain {plain_ms * 1e3:.2f} "
                f"us, bound {b_ms * 1e3:.3f} us ({b_by}; {d['nbytes']} B, "
                f"{d['flops']} flop), {100 * b_ms / ms:.1f}% of bound")
        if model_dscv is not None:
            args = model_dscv[(h, w)]
            ms = device_ms(lambda: parallax_sweeping_cv_fused(*args), 100)
            row["dscv_forward"]["model_inputs_ms"] = ms
            totals["dscv_forward"]["model_inputs_ms"] = (
                totals["dscv_forward"].get("model_inputs_ms", 0.0)
                + ms * calls_per_level)
            centre = args[3]
            log(f"  level {level} b={b} {h}x{w} dscv_forward on the model's "
                f"own inputs (sweep centres "
                f"{centre.min().item():.4g}..{centre.max().item():.4g}): "
                f"kernel {ms * 1e3:.2f} us")
        levels.append(row)
    log(json.dumps({"v1_kernel_levels" if v1 else "kernel_levels": levels}))
    unit = "frame" if calls_per_level == 1 else "step"
    for name, t in totals.items():
        extra = (f", {t['model_inputs_ms'] * 1e3:.1f} us on the model's own "
                 "inputs" if "model_inputs_ms" in t else "")
        if "autograd_ms" in t:
            extra += (f", {t['autograd_ms'] * 1e3:.1f} us through autograd as "
                      "the model runs it")
        log(f"  {'V1 ' if v1 else ''}{name}: {t['ms'] * 1e3:.1f} us/{unit} "
            f"(bound "
            f"{t['bound_ms'] * 1e3:.2f} us, {100 * t['bound_ms'] / t['ms']:.1f}"
            f"% of bound; plain {t['plain_ms'] * 1e3:.1f} us){extra}")
    return totals


# -- main -------------------------------------------------------------------


# -- phase 14 ---------------------------------------------------------------

# mostly lateral motion: a well-conditioned depth recurrence (phase 5's)
CHECK_ROT, CHECK_TRANS = [1.0, 0.001, -0.002, 0.001], [0.3, 0.1, 0.02]
# multi-stream serving: N streams batched on one card
STREAM_COUNTS = (1, 4, 8)
STREAM_WARMUP = 10          # memory_allocated() is read after this frame
STREAM_BLOCKS, STREAM_BLOCK_FRAMES = 3, 20
STREAM_CHECK_FRAMES = 5     # each stream against itself alone at b=1
STREAM_PROFILED = 5
# fresh-frame serving: pipelined against serial, and the bench's loops
FRESH_CHECK_FRAMES = 8
FRESH_BENCH_FRAMES = 200


def stream_inputs(n: int, dev):
    """N streams' frames from a seed and mostly lateral motion, its
    translation scaled by 1 + i/4 for stream i: each stream has its own
    depth scale, so a stream read in another's place shows. (Under bench's
    mostly forward motion the random weights give depths near and below
    zero, where a relative comparison of two bfloat16 runs means nothing;
    the motion does not change the work a step does.)"""
    g = torch.Generator().manual_seed(1)
    rgb = torch.rand(n, SIZE, SIZE, 3, generator=g).to(dev)
    scale = 1 + torch.arange(n, dtype=torch.float32)[:, None] / 4
    f = torch.full((n, 2), FOCAL, device=dev)
    return (rgb, torch.tensor([CHECK_ROT] * n, device=dev),
            (torch.tensor([CHECK_TRANS]) * scale).to(dev),
            Camera(f, f.clone()))


def live_allocations() -> tuple:
    """(memory_allocated(), the live allocations, the bytes they asked
    for). The first counts the allocator's blocks, and a request can land
    on a larger cached block than before (left by an earlier phase) and
    move it with nothing allocated; the other two count the tensors."""
    stats = torch.cuda.memory_stats()
    return (torch.cuda.memory_allocated(), stats["allocation.all.current"],
            stats["requested_bytes.all.current"])


def phase_sharded_serving(dev) -> dict:
    """``parallel.sharded_stream`` on [dev] at each of STREAM_COUNTS
    streams, d6 384x384 bf16: ms a step over timed blocks, frames/s, peak
    memory above the run's baseline, memory_allocated() after frame
    STREAM_WARMUP and after the last with the live allocations and the
    bytes they asked for (those two equal: steady state allocates nothing),
    the forward kernels' launches a step (6 each, whatever N),
    and each stream's first frames against that stream alone through
    ``M4Depth.step`` at b=1. Before each N above 1, the two forward kernels
    against their plain versions at every level shape at b=N (as phase 2
    at b=1). Then a profile of steps at the largest N must hold no
    collective."""
    from torch.profiler import ProfilerActivity, profile

    from m4depth_tpu_torch.parallel import (
        assert_collective_free,
        shard_stream_inputs,
        sharded_stream,
    )
    from m4depth_tpu_torch.testing import assert_bf16_depth_close

    card = gpu_name_and_power_limit()
    cfg = ModelConfig(compute_dtype="bfloat16")
    out = {}
    for n in STREAM_COUNTS:
        worst = forwards_vs_plain(cfg, dev, n) if n > 1 else {}
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = M4Depth(cfg, device=dev, seed=0)
        step = sharded_stream(model, [dev])
        rgb, rot, trans, cam = stream_inputs(n, dev)
        go = torch.zeros(n, dtype=torch.bool, device=dev)
        reset = torch.ones(n, dtype=torch.bool, device=dev)
        state = shard_stream_inputs(
            init_state(cfg, n, SIZE, SIZE, device=dev), [dev])
        zero_launch_counts()
        first = []
        for i in range(STREAM_WARMUP):
            state, depth = step(state, rgb, rot, trans, cam,
                                reset if i == 0 else go)
            if i < STREAM_CHECK_FRAMES:
                first.append(depth.cpu())
        # what earlier phases left to the garbage collector is freed first,
        # so that only this loop's allocations can move the two reads
        gc.collect()
        torch.cuda.synchronize()
        mem_warm = live_allocations()
        block_ms = []
        for _ in range(STREAM_BLOCKS):
            t0 = time.perf_counter()
            for _ in range(STREAM_BLOCK_FRAMES):
                state, depth = step(state, rgb, rot, trans, cam, go)
            torch.cuda.synchronize()
            block_ms.append((time.perf_counter() - t0) * 1e3
                            / STREAM_BLOCK_FRAMES)
        launches = launch_counts()
        gc.collect()
        mem_end = live_allocations()
        peak = torch.cuda.max_memory_allocated() - base
        n_steps = STREAM_WARMUP + STREAM_BLOCKS * STREAM_BLOCK_FRAMES
        check(depth.shape == (n, SIZE, SIZE, 1)
              and bool(torch.isfinite(depth).all()),
              f"N={n}: depth {depth.shape}, finite")
        for k, count in launches.items():
            want = m4depth_serving_launches(n_steps)[k]
            check(count == want, f"N={n}: {k} {count} launches in "
                  f"{n_steps} steps, expected {want}")
        check(mem_end[1:] == mem_warm[1:], f"N={n}: (memory_allocated(), "
              f"live allocations, bytes they asked for) {mem_warm} after "
              f"frame {STREAM_WARMUP}, {mem_end} after the last")
        errs = []
        for i in range(n):
            alone = init_state(cfg, 1, SIZE, SIZE, device=dev)
            for t in range(STREAM_CHECK_FRAMES):
                alone, d1 = model.step(
                    alone, rgb[i:i + 1], rot[i:i + 1], trans[i:i + 1],
                    Camera(cam.f[i:i + 1], cam.c[i:i + 1]),
                    (reset if t == 0 else go)[:1])
                errs.append(assert_bf16_depth_close(
                    first[t][i:i + 1], d1.cpu(),
                    f"N={n} stream {i} frame {t} against it alone"))
        if n == STREAM_COUNTS[-1]:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(STREAM_PROFILED):
                    state, depth = step(state, rgb, rot, trans, cam, go)
                torch.cuda.synchronize()
            assert_collective_free(prof)
            log(f"  N={n}: a profile of {STREAM_PROFILED} steps holds no "
                "collective")
        med = statistics.median(block_ms)
        per_step = {k: c // n_steps for k, c in launches.items()}
        log(f"  [{card}] N={n} streams: {med:.4f} ms/step median of "
            f"{STREAM_BLOCKS} blocks of {STREAM_BLOCK_FRAMES} (blocks "
            f"{', '.join(f'{v:.4f}' for v in block_ms)}; min "
            f"{min(block_ms):.4f}, max {max(block_ms):.4f}); "
            f"{1e3 * n / med:.2f} frames/s aggregate, {med / n:.4f} ms per "
            f"stream-frame; peak {peak} bytes ({peak / 2 ** 20:.1f} MiB) "
            f"above the baseline; (memory_allocated(), live allocations, "
            f"bytes they asked for) {mem_warm} after frame {STREAM_WARMUP} "
            f"and {mem_end} after frame {n_steps}; "
            f"launches a step " + ", ".join(f"{k} {v}" for k, v in
                                            per_step.items()))
        log(f"  N={n}: each stream's first {STREAM_CHECK_FRAMES} frames "
            "against it alone at b=1: relative error median "
            f"{max(e[0] for e in errs):.3e} at worst, 99th percentile "
            f"{max(e[1] for e in errs):.3e} at worst")
        out[n] = dict(ms_per_step=med, block_ms=block_ms,
                      frames_per_s=1e3 * n / med, peak_above_base=peak,
                      launches_per_step=per_step, max_abs_err=worst)
        del model, step, state, depth, rgb, first
        torch.cuda.empty_cache()
    return out


def phase_fresh_frames(dev) -> dict:
    """``FreshFrameStream`` against the serial loop, frame by frame and one
    frame late (bitwise: the same kernels on the same bytes), with the
    forward kernels' launches; then the port's ``fresh_frame_bench``, all
    five loops at FRESH_BENCH_FRAMES frames, consuming every depth."""
    from m4depth_tpu_torch.parallel import FreshFrameStream
    from m4depth_tpu_torch.tools import fresh_frame_bench

    card = gpu_name_and_power_limit()
    cfg = ModelConfig(compute_dtype="bfloat16")
    model = M4Depth(cfg, device=dev, seed=0)
    rng = np.random.RandomState(2)
    frames = [rng.rand(1, SIZE, SIZE, 3).astype(np.float32)
              for _ in range(FRESH_CHECK_FRAMES)]
    rot = np.asarray([ROT], np.float32)
    trans = np.asarray([TRANS], np.float32)
    f = np.full((1, 2), FOCAL, np.float32)
    serial = []
    state = init_state(cfg, 1, SIZE, SIZE, device=dev)
    for t, fr in enumerate(frames):
        state, depth = model.step(
            state, torch.from_numpy(fr).to(dev), torch.from_numpy(rot).to(dev),
            torch.from_numpy(trans).to(dev),
            Camera(torch.from_numpy(f).to(dev), torch.from_numpy(f).to(dev)),
            torch.tensor([t == 0], device=dev))
        serial.append(depth)
    zero_launch_counts()
    sess = FreshFrameStream(model, init_state(cfg, 1, SIZE, SIZE,
                                              device=dev), device=dev)
    piped = []
    for t, fr in enumerate(frames):
        d = sess.push(fr, rot, trans, Camera(f, f.copy()), np.array([t == 0]))
        check((d is None) == (t == 0), f"push {t} returned {d is None}")
        if d is not None:
            piped.append(d)
    piped.append(sess.flush())
    check(sess.flush() is None, "a second flush returns None")
    launches = launch_counts()
    for k, count in launches.items():
        want = m4depth_serving_launches(len(frames))[k]
        check(count == want, f"FreshFrameStream: {k} {count} launches in "
              f"{len(frames)} frames, expected {want}")
    for t, (a, b) in enumerate(zip(piped, serial)):
        check(torch.equal(a, b), f"pipelined depth of frame {t} equals the "
              f"serial loop's (max diff {max_abs_err(a, b)})")
    log(f"  FreshFrameStream: {len(frames)} frames, each depth one push late "
        "and equal to the serial loop's (bitwise); launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = fresh_frame_bench.main([f"--frames={FRESH_BENCH_FRAMES}",
                                     "--consume=every", f"--size={SIZE}",
                                     f"--device={dev}"])
    check(rc == 0, "fresh_frame_bench")
    out = {}
    for line in text.getvalue().splitlines():
        log(f"    | {line}")
        m = re.match(r"(\w+): ([0-9.]+) ms/frame .*; ([0-9.]+) frames/s",
                     line)
        if m:
            out[m.group(1)] = dict(ms_per_frame=float(m.group(2)),
                                   frames_per_s=float(m.group(3)))
    check(tuple(out) == fresh_frame_bench.VARIANTS,
          f"the bench's loops: {tuple(out)}")
    log(f"  [{card}] fresh frames, d6 {SIZE}x{SIZE} b=1 bf16, "
        f"{FRESH_BENCH_FRAMES} frames, every depth read back: " + "; ".join(
            f"{k} {v['ms_per_frame']:.4f} ms/frame ({v['frames_per_s']:.2f} "
            "frames/s)" for k, v in out.items()))
    out["launches_per_frame"] = {k: c // len(frames)
                                 for k, c in launches.items()}
    return out


# -- phase 15 ---------------------------------------------------------------

# the data-parallel step checked against the plain one: float32, d6
DDP_CHECK_HW, DDP_CHECK_B, DDP_CHECK_T = 128, 2, 3
DDP_CHECK_SEEDS = (3, 12)   # weights, batch
DDP_CHECK_STEP = (DDP_CHECK_SEEDS[0], LEARNING_RATE)  # float32_step's
GLOO_RANKS, GLOO_TIMED_STEPS = 2, 6
CLI_DDP_STEPS = 5


def free_port() -> int:
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_step_close(got: dict, ref: dict, what: str) -> None:
    res = assert_step_close(got, ref, LEARNING_RATE, what)
    worst = list(res["shares"].items())[:2]
    log(f"  {what}: loss {got['scalars']['loss']:.7f} against "
        f"{ref['scalars']['loss']:.7f}; grad_norm "
        f"{got['scalars']['grad_norm']:.7f} against "
        f"{ref['scalars']['grad_norm']:.7f}; largest |grad - ref| as a "
        "share of its tolerance: " + ", ".join(
            f"{n} {v:.3e}" for n, v in worst))


def phase_ddp_world1(dev, train_ms: float) -> dict:
    """``distributed_init`` of a world of one over NCCL in this process,
    ``data_parallel(model, make_mesh())``: the training path of phase 8
    through the wrapper, in turns with the plain path (plain, wrapped,
    wrapped, plain: host-bound times compare only side by side), then one
    float32 step at DDP_CHECK_HW against the plain step on the card. The
    group is destroyed before the phase ends."""
    import torch.distributed as dist

    from m4depth_tpu_torch.parallel import distributed_init, make_mesh
    from m4depth_tpu_torch.train import data_parallel

    card = gpu_name_and_power_limit()
    backend = distributed_init(f"localhost:{free_port()}", 1, 0, device=dev)
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"the default backend on {dev}: {backend}")
    try:
        mesh = make_mesh()
        runs = {"plain": [], "ddp": []}
        for name in ("plain", "ddp", "ddp", "plain"):
            log(f"  {name}: d6 {SIZE}x{SIZE} b={TRAIN_B} T={TRAIN_T} bf16"
                + (f" through DistributedDataParallel over {mesh}"
                   if name == "ddp" else ""))
            run = phase_train_path(dev, wrap=(
                None if name == "plain"
                else lambda m: data_parallel(m, mesh)))
            del run["run"]
            runs[name].append(run)
        ms = {k: [r["ms_per_step"] for r in v] for k, v in runs.items()}
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        text = {k: ", ".join(f"{v:.4f}" for v in vals)
                for k, vals in ms.items()}
        log(f"  [{card}] world 1 over NCCL: {text['ddp']} ms/step through "
            f"the wrapper against {text['plain']} without it in turns "
            f"({100 * (mean['ddp'] / mean['plain'] - 1):+.2f}%), and "
            f"phase 8's {train_ms:.4f}; peak "
            f"{runs['ddp'][-1]['peak_above_base']} bytes above the baseline "
            f"(plain {runs['plain'][-1]['peak_above_base']})")
        batch = train_batch(DDP_CHECK_B, DDP_CHECK_T, DDP_CHECK_HW,
                            DDP_CHECK_SEEDS[1], CHECK_ROT, CHECK_TRANS, dev)
        check_step_close(
            float32_step(dev, batch, *DDP_CHECK_STEP,
                         lambda m: data_parallel(m, mesh)),
            float32_step(dev, batch, *DDP_CHECK_STEP),
            f"world 1 over NCCL, float32 d6 {DDP_CHECK_HW}x{DDP_CHECK_HW} "
            f"b={DDP_CHECK_B} T={DDP_CHECK_T}, against the plain step")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the group is destroyed")
    torch.cuda.empty_cache()
    return dict(runs["ddp"][-1], ms_plain=ms["plain"], ms_ddp=ms["ddp"])


def gloo_rank(rank: int, port: int, out_dir: str, device: str) -> None:
    """One of GLOO_RANKS ranks on the one card, over gloo (started by
    ``torch.multiprocessing.spawn``): the float32 check step on its half of
    the global batch, then GLOO_TIMED_STEPS timed steps of the training
    path at b=TRAIN_B a rank, a profile of one step, and its launches.
    Writes what it saw to ``out_dir/rank<rank>.pt``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from m4depth_tpu_torch.parallel import (
        distributed_init,
        local_batch,
        make_mesh,
    )
    from m4depth_tpu_torch.train import data_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    distributed_init(f"localhost:{port}", GLOO_RANKS, rank, backend="gloo",
                     device=dev)
    try:
        mesh = make_mesh()

        def wrap(model):
            return data_parallel(model, mesh)

        gb = train_batch(DDP_CHECK_B * GLOO_RANKS, DDP_CHECK_T, DDP_CHECK_HW,
                         DDP_CHECK_SEEDS[1], CHECK_ROT, CHECK_TRANS, dev)
        out = dict(check=float32_step(dev, local_batch(gb, mesh),
                                      *DDP_CHECK_STEP, wrap))

        model = M4Depth(ModelConfig(compute_dtype="bfloat16",
                                    cv_dtype="bfloat16"), device=dev, seed=0)
        step = make_train_step(wrap(model), make_optimizer(
            model, TrainConfig(learning_rate=LEARNING_RATE)))
        batch = train_batch(TRAIN_B, TRAIN_T, SIZE, rank, ROT, TRANS, dev)
        step(batch)
        sync()
        zero_launch_counts()
        step_ms, losses = [], []
        for _ in range(GLOO_TIMED_STEPS):
            t0 = time.perf_counter()
            losses.append(step(batch)["loss"].item())
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out["launches"] = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(batch)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        comm_us = sum(e.cpu_time_total for e in prof.key_averages()
                      if e.key.startswith("gloo:"))
        out.update(step_ms=step_ms, losses=losses, wall_us=wall_us,
                   comm_us=comm_us, comm_events=sorted(
                       e.key for e in prof.key_averages()
                       if e.key.startswith(("gloo:", "c10d::"))))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_ddp_gloo(dev) -> dict:
    """GLOO_RANKS ranks on the one card over gloo (NCCL refuses two ranks on
    one device; gloo all-reduces CUDA tensors through the host, so its time
    is no multi-GPU number): the averaged loss and gradients of a float32
    step on the global batch against one process's step on it, both ranks'
    weights equal after it; each rank's ms/step and the all-reduce's share
    of a profiled step; 18 launches of each kernel a step on each rank."""
    import torch.multiprocessing as mp

    card = gpu_name_and_power_limit()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(gloo_rank, args=(free_port(), tmp, str(dev)),
                 nprocs=GLOO_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(GLOO_RANKS)]
    gb = train_batch(DDP_CHECK_B * GLOO_RANKS, DDP_CHECK_T, DDP_CHECK_HW,
                     DDP_CHECK_SEEDS[1], CHECK_ROT, CHECK_TRANS, dev)
    ref = float32_step(dev, gb, *DDP_CHECK_STEP)
    for r, out in enumerate(ranks):
        check_step_close(out["check"], ref, f"rank {r} of {GLOO_RANKS} over "
                         f"gloo, float32 d6 {DDP_CHECK_HW}x{DDP_CHECK_HW} "
                         f"local b={DDP_CHECK_B}, against one process on "
                         f"the global b={DDP_CHECK_B * GLOO_RANKS}")
        check(all(torch.equal(p, ranks[0]["check"]["params"][n])
                  for n, p in out["check"]["params"].items()),
              f"rank {r}'s weights after the step equal rank 0's")
    for r, out in enumerate(ranks):
        for k, count in out["launches"].items():
            per_step = m4depth_launches(TRAIN_T)[k]
            check(count == per_step * GLOO_TIMED_STEPS,
                  f"rank {r}: {k} {count} launches in {GLOO_TIMED_STEPS} "
                  f"steps, expected {per_step} a step")
        check(all(np.isfinite(v) for v in out["losses"]), "finite losses")
        med = statistics.median(out["step_ms"])
        log(f"  [{card}] rank {r} of {GLOO_RANKS} on one card over gloo, "
            f"d6 {SIZE}x{SIZE} local b={TRAIN_B} T={TRAIN_T} bf16: "
            f"{med:.4f} ms/step median of {GLOO_TIMED_STEPS} (steps "
            f"{', '.join(f'{v:.3f}' for v in out['step_ms'])}); gloo's "
            f"all-reduce {out['comm_us']:.1f} us of a profiled step's "
            f"{out['wall_us']:.1f} ({100 * out['comm_us'] / out['wall_us']:.1f}"
            f"%); launches a step " + ", ".join(
                f"{k} {c // GLOO_TIMED_STEPS}"
                for k, c in out["launches"].items())
            + f"; profiled collectives {out['comm_events']}")
    log(f"  the two ranks ran in {spawn_s:.1f} s from spawn to exit")
    return dict(ranks=[dict(ms_per_step=statistics.median(o["step_ms"]),
                            comm_share=o["comm_us"] / o["wall_us"],
                            launches_per_step={
                                k: c // GLOO_TIMED_STEPS
                                for k, c in o["launches"].items()})
                       for o in ranks])


def phase_cli_launcher(dev, cli_ms: float) -> float:
    """The CLI's train mode under ``python -m torch.distributed.run
    --nproc_per_node=1`` (a child process) with --data_mesh=1, on a store
    like phase 11's, for CLI_DDP_STEPS steps: it must exit 0 and write one
    checkpoint. Returns its ms/step with loading."""
    card = gpu_name_and_power_limit()
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=repo + (os.pathsep + path
                                              if path else ""))
    with tempfile.TemporaryDirectory() as root:
        location = write_synthetic_store(root)
        ckpt = os.path.join(root, "ckpt")
        argv = [sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node=1", "--master_addr=localhost",
                f"--master_port={free_port()}",
                "-m", "m4depth_tpu_torch.cli.main", "--mode=train",
                "--data_mesh=1", f"--ckpt_dir={ckpt}",
                f"--platform={'gpu' if dev.type == 'cuda' else 'cpu'}",
                f"--total_steps={CLI_DDP_STEPS}", "--dataset=midair",
                f"--db_path_config={location}",
                f"--record_store={os.path.join(root, 'store')}",
                "--arch_depth=6", "--out_size", str(SIZE), str(SIZE),
                "--num_workers=8", "--batch_size=3", "--seq_len=4",
                "--db_seq_len=8", f"--summary_interval={CLI_LOG_EVERY}"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              timeout=CHILD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for line in (proc.stdout + proc.stderr).splitlines()[-40:]:
            log(f"    | {line}")
        check(proc.returncode == 0, f"the CLI under the launcher exited "
              f"{proc.returncode}")
        saved = sorted(os.listdir(os.path.join(ckpt, "train")))
        check(saved == ["0.pt"], f"checkpoints under the launcher: {saved}")
        check("runs the eager DDP step" in proc.stdout,
              "fit under the launcher did not take its DDP step")
    ms = parsed(r"step ms median ([0-9.]+)", proc.stdout,
                "step time under the launcher")
    log(f"  [{card}] train mode under torch.distributed.run at world 1 "
        f"(DDP over NCCL), d6 {SIZE}x{SIZE} b=3 T=4 bf16 from the store: "
        f"{ms:.3f} ms/step with loading, median of the steps after the "
        f"first of {CLI_DDP_STEPS}, against phase 11's {cli_ms:.3f} without "
        f"the launcher; {wall:.1f} s from start to exit")
    return ms


# -- phase 16 ---------------------------------------------------------------

F16 = "float16"
F16_BLOCKS = 2              # timed blocks of the float16 streaming path


def phase_fp16_extreme(dev) -> None:
    """The JAX package's extreme-parallax input (test_cost_volume.py's: a
    previous parallax of 1e6, past float16's 65504) through the DSCV kernel
    at float16, and the same parallax at the six level shapes: every output
    finite, the warped parallax at most 65504, and both outputs equal to
    the plain version's within phase 2's tolerances."""
    g = torch.Generator().manual_seed(3)
    b, h, w, C = 1, 12, 14, 8
    jax_case = dict(
        c1=unit_cuts(g, (b, h, w, C), 1), c2=unit_cuts(g, (b, h, w, C), 1),
        para=torch.full((b, h, w, 1), 1.0e6),
        centre=torch.full((b, h, w, 1), 2.0),
        rot=torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
        trans=torch.tensor([[0.3, 0.1, 0.2]]),
        f=torch.tensor([[10.0, 11.0]]), c=torch.tensor([[7.0, 6.0]]))
    cases = [("JAX test input 12x14", 1,
              {k: v.to(dev) for k, v in jax_case.items()})]
    for spec in level_specs(ModelConfig()):
        x = op_inputs(spec, dev, seed=300 + spec[0])
        x["para"] = torch.full_like(x["para"], 1.0e6)
        cases.append((f"level {spec[0]} {spec[1]}x{spec[2]}", spec[4], x))
    for name, cuts, x in cases:
        before = KERNELS["dscv_forward"].launches
        args = dscv_args(x, torch.float32)
        cv, pw = parallax_sweeping_cv_fused(*args, cuts, torch.float16)
        torch.cuda.synchronize()
        check(KERNELS["dscv_forward"].launches == before + 1,
              f"{name}: the float16 DSCV kernel launched")
        check(bool(torch.isfinite(cv).all() and torch.isfinite(pw).all()),
              f"{name}: finite outputs from a parallax of 1e6 at float16")
        check(pw.max().item() <= 65504.0,
              f"{name}: warped parallax {pw.max().item()} above 65504")
        cv_ref, pw_ref = parallax_sweeping_cv(*args, cuts, torch.float16)
        torch.testing.assert_close(cv, cv_ref, **DSCV_CV_TOL)
        torch.testing.assert_close(pw, pw_ref, **DSCV_PARA_TOL)
        log(f"  {name}: parallax 1e6 at float16: outputs finite, warped "
            f"parallax max {pw.max().item():.1f}, cv max|kernel - plain| "
            f"{max_abs_err(cv, cv_ref):.3e}")


def phase_fp16_paths(dev) -> dict:
    """The serving and training paths of both families with float16 cost
    volumes (bf16 convs): streaming M4Depth.step (with a profile of its
    frames) and M4DepthV1.step, and each family's training step at b=3,
    T=4; each path's launch counts zeroed just before it and read just
    after."""
    out = {}
    log("   M4Depth streaming, d6 384x384 b=1, bf16 convs, float16 cost "
        "volumes")
    out["serve"] = phase_main_path(dev, cv_dtype=F16, blocks=F16_BLOCKS)
    phase_profile(out["serve"]["run"], PROFILED_FRAMES, "frame")
    log("   M4DepthV1 streaming at float16")
    out["v1_serve"] = phase_main_path(
        dev, M4DepthV1, v1_serving_launches(), cv_dtype=F16, blocks=1)
    log(f"   M4Depth training step, b={TRAIN_B} T={TRAIN_T}, float16 cost "
        "volumes")
    out["train"] = phase_train_path(dev, cv_dtype=F16)
    log(f"   M4DepthV1 training step, b={TRAIN_B} T={TRAIN_T}, float16")
    out["v1_train"] = phase_train_path(dev, M4DepthV1,
                                       per_step=v1_launches(TRAIN_T),
                                       cv_dtype=F16)
    return out


# -- phase 17 ---------------------------------------------------------------


def conv_flops_counted(model, fn) -> tuple:
    """``compiled_cost(fn)`` and, from the same call, the convolutions'
    flops counted from the layer shapes: each call of a ``Conv3x3`` of
    ``model`` does 2 * (output elements) * Cin * 3 * 3 (2 per multiply-add,
    as XLA counts)."""
    from m4depth_tpu_torch.models.encoder import Conv3x3

    total = [0]

    def hook(mod, _, y):
        cout, cin, kh, kw = mod.weight.shape
        total[0] += 2 * y.numel() * cin * kh * kw

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv3x3)]
    try:
        got = compiled_cost(fn)
    finally:
        for handle in handles:
            handle.remove()
    return got, total[0]


def phase_compiled_cost(serve: dict, train: dict) -> dict:
    """``utils.profiling.compiled_cost`` of one serving frame (phase 6's
    path) and one training step (phase 8's): flops and bytes accessed; the
    forward convolutions' flops equal the count from the layer shapes, and
    the step's backward convolutions do between 1 and 2 times their
    forward's (each computes its weight's gradient, and its input's where
    that needs one)."""
    out = {}
    for name, path in (("serving frame", serve), ("training step", train)):
        cost_, from_shapes = conv_flops_counted(path["model"], path["run"])
        torch.cuda.synchronize()
        check(cost_["convolution flops"] == from_shapes,
              f"{name}: convolution flops {cost_['convolution flops']} "
              f"against {from_shapes} from the layer shapes")
        bwd = cost_["convolution backward flops"]
        if name == "training step":
            check(from_shapes <= bwd <= 2 * from_shapes,
                  f"{name}: backward convolution flops {bwd}")
        else:
            check(bwd == 0, f"{name}: no backward, {bwd} flops")
        log(f"  {name}: flops {cost_['flops']:.0f}, bytes accessed "
            f"{cost_['bytes accessed']:.0f} (eager: an upper bound); "
            f"convolutions {cost_['convolution flops']:.0f} forward (layer "
            f"shapes: {from_shapes}), {bwd:.0f} backward; cost volumes "
            f"{cost_['cost volume flops']:.0f} flops, "
            f"{cost_['cost volume bytes']:.0f} bytes")
        out[name] = cost_
    return out


# -- phase 18 ---------------------------------------------------------------


def phase_native() -> dict:
    """``m4depth_tpu_torch.native``: built with g++ on this host, then held
    against the port's plain ``dense_image_warp`` (forward, rtol and atol
    1e-5) and its autograd gradient (1e-4), at the native tests' shapes;
    then timed at level 1's shape (b=3, 192x192, 16 channels)."""
    from m4depth_tpu_torch import native
    from m4depth_tpu_torch.ops import dense_image_warp

    t0 = time.perf_counter()
    native.LIBRARY.get()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(1)
    for shape, scale in (((3, 9, 11, 4), 4.0), ((2, 7, 8, 3), 2.0)):
        img = rng.randn(*shape).astype(np.float32)
        flow = (rng.randn(*shape[:3], 2) * scale).astype(np.float32)
        grad = rng.randn(*shape).astype(np.float32)
        ti = torch.from_numpy(img).requires_grad_()
        tf = torch.from_numpy(flow).requires_grad_()
        ref = dense_image_warp(ti, tf)
        (ref * torch.from_numpy(grad)).sum().backward()
        np.testing.assert_allclose(native.backproject_forward(img, flow),
                                   ref.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        dimg, dflow = native.backproject_backward(img, flow, grad)
        np.testing.assert_allclose(dimg, ti.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(dflow, tf.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)
    img = rng.randn(3, 192, 192, 16).astype(np.float32)
    flow = (rng.randn(3, 192, 192, 2) * 4).astype(np.float32)
    times = {}
    for name, fn in (("forward", lambda: native.backproject_forward(
            img, flow)), ("backward", lambda: native.backproject_backward(
                img, flow, img))):
        fn()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        times[name] = (time.perf_counter() - t0) * 1e3 / 5
    log(f"  built in {build_s:.3f} s; forward and gradients match the plain "
        f"warp and autograd; at 3x192x192x16 on {os.cpu_count()} host "
        f"threads: forward {times['forward']:.3f} ms, backward "
        f"{times['backward']:.3f} ms")
    return dict(build_s=build_s, **times)


# -- phase 19 ---------------------------------------------------------------

TOOL_FPS_FRAMES = 50
TOOL_TRAIN_STEPS = 3
REHEARSAL_EPOCH, REHEARSAL_STEPS = 10, (20, 30)
REHEARSAL_VAL_BATCHES = 8


def phase_tools(dev) -> dict:
    """The port's tools, in this process, at reduced counts: each kernel's
    launches zeroed before each tool and read after it."""
    from m4depth_tpu_torch.tools import (
        fps,
        io_bench,
        memory_footprint,
        rehearsal,
        train_prof,
    )

    card = gpu_name_and_power_limit()
    out, launches = {}, {}

    def tool(name, fn):
        zero_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        log(f"  {name} took {time.perf_counter() - t0:.1f} s; launches "
            + ", ".join(f"{k} {n}" for k, n in launches[name].items()))
        out[name] = result
        return result

    r = tool("memory_footprint", lambda: memory_footprint.run(
        memory_footprint.parse_args([])))
    check(r["finite"] and r["peak_above_start"] > 0, f"footprint {r}")
    log(f"  [{card}] memory_footprint, d6 {SIZE}x{SIZE} b=1 bf16: params "
        f"{r['params']} bytes, recurrent state {r['state']} bytes, "
        f"memory_allocated() {r['allocated']} bytes above the start, peak "
        f"{r['peak_above_start']} bytes above it "
        f"({r['peak_above_start'] / 2 ** 20:.1f} MiB; the reference claims "
        f"~{memory_footprint.REFERENCE_CLAIM_MB} MB); the CUDA graph's pool "
        f"{r['graph_pool']} bytes ({r['graph_pool'] / 2 ** 20:.1f} MiB)")

    r = tool("fps", lambda: fps.run(fps.parse_args(
        ["--n", str(TOOL_FPS_FRAMES), "--profile"])))
    frames = 1 + fps.WARMUP_FRAMES + fps.REPEATS * TOOL_FPS_FRAMES \
        + fps.PROFILED_FRAMES
    check(r["finite"] and all(
        n == m4depth_serving_launches(frames)[k]
        for k, n in launches["fps"].items()), f"fps launches in {frames} "
        f"frames: {launches['fps']}")
    bd = r["breakdown"]
    check(bd["n_events"] > 0, "fps --profile recorded device events")
    check(abs(sum(bd["groups"].values()) - bd["busy_us"])
          <= 1e-6 * bd["busy_us"], "the breakdown sums to the busy time")
    check(bd["units"]["complete"] > 0, "fps --profile: complete replays "
          f"by their stage marks {bd['units']}")
    log(f"  [{card}] fps --n {TOOL_FPS_FRAMES}: {r['fps']:.2f} frames/s, "
        f"{r['ms_per_frame']:.3f} ms/frame, host in the compiled call "
        f"{r['dispatch']['ns']:.1f} us/frame; --profile: device busy "
        f"{bd['busy_us']:.1f} us/frame: " + ", ".join(
            f"{c} {us:.1f}" for c, us in sorted(
                bd["groups"].items(), key=lambda kv: -kv[1])))

    r = tool("train_prof", lambda: train_prof.run(train_prof.parse_args(
        ["--steps", str(TOOL_TRAIN_STEPS)])))
    steps = 1 + train_prof.WARMUP_STEPS \
        + train_prof.REPEATS * TOOL_TRAIN_STEPS + train_prof.PROFILED_STEPS
    check(np.isfinite(r["loss"]) and all(
        n == m4depth_launches(TRAIN_T)[k] * steps
        for k, n in launches["train_prof"].items()),
        f"train_prof launches in {steps} steps: {launches['train_prof']}")
    bd = r["breakdown"]
    check(bd["n_events"] > 0 and abs(sum(bd["groups"].values())
                                     - bd["busy_us"]) <= 1e-6 * bd["busy_us"],
          "train_prof's stages sum to the busy time")
    check(bd["units"]["complete"] > 0, "train_prof: complete replays by "
          f"their stage marks {bd['units']}")
    log(f"  [{card}] train_prof --steps {TOOL_TRAIN_STEPS}: "
        f"{r['ms_per_step']:.3f} ms/step (first step {r['first_step_s']:.2f}"
        f" s, host in the compiled call {r['dispatch']['ns']:.1f} us/step),"
        f" device busy {bd['busy_us']:.1f} us/step: " + ", ".join(
            f"{c} {us:.1f}" for c, us in sorted(
                bd["groups"].items(), key=lambda kv: -kv[1])))

    r = tool("io_bench", lambda: io_bench.run(io_bench.parse_args(
        ["--trajs", "2", "--frames", "16"])))
    check(r["record_store"]["batches_per_s"] > 0, f"io_bench {r}")
    log(f"  [{card}] io_bench, record store at {SIZE}^2 b=3 T=4 (2 x 16 "
        f"frames, 8 workers): {r['record_store']['batches_per_s']:.2f} "
        f"batches/s with augmentation, "
        f"{r['record_store_no_augment']['batches_per_s']:.2f} without; "
        + ("decode path " + f"{r['decode']['batches_per_s']:.2f} batches/s"
           if "decode" in r else "decode path not measured (no cv2 or PIL "
           "on this host)"))

    with tempfile.TemporaryDirectory() as workdir:
        common = ["--workdir", workdir, "--steps_per_epoch",
                  str(REHEARSAL_EPOCH), "--val_max_batches",
                  str(REHEARSAL_VAL_BATCHES)]
        texts = []
        for total in REHEARSAL_STEPS:
            texts.append(tool(f"rehearsal --steps {total}", lambda: run_cli(
                common + ["--steps", str(total)], entry=rehearsal.main)))
        check("Resuming from epoch 2" in texts[1],
              "the relaunched rehearsal resumed at epoch 2")
        saved = sorted(os.listdir(os.path.join(workdir, "ckpt", "train")))
        check(saved == ["0.pt", "1.pt", "2.pt"],
              f"rehearsal checkpoints {saved}")
        with open(os.path.join(workdir, "heldout.json")) as f:
            heldout = [json.loads(line) for line in f]
        check(len(heldout) == 2 and all(
            np.isfinite(v) for h in heldout for v in h.values()),
            f"heldout.json {heldout}")
        ms = [parsed(r"step ms median ([0-9.]+)", t, "rehearsal step time")
              for t in texts]
        log(f"  [{card}] rehearsal, d6 {SIZE}^2 b=3 T=4 bf16 cosine on "
            f"DeviceSyntheticStream: 2 epochs of {REHEARSAL_EPOCH} steps at "
            f"{ms[0]:.3f} ms/step, resumed and extended to "
            f"{REHEARSAL_STEPS[1]} steps at {ms[1]:.3f} ms/step; held-out "
            f"AbsRel {heldout[0]['AbsRel']}, then {heldout[1]['AbsRel']}")
    out["launches"] = launches
    return out


# -- phase 20 ---------------------------------------------------------------

GRAPH_FRAMES = 50        # the compiled serving chain held against eager
GRAPH_RESET = 25         # a frame that restarts the trajectory (and 0)
GRAPH_PROFILED_STEPS = 3
GRAPH_CHECK_STEPS = 3    # float32 compiled steps held to eager ones
GRAPH_TRAIN_BLOCKS = 3
# the hand-written kernels as the profiler names them on the device
DEVICE_KERNELS = {"sncv_forward": ("sncv_forward_kernel",),
                  "sncv_backward": ("sncv_backward_kernel",
                                    "sncv_backward_band_kernel"),
                  "dscv_forward": ("dscv_forward_kernel",),
                  "dscv_backward": ("dscv_backward_kernel",),
                  "glue_prep": ("glue_prep_kernel",),
                  "glue_assemble": ("glue_assemble_kernel",),
                  "glue_finish": ("glue_finish_kernel",),
                  "glue_v1_prep": ("glue_v1_prep_kernel",),
                  "glue_v1_assemble": ("glue_v1_assemble_kernel",),
                  "glue_v1_finish": ("glue_v1_finish_kernel",),
                  "glue_prep_backward": ("glue_prep_backward_kernel",),
                  "glue_assemble_backward": (
                      "glue_assemble_backward_kernel",),
                  "glue_finish_backward": ("glue_finish_backward_kernel",),
                  "conv_epilogue_forward": ("epilogue_forward_kernel",),
                  "conv_epilogue_backward": ("epilogue_backward_kernel",)}
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def profiled(run, n: int):
    """``n`` calls of ``run`` under ``torch.profiler`` (after one call
    outside it), ending in a synchronise: the profile's events and the
    window's wall time in us."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof.events(), wall_us


def device_kernels(events) -> dict:
    """Each hand-written kernel's runs on the device in ``events``."""
    from torch.autograd import DeviceType

    return {k: sum(evt.device_type == DeviceType.CUDA
                   and any(name in evt.name for name in names)
                   for evt in events)
            for k, names in DEVICE_KERNELS.items()}


def graph_profile(run, n: int) -> dict:
    """A ``torch.profiler`` window over ``n`` calls of ``run``: wall and
    device-busy time a call, the busy share, the host's launches a call
    (the runtime's ``cudaLaunchKernel``, ``cudaGraphLaunch``, copy and
    memset events) and each hand-written kernel's runs on the device a
    call (graph kernels included)."""
    from torch.autograd import DeviceType

    events, wall_us = profiled(run, n)
    busy, host = 0.0, {}
    for evt in events:
        if evt.device_type == DeviceType.CUDA:
            if "#" in evt.name and "(" not in evt.name:
                continue  # a user annotation, as in phase_profile
            busy += evt.time_range.elapsed_us()
        else:
            for name in HOST_LAUNCHES:
                if evt.name.startswith(name):
                    host[name] = host.get(name, 0) + 1
    return dict(wall_us=wall_us / n, busy_us=busy / n,
                busy_share=busy / wall_us,
                host_launches=sum(host.values()) / n,
                host={k: v / n for k, v in host.items()},
                kernels={k: v / n for k, v in device_kernels(events).items()})


def replay_kernels(run, want: dict, what: str) -> dict:
    """The hand-written kernels' runs on the device in a profile of one
    replay of ``run``'s graph, which must be ``want``. Over a window of
    several replays the profiler missed a few graph kernels once (58 of
    60 in one call), so up to three one-replay windows are read, and one
    must count ``want`` exactly. The epilogue's kernels (~2 us each, 54 a
    frame, 348 a step) are held to at most ``want``: late in this script
    the profiler lost 3 of a V1 frame's 54 in each of three windows (PR
    19's run, whose capture recorded 54 and a fresh process's profile 54
    in each window); their launches are held by the captures' counts."""
    def held(counts):
        return {k: n for k, n in counts.items() if k not in EPILOGUE}

    seen = []
    for _ in range(3):
        seen.append(device_kernels(profiled(run, 1)[0]))
        if held(seen[-1]) == held(want) and all(
                seen[-1][k] <= want[k] for k in EPILOGUE):
            break
    check(held(seen[-1]) == held(want)
          and all(seen[-1][k] <= want[k] for k in EPILOGUE),
          f"{what}: the kernels of one replay in its profile {seen}, "
          f"expected {want}")
    return seen[-1]


def in_turns(runs: dict, blocks: int, per_block: int) -> dict:
    """Each of ``runs`` (name -> one call) timed over ``blocks`` blocks of
    ``per_block`` calls, the names taking turns and each block's first
    name alternating; ms a call of each block, by name."""
    names = list(runs)
    ms = {k: [] for k in names}
    for i in range(blocks):
        for k in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per_block):
                runs[k]()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3 / per_block)
    return ms


def report_turns(ms: dict, unit: str) -> str:
    return "; ".join(
        f"{k} {statistics.median(v):.4f} ms/{unit} (blocks "
        f"{', '.join(f'{x:.4f}' for x in v)})" for k, v in ms.items())


def graphed_serving(dev, family, per_frame: dict, card: str) -> dict:
    """``compile_step`` of the d6 ``family`` at 384x384 b=1 bf16: a chain
    of GRAPH_FRAMES distinct frames (resets at 0 and GRAPH_RESET; the
    counts zeroed before and read after) held against the eager
    ``model.step`` chain; then the compiled and the eager step in turns,
    and a profile of each."""
    from m4depth_tpu_torch.parallel import compile_step

    name = family.__name__
    cfg = ModelConfig(compute_dtype="bfloat16")
    model = family(cfg, device=dev, seed=0)
    g = torch.Generator().manual_seed(20)
    rgbs = torch.rand(GRAPH_FRAMES, 1, SIZE, SIZE, 3, generator=g).to(dev)
    rot = torch.tensor([CHECK_ROT], device=dev)
    trans = torch.tensor([CHECK_TRANS], device=dev)
    f = torch.full((1, 2), FOCAL, device=dev)
    cam = Camera(f, f.clone())
    resets = [torch.tensor([t in (0, GRAPH_RESET)], device=dev)
              for t in range(GRAPH_FRAMES)]
    step = compile_step(model)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    state = init_state(cfg, 1, SIZE, SIZE, device=dev)
    depths = []
    for t in range(GRAPH_FRAMES):
        state, depth = step(state, rgbs[t], rot, trans, cam, resets[t])
        depths.append(depth)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    pool = step.pool_bytes()
    check(step.graphs == 1, f"{name}: one graph for the stream, a reset "
          f"included ({step.graphs})")
    for k, n in launches.items():
        check(n == per_frame[k] * GRAPH_FRAMES, f"{name} compiled: {k} {n} "
              f"launches in {GRAPH_FRAMES} frames")
    eager = init_state(cfg, 1, SIZE, SIZE, device=dev)
    err, equal, rels = 0.0, True, (0.0, 0.0)
    with torch.no_grad():
        for t in range(GRAPH_FRAMES):
            eager, want = model.step(eager, rgbs[t], rot, trans, cam,
                                     resets[t])
            err = max(err, max_abs_err(depths[t], want))
            equal = equal and torch.equal(depths[t], want)
            med, p99 = assert_bf16_depth_close(
                depths[t], want, f"{name} compiled frame {t}")
            rels = (max(rels[0], med), max(rels[1], p99))
    log(f"  {name}: {GRAPH_FRAMES} frames compiled (resets at 0 and "
        f"{GRAPH_RESET}) against the eager chain: max |error| {err:.3e}, "
        f"bitwise equal: {equal}; relative error median <= {rels[0]:.3e}, "
        f"99th percentile <= {rels[1]:.3e}; launches " + ", ".join(
            f"{k} {n // GRAPH_FRAMES}/frame" for k, n in launches.items())
        + f"; {step.graphs} graph")
    log(f"  [{card}] {name} compiled serving: peak {peak} bytes "
        f"({peak / 2 ** 20:.1f} MiB) above the {base} allocated before it "
        f"(the eager warm-up and the capture); the graph's private pool "
        f"holds {pool} bytes ({pool / 2 ** 20:.1f} MiB)")
    check(peak < 500e6, f"{name}: the compiled serving peak {peak} bytes is "
          "under the reference's ~500 MB")

    x = main_path_inputs(dev)
    go = torch.zeros(1, dtype=torch.bool, device=dev)
    box = {"graph": state, "eager": eager}

    def frame_of(key, fn):
        def run():
            box[key], _ = fn(box[key], x["rgb"], x["rot"], x["trans"],
                             x["camera"], go)
        return run

    runs = {"eager": frame_of("eager", torch.no_grad()(model.step)),
            "compiled": frame_of("graph", step)}
    ms = in_turns(runs, TIMED_BLOCKS, FRAMES_PER_BLOCK)
    log(f"  [{card}] {name} serving d6 {SIZE}x{SIZE} b=1 bf16, in turns: "
        + report_turns(ms, "frame"))
    prof = {k: graph_profile(run, PROFILED_FRAMES) for k, run in runs.items()}
    for k, r in prof.items():
        log(f"  [{card}] {name} {k} profile: wall {r['wall_us']:.1f} "
            f"us/frame, device busy {r['busy_us']:.1f} us/frame "
            f"({100 * r['busy_share']:.1f}% busy), host launches "
            f"{r['host_launches']:.1f}/frame ({r['host']}), kernels on the "
            f"device {r['kernels']}/frame")
    check(prof["compiled"]["host"].get("cudaGraphLaunch") == 1,
          f"{name}: one graph launch a frame")
    replay = replay_kernels(runs["compiled"], per_frame, f"{name} serving")
    log(f"  {name}: one replayed frame's profile holds {replay}")
    return dict(launches=launches, ms=ms, profile=prof, replay=replay,
                peak=peak, pool=pool, max_abs_err=err, bitwise=equal)


def graphed_training(dev, family, per_step: dict, card: str) -> dict:
    """``compile_train_step`` of the d6 ``family`` at 384x384 b=3 T=4
    bf16 against ``make_train_step`` from the same weights and batch:
    each one's peak memory and launches (zeroed before, read after), then
    the two in turns and a profile of each."""
    from m4depth_tpu_torch.train import compile_train_step

    name = family.__name__
    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
    batch = train_batch(TRAIN_B, TRAIN_T, SIZE, 0, ROT, TRANS, dev)
    steps, out = {}, {}
    for key, make in (("eager", make_train_step),
                      ("compiled", compile_train_step)):
        model = family(cfg, device=dev, seed=0)
        steps[key] = make(model, make_optimizer(model, TrainConfig(
            learning_rate=LEARNING_RATE)))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        losses = [float(steps[key](batch)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        out[key] = dict(launches=launch_counts(), losses=losses,
                        peak=torch.cuda.max_memory_allocated() - base)
        for k, n in out[key]["launches"].items():
            check(n == 3 * per_step[k], f"{name} {key} training: {k} {n} "
                  "launches in 3 steps")
        check(all(np.isfinite(losses)), f"{name} {key}: finite losses")
    out["compiled"]["pool"] = steps["compiled"].compiled.pool_bytes()
    check(out["eager"]["losses"][0] == out["compiled"]["losses"][0],
          f"{name}: the first step's loss equal, eager and compiled")
    check(steps["compiled"].compiled.graphs == 1, f"{name}: one graph")
    log(f"  [{card}] {name} training d6 {SIZE}x{SIZE} b={TRAIN_B} "
        f"T={TRAIN_T} bf16: losses eager {out['eager']['losses']}, compiled "
        f"{out['compiled']['losses']}; peak above the start eager "
        f"{out['eager']['peak']} bytes, compiled {out['compiled']['peak']} "
        f"bytes; the graph's private pool {out['compiled']['pool']} bytes")
    runs = {k: (lambda s=s: s(batch)) for k, s in steps.items()}
    ms = in_turns(runs, GRAPH_TRAIN_BLOCKS, STEPS_PER_BLOCK)
    log(f"  [{card}] {name} training in turns: " + report_turns(ms, "step"))
    prof = {k: graph_profile(run, GRAPH_PROFILED_STEPS)
            for k, run in runs.items()}
    for k, r in prof.items():
        log(f"  [{card}] {name} {k} training profile: wall "
            f"{r['wall_us']:.1f} us/step, device busy {r['busy_us']:.1f} "
            f"us/step ({100 * r['busy_share']:.1f}% busy), host launches "
            f"{r['host_launches']:.1f}/step ({r['host']}), kernels on the "
            f"device {r['kernels']}/step")
    replay = replay_kernels(runs["compiled"], per_step, f"{name} training")
    log(f"  {name}: one replayed step's profile holds {replay}")
    return dict(out, ms=ms, profile=prof, replay=replay)


def graph_summary(graphs: dict) -> dict:
    """Phase 20's numbers by path and mode: ms a call (median and each
    block), the profile's busy share and device-busy us a call, host
    launches a call, peak bytes above the start (serving: the compiled
    path's alone; phase 6 has the eager one)."""
    out = {"remat": graphs["remat"],
           "cli_eval_ms_frame": graphs["cli_eval"]["ms_frame"]}
    for path, r in graphs.items():
        if "profile" not in r:
            continue
        out[path] = {}
        for mode in ("eager", "compiled"):
            prof = r["profile"][mode]
            if mode in r:
                peak = r[mode]["peak"]
            else:
                peak = r["peak"] if mode == "compiled" else None
            out[path][mode] = dict(
                ms_median=statistics.median(r["ms"][mode]),
                ms_blocks=r["ms"][mode], busy_share=prof["busy_share"],
                busy_us=prof["busy_us"], host_launches=prof["host_launches"],
                peak=peak)
    return out


def phase_graphs(dev) -> dict:
    """The compiled programs (``utils.graphs``), the counterparts of the
    JAX package's jitted, state-donating steps: serving of both families
    held against the eager chain and timed against it in turns; training
    likewise, a float32 check of three compiled steps against three eager
    ones (each eager step from the compiled run's state), and steps at
    T=REMAT_T with remat "all"; the CLI's eval mode (compiled) against the
    eager evaluator."""
    from m4depth_tpu_torch.cli.main import (
        build_dataset,
        build_model,
        restore_params_for_eval,
    )
    from m4depth_tpu_torch.cli.options import (
        build_parser,
        model_config_from_args,
    )
    from m4depth_tpu_torch.metrics import METRIC_NAMES, MetricAccumulator
    from m4depth_tpu_torch.train import (
        TrainState,
        compile_train_step,
        make_streaming_eval_step,
    )
    from m4depth_tpu_torch.train.loop import to_device

    card = gpu_name_and_power_limit()
    out = {}
    log("  serving, compiled against eager")
    out["serve"] = graphed_serving(dev, M4Depth, m4depth_serving_launches(),
                                   card)
    out["v1_serve"] = graphed_serving(dev, M4DepthV1, v1_serving_launches(),
                                      card)
    torch.cuda.empty_cache()

    log("  training, compiled against eager")
    out["train"] = graphed_training(dev, M4Depth, m4depth_launches(TRAIN_T),
                                    card)
    out["v1_train"] = graphed_training(dev, M4DepthV1, v1_launches(TRAIN_T),
                                       card)
    torch.cuda.empty_cache()

    cfg32 = ModelConfig(compute_dtype="float32", cv_dtype="float32")
    batch = train_batch(TRAIN_B, TRAIN_T, SIZE, 3, CHECK_ROT, CHECK_TRANS,
                        dev)
    models = {k: M4Depth(cfg32, device=dev, seed=3)
              for k in ("compiled", "eager")}
    opts = {k: make_optimizer(m, TrainConfig(learning_rate=LEARNING_RATE))
            for k, m in models.items()}
    steps = {"compiled": compile_train_step(models["compiled"],
                                            opts["compiled"]),
             "eager": make_train_step(models["eager"], opts["eager"])}
    for i in range(GRAPH_CHECK_STEPS):
        if i:
            # each eager step starts where the compiled run stands (weights,
            # Adam state, count), so that every pair is one step from one
            # state, as the rule holds it
            TrainState(models["eager"], opts["eager"]).load_state_dict(
                TrainState(models["compiled"], opts["compiled"]).state_dict())
        res = {}
        for k, step in steps.items():
            scalars = step(batch)
            res[k] = dict(
                scalars={n: v.item() for n, v in scalars.items()},
                grads={n: p.grad.cpu()
                       for n, p in models[k].named_parameters()},
                params={n: p.detach().cpu()
                        for n, p in models[k].named_parameters()})
        check_step_close(res["compiled"], res["eager"],
                         f"float32 step {i + 1} of {GRAPH_CHECK_STEPS}, d6 "
                         f"{SIZE}x{SIZE} b={TRAIN_B} T={TRAIN_T}, compiled "
                         "against eager")
    del models, opts, steps, batch
    torch.cuda.empty_cache()

    log(f"  two compiled steps at T={REMAT_T}, b={TRAIN_B}, remat \"all\"")
    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16",
                      remat=True, remat_policy="all")
    model = M4Depth(cfg, device=dev, seed=0)
    step = compile_train_step(model, make_optimizer(model, TrainConfig(
        learning_rate=LEARNING_RATE)))
    batch = train_batch(TRAIN_B, REMAT_T, SIZE, 0, ROT, TRANS, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    t0 = time.perf_counter()
    losses.append(float(step(batch)["loss"]))
    remat_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    per_step = m4depth_launches(REMAT_T, remat="all")
    for k, n in launches.items():
        want = 3 * per_step[k]
        check(n == want, f"remat all, compiled: {k} {n} launches in 3 "
              f"steps, expected {want}")
    check(all(np.isfinite(losses)), f"remat all, compiled: losses {losses}")
    out["remat"] = dict(peak=torch.cuda.max_memory_allocated() - base,
                        ms=remat_ms)
    log(f"  [{card}] T={REMAT_T} remat \"all\" compiled: losses {losses}; "
        f"the replayed step {remat_ms:.1f} ms; peak {out['remat']['peak']} "
        f"bytes ({out['remat']['peak'] / 2 ** 30:.2f} GiB) above the start")
    del model, step, batch
    torch.cuda.empty_cache()

    log("  the CLI's eval mode, compiled, against the eager evaluator")
    with tempfile.TemporaryDirectory() as root:
        location = write_synthetic_store(root)
        store = os.path.join(root, "store")
        ckpt = os.path.join(root, "ckpt")
        argv = ["--mode=eval", f"--ckpt_dir={ckpt}", "--dataset=midair",
                f"--db_path_config={location}", f"--record_store={store}",
                "--arch_depth=6", "--out_size", str(SIZE), str(SIZE),
                "--num_workers=8"]
        zero_launch_counts()
        text = run_cli(argv)
        launches = launch_counts()
        n_frames = STORE_TRAJ * STORE_FRAMES
        for k, n in launches.items():
            want = m4depth_serving_launches(n_frames)[k]
            check(n == want, f"CLI eval, compiled: {k} {n} launches")
        ms_frame = parsed(r"evaluated \d+ frames in [0-9.]+ s \(([0-9.]+) "
                          r"ms/frame", text, "eval time")
        perfs = np.loadtxt(os.path.join(ckpt, "perfs-midair.txt"))
        cmd = build_parser(argparse.ArgumentParser()).parse_args(argv)
        model = build_model(cmd, model_config_from_args(cmd), dev)
        restore_params_for_eval(cmd, model, "best")
        eval_step = make_streaming_eval_step(model)
        acc, state = MetricAccumulator.zeros(dev), None
        with torch.no_grad():
            for frame in build_dataset(cmd, "eval", {}, 1).frames():
                x = to_device(frame, dev)
                if state is None:
                    state = init_state(model.cfg, 1, SIZE, SIZE, device=dev)
                state, acc = eval_step(state, x, acc)
        want = acc.result()
        for i, k in enumerate(METRIC_NAMES):
            check(abs(perfs[i] - float(want[k]))
                  <= EVAL_METRIC_TOL["atol"]
                  + EVAL_METRIC_TOL["rtol"] * abs(float(want[k])),
                  f"CLI eval {k}: {perfs[i]} compiled against "
                  f"{float(want[k])} eager")
        log(f"  [{card}] CLI eval mode compiled: {ms_frame:.3f} ms/frame "
            f"with loading over {n_frames} frames; perfs-midair.txt "
            f"{perfs.tolist()} equals the eager evaluator's within "
            f"{EVAL_METRIC_TOL}")
        out["cli_eval"] = dict(ms_frame=ms_frame, launches=launches)
    return out


# -- phase 21 ---------------------------------------------------------------

GLUE_OTHER = 4          # the memory channels a level hands the next
GLUE_REPLAYS = 5        # replays of a step's glue under the profiler


def glue_cases(spec, n_levels: int, dev, seed: int, cv_dtype) -> dict:
    """Each glue kernel's fused and plain calls at one d6 level shape
    (b=1, bf16 features), as ``DecoderLevel`` makes them without grad:
    the full-resolution camera, the deeper estimate at half the size
    (none at the deepest level), the state, bench's motion; with each
    kernel the bytes it reads and writes and a rough count of its float32
    operations (a few per element: the bytes bound all three by far)."""
    level, h, w, C, cuts, _ = spec
    g = torch.Generator().manual_seed(seed)
    f = torch.full((1, 2), FOCAL)

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=g) * (hi - lo) + lo

    hd, wd = -(-h // 2), -(-w // 2)
    deeper = None if level == n_levels else (
        u(2, 40, 1, hd, wd, 1), u(0.1, 3, 1, hd, wd, 1),
        torch.randn(1, hd, wd, GLUE_OTHER, generator=g))
    reproj = u(0, 5, 1, h, w, 1)
    reproj[:, ::3] = 0.0        # the log's 1e-12 clamp
    x = dict(curr_f=torch.randn(1, h, w, C, generator=g),
             f_maps=torch.randn(1, h, w, C, generator=g),
             depth=u(2, 40, 1, h, w, 1), rot=torch.tensor([ROT]),
             trans=torch.tensor([TRANS]), f=f, c=f.clone(),
             cv=torch.randn(1, h, w, 9 * cuts, generator=g),
             sncv=torch.randn(1, h, w, 49 * cuts, generator=g),
             reproj=reproj,
             out=torch.randn(1, h, w, 1 + GLUE_OTHER, generator=g) * 3)
    x = {k: v.to(dev) for k, v in x.items()}
    for k in ("curr_f", "f_maps", "out"):
        x[k] = x[k].to(torch.bfloat16)
    if deeper is not None:
        deeper = tuple(t.to(dev) for t in deeper)
    para_mul = 2.0 ** (level - 3)
    prep_args = (x["curr_f"], deeper, (x["f_maps"], x["depth"]), x["trans"],
                 Camera(x["f"], x["c"]), 2.0 ** level, cuts, True,
                 GLUE_OTHER, 1000.0, cv_dtype)
    prev, cam_l = glue.glue_prep(*prep_args)[:2]
    asm_args = (x["cv"], prev[1], prev[2], x["sncv"], x["reproj"], para_mul,
                torch.bfloat16)
    # the serving step passes its reset flags on every frame
    go = torch.zeros(1, dtype=torch.bool, device=dev)

    def fin_args(reset):
        return (x["out"], prev, reset, x["rot"], x["trans"], cam_l,
                para_mul, 1000.0)

    def plain_prep():
        # and the roundings that the cost-volume wrappers then make, which
        # the kernel makes in their place
        r = glue.glue_prep(*prep_args)
        return (r[:2] + (r[2].to(cv_dtype), r[3].to(cv_dtype),
                         round_parallax(r[4], cv_dtype)))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    n_pix, cv_size = h * w, torch.finfo(cv_dtype).bits // 8
    f_input = glue.glue_assemble(*asm_args)
    return dict(
        glue_prep=dict(
            fused=lambda: glue.glue_prep_fused(*prep_args), plain=plain_prep,
            nbytes=(nbytes(x["curr_f"], x["f_maps"], x["depth"], *prev,
                           *(deeper or ()))
                    + n_pix * (2 * C + 1) * cv_size),
            flops=6 * n_pix * C + 60 * n_pix),
        glue_assemble=dict(
            fused=lambda: glue.glue_assemble_fused(*asm_args),
            plain=lambda: glue.glue_assemble(*asm_args),
            nbytes=nbytes(x["cv"], prev[1], prev[2], x["sncv"], x["reproj"],
                          f_input),
            flops=6 * n_pix),
        glue_finish=dict(
            fused=lambda reset=go: glue.glue_finish_fused(*fin_args(reset)),
            plain=lambda reset=go: glue.glue_finish(*fin_args(reset)),
            nbytes=nbytes(x["out"], *prev, *prev, prev[0]),
            flops=60 * n_pix))


def check_glue_case(name: str, case: dict, cv, dev, what: str) -> tuple:
    """One kernel's results against its plain version's on the same
    inputs: float32 to SNCV_TOL, outputs rounded to bfloat16 (features of
    bfloat16 convs, the previous parallax, the refiner's input) within
    one bfloat16 ulp; the largest float32 error and the largest rounded
    one in ulps. The finish runs without a reset, with none set and with
    one set."""
    f32_err, ulps = 0.0, 0.0

    def close(got, want, key):
        nonlocal f32_err
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"{what} {key}: {got.dtype} {tuple(got.shape)}")
        torch.testing.assert_close(got, want, **SNCV_TOL,
                                   msg=f"{what} {key}")
        f32_err = max(f32_err, max_abs_err(got, want))

    if name == "glue_prep":
        got, want = case["fused"](), case["plain"]()
        for i, key in enumerate(("depth", "parallax", "other")):
            close(got[0][i], want[0][i], f"deeper {key}")
        check(all(torch.equal(a, b) for a, b in zip(got[1], want[1])),
              f"{what} intrinsics")
        for i, key in ((2, "curr_p"), (3, "prev_p"), (4, "para_prev_t")):
            ulps = max(ulps, assert_within_ulps(
                got[i], want[i], f"{what} {key}",
                spacing_dtype=torch.bfloat16 if i < 4 else cv))
    elif name == "glue_assemble":
        ulps = assert_within_ulps(case["fused"](), case["plain"](),
                                  f"{what} f_input")
    else:
        for reset in (None, torch.tensor([False], device=dev),
                      torch.tensor([True], device=dev)):
            (est, depth), (west, wdepth) = (case["fused"](reset),
                                            case["plain"](reset))
            for key, a, b in zip(("depth", "parallax", "other", "next"),
                                 (*est, depth), (*west, wdepth)):
                close(a, b, f"{key} (reset {reset})")
    return f32_err, ulps


V1_GLUE_B = 8           # V1's glue timed at v1-stream8's batch


def glue_v1_cases(spec, n_levels: int, dev, seed: int) -> dict:
    """Each V1 glue kernel's fused and plain calls at one V1-d6 level shape
    (``level_specs``' batch, bf16 features), as ``DecoderLevelV1`` makes
    them without grad: the memory, the deeper depth at half the size (none
    at the deepest level), a serving step's reset flags (none set),
    bench's motion, the full-resolution camera; with each kernel the
    unique bytes it reads and writes and a rough count of its float32
    operations (the bytes bound all three)."""
    level, h, w, C, _, cam_l = spec
    b = cam_l.f.shape[0]
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=g) * (hi - lo) + lo

    hd, wd = -(-h // 2), -(-w // 2)
    f = torch.full((b, 2), FOCAL)
    x = dict(curr_f=torch.randn(b, h, w, C, generator=g),
             f_maps=torch.randn(b, h, w, C, generator=g),
             depth=u(2, 40, b, h, w, 1), rot=torch.tensor([ROT] * b),
             trans=torch.tensor([TRANS] * b), f=f, c=f.clone(),
             cv=torch.randn(b, h, w, (2 * V1_SEARCH + 1) ** 2, generator=g),
             out=torch.randn(b, h, w, 1, generator=g) * 4)
    if level < n_levels:
        x["deeper"] = u(2, 40, b, hd, wd, 1)
    x = {k: v.to(dev) for k, v in x.items()}
    for k in ("curr_f", "f_maps", "out"):
        x[k] = x[k].to(torch.bfloat16)
    deeper = x.get("deeper")
    go = torch.zeros(b, dtype=torch.bool, device=dev)
    prep_args = (x["curr_f"], (x["f_maps"], x["depth"]), deeper, go,
                 x["rot"], x["trans"], Camera(x["f"], x["c"]), 2.0 ** level)
    f0_w, log_d0w, log_dprev = glue_v1.glue_v1_prep(*prep_args)
    asm_args = (x["curr_f"], x["cv"], log_d0w, log_dprev, x["rot"],
                x["trans"], Camera(x["f"], x["c"]), 2.0 ** level)
    f_input = glue_v1.glue_v1_assemble(*asm_args)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    n_pix = b * h * w
    return dict(
        glue_v1_prep=dict(
            fused=lambda: glue_v1.glue_v1_prep_fused(*prep_args),
            plain=lambda: glue_v1.glue_v1_prep(*prep_args),
            nbytes=nbytes(x["f_maps"], x["depth"], deeper, f0_w, log_d0w,
                          log_dprev),
            flops=120 * n_pix + 12 * n_pix * C),
        glue_v1_assemble=dict(
            fused=lambda: glue_v1.glue_v1_assemble_fused(*asm_args),
            plain=lambda: glue_v1.glue_v1_assemble(*asm_args),
            nbytes=nbytes(x["curr_f"], x["cv"], log_d0w, log_dprev, f_input),
            flops=2 * f_input.numel()),
        glue_v1_finish=dict(
            fused=lambda: glue_v1.glue_v1_finish_fused(x["out"], LEAKY),
            plain=lambda: glue_v1.glue_v1_finish(x["out"], LEAKY),
            nbytes=nbytes(x["out"]) + 4 * n_pix,
            flops=10 * n_pix))


def check_glue_v1_case(case: dict, what: str) -> tuple:
    """One V1 glue kernel's results against its plain version's on the
    same inputs: float32 (the depth) to SNCV_TOL, bfloat16 (the warped
    features, the log depths, the refiner's input) within one ulp; the
    largest float32 error and the largest bfloat16 one in ulps."""
    got, want = case["fused"](), case["plain"]()
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    f32_err, ulps = 0.0, 0.0
    for i, (a, r) in enumerate(zip(got, want)):
        check(a.dtype == r.dtype and a.shape == r.shape,
              f"{what}[{i}]: {a.dtype} {tuple(a.shape)}")
        if r.dtype == torch.float32:
            torch.testing.assert_close(a, r, **SNCV_TOL, msg=f"{what}[{i}]")
            f32_err = max(f32_err, max_abs_err(a, r))
        else:
            ulps = max(ulps, assert_within_ulps(a, r, f"{what}[{i}]"))
    return f32_err, ulps


def glue_step_leaves(cfg: ModelConfig, dev, b: int, seed: int) -> dict:
    """The tensors one training step's glue reads at d6's level shapes
    (SIZE x SIZE, batch b, bf16 features), by (frame, level): each frame's
    features, and from frame 1 on the cost volumes, the warped parallax
    and the refiner's output, each a leaf that requires grad; the motion
    and the full-resolution camera."""
    g = torch.Generator().manual_seed(seed)
    leaves = {}
    for t in range(TRAIN_T):
        for level, h, w, C, cuts, _ in level_specs(cfg, b):
            x = dict(curr_f=torch.randn(b, h, w, C, generator=g)
                     .to(torch.bfloat16))
            if t > 0:
                reproj = torch.rand(b, h, w, 1, generator=g) * 5
                reproj[:, ::3] = 0.0        # the log's 1e-12 clamp
                x.update(cv=torch.randn(b, h, w, 9 * cuts, generator=g),
                         sncv=torch.randn(b, h, w, 49 * cuts, generator=g),
                         reproj=reproj,
                         out=(torch.randn(b, h, w, 1 + GLUE_OTHER,
                                          generator=g) * 3)
                         .to(torch.bfloat16))
            leaves[t, level] = {k: v.to(dev).requires_grad_()
                                for k, v in x.items()}
    f = torch.full((b, 2), FOCAL, device=dev)
    return dict(leaves=leaves, cam=Camera(f, f.clone()),
                rot=torch.tensor([ROT] * b, device=dev),
                trans=torch.tensor([TRANS] * b, device=dev))


def glue_step(cfg: ModelConfig, fns, x: dict):
    """One training step's glue, as ``M4Depth.forward`` runs it with
    ``fns`` = (prep, assemble, finish): TRAIN_T frames of the six levels,
    deepest first, frame 0 without state (24 preps, 18 assembles and
    finishes); the features' memory is the last frame's features. Returns
    the outputs that the step differentiates from outside the glue: the
    cost volumes' features and sweep centre, the refiner's input and the
    level's depth (the others feed later glue)."""
    prep, assemble, finish = fns
    outs, state = [], {}
    for t in range(TRAIN_T):
        deeper = None
        for level, h, w, C, cuts, _ in reversed(level_specs(cfg)):
            xi = x["leaves"][t, level]
            mul = 2.0 ** (level - 3)
            prev, cam_l, curr_p, prev_p, _ = prep(
                xi["curr_f"], deeper, state.get(level), x["trans"], x["cam"],
                2.0 ** level, cuts, True, GLUE_OTHER, 1000.0, torch.bfloat16)
            if t == 0:
                deeper = prev
                state[level] = (xi["curr_f"], torch.full_like(prev[0],
                                                              1000.0))
                continue
            f_input = assemble(xi["cv"], prev[1], prev[2], xi["sncv"],
                               xi["reproj"], mul, torch.bfloat16)
            deeper, depth = finish(xi["out"], prev, None, x["rot"],
                                   x["trans"], cam_l, mul, 1000.0)
            state[level] = (xi["curr_f"], depth)
            outs += [curr_p, prev_p, prev[1], f_input, depth]
    return outs


def glue_step_replay(cfg: ModelConfig, dev, fns, what: str,
                     seed: int = 0) -> dict:
    """One training step's glue (``glue_step`` with ``fns``) at b=TRAIN_B,
    captured into a CUDA graph twice: its forward alone (grad enabled, as
    training runs it) and its forward with the backward (random
    cotangents on ``glue_step``'s outputs, ``torch.autograd.grad`` of
    every leaf); each replayed under the profiler. Device-busy us and the
    device's kernels a replay for each, the backward's as their
    difference."""
    x = glue_step_leaves(cfg, dev, TRAIN_B, seed)
    leaves = [v for xi in x["leaves"].values() for v in xi.values()]
    g = torch.Generator(device=dev).manual_seed(seed)
    cots = [torch.randn(o.shape, generator=g, device=dev).to(o.dtype)
            for o in glue_step(cfg, fns, x)]

    def forward():
        return glue_step(cfg, fns, x)

    def both():
        # the deepest level's deeper estimate is constant: no gradient
        pairs = [(o, c) for o, c in zip(glue_step(cfg, fns, x), cots)
                 if o.requires_grad]
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [c for _, c in pairs], allow_unused=True)

    from torch.autograd import DeviceType

    out = {}
    for key, fn in (("forward", forward), ("both", both)):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as launches, torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        events, _ = profiled(graph.replay, GLUE_REPLAYS)
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not ("#" in e.name and "(" not in e.name)]
        out[key] = dict(
            busy_us=sum(e.time_range.elapsed_us() for e in kernels)
            / GLUE_REPLAYS,
            kernels=len(kernels) / GLUE_REPLAYS,
            span_ms=device_ms(graph.replay, GLUE_REPLAYS),
            # the hand-written kernels the graph launches, as its capture
            # recorded them
            launches={k.symbol: n for k, n in launches.items()},
            # the glue's own kernels: (runs, device us) a replay in the
            # profile, which can miss a few graph kernels (replay_kernels)
            glue={k: (sum(n in e.name for n in DEVICE_KERNELS[k]
                          for e in kernels) / GLUE_REPLAYS,
                      sum(e.time_range.elapsed_us() for e in kernels
                          if any(n in e.name for n in DEVICE_KERNELS[k]))
                      / GLUE_REPLAYS)
                  for k in GLUE + GLUE_BACKWARD})
        del graph
    out["backward"] = {k: out["both"][k] - out["forward"][k]
                       for k in ("busy_us", "kernels", "span_ms")}
    log(f"  {what} glue of a step (d6 {SIZE}x{SIZE} b={TRAIN_B} T={TRAIN_T}"
        f" bf16, replayed): " + "; ".join(
            f"{k} {r['busy_us']:.1f} us busy, {r['kernels']:.0f} kernels, "
            f"{r['span_ms'] * 1e3:.1f} us a replay" for k, r in out.items())
        + "; the glue kernels (runs, us): " + json.dumps(out["both"]["glue"]))
    return out


def phase_glue(cfg: ModelConfig, dev) -> dict:
    """The decoder glue's kernels at d6's six level shapes (384x384, b=1,
    bf16 convs and cost volumes), each against its plain version on the
    same inputs (``check_glue_case``), then its device time a call beside
    the plain version's and its bound; totals a serving frame (each
    kernel runs once a level). Then V1's glue kernels the same way at b=8
    (``check_glue_v1_case``), totals a V1 serving step of eight
    cameras."""
    totals = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                      t_ops=0.0, max_abs_err=0.0, max_ulps=0.0)
              for k in GLUE + GLUE_V1}
    levels = []
    runs = [(spec, GLUE, False) for spec in level_specs(cfg, 1)] + [
        (spec, GLUE_V1, True)
        for spec in level_specs(cfg, V1_GLUE_B, v1=True)]
    for spec, names, v1 in runs:
        level, h, w, C, cuts = spec[:5]
        if v1:
            cases = glue_v1_cases(spec, cfg.num_levels, dev, 41 + level)
        else:
            cases = glue_cases(spec, cfg.num_levels, dev, 21 + level,
                               cfg.torch_cv_dtype)
        b = spec[5].f.shape[0]
        row = dict(level=level, b=b, h=h, w=w, C=C, cuts=cuts)
        for name in names:
            d = cases[name]
            what = f"level {level} {h}x{w} b={b} {name}"
            err, ulps = (check_glue_v1_case(d, what) if v1 else
                         check_glue_case(name, d, cfg.torch_cv_dtype, dev,
                                         what))
            ms = device_ms(d["fused"], 100)
            # a plain call queues tens of small kernels: few calls keep them
            # inside the launch queue while the spin runs
            plain_ms = device_ms(d["plain"], 3)
            b_ms, b_by = bound(d["nbytes"], d["flops"])
            t = totals[name]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["bound_ms"] += b_ms
            t["t_bytes"] += d["nbytes"] / HBM_BYTES_PER_S * 1e3
            t["t_ops"] += d["flops"] / FP32_FLOPS_PER_S * 1e3
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["max_ulps"] = max(t["max_ulps"], ulps)
            row[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=d["nbytes"],
                             flops=d["flops"], max_abs_err=err,
                             max_ulps=ulps)
            log(f"  {what} C={C} cuts={cuts}: kernel "
                f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.3f} us ({b_by}; {d['nbytes']} B), "
                f"{100 * b_ms / ms:.1f}% of bound; max |float32 error| "
                f"{err:.3e}, max rounded error {ulps:.2f} ulp")
        levels.append(row)
    log(json.dumps({"glue_levels": levels}))
    for name, t in totals.items():
        log(f"  {name}: {t['ms'] * 1e3:.1f} us/"
            f"{'V1 step (b=8)' if name in GLUE_V1 else 'frame'} (bound "
            f"{t['bound_ms'] * 1e3:.2f} us, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of bound; plain "
            f"{t['plain_ms'] * 1e3:.1f} us)")
    return totals


def glue_backward_cases(spec, n_levels: int, dev, seed: int,
                        dtype) -> dict:
    """Each glue backward kernel's fused and plain calls at one d6 level
    shape (``level_specs``' batch), features, cost volumes and the
    refiner's input in ``dtype``, as the training step makes them: the
    features' gradients in the cost volumes' dtype, the resized deeper
    estimate's parallax and memory (its depth gets none), the refiner
    input's, the estimate's; some feature cuts zero (the norm's clamp),
    log parallaxes on and beyond the clip's bounds, the log's clamp met.
    With each: the call through autograd of its fused wrapper (the
    Function's backward, as the model runs it) and the unique bytes it
    reads and writes."""
    level, h, w, C, cuts, cam_l = spec
    b = cam_l.f.shape[0]
    g = torch.Generator().manual_seed(seed)
    cc = C // cuts

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g).to(dt)

    hd, wd = -(-h // 2), -(-w // 2)
    f = torch.full((b, 2), FOCAL)
    x = dict(curr_f=rnd(b, h, w, C, dt=dtype), f_maps=rnd(b, h, w, C,
                                                          dt=dtype),
             depth=torch.rand(b, h, w, 1, generator=g) * 38 + 2,
             g_curr=rnd(b, h, w, C, dt=dtype), g_prev_p=rnd(b, h, w, C,
                                                            dt=dtype),
             g_para=rnd(b, h, w, 1), g_other=rnd(b, h, w, GLUE_OTHER),
             cv=rnd(b, h, w, 9 * cuts), sncv=rnd(b, h, w, 49 * cuts),
             reproj=torch.rand(b, h, w, 1, generator=g) * 5,
             out=rnd(b, h, w, 1 + GLUE_OTHER) * 4,
             g_est=[rnd(b, h, w, 1), rnd(b, h, w, 1),
                    rnd(b, h, w, GLUE_OTHER)],
             rot=torch.tensor([ROT] * b), trans=torch.tensor([TRANS] * b),
             f=f, c=f.clone())
    x["curr_f"][:, ::5, ::3, :cc] = 0
    x["f_maps"][:, 1::4, ::2, -cc:] = 0
    x["reproj"][:, ::3] = 0.0
    x["out"][:, ::7, ::5, 0] = 7.0
    x["out"][:, 1::7, ::5, 0] = -7.0
    n = 9 * cuts + 1 + GLUE_OTHER + 49 * cuts + 1
    x["g_input"] = rnd(b, h, w, n, dt=dtype)
    x["out"] = x["out"].to(dtype)
    deeper = None if level == n_levels else (
        torch.rand(b, hd, wd, 1, generator=g) * 38 + 2,
        torch.rand(b, hd, wd, 1, generator=g) * 2.9 + 0.1,
        rnd(b, hd, wd, GLUE_OTHER))
    x = {k: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
         for k, v in x.items()}
    if deeper is not None:
        deeper = tuple(t.to(dev) for t in deeper)
    cam = Camera(x["f"], x["c"])
    lvl_mul = 2.0 ** (level - 3)
    deeper_hw = None if deeper is None else (hd, wd)
    g_prev = (None, x["g_para"], x["g_other"])
    prep_args = (x["g_curr"], x["g_prev_p"], g_prev, x["curr_f"],
                 x["f_maps"], deeper_hw, cuts, True)
    prev, cam_l = glue.glue_prep(x["curr_f"], deeper,
                                 (x["f_maps"], x["depth"]), x["trans"], cam,
                                 2.0 ** level, cuts, True, GLUE_OTHER, 1000.0,
                                 dtype)[:2]
    asm_args = (x["g_input"], prev[1], x["reproj"], 9 * cuts, GLUE_OTHER,
                49 * cuts, lvl_mul, (True,) * 5)
    fin_args = (x["g_est"], x["out"], x["rot"], x["trans"], cam_l, lvl_mul)

    # through autograd: the fused wrappers on leaves that require grad,
    # each backward alone (retain_graph keeps the forward for every call)
    leaf = {k: x[k].clone().requires_grad_()
            for k in ("curr_f", "f_maps", "cv", "sncv", "reproj", "out")}
    leaf_deeper = None if deeper is None else tuple(
        t.clone().requires_grad_() for t in deeper)
    p_out = glue.glue_prep_fused(
        leaf["curr_f"], leaf_deeper, (leaf["f_maps"], x["depth"]),
        x["trans"], cam, 2.0 ** level, cuts, True, GLUE_OTHER, 1000.0, dtype)
    p_outs = [p_out[2], p_out[3]] + ([] if deeper is None else
                                     [p_out[0][1], p_out[0][2]])
    p_cots = [x["g_curr"], x["g_prev_p"], x["g_para"], x["g_other"]]
    p_ins = [leaf["curr_f"], leaf["f_maps"], *(leaf_deeper or ())]
    prev_leaf = tuple(t.detach().requires_grad_() for t in prev)
    f_input = glue.glue_assemble_fused(leaf["cv"], prev_leaf[1],
                                       prev_leaf[2], leaf["sncv"],
                                       leaf["reproj"], lvl_mul, dtype)
    a_ins = [leaf["cv"], prev_leaf[1], prev_leaf[2], leaf["sncv"],
             leaf["reproj"]]
    est, _ = glue.glue_finish_fused(leaf["out"], prev, None, x["rot"],
                                    x["trans"], cam_l, lvl_mul, 1000.0)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    return dict(
        glue_prep_backward=dict(
            fused=lambda: glue.glue_prep_backward_fused(*prep_args),
            plain=lambda: glue.glue_prep_backward(*prep_args),
            autograd=lambda: torch.autograd.grad(
                p_outs, p_ins, p_cots[:len(p_outs)], retain_graph=True,
                allow_unused=True),
            nbytes=3 * nbytes(x["curr_f"], x["f_maps"])
            + nbytes(x["g_para"], x["g_other"])
            + (0 if deeper is None else nbytes(*deeper[1:])),
            flops=8 * b * h * w * C + 40 * b * hd * wd * (1 + GLUE_OTHER)),
        glue_assemble_backward=dict(
            fused=lambda: glue.glue_assemble_backward_fused(*asm_args),
            plain=lambda: glue.glue_assemble_backward(*asm_args),
            autograd=lambda: torch.autograd.grad(
                f_input, a_ins, x["g_input"], retain_graph=True),
            nbytes=nbytes(x["g_input"], prev[1], x["reproj"], x["cv"],
                          prev[1], prev[2], x["sncv"], x["reproj"]),
            flops=4 * b * h * w),
        glue_finish_backward=dict(
            fused=lambda: glue.glue_finish_backward_fused(*fin_args),
            plain=lambda: glue.glue_finish_backward(*fin_args),
            autograd=lambda: torch.autograd.grad(
                est, leaf["out"], x["g_est"], retain_graph=True),
            nbytes=nbytes(*x["g_est"], x["out"], x["out"]),
            flops=80 * b * h * w))


def phase_glue_backward(cfg: ModelConfig, dev) -> dict:
    """The glue's backward kernels at d6's six level shapes with b=TRAIN_B:
    each against its plain version in bfloat16 and float32 (features, cost
    volumes and refiner input in that dtype; ``testing.GLUE_BWD_TOL``),
    then, in bfloat16 (the training step's dtypes), its device time a call
    as called directly and through autograd of its fused wrapper, beside
    its plain version's and its bound; totals a training step (each level
    runs each backward TRAIN_T - 1 times)."""
    calls = TRAIN_T - 1
    totals = {k: dict(ms=0.0, plain_ms=0.0, autograd_ms=0.0, bound_ms=0.0,
                      t_bytes=0.0, t_ops=0.0, max_err={})
              for k in GLUE_BACKWARD}
    levels = []
    for spec in level_specs(cfg, TRAIN_B):
        level, h, w, C, cuts = spec[:5]
        row = dict(level=level, b=TRAIN_B, h=h, w=w, C=C, cuts=cuts)
        for dtype in (torch.float32, torch.bfloat16):
            cases = glue_backward_cases(spec, cfg.num_levels, dev,
                                        31 + level, dtype)
            for name in GLUE_BACKWARD:
                d = cases[name]
                got, want = d["fused"](), d["plain"]()
                if name == "glue_prep_backward":
                    got = got[:2] + tuple(got[2] or ())
                    want = want[:2] + tuple(want[2] or ())
                elif name == "glue_finish_backward":
                    got, want = (got,), (want,)
                err = 0.0
                for i, (a, r) in enumerate(zip(got, want)):
                    check((a is None) == (r is None), f"level {level} "
                          f"{name}[{i}]: a gradient on one side only")
                    if r is not None:
                        check(a.dtype == r.dtype and a.shape == r.shape,
                              f"level {level} {name}[{i}] {a.dtype}")
                        err = max(err, assert_grad_close(
                            a, r, GLUE_BWD_TOL[r.dtype],
                            f"level {level} {h}x{w} {dtype_name(dtype)} "
                            f"{name}[{i}]"))
                key = dtype_name(dtype)
                t = totals[name]
                t["max_err"][key] = max(t["max_err"].get(key, 0.0), err)
                if dtype != torch.bfloat16:
                    continue
                ms = device_ms(d["fused"], 100)
                ag_ms = device_ms(d["autograd"], 20)
                plain_ms = device_ms(d["plain"], 3)
                b_ms, b_by = bound(d["nbytes"], d["flops"])
                t["ms"] += ms * calls
                t["autograd_ms"] += ag_ms * calls
                t["plain_ms"] += plain_ms * calls
                t["bound_ms"] += b_ms * calls
                t["t_bytes"] += d["nbytes"] / HBM_BYTES_PER_S * 1e3 * calls
                t["t_ops"] += d["flops"] / FP32_FLOPS_PER_S * 1e3 * calls
                row[name] = dict(ms=ms, autograd_ms=ag_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 bytes=d["nbytes"], flops=d["flops"],
                                 max_abs_err=err)
                log(f"  level {level} b={TRAIN_B} {h}x{w} C={C} cuts={cuts} "
                    f"{name}: kernel {ms * 1e3:.2f} us, through autograd "
                    f"{ag_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                    f"bound {b_ms * 1e3:.3f} us ({b_by}; {d['nbytes']} B), "
                    f"{100 * b_ms / ms:.1f}% of bound; max |error| "
                    f"{err:.3e}")
        levels.append(row)
    log(json.dumps({"glue_backward_levels": levels}))
    for name, t in totals.items():
        log(f"  {name}: {t['ms'] * 1e3:.1f} us/step (through autograd "
            f"{t['autograd_ms'] * 1e3:.1f} us; bound "
            f"{t['bound_ms'] * 1e3:.2f} us, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of bound; plain "
            f"{t['plain_ms'] * 1e3:.1f} us); max |error| {t['max_err']}")
    return totals


def phase_glue_training(dev) -> dict:
    """One training step's glue replayed (``glue_step_replay``), plain and
    fused (its kernels' runs and device time a step through autograd);
    then compiled float32 d6 steps with the glue kernels against eager
    steps with the plain glue (``testing.assert_glue_steps_close``),
    without remat and with each policy."""
    cfg = ModelConfig(compute_dtype="bfloat16")
    out = {}
    for key, fns in (("plain", (glue.glue_prep, glue.glue_assemble,
                                glue.glue_finish)),
                     ("fused", (glue.glue_prep_fused,
                                glue.glue_assemble_fused,
                                glue.glue_finish_fused))):
        out[key] = glue_step_replay(cfg, dev, fns, key)
    want = m4depth_launches(TRAIN_T)
    got = out["fused"]["both"]["launches"]
    check(got == {k: want[k] for k in GLUE + GLUE_BACKWARD}
          and not out["plain"]["both"]["launches"],
          f"the replayed step's glue launches {got}, the plain glue's "
          f"{out['plain']['both']['launches']}")
    torch.cuda.empty_cache()
    for remat in ("", "all", "dscv"):
        kw = dict(remat=True, remat_policy=remat) if remat else {}
        res = assert_glue_steps_close(dev, **kw)
        log(f"  compiled float32 d6 128x128 b=2 T=3 steps, glue kernels "
            f"against the plain glue, remat {remat or 'none'}: worst leaf "
            "share of its tolerance by step "
            f"{[round(max(r['shares'].values()), 4) for r in res]}")
        torch.cuda.empty_cache()
    return out


# -- phase 22 ---------------------------------------------------------------

# calls of a kernel timed behind the spin (device_ms); a plain chain's few
# ATen kernels a call stay inside the launch queue at fewer
EPILOGUE_CALLS, EPILOGUE_PLAIN_CALLS = 100, 20


def conv_calls(family, cfg: ModelConfig, dev, b: int) -> list:
    """Each ``Conv3x3`` call of one serving frame of ``family`` at SIZE x
    SIZE and batch ``b`` (every level runs its refiner), in order: (module
    name, output shape [b, h, w, C], slope)."""
    from m4depth_tpu_torch.models.encoder import Conv3x3

    model = family(cfg, device=dev, seed=0)
    calls = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: calls.append(
            (name, tuple(o.shape), m.slope)))
        for name, m in model.named_modules() if isinstance(m, Conv3x3)]
    g = torch.Generator().manual_seed(0)
    f = torch.full((b, 2), FOCAL, device=dev)
    with torch.no_grad():
        model.step(init_state(cfg, b, SIZE, SIZE, device=dev),
                   torch.rand(b, SIZE, SIZE, 3, generator=g).to(dev),
                   torch.tensor([ROT] * b, device=dev),
                   torch.tensor([TRANS] * b, device=dev),
                   Camera(f, f.clone()), torch.ones(b, dtype=torch.bool,
                                                    device=dev))
    for h in hooks:
        h.remove()
    return calls


def epilogue_case(shape, slope, dev, g, backward: bool) -> dict:
    """One conv call's epilogue at ``shape`` [b, h, w, C] in bf16: the
    kernels against the plain chain on the card (the forward and dx bit for
    bit, the bias gradient to ``EPILOGUE_BIAS_RTOL`` of an fp64 sum and to
    bf16 rounding of the plain path's, the same on a second run), then each
    one's device time a call beside the plain chain's and its bound. The
    plain chain is what ran before: the bias cast to bf16 and added in
    place to the conv's NCHW (channels-last) output, then the activation;
    in the backward ATen's leaky_relu_backward on the pre-activation and
    the bias gradient summed in bf16 and cast to float32."""
    from m4depth_tpu_torch.ops import conv_epilogue as ce

    b, h, w, C = shape
    dt = torch.bfloat16
    y0 = torch.randn(b, C, h, w, generator=g, device=dev).to(dt).contiguous(
        memory_format=torch.channels_last)
    bias = 0.1 * torch.randn(C, generator=g, device=dev)
    x = y0.clone(memory_format=torch.channels_last)
    x.add_(bias.to(dt).reshape(1, C, 1, 1))
    want = x if slope is None else torch.nn.functional.leaky_relu(x, slope)
    y = y0.clone(memory_format=torch.channels_last)
    got = ce.conv_epilogue_fused(y, bias, slope)
    check(got.data_ptr() == y.data_ptr() and torch.equal(
        got, want.permute(0, 2, 3, 1)), f"epilogue forward {shape} slope "
          f"{slope}: in place and equal to the plain chain")
    n = b * h * w * C
    out = dict(fwd_bytes=2 * n * 2 + 4 * C)
    out["fwd_ms"] = device_ms(
        lambda: ce.conv_epilogue_fused(y, bias, slope), EPILOGUE_CALLS)
    xp = y0.clone(memory_format=torch.channels_last)

    def plain_forward():
        xp.add_(bias.to(dt).reshape(1, C, 1, 1))
        return xp if slope is None else torch.nn.functional.leaky_relu(
            xp, slope)

    out["fwd_plain_ms"] = device_ms(plain_forward, EPILOGUE_PLAIN_CALLS)
    if not backward:
        return out
    gr = torch.randn(b, C, h, w, generator=g, device=dev).to(dt).contiguous(
        memory_format=torch.channels_last)
    yv = None if slope is None else want.permute(0, 2, 3, 1)
    dx, db = ce.conv_epilogue_backward_fused(gr.permute(0, 2, 3, 1), yv,
                                             slope)
    ref = gr if slope is None else torch.ops.aten.leaky_relu_backward(
        gr, x, slope, False)
    check(torch.equal(dx, ref.permute(0, 2, 3, 1)), f"epilogue backward "
          f"{shape} slope {slope}: dx equal to leaky_relu_backward's")
    exact = ref.double().sum((0, 2, 3))
    scale = ref.double().abs().sum((0, 2, 3))
    plain = ref.sum((0, 2, 3)).float()
    err = (db.double() - exact).abs()
    check(bool((err <= EPILOGUE_BIAS_RTOL * scale).all()), f"epilogue "
          f"backward {shape}: bias gradient off the fp64 sum by "
          f"{(err / scale.clamp_min(1e-30)).max().item():.3e} of sum |dx|")
    check(bool(((db - plain).abs() <= 2 ** -8 * plain.abs()
                + EPILOGUE_BIAS_RTOL * scale.float()).all()),
          f"epilogue backward {shape}: bias gradient within bf16 rounding "
          "of the plain path's")
    check(torch.equal(ce.conv_epilogue_backward_fused(
        gr.permute(0, 2, 3, 1), yv, slope)[1], db), f"epilogue backward "
          f"{shape}: the bias gradient repeats bit for bit")
    out["bwd_bytes"] = (3 if slope is not None else 1) * n * 2 + 4 * C
    out["bwd_ms"] = device_ms(lambda: ce.conv_epilogue_backward_fused(
        gr.permute(0, 2, 3, 1), yv, slope), EPILOGUE_CALLS)

    def plain_backward():
        d = gr if slope is None else torch.ops.aten.leaky_relu_backward(
            gr, x, slope, False)
        return d.sum((0, 2, 3)).float()

    out["bwd_plain_ms"] = device_ms(plain_backward, EPILOGUE_PLAIN_CALLS)
    return out


def phase_conv_epilogue(dev) -> dict:
    """The convs' epilogue kernels at every conv call of the three
    benchmark units, bf16: a d6 serving frame (b=1, 54 calls), a V1
    serving step of eight cameras (b=8, 54 calls) and a d6 training step
    (b=3: each frame's 12 encoder calls, the 42 refiner calls of the three
    frames after the first), forward and, in training, backward; each call
    checked and timed (``epilogue_case``). Returns the totals a unit:
    kernel, plain chain and bound (bytes over HBM_BYTES_PER_S), us."""
    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(22)
    units = {"d6 frame b=1": (M4Depth, 1, False),
             "V1 step b=8": (M4DepthV1, 8, False),
             f"d6 train step b={TRAIN_B}": (M4Depth, TRAIN_B, True)}
    totals = {}
    for unit, (family, b, train) in units.items():
        t = collections.Counter()
        for name, shape, slope in conv_calls(family, cfg, dev, b):
            r = epilogue_case(shape, slope, dev, g, train)
            log(f"    {unit} {name} {shape} slope {slope}: " + ", ".join(
                f"{d} kernel {r[f'{d}_ms'] * 1e3:.2f} us, plain "
                f"{r[f'{d}_plain_ms'] * 1e3:.2f} us, bound "
                f"{r[f'{d}_bytes'] / HBM_BYTES_PER_S * 1e6:.2f} us"
                for d in (("fwd", "bwd") if train else ("fwd",))))
            # a training step: the encoder's calls on each of its frames,
            # the refiners' on the frames after the first
            times = (TRAIN_T if name.startswith("encoder.") else
                     TRAIN_T - 1) if train else 1
            for k, v in r.items():
                t[k] += times * v
            t["calls"] += times
        totals[unit] = t
        line = [f"{t['calls']} calls"]
        for d in ("fwd", "bwd") if train else ("fwd",):
            bound_ms = t[f"{d}_bytes"] / HBM_BYTES_PER_S * 1e3
            line.append(
                f"{d} kernel {t[f'{d}_ms'] * 1e3:.1f} us, plain "
                f"{t[f'{d}_plain_ms'] * 1e3:.1f} us, bound "
                f"{bound_ms * 1e3:.1f} us ({t[f'{d}_bytes']} B, "
                f"{100 * bound_ms / t[f'{d}_ms']:.1f}% of bound)")
        log(f"  {unit}: " + "; ".join(line))
    log(json.dumps({"conv_epilogue": {u: dict(t) for u, t in totals.items()},
                    "card": gpu_name_and_power_limit()}))
    return totals


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
    times = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        times[name] = time.perf_counter() - t0
        return result

    log("== phase 1: environment")
    timed(1, phase_environment)
    log("== phase 2: forward kernels against their plain versions (d6 "
        "384x384 level shapes, b=1; V1's SNCV at b=1 and b=3)")
    worst = timed(2, phase_kernels_vs_plain, serving, dev)
    log("== phase 3: backward kernels against their plain versions (d6 "
        f"384x384 level shapes, b={TRAIN_B}; V1's SNCV at b=1 and "
        f"b={TRAIN_B})")
    worst.update(timed(3, phase_backward_vs_plain, serving, dev))
    log("== phase 4: d6 128x128 model, card (kernels) against CPU (plain), "
        "float32")
    timed(4, phase_model_card_vs_cpu, dev)
    log("== phase 5: one training step, d6 128x128 b=2 T=3, card against "
        "CPU, float32")
    timed(5, phase_train_card_vs_cpu, dev)
    log("== phase 6: serving path, streaming M4Depth.step d6 384x384 b=1 "
        "bf16")
    serve = timed(6, phase_main_path, dev)
    log("== phase 7: profile of the serving path")
    timed(7, phase_profile, serve["run"], PROFILED_FRAMES, "frame")
    log(f"== phase 8: training path, d6 384x384 b={TRAIN_B} T={TRAIN_T} "
        "bf16/bf16, Adam 1e-4")
    train = timed(8, phase_train_path, dev)
    log("   profile of the training path")
    phase_profile(train["run"], PROFILED_STEPS, "step")
    log("== phase 9: forward kernel device times per level shape, b=1 "
        "(serving), bf16, on random inputs and (DSCV) on one serving "
        "frame's; then V1's SNCV (radius 4, one cut, c1 != c2); no single "
        "PyTorch call computes either op, so library_ms is null")
    model_dscv = {}
    with captured_dscv_inputs(model_dscv):
        serve["run"]()
    check(len(model_dscv) == serving.num_levels, "one DSCV call a level")
    t0 = time.perf_counter()
    serving_totals = phase_kernel_times(serving, dev, 1, False, 1,
                                        model_dscv)
    v1_serving_totals = phase_kernel_times(serving, dev, 1, False, 1,
                                           v1=True)
    times[9] = time.perf_counter() - t0
    log(f"== phase 10: kernel device times per level shape, b={TRAIN_B} "
        f"(training), bf16; per step each level runs {TRAIN_T - 1} times "
        f"(V1's SNCV {TRAIN_T} times)")
    t0 = time.perf_counter()
    totals = phase_kernel_times(serving, dev, TRAIN_B, True, TRAIN_T - 1)
    v1_totals = phase_kernel_times(serving, dev, TRAIN_B, True, TRAIN_T,
                                   v1=True)
    times[10] = time.perf_counter() - t0
    log(f"== phase 11: the CLI (m4depth_tpu_torch.cli.main) on a synthetic "
        f"record store, d6 {SIZE}x{SIZE}: train, resume, --augment_device, "
        "validation (a child process on the card), eval, predict; V1 train "
        f"and eval; --remat at T={REMAT_T}; finetune_kitti")
    cli = timed(11, phase_cli, dev, train["ms_per_step"])
    log("== phase 12: the V1 model: d6 128x128 card against CPU, float32")
    t0 = time.perf_counter()
    phase_v1_card_vs_cpu(dev)
    log("   V1 serving path, streaming M4DepthV1.step d6 384x384 b=1 bf16")
    v1_serve = phase_main_path(dev, M4DepthV1, v1_serving_launches())
    log("   profile of V1's serving path")
    v1_serve_prof = phase_profile(v1_serve["run"], PROFILED_FRAMES, "frame")
    log(f"   V1 training path, d6 384x384 b={TRAIN_B} T={TRAIN_T} bf16/bf16")
    v1_train = phase_train_path(dev, M4DepthV1, per_step=v1_launches(TRAIN_T))
    log("   profile of V1's training path")
    v1_train_prof = phase_profile(v1_train["run"], PROFILED_STEPS, "step")
    log(f"   the training step at T={REMAT_T}, b={TRAIN_B}, without and with "
        "remat")
    remat = phase_remat(dev)
    times[12] = time.perf_counter() - t0
    log("== phase 13: the geometry gates (synthetic_validation --mode "
        "overfit, d4 64x64 bf16)")
    gates = timed(13, phase_gates)
    log("== phase 14: parallel serving, d6 384x384 bf16: sharded_stream "
        f"on [{dev}] at N = {', '.join(map(str, STREAM_COUNTS))} streams, "
        "the forward kernels against their plain versions at b=N; "
        "FreshFrameStream against the serial loop; the port's "
        "fresh_frame_bench")
    t0 = time.perf_counter()
    sharded = phase_sharded_serving(dev)
    for r in sharded.values():
        for key, err in r["max_abs_err"].items():
            worst[key] = max(worst[key], err)
    fresh = phase_fresh_frames(dev)
    times[14] = time.perf_counter() - t0
    log("== phase 15: data-parallel training: world 1 over NCCL in this "
        f"process; {GLOO_RANKS} ranks on the one card over gloo; the CLI "
        "under torch.distributed.run")
    t0 = time.perf_counter()
    ddp1 = phase_ddp_world1(dev, train["ms_per_step"])
    gloo = phase_ddp_gloo(dev)
    phase_cli_launcher(dev, cli["ms_step"])
    times[15] = time.perf_counter() - t0
    log("== phase 16: float16 cost volumes: the extreme parallax through the "
        "DSCV kernel; streaming and training of both families; the kernels' "
        "float16 device times")
    t0 = time.perf_counter()
    phase_fp16_extreme(dev)
    f16 = phase_fp16_paths(dev)
    f16_cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype=F16)
    log("   float16 kernel device times per level shape, b=1 (serving)")
    f16_serving_totals = phase_kernel_times(f16_cfg, dev, 1, False, 1)
    log(f"   float16 kernel device times per level shape, b={TRAIN_B} "
        "(training)")
    f16_totals = phase_kernel_times(f16_cfg, dev, TRAIN_B, True, TRAIN_T - 1)
    times[16] = time.perf_counter() - t0
    log("== phase 17: compiled_cost of one serving frame and one training "
        "step")
    costs = timed(17, phase_compiled_cost, serve, train)
    log("== phase 18: the native host backproject")
    timed(18, phase_native)
    log("== phase 19: the port's tools (memory_footprint, fps, train_prof, "
        "io_bench, rehearsal)")
    tools = timed(19, phase_tools, dev)
    log("== phase 20: the compiled programs (CUDA graphs): serving and "
        "training of both families against the eager steps, in turns; a "
        f"float32 check; T={REMAT_T} with remat; the CLI's eval mode")
    graphs = timed(20, phase_graphs, dev)
    log("== phase 21: the decoder glue's kernels against their plain "
        "versions (d6 384x384 level shapes, b=1, bf16; V1's at b=8), "
        "timed; their "
        f"backward kernels (b={TRAIN_B}, float32 and bf16), timed; one "
        "training step's glue replayed, plain and fused; compiled float32 "
        "steps with the glue kernels against the plain glue, each remat "
        "policy")
    t0 = time.perf_counter()
    glue_totals = phase_glue(serving, dev)
    glue_totals.update(phase_glue_backward(serving, dev))
    glue_train = phase_glue_training(dev)
    times[21] = time.perf_counter() - t0
    log("== phase 22: the convs' epilogue kernels against the plain chain "
        "at every conv call of a d6 serving frame (b=1), a V1 step (b=8) "
        f"and a d6 training step (b={TRAIN_B}), bf16, timed")
    epilogue = timed(22, phase_conv_epilogue, dev)

    kernels = []
    for key, info in KERNEL_INFO.items():
        t = totals[key]
        n_train = train["launches"][key]
        n_serve = serve["launches"][key]
        v1t, v1s = v1_totals.get(key), v1_serving_totals.get(key)
        kernels.append(dict(
            name=key, route="cuda", **info,
            # the training path's count: it runs all four kernels
            launches=n_train, launches_per_step=n_train // train["n_steps"],
            # phase 11: the CLI's first train run, its eval run, V1's train
            # and eval runs, the --remat run and the finetune
            cli_train_launches=cli["train_launches"][key],
            cli_eval_launches=cli["eval_launches"][key],
            cli_v1_train_launches=cli["v1_train_launches"][key],
            cli_v1_eval_launches=cli["v1_eval_launches"][key],
            cli_remat_launches=cli["remat_launches"][key],
            cli_finetune_launches=cli["finetune_launches"][key],
            serving_launches=n_serve,
            serving_launches_per_frame=n_serve // serve["n_frames"],
            # phase 12: V1's serving and training paths
            v1_serving_launches_per_frame=(v1_serve["launches"][key]
                                           // v1_serve["n_frames"]),
            v1_launches_per_step=(v1_train["launches"][key]
                                  // v1_train["n_steps"]),
            # phase 13: each geometry gate's run
            gate_launches={m: g["launches"][key] for m, g in gates.items()},
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
            # per training step, backward kernels only: the same calls made
            # through autograd of the fused wrapper, as the model makes them
            autograd_ms=t.get("autograd_ms"),
            # V1's SNCV (radius 4, one cut, c1 != c2): per step (b=3, each
            # level 4 times) and per serving frame (b=1)
            v1_ms=v1t["ms"] if v1t else None,
            v1_plain_ms=v1t["plain_ms"] if v1t else None,
            v1_bound_ms=v1t["bound_ms"] if v1t else None,
            v1_bound_by=(("bytes" if v1t["t_bytes"] >= v1t["t_ops"]
                          else "operations") if v1t else None),
            v1_autograd_ms=v1t.get("autograd_ms") if v1t else None,
            v1_serving_ms=v1s["ms"] if v1s else None,
            v1_serving_bound_ms=v1s["bound_ms"] if v1s else None,
            # phase 14: launches a step of sharded_stream at each N, and a
            # frame of FreshFrameStream
            sharded_serving_launches_per_step={
                n: r["launches_per_step"][key] for n, r in sharded.items()},
            fresh_frame_launches_per_frame=fresh["launches_per_frame"][key],
            # phase 15: a step through DistributedDataParallel, world 1
            # over NCCL, and each of the ranks over gloo
            ddp_launches_per_step=ddp1["launches"][key] // ddp1["n_steps"],
            gloo_rank_launches_per_step=[
                r["launches_per_step"][key] for r in gloo["ranks"]],
            # phase 19: each tool's run
            tool_launches={name: n[key]
                           for name, n in tools["launches"].items()},
            # phase 20: the compiled (CUDA-graph) paths: launches a frame
            # and a step counted through the replays, and the runs on the
            # device a replayed frame or step that the profiler saw
            graph_serving_launches_per_frame=(
                graphs["serve"]["launches"][key] // GRAPH_FRAMES),
            graph_v1_serving_launches_per_frame=(
                graphs["v1_serve"]["launches"][key] // GRAPH_FRAMES),
            graph_launches_per_step=graphs["train"]["compiled"]["launches"][
                key] // 3,
            graph_v1_launches_per_step=graphs["v1_train"]["compiled"][
                "launches"][key] // 3,
            graph_profiled_per_frame=graphs["serve"]["replay"][key],
            graph_profiled_per_step=graphs["train"]["replay"][key],
            graph_cli_eval_launches=graphs["cli_eval"]["launches"][key],
            passed=True))
        check(kernels[-1]["launches_per_step"] == train["per_step"][key],
              f"{key} launches per step")
    # the float16 instantiations: the same kernels with another element
    # type, on phase 16's paths; the same bytes, so the same bound
    for key, info in KERNEL_INFO.items():
        t, ts = f16_totals[key], f16_serving_totals.get(key)
        n_train = f16["train"]["launches"][key]
        kernels.append(dict(
            name=err_key(key, torch.float16), route="cuda", **info,
            launches=n_train,
            launches_per_step=n_train // f16["train"]["n_steps"],
            serving_launches_per_frame=(f16["serve"]["launches"][key]
                                        // f16["serve"]["n_frames"]),
            v1_serving_launches_per_frame=(f16["v1_serve"]["launches"][key]
                                           // f16["v1_serve"]["n_frames"]),
            v1_launches_per_step=(f16["v1_train"]["launches"][key]
                                  // f16["v1_train"]["n_steps"]),
            cli_eval_launches=cli["eval_f16_launches"][key],
            cli_v1_eval_launches=cli["v1_eval_f16_launches"][key],
            max_abs_err=worst[err_key(key, torch.float16)],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_bytes"] >= t["t_ops"] else "operations",
            library_ms=None,
            serving_ms=ts["ms"] if ts else None,
            serving_bound_ms=ts["bound_ms"] if ts else None,
            autograd_ms=t.get("autograd_ms"),
            passed=True))
        check(kernels[-1]["launches_per_step"]
              == f16["train"]["per_step"][key],
              f"{key} float16 launches per step")
    # the decoder glue's kernels and their backwards: launches are the
    # serving path's (phase 6, counted from 0 just before it) and the
    # training path's (phase 8); the forwards' times a serving frame (b=1,
    # six levels), the backwards' a training step (b=3); through autograd,
    # each one's device time in one training step's glue replayed (phase
    # 21); the JAX package's XLA fuses this glue and its VJP
    per_step = m4depth_launches(TRAIN_T)
    for key in GLUE + GLUE_BACKWARD:
        t = glue_totals[key]
        n_serve = serve["launches"][key]
        runs = glue_train["fused"]["both"]["launches"].get(key, 0)
        us = glue_train["fused"]["both"]["glue"][key][1]
        kernels.append(dict(
            name=key, route="cuda",
            source=("m4depth_tpu_torch/ops/csrc/"
                    + ("glue.cu" if key in GLUE else "glue_backward.cu")),
            replaces=None, plain=f"m4depth_tpu_torch/ops/glue.py::{key}",
            launches=n_serve,
            serving_launches_per_frame=n_serve // serve["n_frames"],
            launches_per_step=train["launches"][key] // train["n_steps"],
            cli_eval_launches=cli["eval_launches"][key],
            graph_serving_launches_per_frame=(
                graphs["serve"]["launches"][key] // GRAPH_FRAMES),
            graph_profiled_per_frame=graphs["serve"]["replay"][key],
            graph_launches_per_step=graphs["train"]["compiled"]["launches"][
                key] // 3,
            graph_profiled_per_step=graphs["train"]["replay"][key],
            max_abs_err=t.get("max_abs_err", t.get("max_err")),
            max_ulps=t.get("max_ulps"),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_bytes"] >= t["t_ops"] else "operations",
            autograd_ms=t.get("autograd_ms"),
            step_replay_runs=runs, step_replay_ms=us * 1e-3,
            library_ms=None, passed=True))
        check(kernels[-1]["serving_launches_per_frame"]
              == (serving.num_levels if key in GLUE else 0)
              and kernels[-1]["launches_per_step"] == per_step[key],
              f"{key}: {kernels[-1]['serving_launches_per_frame']} a "
              f"serving frame, {kernels[-1]['launches_per_step']} a "
              f"training step, expected {per_step[key]}")
    # V1's glue kernels: launches a V1 serving frame (phase 12, b=1), none
    # a V1 training step (its glue runs plain under grad); times a V1
    # serving step of eight cameras (phase 21, b=8); the JAX package's XLA
    # fuses this glue
    for key in GLUE_V1:
        t = glue_totals[key]
        kernels.append(dict(
            name=key, route="cuda",
            source="m4depth_tpu_torch/ops/csrc/glue_v1.cu", replaces=None,
            plain=f"m4depth_tpu_torch/ops/glue_v1.py::{key}",
            v1_serving_launches_per_frame=(v1_serve["launches"][key]
                                           // v1_serve["n_frames"]),
            v1_launches_per_step=(v1_train["launches"][key]
                                  // v1_train["n_steps"]),
            cli_v1_eval_launches=cli["v1_eval_launches"][key],
            graph_v1_serving_launches_per_frame=(
                graphs["v1_serve"]["launches"][key] // GRAPH_FRAMES),
            graph_v1_launches_per_step=graphs["v1_train"]["compiled"][
                "launches"][key] // 3,
            gate_launches={m: g["launches"][key] for m, g in gates.items()},
            max_abs_err=t["max_abs_err"], max_ulps=t["max_ulps"],
            v1_step_ms=t["ms"], v1_step_plain_ms=t["plain_ms"],
            v1_step_bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_bytes"] >= t["t_ops"] else "operations",
            library_ms=None, passed=True))
        check(kernels[-1]["v1_serving_launches_per_frame"] == 6
              and kernels[-1]["v1_launches_per_step"] == 0,
              f"{key}: {kernels[-1]['v1_serving_launches_per_frame']} a V1 "
              f"serving frame, {kernels[-1]['v1_launches_per_step']} a V1 "
              "training step, expected 6 and 0")
    # the convs' epilogue kernels: launches a serving frame (phase 6), a
    # training step (phase 8), a V1 serving frame and training step (phase
    # 12); device time a unit over its conv calls beside the plain chain's
    # and the bound (phase 22); the JAX package's XLA fuses the epilogue
    # into its convs
    for key, d, plain in (("conv_epilogue_forward", "fwd", "conv_epilogue"),
                          ("conv_epilogue_backward", "bwd",
                           "conv_epilogue_backward")):
        kernels.append(dict(
            name=key, route="cuda",
            source="m4depth_tpu_torch/ops/csrc/conv_epilogue.cu",
            replaces=None,
            plain=f"m4depth_tpu_torch/ops/conv_epilogue.py::{plain}",
            serving_launches_per_frame=(serve["launches"][key]
                                        // serve["n_frames"]),
            launches_per_step=train["launches"][key] // train["n_steps"],
            v1_serving_launches_per_frame=(v1_serve["launches"][key]
                                           // v1_serve["n_frames"]),
            v1_launches_per_step=(v1_train["launches"][key]
                                  // v1_train["n_steps"]),
            us={u: 1e3 * t[f"{d}_ms"] for u, t in epilogue.items()
                if t[f"{d}_ms"]},
            plain_us={u: 1e3 * t[f"{d}_plain_ms"]
                      for u, t in epilogue.items() if t[f"{d}_ms"]},
            bound_us={u: 1e6 * t[f"{d}_bytes"] / HBM_BYTES_PER_S
                      for u, t in epilogue.items() if t[f"{d}_ms"]},
            bound_by="bytes", library_ms=None, passed=True))
        want = (m4depth_serving_launches()[key],
                m4depth_launches(TRAIN_T)[key], v1_serving_launches()[key],
                v1_launches(TRAIN_T)[key])
        got = tuple(kernels[-1][k] for k in (
            "serving_launches_per_frame", "launches_per_step",
            "v1_serving_launches_per_frame", "v1_launches_per_step"))
        check(got == want, f"{key}: launches a serving frame, a training "
              f"step, a V1 serving frame and a V1 step {got}, expected "
              f"{want}")
    log(json.dumps({"glue_step_replay": {
        k: {p: {q: v for q, v in r.items() if q != "glue"}
            for p, r in d.items()} for k, d in glue_train.items()},
        "card": gpu_name_and_power_limit()}))
    log("phase times: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                    times.items()))
    log(json.dumps({"compiled_cost": costs}))
    log(json.dumps({"remat": {k: dict(ms_per_step=v["ms_per_step"],
                                      peak_above_base=v["peak_above_base"])
                              for k, v in remat.items()},
                    "gates": {m: {k: v for k, v in g.items()
                                  if k != "launches"}
                              for m, g in gates.items()}}))
    log(json.dumps({"v1_profile": {"serving_per_frame": v1_serve_prof,
                                   "training_per_step": v1_train_prof,
                                   "card": gpu_name_and_power_limit()}}))
    log(json.dumps({"graphs": graph_summary(graphs),
                    "card": gpu_name_and_power_limit()}))
    log(f"smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

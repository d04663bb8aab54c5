"""Comparisons of the CUDA kernels, and of the model on the card, with their
plain PyTorch versions: the tolerances and the rules that ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` both apply, kept in one place.

Each ``assert_*`` raises an ``AssertionError`` naming what disagreed (also
under ``python -O``) and returns the largest error it saw, for the caller
to print.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera, parallax_sweep_flows
from m4depth_tpu_torch.models import M4Depth
from m4depth_tpu_torch.ops import (
    glue,
    glue_launches,
    glue_v1,
    spatial_cost_volume,
)
from m4depth_tpu_torch.train import (
    TrainState,
    compile_train_step,
    make_optimizer,
    make_train_step,
)

# Forward kernels against their plain versions. Both sides round their
# inputs to the same dtype and multiply and add in float32.
#   SNCV: the same products summed in another order (and with FMA): float32
#     rounding of a cut's mean of at most 192 terms (V1's one cut at level
#     6; M4Depth's cuts have at most 24) whose absolute values sum to at
#     most 1 for unit cuts.
#   DSCV: the kernel computes each sample position inline, the plain version
#     through tensor ops; positions differ by a few float32 ulps of a pixel
#     coordinate (< 1.2e-4 px below 512). Bilinear sampling is continuous in
#     the position, so outputs differ by at most that times their per-pixel
#     slope: 2/cc for the per-cut mean of unit cuts, and up to the random
#     parallax map's step (<= 4 per px in the checks) for the parallax.
SNCV_TOL = dict(rtol=1e-5, atol=1e-6)
DSCV_CV_TOL = dict(rtol=1e-4, atol=2e-5)
DSCV_PARA_TOL = dict(rtol=1e-4, atol=5e-4)

# The model's depth, card (kernels, cuDNN with TF32 off) against CPU (plain
# versions), float32. Under mostly lateral motion the recurrence is well
# conditioned (no parallax near zero), so op-level float32 differences of
# ~1e-4 stay ~1e-4 in depth.
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)

# The model's depth in bfloat16 against another run of the same weights on
# the same frames whose convs may take other cuDNN algorithms (a batch of
# streams against each stream alone): a conv summed in another order rounds
# its bfloat16 output to a neighbour, one ulp (2^-8 of the value) apart,
# and the ~70 convs and cost volumes of a d6 frame, and the recurrence over
# frames, compound such steps. So half the pixels within 2^-6 (four ulps)
# and 99% within 2^-3 of their own depth; a stream read in another
# stream's place (each has its own motion, so its own depth scale) misses
# both.
BF16_DEPTH_MEDIAN_RTOL, BF16_DEPTH_P99_RTOL = 2.0 ** -6, 2.0 ** -3

# The evaluator's metrics accumulated on the card against the CPU's
# accumulation of the same depths (the card's, copied): the same float32
# arithmetic per pixel, sums and means in other orders.
EVAL_METRIC_TOL = dict(rtol=1e-5, atol=1e-6)

# The decoder glue's kernels (ops/csrc/glue.cu) against their plain versions
# (ops/glue.py) on the card. Both compute in float32 with the same roundings
# at the same points, but the kernels sum a cut's squares in another order
# than ATen's reduction and take the depth's epipolar terms from the DSCV
# kernels' (contracted into FMAs), so float32 results differ by a few
# float32 ulps (SNCV_TOL holds them), and where such a difference straddles
# a rounding boundary an output rounded to bfloat16 or float16 differs by
# one ulp (GLUE_ULPS, ``assert_within_ulps``) of the coarsest dtype it was
# rounded to: features of bfloat16 convs rounded on to float16 cost
# volumes keep bfloat16's spacing (one bfloat16 ulp is 8 of float16).
# V1's glue kernels (ops/csrc/glue_v1.cu) against theirs (ops/glue_v1.py)
# by the same rule: they round as the plain chain rounds on the card, its
# rotation matrix and its three-term sums (in ATen's CUDA order) included.
GLUE_ULPS = 1

# The glue's backward kernels (ops/csrc/glue_backward.cu) against their
# plain versions (ops/glue.py), and those against autograd of the plain
# forwards, as (rtol, atol as a fraction of the largest reference value), by
# the gradient's dtype.
#   float32: the same terms summed in other orders (a cut's sum of squares
#     and of products with the gradient, the normalisation's three terms,
#     the resize's taps), and, on the card, CUDA's rsqrtf and the depth's
#     epipolar terms from the DSCV kernels' contracted arithmetic: a few
#     float32 ulps of the largest term; where the terms cancel (a gradient
#     along the normalised cut) the atol of 1e-5 of the largest value holds
#     that remainder.
#   bfloat16 (the features' and the refiner output's gradients): both sides
#     round one float32 value to bfloat16, so one ulp apart at most, 2^-7
#     of the value, as BWD_TOL's.
GLUE_BWD_TOL = {torch.float32: (1e-5, 1e-5),
                torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}

# The convs' epilogue (ops/csrc/conv_epilogue.cu): its forward and its dx
# equal the plain chain's on the card bit for bit. Its bias gradient sums
# dx in float32 in a fixed order, a thread's vectors, then the block's
# lanes, then the blocks' rows: a few hundred partial sums in sequence at
# the model's shapes, each adding at most 2^-24 of the running sum, so it
# lies within this share of sum |dx| of the exact sum.
EPILOGUE_BIAS_RTOL = 2.0 ** -13

# Backward kernels against autograd of the plain forward, as (rtol, atol as
# a fraction of the largest reference value).
#   float32: the same products summed in another order, the DSCV's dc2 and
#     dpara by atomics whose order changes from run to run, and the DSCV's
#     few-ulp position difference: 1e-4 (the SNCV, which has neither
#     atomics nor positions, 1e-5).
#   bfloat16 outputs (dc1, dc2, dpara): both sides round one float32 sum to
#     bfloat16, so they differ by at most one ulp, 2^-7 of the value; the
#     atol of one ulp of the largest value covers values that float32
#     rounding moves across zero. With c1 is c2 autograd adds two such
#     bfloat16 gradients on each side: two ulps.
#   float16 outputs: the same rule with float16's ulp, 2^-10 of the value
#     (one ulp; two with c1 is c2), 8 times tighter than bfloat16's.
#   The SNCV's reference is its plain version on the backward kernel's own
#     inputs (``sncv_plain_grads``): the leaky ReLU's derivative taken at
#     the forward output the kernel is given. Autograd of the whole plain
#     forward would take it at its own output, and where a correlation is
#     within rounding of zero the two forwards can fall on either side of
#     the kink (float16 met one in 2.2M outputs), moving that pixel's
#     gradient by 0.9 of its term.
#   The DSCV's sweep-centre gradient is float32 in every dtype (1e-4). The
#     bilinear sample's derivative jumps where a sample crosses a pixel
#     boundary, so pixels with a sample within TIE_PX of one, where the
#     few-ulp position difference can pick either side, are left out of its
#     comparison (ties are measure-zero).
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -7),
           torch.float16: (2.0 ** -10, 2.0 ** -10)}
SNCV_BWD_TOL = {torch.float32: (1e-5, 1e-5),
                torch.bfloat16: (2.0 ** -7, 2.0 ** -7),
                torch.float16: (2.0 ** -10, 2.0 ** -10)}
SNCV_SAME_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -6),
                 torch.float16: (2.0 ** -10, 2.0 ** -9)}
TIE_PX = 1e-3

# V1's SNCV (radius 4, one cut, c1 != c2) at shapes that reach each branch
# of its kernels' launch plans beyond the d6 level shapes, as (b, h, w, C):
# a width that is a multiple of neither the backward's 16-pixel tiles nor
# the forward's segments, over several bands of rows; a height below the
# 9-row window; C = 18, a multiple of no 16-byte vector in any dtype (the
# 4-byte paths); the KITTI finetune's level 1 (256x768 frames); b=8 at
# levels 3 and 6 (the forward's split channels, the backward's row
# groups). The one-cut backward kernel takes each of them; the d6 levels
# also reach the tile kernel it leaves V1's level 5 to.
# ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 2 and 3 both
# run them.
V1_SNCV_EDGE_SHAPES = ((2, 13, 37, 16), (3, 5, 41, 32), (2, 11, 41, 18),
                       (3, 128, 384, 16), (8, 48, 48, 64), (8, 6, 6, 192))
DSCV_GRADS = ("dc1", "dc2", "dpara", "dcentre")

# One training step, card against CPU, float32. The loss to rtol 1e-4.
# Each gradient to rtol 1e-3 plus an atol of 1e-3 of its leaf's largest
# value (float32 convs and cost volumes summed in other orders through the
# recurrence). A leaf whose largest gradient is under SMALL_LEAF of the
# model's largest (the deeper encoder convs: their gradient reaches them
# through the normalised cost volumes) is a small remainder of sums that
# cancel, and keeps the differences of their terms in absolute size: the
# card's and the CPU's arithmetic of the model's other ops put such leaves
# up to ~5e-3 of their scale apart even with the plain cost volumes on
# both, and moving every frame value by one float32 ulp moves some by
# ~1e-3 (chip_smoke.py phase 5 prints both), so such a leaf is held to
# 1e-2 of its scale. Every leaf also gets an atol of one float32 ulp of
# the model's largest gradient: a gradient that is zero in exact arithmetic
# (the first conv's bias, whose output the domain norm centres) is
# computed as a rounding residue.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-3, 1e-3
SMALL_LEAF, SMALL_LEAF_ATOL = 1e-2, 1e-2
STEP_GRAD_ATOL_TOP = 2.0 ** -23


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_bf16_depth_close(got: torch.Tensor, want: torch.Tensor,
                            what: str) -> Tuple[float, float]:
    """bfloat16-compute depth ``got`` against ``want`` under the rule
    above; returns the median and 99th-percentile relative error."""
    rel = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1e-6)).flatten().double()
    _require(bool(torch.isfinite(got).all()), f"{what}: depth not finite")
    med = rel.median().item()
    p99 = torch.quantile(rel, 0.99).item()
    _require(med <= BF16_DEPTH_MEDIAN_RTOL and p99 <= BF16_DEPTH_P99_RTOL,
             f"{what}: relative error median {med:.3e}, 99th percentile "
             f"{p99:.3e}")
    return med, p99


def ulps(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at each value of ``x``, as
    float32 (the subnormal spacing at and below the smallest normal)."""
    fi = torch.finfo(dtype)
    mag = x.float().abs()
    _, exp = torch.frexp(mag)
    spacing = fi.eps * torch.pow(2.0, (exp - 1).float())
    return torch.where(mag < fi.tiny, fi.tiny * fi.eps, spacing)


def assert_within_ulps(got: torch.Tensor, want: torch.Tensor, what: str,
                       n: int = GLUE_ULPS,
                       spacing_dtype: Optional[torch.dtype] = None) -> float:
    """``got`` and ``want`` of one dtype within ``n`` ulps of
    ``spacing_dtype`` (by default theirs) at each value (the larger spacing
    of the two, where they straddle a power of two); returns the largest
    difference in ulps."""
    _require(got.dtype == want.dtype and got.shape == want.shape,
             f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} "
             f"{tuple(want.shape)}")
    _require(bool(torch.isfinite(want).all()), f"{what}: reference not finite")
    dt = spacing_dtype or got.dtype
    spacing = torch.maximum(ulps(got, dt), ulps(want, dt))
    err = ((got.float() - want.float()).abs() / spacing).max().item()
    _require(err <= n, f"{what}: {err:.2f} ulps apart (at most {n})")
    return err


def assert_grad_close(got: torch.Tensor, ref: torch.Tensor,
                      tol: Tuple[float, float], what: str,
                      mask: Optional[torch.Tensor] = None) -> float:
    """|got - ref| <= rtol |ref| + atol max|ref| (where ``mask`` holds)."""
    got, ref = got.float(), ref.float()
    if mask is not None:
        got, ref = got[mask], ref[mask]
    rtol, atol = tol
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=atol * ref.abs().max().item(),
                               msg=lambda m: f"{what}: {m}")
    return max_abs_err(got, ref)


def sncv_plain_grads(a: torch.Tensor, b: torch.Tensor, radius: int,
                     cuts: int, dtype: torch.dtype, g: torch.Tensor,
                     out: torch.Tensor, slope: float = 0.1) -> tuple:
    """The plain version of the SNCV backward on the backward kernel's
    inputs: autograd of the plain correlations (``spatial_cost_volume``
    with a slope of 1, the identity in place of the leaky ReLU) against
    ``g`` times the leaky ReLU's derivative at ``out``, the forward output
    whose backward is checked. Returns (da,) when ``b is a``, else
    (da, db)."""
    lin = spatial_cost_volume(a, b, radius, cuts, dtype, leaky_slope=1.0)
    ins = [a] if b is a else [a, b]
    return torch.autograd.grad(lin, ins, g * torch.where(out > 0, 1.0,
                                                         slope))


def assert_sncv_grads_close(got: Sequence[torch.Tensor],
                            ref: Sequence[torch.Tensor], dtype: torch.dtype,
                            same: bool, what: str = "sncv") -> list:
    """(dc1[, dc2]) of the SNCV backward kernel against the plain version's;
    with ``same`` (c1 is c2) one gradient, the sum of both."""
    tol = (SNCV_SAME_TOL[dtype] if same and dtype in SNCV_SAME_TOL
           else SNCV_BWD_TOL[dtype])
    errs = []
    for g, r, name in zip(got, ref, ("dc1", "dc2")):
        _require(g.dtype == r.dtype == dtype,
                 f"{what} {name} dtype {g.dtype}")
        errs.append(assert_grad_close(g, r, tol, f"{what} {name}"))
    return errs


def tie_free_pixels(centre: torch.Tensor, rot: torch.Tensor,
                    trans: torch.Tensor, camera: Camera,
                    search_range: int) -> torch.Tensor:
    """[b, h, w, 1] True where no DSCV sample of any hypothesis lies within
    TIE_PX of a pixel boundary, where the bilinear derivative jumps."""
    h, w = centre.shape[1:3]
    flows = parallax_sweep_flows(centre, rot, trans, camera, search_range)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=centre.device),
        torch.arange(w, dtype=torch.float32, device=centre.device),
        indexing="ij")
    q = flows + torch.stack([gx, gy], dim=-1)
    near = ((q - torch.round(q)).abs() < TIE_PX).any(dim=-1).any(dim=1)
    return ~near[..., None]


def assert_dscv_grads_close(got: Sequence[torch.Tensor],
                            ref: Sequence[torch.Tensor], dtype: torch.dtype,
                            mask: torch.Tensor, what: str = "dscv") -> list:
    """(dc1, dc2, dpara, dcentre) of the DSCV backward kernel against the
    plain version's; dcentre only on the tie-free pixels ``mask``, and it
    must not be zero."""
    errs = []
    for i, (g, r, name) in enumerate(zip(got, ref, DSCV_GRADS)):
        _require(g.dtype == r.dtype, f"{what} {name} dtype {g.dtype}")
        tol = BWD_TOL[dtype if i < 3 else torch.float32]
        errs.append(assert_grad_close(g, r, tol, f"{what} {name}",
                                      mask if i == 3 else None))
    _require(got[3].abs().max().item() > 0, f"{what}: dcentre is zero")
    return errs


def assert_train_step_close(grads: Dict[str, torch.Tensor],
                            ref_grads: Dict[str, torch.Tensor],
                            params: Dict[str, torch.Tensor],
                            ref_params: Dict[str, torch.Tensor],
                            lr: float) -> dict:
    """Every gradient of one training step and every parameter after its
    Adam update, against the reference's (the CPU's).

    Adam's first step moves a parameter by lr g / (|g| + eps), lr times the
    sign of g: at most 2 lr apart anywhere, and equal to 1e-6 where |g| is
    over ten times the gradient's atol (its sign is sure).

    Every leaf is compared before any failure is raised, so the message
    names each leaf that failed. Returns the model's largest |grad|, each
    leaf's largest |grad - ref| as a share of its tolerance (worst first)
    and as a share of the leaf's largest |ref|, the leaves held as small
    ones, and the largest parameter difference where the sign is sure.
    """
    top = max(g.abs().max().item() for g in ref_grads.values())
    shares, rel, small, bad, worst_param = {}, {}, [], [], 0.0
    for n, ref in ref_grads.items():
        got = grads[n]
        scale = ref.abs().max().item()
        small_leaf = scale < SMALL_LEAF * top
        if small_leaf:
            small.append(n)
        atol = ((SMALL_LEAF_ATOL if small_leaf else STEP_GRAD_ATOL) * scale
                + STEP_GRAD_ATOL_TOP * top)
        err = (got - ref).abs()
        shares[n] = (err / (atol + STEP_GRAD_RTOL * ref.abs())).max().item()
        rel[n] = err.max().item() / max(scale, 1e-30)
        if not (shares[n] <= 1 and bool(torch.isfinite(got).all())):
            bad.append(f"{n} (max|grad| {scale / top:.3e} of the model's, "
                       f"max|err| {err.max().item():.3e}, {shares[n]:.3f}x "
                       "its tolerance)")
        diff = (params[n] - ref_params[n]).abs()
        _require(diff.max().item() <= 2 * lr + 1e-6,
                 f"{n}: step {diff.max()}")
        sure = ref.abs() > 10 * atol
        worst_param = max(worst_param,
                          torch.where(sure, diff, 0.0).max().item())
    _require(not bad, "step gradients out of tolerance: " + "; ".join(bad))
    _require(worst_param <= 1e-6,
             f"parameters after the step: {worst_param}")
    shares = dict(sorted(shares.items(), key=lambda kv: -kv[1]))
    return dict(top=top, shares=shares, rel=rel, small_leaves=small,
                worst_param=worst_param)


def train_batch(b: int, T: int, hw: int, seed: int, rot, trans,
                dev) -> Dict[str, torch.Tensor]:
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


def float32_step(dev, batch: Dict[str, torch.Tensor], seed: int, lr: float,
                 wrap: Optional[Callable] = None) -> dict:
    """One float32 training step of the d6 model from ``seed``'s weights
    on ``batch`` (through ``wrap(model)`` when given, such as
    ``train.data_parallel``), Adam at ``lr``: its scalars, each
    parameter's gradient and the parameters after the update, on the
    CPU."""
    model = M4Depth(ModelConfig(compute_dtype="float32", cv_dtype="float32"),
                    device=dev, seed=seed)
    opt = make_optimizer(model, TrainConfig(learning_rate=lr))
    out = make_train_step(model if wrap is None else wrap(model), opt)(batch)
    return dict(scalars={k: v.item() for k, v in out.items()},
                grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                params={n: p.detach().cpu()
                        for n, p in model.named_parameters()})


def assert_step_close(got: dict, ref: dict, lr: float, what: str) -> dict:
    """Two ``float32_step`` results: the loss to STEP_LOSS_RTOL, then
    ``assert_train_step_close``, whose result it returns."""
    loss, ref_loss = got["scalars"]["loss"], ref["scalars"]["loss"]
    _require(abs(loss - ref_loss) <= STEP_LOSS_RTOL * abs(ref_loss),
             f"{what}: loss {loss} against {ref_loss}")
    return assert_train_step_close(got["grads"], ref["grads"], got["params"],
                                   ref["params"], lr)


@contextlib.contextmanager
def plain_glue():
    """Both families' decoders run the plain glue in place of the fused
    wrappers, on any device and in any grad mode."""
    from m4depth_tpu_torch.models import decoder, m4depth_v1

    swaps = [(module, n, getattr(source, n[:-len("_fused")]))
             for module, source, names in (
                 (decoder, glue, ("glue_prep_fused", "glue_assemble_fused",
                                  "glue_finish_fused")),
                 (m4depth_v1, glue_v1, ("glue_v1_prep_fused",
                                        "glue_v1_assemble_fused",
                                        "glue_v1_finish_fused")))
             for n in names]
    saved = [getattr(module, n) for module, n, _ in swaps]
    for module, n, plain in swaps:
        setattr(module, n, plain)
    try:
        yield
    finally:
        for (module, n, _), fn in zip(swaps, saved):
            setattr(module, n, fn)


@contextlib.contextmanager
def plain_epilogue():
    """Every ``Conv3x3`` runs the plain chain (``F.conv2d`` with its bias,
    then ``F.leaky_relu``) in place of the conv without bias and the
    epilogue kernels, on any device and in any grad mode."""
    from m4depth_tpu_torch.models import encoder
    from m4depth_tpu_torch.ops import conv_epilogue

    saved = encoder.conv3x3
    encoder.conv3x3 = conv_epilogue.conv3x3_plain
    try:
        yield
    finally:
        encoder.conv3x3 = saved


def assert_runs_plain_glue(call: Callable[[], Any]) -> None:
    """``call()`` runs the plain glue: it launches no glue kernel
    (``ops.glue_launches``) and equals the same call under ``plain_glue``
    bit for bit."""
    before = glue_launches()
    got = tree_flatten(call())[0]
    _require(glue_launches() == before, "a glue kernel launched")
    with plain_glue():
        want = tree_flatten(call())[0]
    _require(len(got) == len(want), "the outputs' structures differ")
    for i, (g, w) in enumerate(zip(got, want)):
        _require(torch.equal(g, w), f"output {i} differs from the plain "
                 "glue's")


def _step_result(step, model, batch) -> dict:
    scalars = step(batch)
    return dict(scalars={n: v.item() for n, v in scalars.items()},
                grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                params={n: p.detach().cpu()
                        for n, p in model.named_parameters()})


def assert_glue_steps_close(dev, steps: int = 3, b: int = 2, T: int = 3,
                            hw: int = 128, seed: int = 9,
                            **cfg_kw) -> list:
    """``steps`` compiled training steps of the float32 d6 model at ``hw``
    (its eager first call, the capture, replays: the glue kernels and their
    backwards; ``cfg_kw`` adds model settings, such as remat), each held by
    ``assert_step_close`` to one eager step with the plain glue
    (``plain_glue``) from the compiled run's state before it (weights, Adam
    state, count). Both steps update through ``Optimizer.apply_gradients``,
    so the weights differ only through the gradients. Returns each step's
    ``assert_train_step_close`` result."""
    cfg = ModelConfig(compute_dtype="float32", cv_dtype="float32", **cfg_kw)
    batch = train_batch(b, T, hw, seed, [1.0, 0.001, -0.002, 0.001],
                        [0.3, 0.1, 0.02], dev)
    models = {k: M4Depth(cfg, device=dev, seed=seed)
              for k in ("kernels", "plain")}
    opts = {k: make_optimizer(m, TrainConfig(learning_rate=1e-4))
            for k, m in models.items()}
    kernels = compile_train_step(models["kernels"], opts["kernels"])
    plain = make_train_step(models["plain"], opts["plain"])
    out = []
    for i in range(steps):
        if i:
            TrainState(models["plain"], opts["plain"]).load_state_dict(
                TrainState(models["kernels"], opts["kernels"]).state_dict())
        got = _step_result(kernels, models["kernels"], batch)
        with plain_glue():
            want = _step_result(plain, models["plain"], batch)
        out.append(assert_step_close(got, want, 1e-4, f"step {i + 1} of "
                                     f"{steps}, glue kernels against the "
                                     f"plain glue {cfg_kw or ''}"))
    return out

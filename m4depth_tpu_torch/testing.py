"""Comparisons of the CUDA kernels, and of the model on the card, with their
plain PyTorch versions: the tolerances and the rules that ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` both apply, kept in one place.

Each ``assert_*`` raises an ``AssertionError`` naming what disagreed (also
under ``python -O``) and returns the largest error it saw, for the caller
to print.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from m4depth_tpu_torch.geometry import Camera, parallax_sweep_flows

# Forward kernels against their plain versions. Both sides round their
# inputs to the same dtype and multiply and add in float32.
#   SNCV: the same products summed in another order (and with FMA): float32
#     rounding of sums of at most 24 terms of size <= 1.
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
#   The DSCV's sweep-centre gradient is float32 in both dtypes (1e-4). The
#     bilinear sample's derivative jumps where a sample crosses a pixel
#     boundary, so pixels with a sample within TIE_PX of one, where the
#     few-ulp position difference can pick either side, are left out of its
#     comparison (ties are measure-zero).
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}
SNCV_BWD_TOL = {torch.float32: (1e-5, 1e-5),
                torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}
SNCV_SAME_BF16_TOL = (2.0 ** -7, 2.0 ** -6)
TIE_PX = 1e-3
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


def assert_sncv_grads_close(got: Sequence[torch.Tensor],
                            ref: Sequence[torch.Tensor], dtype: torch.dtype,
                            same: bool, what: str = "sncv") -> list:
    """(dc1[, dc2]) of the SNCV backward kernel against the plain version's;
    with ``same`` (c1 is c2) one gradient, the sum of both."""
    tol = (SNCV_SAME_BF16_TOL if same and dtype == torch.bfloat16
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

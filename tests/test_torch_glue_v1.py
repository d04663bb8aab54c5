"""V1's decoder glue (``m4depth_tpu_torch/ops/glue_v1.py``) on the CPU.

The plain glue functions, chained as ``DecoderLevelV1.forward`` chains
them, are held bit for bit against the chain of tensor ops that the level
and ``M4DepthV1.forward_frame`` spelled out before the glue moved into
``ops/glue_v1.py`` (``_chain`` below keeps a copy of it), and so is the
level itself, with grad and without. The fused wrappers run the plain
versions on CPU tensors. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``; their ``ctypes`` argument lists are held
against the C entry points in ``tests/test_torch_glue.py``). The file
imports no JAX.
"""

import itertools
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import (
    Camera,
    pixel_grid,
    recompute_depth,
    reprojection_flow,
    resize_bilinear_v1,
    scale_camera,
)
from m4depth_tpu_torch.models import M4DepthV1, init_state
from m4depth_tpu_torch.models.m4depth_v1 import DecoderLevelV1
from m4depth_tpu_torch.ops import (
    dense_image_warp,
    glue_launches,
    glue_v1,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.testing import assert_runs_plain_glue

# narrow widths at the V1 defaults' search range (radius 4, 81 offsets)
WIDTHS = dict(num_levels=3, encoder_channels=(8, 12, 16))
B, H, W = 2, 8, 12


class Case(NamedTuple):
    dtype: str = "float32"
    memory: bool = True
    deepest: bool = False
    reset: Optional[str] = None      # None, or "one": the last element
    rot_dim: int = 4

    @property
    def id(self) -> str:
        return (f"{self.dtype}-{'memory' if self.memory else 'first'}-"
                f"{'deepest' if self.deepest else 'inner'}-"
                f"reset_{self.reset}-rot{self.rot_dim}")


CASES = [Case(*c) for c in itertools.product(
    ("float32", "bfloat16"), (True, False), (False, True), (None, "one"),
    (3, 4))]


def _setup(case: Case, seed: int = 0):
    """A level (level 2 of a d3 model, or its deepest) and its inputs:
    (curr_f, state, deeper depth, rot, trans, full-resolution camera,
    new_traj)."""
    cfg = ModelConfig(compute_dtype=case.dtype, cv_dtype=case.dtype,
                      **WIDTHS)
    level = 3 if case.deepest else 2
    C = cfg.channels[level - 1]
    lvl = DecoderLevelV1(cfg, C, case.rot_dim, level)
    g = torch.Generator().manual_seed(seed)
    for conv in lvl.convs:
        conv.reset_parameters(g)
    rng = np.random.RandomState(seed)

    def arr(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    dt = cfg.torch_compute_dtype
    curr_f = arr(rng.randn(B, H, W, C)).to(dt)
    state = (arr(rng.randn(B, H, W, C)).to(dt),
             arr(rng.uniform(2, 40, (B, H, W, 1)))) if case.memory else None
    deeper = None if case.deepest else arr(
        rng.uniform(2, 40, (B, H // 2, W // 2, 1)))
    if case.rot_dim == 3:
        rot = arr(rng.randn(B, 3) * 0.02)
    else:
        q = np.concatenate([np.ones((B, 1)), rng.randn(B, 3) * 0.02], 1)
        rot = arr(q / np.linalg.norm(q, axis=1, keepdims=True))
    trans = arr(rng.randn(B, 3) * 0.2 + [0.3, 0.1, 0.3])
    scale = 2.0 ** level
    f = arr(np.tile([[W * scale * 0.6, H * scale * 0.7]], (B, 1)))
    c = arr(np.tile([[W * scale / 2 + 0.3, H * scale / 2 - 0.2]], (B, 1)))
    new_traj = None if case.reset is None else torch.tensor([False, True])
    return lvl, (curr_f, state, deeper, rot, trans, Camera(f, c), new_traj)


def _chain(lvl: DecoderLevelV1, curr_f, state, deeper, rot, trans, camera,
           new_traj):
    """The glue as ``M4DepthV1.forward_frame`` (the reset select of the
    previous features) and ``DecoderLevelV1.forward`` computed it in line,
    with the camera scaled as ``forward_frame`` scaled it: every
    intermediate, by name."""
    cfg = lvl.cfg
    camera = scale_camera(camera, 2.0 ** lvl.level)
    if state is None:
        prev_f, prev_t_depth = curr_f, None
    else:
        prev_f, prev_t_depth = state
        if new_traj is not None:
            prev_f = torch.where(new_traj.reshape(-1, 1, 1, 1), curr_f,
                                 prev_f)
    b, h, w, _ = curr_f.shape
    kw = dict(dtype=torch.float32, device=curr_f.device)
    if prev_t_depth is None:
        d_0 = torch.ones((b, h, w, 1), **kw)
    else:
        d_0 = recompute_depth(prev_t_depth, -rot, trans, camera)
        if new_traj is not None:
            d_0 = torch.where(new_traj.reshape(b, 1, 1, 1),
                              torch.ones_like(d_0), d_0)
    if deeper is None:
        d_prev_l = torch.full((b, h, w, 1), 100.0, **kw)
    else:
        d_prev_l = resize_bilinear_v1(deeper, (h, w))
    fmap = torch.cat([d_0.to(curr_f.dtype), prev_f], dim=-1)
    flow = reprojection_flow(d_prev_l.detach(), rot, trans, camera)
    warped = dense_image_warp(fmap, flow)
    d0_w = warped[..., :1].float()
    r = dict(f0_w=warped[..., 1:].contiguous())
    r["cv"] = cv = spatial_cost_volume_fused(
        curr_f, r["f0_w"], cfg.search_range, 1, cfg.torch_cv_dtype,
        cfg.leaky_slope)

    def log_safe(x):
        return torch.log(torch.clamp(x, min=1e-12))

    rc = rot.shape[-1]
    dt = curr_f.dtype
    coords, _ = pixel_grid(h, w, camera)
    r["log_d0w"] = log_safe(d0_w / 10.0).to(dt)
    r["log_dprev"] = log_safe(d_prev_l / 10.0).to(dt)
    r["x"] = x = torch.cat([
        curr_f,
        cv.to(dt),
        r["log_d0w"],
        r["log_dprev"],
        rot.reshape(b, 1, 1, rc).expand(b, h, w, rc).to(dt),
        trans.reshape(b, 1, 1, 3).expand(b, h, w, 3).to(dt),
        coords[..., :2].expand(b, h, w, 2).to(dt),
    ], dim=-1)
    # each conv applies its leaky relu
    for conv in lvl.convs:
        x = conv(x)
    r["out"] = x
    x = x.float()
    x = torch.where(x > 0, x, x / cfg.leaky_slope)
    r["depth"] = torch.exp(torch.clamp(x, -7.0, 7.0)) * 10.0
    return r


def _assert_equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool(torch.isfinite(want).all()), what
    assert torch.equal(got, want), what


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_plain_glue_v1_matches_the_level_chain(case):
    """``glue_v1_prep``, ``glue_v1_assemble`` and ``glue_v1_finish``
    against the level's former chain on the same inputs, each bit for bit,
    and the level that now calls them against the whole chain, with grad
    (the plain versions) and without (the fused wrappers, which run the
    plain versions on the CPU)."""
    lvl, args = _setup(case)
    curr_f, state, deeper, rot, trans, camera, new_traj = args
    scale = 2.0 ** lvl.level
    with torch.no_grad():
        want = _chain(lvl, *args)
        got = glue_v1.glue_v1_prep(curr_f, state, deeper, new_traj, rot,
                                   trans, camera, scale)
        for g, key in zip(got, ("f0_w", "log_d0w", "log_dprev")):
            _assert_equal(g, want[key], key)
        assert got[0].is_contiguous()
        _assert_equal(glue_v1.glue_v1_assemble(
            curr_f, want["cv"], want["log_d0w"], want["log_dprev"], rot,
            trans, camera, scale), want["x"], "x")
        assert want["x"].shape[3] == (curr_f.shape[3] + 81 + 2
                                      + case.rot_dim + 3 + 2)
        _assert_equal(glue_v1.glue_v1_finish(want["out"],
                                             lvl.cfg.leaky_slope),
                      want["depth"], "depth")
    depth, memory = lvl(*args)
    assert memory is depth
    _assert_equal(depth.detach(), want["depth"], "level, grad")
    with torch.no_grad():
        depth, _ = lvl(*args)
    _assert_equal(depth, want["depth"], "level, no grad")


@pytest.mark.parametrize("case", [Case(), Case("bfloat16", reset="one"),
                                  Case(memory=False, deepest=True,
                                       rot_dim=3)],
                         ids=lambda c: c.id)
def test_fused_wrappers_run_the_plain_glue_v1_on_the_cpu(case):
    """On CPU tensors each fused wrapper is its plain version, for inputs
    that require grad too, whose gradient flows as the plain one's."""
    lvl, args = _setup(case, seed=1)
    curr_f, state, deeper, rot, trans, camera, new_traj = args
    scale = 2.0 ** lvl.level
    curr_f = curr_f.clone().requires_grad_(True)
    prep_args = (curr_f, state, deeper, new_traj, rot, trans, camera, scale)
    got = glue_v1.glue_v1_prep_fused(*prep_args)
    want = glue_v1.glue_v1_prep(*prep_args)
    for g, w, key in zip(got, want, ("f0_w", "log_d0w", "log_dprev")):
        _assert_equal(g.detach(), w.detach(), key)
    cv = torch.randn(B, H, W, 81)
    asm_args = (curr_f, cv, got[1], got[2], rot, trans, camera, scale)
    x = glue_v1.glue_v1_assemble_fused(*asm_args)
    _assert_equal(x.detach(), glue_v1.glue_v1_assemble(*asm_args).detach(),
                  "x")
    (gx,) = torch.autograd.grad(x.float().sum(), curr_f,
                                retain_graph=True)
    (wx,) = torch.autograd.grad(glue_v1.glue_v1_assemble(
        *asm_args).float().sum(), curr_f)
    assert torch.equal(gx, wx)
    out = torch.randn(B, H, W, 1).to(curr_f.dtype).requires_grad_(True)
    depth = glue_v1.glue_v1_finish_fused(out, 0.1)
    _assert_equal(depth.detach(), glue_v1.glue_v1_finish(out, 0.1).detach(),
                  "depth")
    (g,) = torch.autograd.grad(depth.sum(), out)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_v1_model_counts_its_glue_as_plain_on_the_cpu():
    """On the CPU the V1 model runs the plain glue in a streaming frame (no
    grad) of the six-level model and in a training window (grad): each
    equals the same call with the decoder's wrappers swapped for the plain
    versions bit for bit, and no glue kernel launches
    (``testing.assert_runs_plain_glue``)."""
    cfg = ModelConfig(encoder_channels=(4, 4, 4, 4, 4, 4))
    model = M4DepthV1(cfg, device="cpu", seed=0)
    b, hw, T = 1, 128, 2
    rgb = torch.rand(b, T, hw, hw, 3)
    rot = torch.tensor([[[1.0, 0.001, -0.002, 0.001]] * T] * b)
    trans = torch.tensor([[[0.3, 0.1, 0.02]] * T] * b)
    f = torch.full((b, 2), hw / 2)
    cam = Camera(f, f.clone())
    state = init_state(cfg, b, hw, hw, device="cpu")
    assert_runs_plain_glue(lambda: model.step(
        state, rgb[:, 0], rot[:, 0], trans[:, 0], cam, torch.tensor([True])))
    assert_runs_plain_glue(lambda: model(rgb, rot, trans, cam))

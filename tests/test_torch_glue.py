"""The decoder level's glue (``m4depth_tpu_torch/ops/glue.py``) on the CPU.

Each plain glue function is held bit for bit against the chain of tensor
ops that ``DecoderLevel.forward`` spelled out before the glue moved into
``ops/glue.py`` (``_chain`` below keeps a copy of it), and the level
under ``torch.no_grad`` (the fused wrappers, which take the plain versions
on CPU tensors) against the level with grad. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``); here their C entry
points' signatures are held against the wrappers' ``ctypes`` argument
lists. The file imports no JAX.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from m4depth_tpu_torch.config import AblationFlags, ModelConfig
from m4depth_tpu_torch.geometry import (
    Camera,
    parallax_to_depth,
    prev_depth_to_parallax,
    resize_bilinear_v1,
    scale_camera,
)
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.models.decoder import (
    DecoderLevel,
    LevelEstimate,
    LevelState,
)
from m4depth_tpu_torch.models.encoder import Conv3x3
from m4depth_tpu_torch.ops import (
    KERNELS,
    parallax_sweeping_cv_fused,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops import glue
from m4depth_tpu_torch.utils import tracing

CSRC = Path(glue.__file__).resolve().parent / "csrc"

# a d3 model at narrow widths; level 3 is the deepest
WIDTHS = dict(num_levels=3, encoder_channels=(8, 12, 16),
              refiner_prep_channels=(16, 16, 8),
              refiner_est_channels=(8, 8, 5))


def _chain(level: DecoderLevel, curr_f, deeper_est, state, rot, trans,
           camera, new_traj):
    """The glue as ``DecoderLevel.forward`` computed it in line, with the
    camera scaled as ``M4Depth.forward_frame`` scaled it: every
    intermediate, by name."""
    cfg, abl = level.cfg, level.cfg.ablation
    b, h, w, _ = curr_f.shape
    cuts = cfg.num_cuts(level.level)
    cdt = cfg.torch_compute_dtype
    camera = scale_camera(camera, 2.0 ** level.level)
    r = dict(camera=camera)

    def prep(f):
        if not abl.normalize_features:
            return f.contiguous()
        blocks = f.reshape(b, h, w, cuts, f.shape[3] // cuts).float()
        sq = torch.sum(blocks * blocks, dim=-1, keepdim=True)
        blocks = blocks * torch.rsqrt(torch.clamp(sq, min=1e-12))
        return blocks.reshape(f.shape).to(f.dtype)

    if deeper_est is None:
        kw = dict(dtype=torch.float32, device=curr_f.device)
        prev_l = LevelEstimate(
            depth=torch.full((b, h, w, 1), 1000.0, **kw),
            parallax=torch.ones((b, h, w, 1), **kw),
            other=torch.zeros((b, h, w, level.other_channels), **kw))
    else:
        prev_l = LevelEstimate(
            depth=resize_bilinear_v1(deeper_est.depth, (h, w)),
            parallax=resize_bilinear_v1(deeper_est.parallax, (h, w)) * 2.0,
            other=resize_bilinear_v1(deeper_est.other, (h, w)))
    r["prev_l"] = prev_l
    if state is None:
        r["est"] = prev_l
        r["state"] = LevelState(curr_f, torch.full((b, h, w, 1), 1000.0))
        return r
    r["curr_p"] = curr_p = prep(curr_f)
    r["prev_p"] = prev_p = prep(state.f_maps)
    r["para_prev_t"] = para_prev_t = prev_depth_to_parallax(
        state.depth, rot, trans, camera)
    r["cv"], r["para_reproj"] = cv, para_reproj = parallax_sweeping_cv_fused(
        curr_p, prev_p, para_prev_t, prev_l.parallax, rot, trans, camera,
        cfg.search_range, cuts, cfg.torch_cv_dtype)

    def log_safe(x):
        return torch.log(torch.clamp(x, min=1e-12))

    inputs = [cv, log_safe(prev_l.parallax * level.lvl_mul)]
    if abl.level_memory:
        inputs.append(prev_l.other)
    r["sncv"] = None
    if abl.sncv:
        r["sncv"] = spatial_cost_volume_fused(
            curr_p, curr_p, cfg.sncv_search_range, cuts, cfg.torch_cv_dtype,
            cfg.leaky_slope)
        inputs.append(r["sncv"])
    if abl.time_recurr:
        inputs.append(log_safe(para_reproj * level.lvl_mul))
    r["f_input"] = f_input = torch.cat([x.to(cdt) for x in inputs], dim=-1)
    r["out"] = out_c = level.refiner(f_input)
    out = out_c.float()
    parallax = torch.exp(torch.clamp(out[..., :1], -7.0, 7.0)) / level.lvl_mul
    depth = parallax_to_depth(parallax, rot, trans, camera)
    est = LevelEstimate(depth=depth, parallax=parallax, other=out[..., 1:])
    if new_traj is None:
        r["est"], r["state"] = est, LevelState(f_maps=curr_f, depth=depth)
        return r
    mask = new_traj.reshape(b, 1, 1, 1)
    r["est"] = LevelEstimate(
        depth=torch.where(mask, prev_l.depth, depth),
        parallax=torch.where(mask, prev_l.parallax, parallax),
        other=torch.where(mask, prev_l.other, est.other))
    r["state"] = LevelState(
        f_maps=curr_f,
        depth=torch.where(mask, torch.full_like(depth, 1000.0), depth))
    return r


@dataclasses.dataclass(frozen=True)
class Case:
    level: int = 2                  # 3 is the deepest
    rot_dim: int = 4
    reset: str = "mixed"            # "none" (None), "false", "true", "mixed"
    off: str = ""                   # an ablation flag turned off
    hw: tuple = (12, 16)            # the level's size
    first: bool = False             # no state (a window's first frame)
    dtypes: tuple = ("float32", "bfloat16")  # compute, cost volumes

    @property
    def id(self):
        return "-".join(
            [f"level{self.level}", f"rot{self.rot_dim}", f"reset_{self.reset}"]
            + ([f"no_{self.off}"] if self.off else [])
            + ([f"{self.hw[0]}x{self.hw[1]}"] if self.hw != (12, 16) else [])
            + (["first"] if self.first else [])
            + ([f"{self.dtypes[0]}-{self.dtypes[1]}"]
               if self.dtypes != ("float32", "bfloat16") else []))


CASES = (
    [Case(level=lv, rot_dim=rd, reset=rs) for lv in (3, 2) for rd in (3, 4)
     for rs in ("none", "false", "true", "mixed")]
    + [Case(off=flag) for flag in ("level_memory", "sncv", "time_recurr",
                                   "normalize_features",
                                   "subdivide_features")]
    + [Case(level=lv, hw=(7, 5)) for lv in (3, 2)]
    + [Case(level=lv, first=True) for lv in (3, 2)]
    + [Case(dtypes=("bfloat16", "float16")),
       Case(dtypes=("float32", "float32"), rot_dim=3)])


def _setup(case: Case, seed=0):
    """(level module, inputs of its forward) for ``case``, from numpy."""
    ablation = AblationFlags(**({case.off: False} if case.off else {}))
    cfg = ModelConfig(compute_dtype=case.dtypes[0], cv_dtype=case.dtypes[1],
                      ablation=ablation, **WIDTHS)
    lvl = DecoderLevel(cfg, case.level)
    generator = torch.Generator().manual_seed(seed)
    for m in lvl.modules():
        if isinstance(m, Conv3x3):
            m.reset_parameters(generator)
    rng = np.random.RandomState(seed)
    b, (h, w) = 2, case.hw
    C = cfg.channels[case.level - 1]

    def arr(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    cdt = cfg.torch_compute_dtype
    curr_f = arr(rng.randn(b, h, w, C)).to(cdt)
    deeper = None
    if case.level < cfg.num_levels:
        hd, wd = -(-h // 2), -(-w // 2)
        deeper = LevelEstimate(
            depth=arr(rng.uniform(2, 40, (b, hd, wd, 1))),
            parallax=arr(rng.uniform(0.1, 3, (b, hd, wd, 1))),
            other=arr(rng.randn(b, hd, wd, lvl.other_channels)))
    state = None if case.first else LevelState(
        f_maps=arr(rng.randn(b, h, w, C)).to(cdt),
        depth=arr(rng.uniform(2, 40, (b, h, w, 1))))
    if case.rot_dim == 3:
        rot = arr(rng.randn(b, 3) * 0.02)
    else:
        q = np.concatenate([np.ones((b, 1)), rng.randn(b, 3) * 0.01], 1)
        rot = arr(q / np.linalg.norm(q, axis=1, keepdims=True))
    trans = arr(rng.randn(b, 3) * 0.2 + [0.3, 0.1, 0.3])
    scale = 2.0 ** case.level
    f = arr(np.tile([[w * scale * 0.6, h * scale * 0.7]], (b, 1)))
    c = arr(np.tile([[w * scale / 2 + 0.3, h * scale / 2 - 0.2]], (b, 1)))
    new_traj = {"none": None, "false": torch.tensor([False, False]),
                "true": torch.tensor([True, True]),
                "mixed": torch.tensor([True, False])}[case.reset]
    return lvl, (curr_f, deeper, state, rot, trans, Camera(f, c), new_traj)


def _assert_equal(got, want, what):
    if want is None or got is None:
        assert got is None and want is None, what
        return
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{what}[{i}]")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool(torch.isfinite(want).all()), what
    assert torch.equal(got, want), what


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_plain_glue_matches_the_decoder_chain(case):
    """``glue_prep``, ``glue_assemble`` and ``glue_finish`` against the
    decoder's former chain on the same inputs, each bit for bit, and the
    level that now calls them (grad enabled) against the whole chain."""
    lvl, args = _setup(case)
    curr_f, deeper, state, rot, trans, camera, new_traj = args
    cfg, abl = lvl.cfg, lvl.cfg.ablation
    cuts = cfg.num_cuts(case.level)
    with torch.no_grad():
        want = _chain(lvl, *args)
        prev, cam_l, curr_p, prev_p, para_prev_t = glue.glue_prep(
            curr_f, deeper, state, trans, camera, 2.0 ** case.level, cuts,
            abl.normalize_features, lvl.other_channels, 1000.0,
            cfg.torch_cv_dtype)
        _assert_equal(tuple(prev), tuple(want["prev_l"]), "prev_l")
        _assert_equal(tuple(cam_l), tuple(want["camera"]), "camera")
        for key, got in (("curr_p", curr_p), ("prev_p", prev_p),
                         ("para_prev_t", para_prev_t)):
            _assert_equal(got, want.get(key), key)
        if state is not None:
            prev_l = want["prev_l"]
            f_input = glue.glue_assemble(
                want["cv"], prev_l.parallax,
                prev_l.other if abl.level_memory else None, want["sncv"],
                want["para_reproj"] if abl.time_recurr else None,
                lvl.lvl_mul, cfg.torch_compute_dtype)
            _assert_equal(f_input, want["f_input"], "f_input")
            assert f_input.shape[3] == lvl.refiner_in_channels()
            est, depth = glue.glue_finish(want["out"], prev_l, new_traj, rot,
                                          trans, want["camera"], lvl.lvl_mul,
                                          1000.0)
            _assert_equal(tuple(est), tuple(want["est"]), "est")
            _assert_equal(depth, want["state"].depth, "state depth")
    est, new_state = lvl(*args)
    _assert_equal(tuple(est), tuple(want["est"]), "level est")
    _assert_equal(tuple(new_state), tuple(want["state"]), "level state")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_level_without_grad_matches_with_grad(case):
    """The level under ``torch.no_grad`` (the fused wrappers, on the CPU
    their plain versions) equals the level with grad, bit for bit, and
    counts its call as fused where the other counts it as plain."""
    lvl, args = _setup(case, seed=1)
    before = tracing.counters()
    est, state = lvl(*args)
    mid = tracing.counters()
    with torch.no_grad():
        est_ng, state_ng = lvl(*args)
    after = tracing.counters()
    _assert_equal(tuple(est_ng), tuple(x.detach() for x in est), "est")
    _assert_equal(tuple(state_ng), tuple(x.detach() for x in state), "state")

    def calls(a, b, name):
        return b.get(name, {}).get("calls", 0) - a.get(name, {}).get(
            "calls", 0)

    assert (calls(before, mid, "decoder.glue_plain"),
            calls(before, mid, "decoder.glue_fused")) == (1, 0)
    assert (calls(mid, after, "decoder.glue_plain"),
            calls(mid, after, "decoder.glue_fused")) == (0, 1)


def test_model_counts_its_glue_by_grad_mode():
    """A streaming step (no grad) counts each level's glue as fused, a
    training window (grad) as plain, one a level and frame."""
    cfg = ModelConfig(**WIDTHS)
    model = M4Depth(cfg, device="cpu", seed=0)
    b, hw, T = 1, 32, 2
    rgb = torch.rand(b, T, hw, hw, 3)
    rot = torch.tensor([[[1.0, 0.001, -0.002, 0.001]] * T] * b)
    trans = torch.tensor([[[0.3, 0.1, 0.02]] * T] * b)
    f = torch.full((b, 2), hw / 2)
    cam = Camera(f, f.clone())

    def count(fn):
        a = tracing.counters()
        fn()
        z = tracing.counters()
        return tuple(z.get(k, {}).get("calls", 0)
                     - a.get(k, {}).get("calls", 0)
                     for k in ("decoder.glue_fused", "decoder.glue_plain"))

    state = init_state(cfg, b, hw, hw, device="cpu")
    assert count(lambda: model.step(state, rgb[:, 0], rot[:, 0], trans[:, 0],
                                    cam, torch.tensor([True]))) == (3, 0)
    assert count(lambda: model(rgb, rot, trans, cam)) == (0, T * 3)


def test_fused_wrappers_run_the_plain_glue_on_the_cpu():
    """On CPU tensors the fused wrappers are the plain functions, also for
    inputs that require grad (the gradient flows as the plain one's)."""
    lvl, args = _setup(Case(), seed=2)
    curr_f, deeper, state, rot, trans, camera, new_traj = args
    curr_f = curr_f.clone().requires_grad_(True)
    cfg = lvl.cfg
    args = (deeper, state, trans, camera, 4.0, cfg.num_cuts(2), True,
            lvl.other_channels, 1000.0, cfg.torch_cv_dtype)
    got = glue.glue_prep_fused(curr_f, *args)
    want = glue.glue_prep(curr_f, *args)
    _assert_equal(got[2].detach(), want[2].detach(), "curr_p")
    (g,) = torch.autograd.grad(got[2].sum(), curr_f)
    (h,) = torch.autograd.grad(want[2].sum(), curr_f)
    assert torch.equal(g, h)
    out = torch.randn(2, 12, 16, 5, requires_grad=True)
    (depth, _, _), _ = glue.glue_finish_fused(out, got[0], new_traj, rot,
                                              trans, got[1], lvl.lvl_mul,
                                              1000.0)
    (g,) = torch.autograd.grad(depth.sum(), out)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int",
            "float": "c_float"}


def _c_signature(source: str, symbol: str):
    """The ctypes names of ``symbol``'s parameters in ``csrc/<source>``."""
    src = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"{symbol} not found in {source}"
    out = []
    for param in m.group(1).split(","):
        ctype = re.sub(r"\s+", " ", param.strip()).rsplit(" ", 1)[0]
        ctype = ctype.replace(" *", "*")
        out.append(_C_TYPES[ctype])
    return out


@pytest.mark.parametrize("symbol", sorted(KERNELS))
def test_kernel_argtypes_match_their_c_entry_points(symbol):
    """Each wrapper's ctypes argument list against its C entry point's
    parameters, in order: ctypes passes what it is told, so a slip would
    hand the kernel a wrong pointer where no CPU test could see it."""
    kernel = KERNELS[symbol]
    assert [t.__name__ for t in kernel.argtypes] == _c_signature(
        kernel.source, kernel.symbol)

"""The decoder level's glue (``m4depth_tpu_torch/ops/glue.py``) on the CPU.

Each plain glue function is held bit for bit against the chain of tensor
ops that ``DecoderLevel.forward`` spelled out before the glue moved into
``ops/glue.py`` (``_chain`` below keeps a copy of it), and the level
under ``torch.no_grad`` against the level with grad. Each plain backward
version is held against ``torch.autograd.grad`` of its plain forward, and
the three autograd Functions, with CPU stand-ins for their kernels'
launches, against autograd of the plain glue. The kernels themselves run
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
    glue_launches,
    parallax_sweeping_cv_fused,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.ops import glue
from m4depth_tpu_torch.testing import (
    GLUE_BWD_TOL,
    assert_glue_steps_close,
    assert_runs_plain_glue,
)

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
    """The level under ``torch.no_grad`` equals the level with grad and the
    decoder's former chain, bit for bit: on CPU tensors the fused wrappers
    take the plain versions in either grad mode, and no glue kernel
    launches."""
    lvl, args = _setup(case, seed=1)
    before = glue_launches()
    est, state = lvl(*args)
    with torch.no_grad():
        est_ng, state_ng = lvl(*args)
        want = _chain(lvl, *args)
    assert glue_launches() == before
    _assert_equal(tuple(est_ng), tuple(x.detach() for x in est), "est")
    _assert_equal(tuple(state_ng), tuple(x.detach() for x in state), "state")
    _assert_equal(tuple(est_ng), tuple(want["est"]), "est, chain")
    _assert_equal(tuple(state_ng), tuple(want["state"]), "state, chain")


def test_model_counts_its_glue_by_grad_mode():
    """On the CPU a streaming step (no grad) and a training window (grad)
    both run the plain glue: each equals the same call with the decoder's
    wrappers swapped for the plain versions bit for bit, and no glue
    kernel launches (``testing.assert_runs_plain_glue``)."""
    cfg = ModelConfig(**WIDTHS)
    model = M4Depth(cfg, device="cpu", seed=0)
    b, hw, T = 1, 32, 2
    rgb = torch.rand(b, T, hw, hw, 3)
    rot = torch.tensor([[[1.0, 0.001, -0.002, 0.001]] * T] * b)
    trans = torch.tensor([[[0.3, 0.1, 0.02]] * T] * b)
    f = torch.full((b, 2), hw / 2)
    cam = Camera(f, f.clone())
    state = init_state(cfg, b, hw, hw, device="cpu")
    assert_runs_plain_glue(lambda: model.step(
        state, rgb[:, 0], rot[:, 0], trans[:, 0], cam, torch.tensor([True])))
    assert_runs_plain_glue(lambda: model(rgb, rot, trans, cam))


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


# ctypes names its 64-bit integer c_long where a long is 64 bits (Linux)
_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int",
            "float": "c_float", "long long": "c_long"}


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


# -- the backward versions -----------------------------------------------

# d6 at 96x96: levels of 48, 24, 12, 6, 3 and 2 pixels a side (level 5's
# deeper level is 2 of its 3: a resize that is not a doubling)
D6_SIZE = 96


@dataclasses.dataclass(frozen=True)
class BwdCase:
    level: int = 3                  # of d6; 6 is the deepest
    deeper: bool = True             # False at level 6 only
    state: bool = True
    off: str = ""                   # an ablation flag turned off
    dtypes: tuple = ("bfloat16", "bfloat16")  # features, cost volumes
    edges: bool = False             # values on the clamps' bounds

    @property
    def id(self):
        return "-".join(
            [f"level{self.level}"] + ([] if self.deeper else ["deepest"])
            + ([] if self.state else ["first"])
            + ([f"no_{self.off}"] if self.off else [])
            + [f"{self.dtypes[0]}-{self.dtypes[1]}"]
            + (["edges"] if self.edges else []))


BWD_CASES = (
    [BwdCase(level=lv, deeper=lv < 6, dtypes=dt) for lv in range(1, 7)
     for dt in (("float32", "float32"), ("bfloat16", "bfloat16"))]
    + [BwdCase(level=lv, deeper=lv < 6, state=False) for lv in (5, 6)]
    + [BwdCase(off=flag) for flag in ("normalize_features", "level_memory",
                                      "sncv", "time_recurr")]
    + [BwdCase(level=lv, deeper=lv < 6, dtypes=dt, edges=True)
       for lv in (2, 6) for dt in (("float32", "float32"),
                                   ("bfloat16", "bfloat16"))]
    + [BwdCase(dtypes=("bfloat16", "float16")),
       BwdCase(dtypes=("float32", "bfloat16"), edges=True)])


def _bwd_setup(case: BwdCase, seed: int = 0) -> dict:
    """A d6 level's glue inputs for ``case`` (b=2), from numpy: every map
    the glue differentiates a leaf that requires grad."""
    from m4depth_tpu_torch.models import level_shape

    fdt, cvdt = (getattr(torch, d) for d in case.dtypes)
    ablation = AblationFlags(**({case.off: False} if case.off else {}))
    cfg = ModelConfig(compute_dtype=case.dtypes[0], ablation=ablation)
    lv = case.level
    h, w = level_shape(D6_SIZE, D6_SIZE, lv - 1)
    C, cuts = cfg.channels[lv - 1], cfg.num_cuts(lv)
    rng = np.random.RandomState(seed)
    b, n_other = 2, 4

    def t(x, dtype=torch.float32, grad=True):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            dtype).requires_grad_(grad)

    curr_f = rng.randn(b, h, w, C)
    f_maps = rng.randn(b, h, w, C)
    para = rng.uniform(0.1, 3, (b, h, w, 1))
    reproj = rng.uniform(0, 5, (b, h, w, 1))
    out = rng.randn(b, h, w, 1 + n_other) * 3
    mul = 2.0 ** (lv - 3)
    if case.edges:
        cc = C // cuts
        curr_f[0, 0, 0, :cc] = 0.0          # the norm's clamp holds
        f_maps[0, 0, 0, :cc] = 0.0
        if fdt == torch.float32:
            # a sum of squares of exactly 1e-12 in float32: the clamp's
            # bound, where autograd passes the gradient
            curr_f[1, 0, 0, :cc] = 0.0
            curr_f[1, 0, 0, 0] = 1e-6
        curr_f[0, -1, -1, :cc] *= 1e-7       # under the bound
        para.flat[:3] = (0.0, 1e-12 / mul, 2e-12 / mul)
        reproj.flat[-2:] = (0.0, 1e-12 / mul)
        out[..., 0].flat[:6] = (7.0, -7.0, 8.0, -8.0, 6.99, -6.99)
    hd, wd = level_shape(D6_SIZE, D6_SIZE, lv) if case.deeper else (0, 0)
    deeper = None if not case.deeper else (
        t(rng.uniform(2, 40, (b, hd, wd, 1))),
        t(rng.uniform(0.1, 3, (b, hd, wd, 1))),
        t(rng.randn(b, hd, wd, n_other)))
    q = np.concatenate([np.ones((b, 1)), rng.randn(b, 3) * 0.01], 1)
    scale = 2.0 ** lv
    f = np.tile([[D6_SIZE * 0.6, D6_SIZE * 0.7]], (b, 1))
    c = np.tile([[D6_SIZE / 2 + 0.3, D6_SIZE / 2 - 0.2]], (b, 1))
    return dict(
        cfg=cfg, fdt=fdt, cvdt=cvdt, cuts=cuts, n_other=n_other, mul=mul,
        scale=scale, deeper=deeper, curr_f=t(curr_f, fdt),
        state=(t(f_maps, fdt), t(rng.uniform(2, 40, (b, h, w, 1)),
                                 grad=False)) if case.state else None,
        rot=t(q / np.linalg.norm(q, axis=1, keepdims=True), grad=False),
        trans=t(rng.randn(b, 3) * 0.2 + [0.3, 0.1, 0.3], grad=False),
        camera=Camera(t(f, grad=False), t(c, grad=False)),
        cv=t(rng.randn(b, h, w, 9 * cuts)), para=t(para),
        other=t(rng.randn(b, h, w, n_other)),
        sncv=t(rng.randn(b, h, w, 49 * cuts)), reproj=t(reproj),
        out=t(out, fdt), rng=rng)


def _cot(rng, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(rng.randn(*like.shape).astype(np.float32)).to(
        like.dtype)


def _close(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert got is not None and got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    rtol, atol = GLUE_BWD_TOL[want.dtype]
    torch.testing.assert_close(
        got.float(), want.float(), rtol=rtol,
        atol=atol * want.float().abs().max().item(),
        msg=lambda m: f"{what}: {m}")


def _prep_outputs(x, abl, prep=None):
    """glue_prep's differentiable outputs (the features in the cost
    volumes' dtype, as the kernel returns them) and the leaves they
    reach."""
    prev, cam_l, curr_p, prev_p, _ = (prep or glue.glue_prep)(
        x["curr_f"], x["deeper"], x["state"], x["trans"], x["camera"],
        x["scale"], x["cuts"], abl.normalize_features, x["n_other"], 1000.0,
        x["cvdt"])
    outs = {"depth": prev[0], "parallax": prev[1], "other": prev[2]}
    if x["state"] is not None:
        outs.update(curr_p=curr_p.to(x["cvdt"]), prev_p=prev_p.to(x["cvdt"]))
    return outs, cam_l


@pytest.mark.parametrize("case", BWD_CASES, ids=[c.id for c in BWD_CASES])
def test_plain_glue_backward_matches_autograd(case):
    """``glue_prep_backward``, ``glue_assemble_backward`` and
    ``glue_finish_backward`` against ``torch.autograd.grad`` of the plain
    forwards on the same inputs and cotangents (the previous depth's
    gradient left out where the case is a deepest level, as in training,
    where only the estimate's parallax and memory reach it)."""
    x = _bwd_setup(case)
    abl, rng = x["cfg"].ablation, x["rng"]
    outs, cam_l = _prep_outputs(x, abl)
    cots = {k: _cot(rng, v) for k, v in outs.items()
            if v.requires_grad and not (k == "depth" and not case.deeper)}
    leaves = {"curr_f": x["curr_f"]}
    if x["state"] is not None:
        leaves["f_maps"] = x["state"][0]
    for k, v in zip(("depth", "parallax", "other"), x["deeper"] or ()):
        leaves["d_" + k] = v
    want = dict(zip(leaves, torch.autograd.grad(
        [outs[k] for k in cots], list(leaves.values()),
        list(cots.values()), allow_unused=True))) if cots else {}
    d_curr, d_prev, d_deep = glue.glue_prep_backward(
        cots.get("curr_p"), cots.get("prev_p"),
        tuple(cots.get(k) for k in ("depth", "parallax", "other")),
        x["curr_f"].detach(),
        None if x["state"] is None else x["state"][0].detach(),
        None if x["deeper"] is None else tuple(x["deeper"][0].shape[1:3]),
        x["cuts"], abl.normalize_features)
    _close(d_curr, want.get("curr_f"), "prep curr_f")
    _close(d_prev, want.get("f_maps"), "prep f_maps")
    if x["deeper"] is None:
        assert d_deep is None
    else:
        for k, got in zip(("depth", "parallax", "other"), d_deep):
            _close(got, want.get("d_" + k), f"prep deeper {k}")
    if x["state"] is None:
        return

    maps = dict(cv=x["cv"], parallax=x["para"],
                other=x["other"] if abl.level_memory else None,
                sncv=x["sncv"] if abl.sncv else None,
                reproj=x["reproj"] if abl.time_recurr else None)
    f_input = glue.glue_assemble(*maps.values(), x["mul"], x["fdt"])
    g = _cot(rng, f_input)
    given = {k: v for k, v in maps.items() if v is not None}
    want = dict(zip(given, torch.autograd.grad(f_input, list(given.values()),
                                               g)))
    got = glue.glue_assemble_backward(
        g, x["para"].detach(),
        None if maps["reproj"] is None else x["reproj"].detach(),
        x["cv"].shape[3], x["n_other"] if abl.level_memory else 0,
        x["sncv"].shape[3] if abl.sncv else 0, x["mul"], (True,) * 5)
    for k, d in zip(maps, got):
        _close(d, want.get(k), f"assemble {k}")

    prev = tuple(t.detach() for t in outs.values())[:3]
    est, _ = glue.glue_finish(x["out"], prev, None, x["rot"], x["trans"],
                              cam_l, x["mul"], 1000.0)
    g_est = [_cot(rng, e) for e in est]
    (want,) = torch.autograd.grad(est, x["out"], g_est, retain_graph=True)
    _close(glue.glue_finish_backward(g_est, x["out"].detach(), x["rot"],
                                     x["trans"], cam_l, x["mul"]),
           want, "finish out")
    # a gradient that does not flow is zero
    (want,) = torch.autograd.grad(est[1:], x["out"], g_est[1:])
    _close(glue.glue_finish_backward((None, *g_est[1:]), x["out"].detach(),
                                     x["rot"], x["trans"], cam_l, x["mul"]),
           want, "finish out without the depth's gradient")


def _cpu_launchers(monkeypatch):
    """The kernels' launches replaced by the plain forwards under no_grad,
    rounded as the kernels round (the features and the previous parallax
    to the cost volumes' dtype), so that the autograd Functions run on the
    CPU: their backwards then take the plain backward versions."""
    from m4depth_tpu_torch.ops.cost_volume import round_parallax

    def prep(curr_f, f_maps, depth, deeper, trans, f, c, scale, cuts,
             normalize, n_other, init_depth, cv_dtype):
        with torch.no_grad():
            prev, cam, cp, pp, para = glue.glue_prep(
                curr_f, deeper, None if f_maps is None else (f_maps, depth),
                trans, Camera(f, c), scale, cuts, normalize, n_other,
                init_depth, cv_dtype)
        if f_maps is not None:
            cp, pp = cp.to(cv_dtype), pp.to(cv_dtype)
            para = round_parallax(para, cv_dtype)
        return prev, torch.stack([cam.f, cam.c]), cp, pp, para

    def assemble(*args):
        with torch.no_grad():
            return glue.glue_assemble(*args)

    def finish(out, prev, reset, rot, trans, f, c, para_mul, init_depth):
        with torch.no_grad():
            return glue.glue_finish(out, prev, reset, rot, trans,
                                    Camera(f, c), para_mul, init_depth)

    monkeypatch.setattr(glue, "_launch_prep", prep)
    monkeypatch.setattr(glue, "_launch_assemble", assemble)
    monkeypatch.setattr(glue, "_launch_finish", finish)


FN_CASES = [c for c in BWD_CASES if not c.edges]


@pytest.mark.parametrize("case", FN_CASES, ids=[c.id for c in FN_CASES])
def test_glue_functions_route_the_gradients(case, monkeypatch):
    """``GluePrepFunction``, ``GlueAssembleFunction`` and
    ``GlueFinishFunction`` with CPU stand-ins for the kernels' launches: a
    level's glue through them, fed forward as the decoder feeds it (the
    estimate to the next level, the cost volumes' stand-ins from the
    features), gives every leaf the gradient that autograd of the plain
    glue gives it: each backward's gradients reach the inputs they
    belong to, and the outputs that carry none (the intrinsics, the
    previous parallax, the deepest level's constants) stay out of the
    graph."""
    _cpu_launchers(monkeypatch)
    x = _bwd_setup(case, seed=3)
    abl, cfg = x["cfg"].ablation, x["cfg"]

    def level(fused: bool):
        deeper = x["deeper"]
        state = x["state"]
        args = (x["trans"], *x["camera"], x["scale"], x["cuts"],
                abl.normalize_features, x["n_other"], 1000.0, x["cvdt"])
        if fused:
            out = glue.GluePrepFunction.apply(
                x["curr_f"], *(state or (None, None)),
                *(deeper or (None,) * 3), *args)
            prev, cam = tuple(out[:3]), Camera(out[3][0], out[3][1])
            cp, pp, para = out[4:] if state else (None,) * 3
        else:
            prev, cam, cp, pp, para = glue.glue_prep(
                x["curr_f"], deeper, state, x["trans"], x["camera"],
                x["scale"], x["cuts"], abl.normalize_features, x["n_other"],
                1000.0, x["cvdt"])
            if state:
                cp, pp = cp.to(x["cvdt"]), pp.to(x["cvdt"])
        assert not cam.f.requires_grad
        if state is None:
            return list(prev)
        assert not para.requires_grad
        # the cost volumes' stand-ins: smooth functions of the features
        # and of the sweep centre
        cv = (cp.float() * pp.float()).sum(-1, keepdim=True) * x["cv"] + (
            prev[1] * x["cv"])
        sncv = cp.float().mean(-1, keepdim=True) * x["sncv"]
        reproj = x["reproj"] * prev[1]
        maps = (cv, prev[1], prev[2] if abl.level_memory else None,
                sncv if abl.sncv else None,
                reproj if abl.time_recurr else None, x["mul"], x["fdt"])
        f_input = (glue.GlueAssembleFunction.apply(*maps) if fused
                   else glue.glue_assemble(*maps))
        out = (x["out"] + f_input.float().mean(-1, keepdim=True)).to(
            x["fdt"])
        if fused:
            est = glue.GlueFinishFunction.apply(
                out, *prev, x["rot"], x["trans"], cam.f, cam.c, x["mul"],
                1000.0)
        else:
            est, _ = glue.glue_finish(out, prev, None, x["rot"], x["trans"],
                                      cam, x["mul"], 1000.0)
        return [*est, f_input]

    leaves = [t for t in (x["curr_f"], *(x["state"] or ())[:1],
                          *(x["deeper"] or ()), x["cv"], x["sncv"],
                          x["reproj"], x["out"]) if t.requires_grad]
    want_outs, got_outs = level(False), level(True)
    rng = np.random.RandomState(5)
    cots = [_cot(rng, o) for o in want_outs]
    pairs = [(w, g, c) for w, g, c in zip(want_outs, got_outs, cots)
             if w.requires_grad]
    assert [g.requires_grad for g in got_outs] == [
        w.requires_grad for w in want_outs]
    if not pairs:
        return
    want = torch.autograd.grad([p[0] for p in pairs], leaves,
                               [p[2] for p in pairs], allow_unused=True)
    got = torch.autograd.grad([p[1] for p in pairs], leaves,
                              [p[2] for p in pairs], allow_unused=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None or not bool(g.any()), f"leaf {i}"
            continue
        rtol, atol = GLUE_BWD_TOL[w.dtype]
        torch.testing.assert_close(g.float(), w.float(), rtol=10 * rtol,
                                   atol=10 * atol * w.abs().max().item(),
                                   msg=lambda m: f"leaf {i}: {m}")


def test_glue_step_comparison_runs_on_the_cpu():
    """``testing.assert_glue_steps_close``, which holds the card's compiled
    steps with the glue kernels to eager steps with the plain glue, on the
    CPU at the narrow d3 model: both sides run the plain glue and the same Adam
    update there, so each step's gradients agree to the last bit, and so
    do the weights that the rule holds to 1e-6 (``worst_param``); the
    helper's steps, state copies and comparisons run end to end."""
    res = assert_glue_steps_close(torch.device("cpu"), steps=2, b=1, T=2,
                                  hw=128, **WIDTHS)
    assert [max(r["shares"].values()) for r in res] == [0.0, 0.0]
    assert [r["worst_param"] for r in res] == [0.0, 0.0]

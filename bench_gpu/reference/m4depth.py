"""Plain float32 references of the two model families' frames, their
parameters' names and shapes, and M4Depth's training loss.

* ``m4depth``: Fonder et al., Sensors 2022 (github.com/michael-fonder/M4Depth,
  ``m4depth_network.py``): an encoder of a stride-1 and a stride-2 3x3 conv a
  level (domain-invariant normalisation after the first), and a decoder,
  deepest level first, whose refiner reads the DSCV (a parallax sweep
  against the previous frame's features), the deeper level's parallax and
  4-channel memory, the SNCV (auto-correlation) and the warped previous
  parallax.
* ``m4depth-v1``: the legacy model (arXiv:2105.09847): a stride-2 then
  stride-1 encoder, and a depth-recurrent decoder whose one cost volume is
  a 9x9 cross-correlation of the features with the previous frame's,
  warped by the deeper level's depth.

A frame function takes the parameters as a dict (the names the benchmark
draws them under), the level states of the previous frame (or None for
the first frame of every sequence), and per-element resets, and returns
the new states and each level's estimate, finest first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench_gpu.reference.ops import (
    INIT_DEPTH,
    Numerics,
    conv,
    dscv,
    leaky,
    no_tf32,
    parallax_to_depth,
    prev_depth_to_parallax,
    recompute_depth,
    reprojection_flow,
    resize_bilinear,
    resize_bilinear_v1,
    resize_nearest,
    rays,
    sncv,
    warp,
)

Params = Dict[str, torch.Tensor]


def cuts(level: int) -> int:
    """Feature cuts at 1-indexed decoder ``level``."""
    return 2 ** (level // 2)


def refiner_in(cfg: dict, level: int) -> int:
    """Input channels of M4Depth's refiner at ``level``: the DSCV, the
    log parallax, the memory, the SNCV and the warped log parallax."""
    k = cuts(level)
    return (k * (2 * cfg["search_range"] + 1) + 1
            + cfg["refiner_est_channels"][-1] - 1
            + (2 * cfg["sncv_search_range"] + 1) ** 2 * k + 1)


def v1_refiner_in(cfg: dict, ch: int) -> int:
    """Input channels of V1's refiner: the features, the (2r+1)^2 cost
    volume, two log depths, the rotation, the translation, the pixel
    coordinates."""
    return ch + (2 * cfg["search_range"] + 1) ** 2 + 2 + cfg["rot_dim"] + 3 + 2


def convs(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """Every conv of a frame as (name, cin, cout, stride), in the
    parameter order of the model."""
    ch = cfg["encoder_channels"][: cfg["num_levels"]]
    ins = (3,) + tuple(ch[:-1])
    out = []
    if cfg["family"] == "m4depth":
        out += [(f"encoder.conv_s1.{i}", a, c, 1) for i, (a, c) in
                enumerate(zip(ins, ch))]
        out += [(f"encoder.conv_s2.{i}", c, c, 2) for i, c in enumerate(ch)]
        prep, est = cfg["refiner_prep_channels"], cfg["refiner_est_channels"]
        for i in range(cfg["num_levels"]):
            cin = refiner_in(cfg, i + 1)
            for j, c in enumerate(prep):
                out.append((f"levels.{i}.refiner.prep.{j}", cin, c, 1))
                cin = c
            for j, c in enumerate(est):
                out.append((f"levels.{i}.refiner.est.{j}", cin, c, 1))
                cin = c
    else:
        out += [(f"encoder.conv_s2.{i}", a, c, 2) for i, (a, c) in
                enumerate(zip(ins, ch))]
        out += [(f"encoder.conv_s1.{i}", c, c, 1) for i, c in enumerate(ch)]
        for i, c in enumerate(ch):
            cin = v1_refiner_in(cfg, c)
            for j, co in enumerate(cfg["refiner_channels"]):
                out.append((f"levels.{i}.convs.{j}", cin, co, 1))
                cin = co
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's name and shape (the convs' OIHW weights and
    biases, and M4Depth's domain-norm scale and bias)."""
    shapes = {}
    for name, cin, cout, _ in convs(cfg):
        shapes[name + ".weight"] = (cout, cin, 3, 3)
        shapes[name + ".bias"] = (cout,)
    if cfg["family"] == "m4depth":
        c0 = cfg["encoder_channels"][0]
        shapes["encoder.dinl.scale"] = (c0,)
        shapes["encoder.dinl.bias"] = (c0,)
    return shapes


def level_hw(h: int, w: int, idx: int) -> Tuple[int, int]:
    """Spatial size of encoder output ``idx`` (stride 2**(idx+1), SAME)."""
    for _ in range(idx + 1):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


# -- M4Depth ------------------------------------------------------------------


def domain_norm(x, scale, bias):
    """Standardise each channel over space dividing by the variance, then
    L2-normalise over channels; a learned scale and bias."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, correction=0)
    s = (x - mean) / (var + 1e-12)
    s = s * torch.rsqrt((s * s).sum(-1, keepdim=True).clamp(min=1e-12))
    return scale * s + bias


def encoder(p: Params, cfg: dict, rgb: torch.Tensor, num: Numerics):
    slope = cfg["leaky_slope"]
    x, outs = rgb, []
    for i in range(cfg["num_levels"]):
        if cfg["family"] == "m4depth":
            x = conv(x, p, f"encoder.conv_s1.{i}", num)
            if i == 0:
                x = num.rc(domain_norm(x, p["encoder.dinl.scale"],
                                       p["encoder.dinl.bias"]))
            x = leaky(conv(leaky(x, slope), p, f"encoder.conv_s2.{i}", num,
                           stride=2), slope)
        else:
            x = leaky(conv(x, p, f"encoder.conv_s2.{i}", num, stride=2), slope)
            x = leaky(conv(x, p, f"encoder.conv_s1.{i}", num), slope)
        outs.append(x)
    return outs


def normalize_cuts(f: torch.Tensor, k: int) -> torch.Tensor:
    b, h, w, c = f.shape
    x = f.reshape(b, h, w, k, c // k)
    x = x * torch.rsqrt((x * x).sum(-1, keepdim=True).clamp(min=1e-12))
    return x.reshape(b, h, w, c)


def _log(x):
    return torch.log(x.clamp(min=1e-12))


def m4depth_level(p, cfg, level, curr_f, deeper, state, rot, trans, f, c,
                  reset, num):
    """One M4Depth decoder level. ``deeper`` is (depth, parallax, other)
    of the next deeper level, or None at the deepest; ``state`` the
    previous frame's (features, depth) or None on every sequence's first
    frame; ``reset`` [b] bool or None. Returns (estimate, state)."""
    b, h, w, _ = curr_f.shape
    k = cuts(level)
    mul = 2.0 ** (level - 3)
    n_other = cfg["refiner_est_channels"][-1] - 1
    if deeper is None:
        prev = (torch.full((b, h, w, 1), INIT_DEPTH, device=curr_f.device),
                torch.ones((b, h, w, 1), device=curr_f.device),
                torch.zeros((b, h, w, n_other), device=curr_f.device))
    else:
        prev = (resize_bilinear_v1(deeper[0], (h, w)),
                resize_bilinear_v1(deeper[1], (h, w)) * 2.0,
                resize_bilinear_v1(deeper[2], (h, w)))
    if state is None:
        return prev, (curr_f, torch.full((b, h, w, 1), INIT_DEPTH,
                                         device=curr_f.device))
    curr_p = num.rc(normalize_cuts(curr_f, k))
    prev_p = num.rc(normalize_cuts(state[0], k))
    para_prev = prev_depth_to_parallax(state[1], trans, f, c)
    cv, para_warp = dscv(curr_p, prev_p, para_prev, prev[1], rot, trans, f,
                         c, cfg["search_range"], k, num)
    auto = sncv(curr_p, curr_p, cfg["sncv_search_range"], k,
                cfg["leaky_slope"], num)
    x = torch.cat([cv, _log(prev[1] * mul), prev[2], auto,
                   _log(para_warp * mul)], -1)
    slope = cfg["leaky_slope"]
    n_prep = len(cfg["refiner_prep_channels"])
    n_est = len(cfg["refiner_est_channels"])
    for j in range(n_prep):
        x = leaky(conv(x, p, f"levels.{level - 1}.refiner.prep.{j}", num),
                  slope)
    for j in range(n_est):
        x = conv(x, p, f"levels.{level - 1}.refiner.est.{j}", num)
        if j < n_est - 1:
            x = leaky(x, slope)
    para = torch.exp(x[..., :1].clamp(-7.0, 7.0)) / mul
    depth = parallax_to_depth(para, rot, trans, f, c)
    est = (depth, para, x[..., 1:])
    if reset is None:
        return est, (curr_f, depth)
    m = reset.reshape(b, 1, 1, 1)
    est = tuple(torch.where(m, a, e) for a, e in zip(prev, est))
    return est, (curr_f, torch.where(m, torch.full_like(depth, INIT_DEPTH),
                                     depth))


def m4depth_frame(p, cfg, state, rgb, rot, trans, f, c, reset, num):
    """One M4Depth frame: (new states, estimates finest first)."""
    feats = encoder(p, cfg, rgb, num)
    n = cfg["num_levels"]
    states: List = [None] * n
    ests: List = [None] * n
    deeper = None
    for i in reversed(range(n)):
        s = 2.0 ** (i + 1)
        deeper, states[i] = m4depth_level(
            p, cfg, i + 1, feats[i], deeper, None if state is None
            else state[i], rot, trans, f / s, c / s, reset, num)
        ests[i] = deeper
    return states, ests


# -- V1 -----------------------------------------------------------------------


def v1_level(p, cfg, idx, curr_f, prev_f, prev_d, deeper, rot, trans, f, c,
             reset, num):
    """One V1 level: (depth, depth as the next memory)."""
    b, h, w, _ = curr_f.shape
    dev = curr_f.device
    if prev_d is None:
        d0 = torch.ones((b, h, w, 1), device=dev)
    else:
        # the legacy code reads the transposed small-angle row; -rot
        # reproduces it for the small-angle form, and R(-q) = R(q) for a
        # quaternion
        d0 = recompute_depth(prev_d, -rot, trans, f, c)
        if reset is not None:
            d0 = torch.where(reset.reshape(b, 1, 1, 1), torch.ones_like(d0),
                             d0)
    d_l = (torch.full((b, h, w, 1), 100.0, device=dev) if deeper is None
           else resize_bilinear_v1(deeper, (h, w)))
    fmap = torch.cat([num.rc(d0), prev_f], -1)
    warped = warp(fmap, reprojection_flow(d_l.detach(), rot, trans, f, c))
    d0w, f0w = warped[..., :1], num.rc(warped[..., 1:])
    cv = sncv(curr_f, f0w, cfg["search_range"], 1, cfg["leaky_slope"], num)
    ray, _ = rays(h, w, f, c)
    rd = rot.shape[-1]
    x = torch.cat([curr_f, cv, _log(d0w / 10.0), _log(d_l / 10.0),
                   rot.reshape(b, 1, 1, rd).expand(b, h, w, rd),
                   trans.reshape(b, 1, 1, 3).expand(b, h, w, 3),
                   ray[..., :2]], -1)
    for j in range(len(cfg["refiner_channels"])):
        x = leaky(conv(x, p, f"levels.{idx}.convs.{j}", num),
                  cfg["leaky_slope"])
    x = torch.where(x > 0, x, x / cfg["leaky_slope"])
    depth = torch.exp(x.clamp(-7.0, 7.0)) * 10.0
    return depth, depth


def v1_frame(p, cfg, state, rgb, rot, trans, f, c, reset, num):
    """One V1 frame: (new states, depths finest first)."""
    feats = encoder(p, cfg, rgb, num)
    n = cfg["num_levels"]
    states: List = [None] * n
    ests: List = [None] * n
    deeper = None
    for i in reversed(range(n)):
        s = 2.0 ** (i + 1)
        if state is None:
            prev_f, prev_d = feats[i], None
        else:
            prev_f, prev_d = state[i]
            if reset is not None:
                prev_f = torch.where(reset.reshape(-1, 1, 1, 1), feats[i],
                                     prev_f)
        deeper, mem = v1_level(p, cfg, i, feats[i], prev_f, prev_d, deeper,
                               rot, trans, f / s, c / s, reset, num)
        ests[i] = deeper
        states[i] = (feats[i], mem)
    return states, ests


# -- entry points -------------------------------------------------------------


def frame(p: Params, cfg: dict, state, rgb, rot, trans, f, c,
          reset: Optional[torch.Tensor], num: Numerics):
    """One frame of ``cfg``'s family: (states, estimates finest first;
    an M4Depth estimate is (depth, parallax, other), a V1 one a depth)."""
    fn = m4depth_frame if cfg["family"] == "m4depth" else v1_frame
    with no_tf32():
        return fn(p, cfg, state, rgb, rot, trans, f, c, reset, num)


def depth_of(est) -> torch.Tensor:
    return est[0] if isinstance(est, tuple) else est


def stream_step(p, cfg, state, rgb, rot, trans, f, c, reset, num):
    """Streaming: (states, full-resolution depth [b,h,w,1], nearest
    upsampling of the finest level)."""
    states, ests = frame(p, cfg, state, rgb, rot, trans, f, c, reset, num)
    return states, resize_nearest(depth_of(ests[0]), rgb.shape[1:3])


def window(p, cfg, rgb, rot, trans, f, c, num) -> List[Sequence]:
    """A training window [b,T,...] whose frame 0 starts every sequence:
    each frame's estimates."""
    state, outs = None, []
    for t in range(rgb.shape[1]):
        state, ests = frame(p, cfg, state, rgb[:, t], rot[:, t], trans[:, t],
                            f, c, None, num)
        outs.append(ests)
    return outs


def m4depth_loss(gt: torch.Tensor, preds: Sequence[Sequence]) -> torch.Tensor:
    """L1 of log depth (clipped to [0.01, 200]) against the ground truth
    bilinearly resized to each level, level i (finest first) weighted
    0.64 / 2**(i-1), averaged over frames 1..T-1."""
    T = gt.shape[1]
    total = torch.zeros((), device=gt.device)
    for t in range(1, T):
        g = torch.log(gt[:, t].clamp(0.01, 200.0))
        for i, est in enumerate(preds[t]):
            d = torch.log(depth_of(est).clamp(0.01, 200.0))
            term = (resize_bilinear(g, d.shape[1:3]) - d).abs().mean()
            total = total + 0.64 / 2.0 ** (i - 1) * term / (T - 1)
    return total

"""Rendered camera trajectories, made on the device from a generator: the
scene distribution of ``m4depth_tpu_torch/data/synthetic.py``
(``device_batch_sampler``: a textured, tilted plane ray-cast from a chained
camera path, so depth and motion are exact), copied here so that the
benchmark's traffic does not move with the program, and with the camera's
motion taken from the traffic file.

Motion: a drone flying a survey line. Each trajectory picks a heading in
the image plane (an angle, uniform) and each step moves ``lateral`` metres
(uniform between its two bounds) along it, ``forward`` metres along the
optical axis, and turns by an angle uniform in ``turn`` (radians) about a
random axis. Mostly lateral motion keeps the parallax away from zero, so
the depth is well posed for a comparison of two precisions; under mostly
forward motion random weights give depths near zero, where it is not.

Conventions: ``rot[t]`` is the (w, x, y, z) quaternion and ``trans[t]`` the
translation that map a point in camera ``t`` to camera ``t-1``; rays are
((u+0.5-cx)/fx, (v+0.5-cy)/fy, 1), f = c = (w/2, h/2).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

N_WAVES = 3


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _quat_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def render(n: int, T: int, h: int, w: int, motion: dict,
           g: torch.Generator) -> Dict[str, torch.Tensor]:
    """``n`` trajectories of ``T`` frames on ``g``'s device: rgb
    [n,T,h,w,3] in (0, 1), depth [n,T,h,w,1], rot [n,T,4], trans [n,T,3]
    (frame 0: identity and 0), camera_f and camera_c [n,2]; float32."""
    dev = g.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev)

    f = torch.tensor([w / 2.0, h / 2.0], device=dev)
    us = (torch.arange(w, device=dev) + 0.5 - f[0]) / f[0]
    vs = (torch.arange(h, device=dev) + 0.5 - f[1]) / f[1]
    rays = torch.stack([us[None].expand(h, w), vs[:, None].expand(h, w),
                        torch.ones((h, w), device=dev)], -1)

    # the plane (world = camera-0 frame): mildly tilted, facing the camera
    normal_ = _unit(torch.cat([uniform((n, 2), -0.22, 0.22),
                               -torch.ones((n, 1), device=dev)], 1))
    p0 = torch.cat([uniform((n, 2), -1.0, 1.0), uniform((n, 1), 5.0, 9.0)], 1)
    plane_d = (normal_ * p0).sum(1)
    # its texture: a mixture of long sinusoids
    kvec = _unit(normal((n, 3, N_WAVES, 3))) * (
        2 * math.pi / uniform((n, 3, N_WAVES), 14.0, 30.0))[..., None]
    phase = uniform((n, 3, N_WAVES), 0.0, 2 * math.pi)
    amp = uniform((n, 3, N_WAVES), 0.5, 1.0)
    amp = 0.42 * amp / amp.sum(2, keepdim=True)

    # the path: a heading a trajectory, steps along it, small turns
    heading = uniform((n, 1), 0.0, 2 * math.pi)
    lat = uniform((n, T - 1, 1), *motion["lateral"])
    steps = torch.cat([lat * torch.cos(heading)[:, None],
                       lat * torch.sin(heading)[:, None],
                       uniform((n, T - 1, 1), *motion["forward"])], -1)
    ang = uniform((n, T - 1, 1), *motion["turn"])
    dq = torch.cat([torch.cos(ang / 2),
                    torch.sin(ang / 2) * _unit(normal((n, T - 1, 3)))], -1)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(n, 4)
    quats, pos = [ident], [torch.zeros((n, 3), device=dev)]
    for t in range(1, T):
        quats.append(_quat_mul(quats[-1], dq[:, t - 1]))
        pos.append(pos[-1] + torch.einsum("bij,bj->bi", _quat_mat(quats[-2]),
                                          steps[:, t - 1]))

    rgb, depth, rot, trans = [], [], [], []
    for t in range(T):
        dirs = torch.einsum("hwk,bjk->bhwj", rays, _quat_mat(quats[t]))
        s = ((plane_d - (normal_ * pos[t]).sum(1))[:, None, None]
             / (dirs * normal_[:, None, None]).sum(-1))
        pts = pos[t][:, None, None] + dirs * s[..., None]
        ph = torch.einsum("bhwk,bcnk->bhwcn", pts, kvec) + phase[:, None, None]
        rgb.append((0.5 + (torch.sin(ph) * amp[:, None, None]).sum(-1))
                   .clamp(0.02, 0.98))
        depth.append(s[..., None])
        if t == 0:
            rot.append(ident)
            trans.append(torch.zeros((n, 3), device=dev))
        else:
            conj = quats[t - 1] * torch.tensor([1.0, -1.0, -1.0, -1.0],
                                               device=dev)
            rot.append(_quat_mul(conj, quats[t]))
            trans.append(torch.einsum("bij,bi->bj", _quat_mat(quats[t - 1]),
                                      pos[t] - pos[t - 1]))
    return {"rgb": torch.stack(rgb, 1), "depth": torch.stack(depth, 1),
            "rot": torch.stack(rot, 1), "trans": torch.stack(trans, 1),
            "camera_f": f.expand(n, 2).clone(),
            "camera_c": f.expand(n, 2).clone()}

"""Analytic synthetic sequences: textured 3-D planes with closed-form depth.
Counterpart of ``m4depth_tpu/data/synthetic.py``: the host renderer is a
copy; the device sampler draws with ``torch`` on the device.

Every frame is ray-cast against a randomly tilted textured plane from a
chained camera trajectory, so (frames, depth, motion) are *exactly*
photometrically consistent with the package's own geometry conventions
(`m4depth_tpu_torch.geometry.reprojection_flow` backward-warp): sampling the
previous frame at the flow induced by the current depth reproduces the
current frame up to bilinear-interpolation error of the smooth texture.

The real datasets are not in the repository, so end-to-end runs use data
whose ground truth is analytically correct by construction.

Conventions (must match m4depth_tpu_torch/geometry/parallax.py):
  * ``rot[t]`` is a (w, x, y, z) quaternion and ``trans[t]`` a 3-vector such
    that a point expressed in the frame-``t`` camera maps to the
    frame-``t-1`` camera as ``X_prev = R(rot[t]) @ X_cur + trans[t]``.
  * Pixel rays are ``((u+0.5-cx)/fx, (v+0.5-cy)/fy, 1)``; depth is the
    camera-frame z of the surface point (= the ray parameter).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator

import numpy as np
import torch

from m4depth_tpu_torch import mix_seed, resolve_device


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of (w, x, y, z) quaternions."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dtype=np.float64)


def _quat_conj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]], dtype=np.float64)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Same expansion as geometry.rotations.rot_mat_quaternion (unit quat)."""
    w, x, y, z = q
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return np.array([
        [1.0 - (tyy + tzz), txy - twz, txz + twy],
        [txy + twz, 1.0 - (txx + tzz), tyz - twx],
        [txz - twy, tyz + twx, 1.0 - (txx + tyy)],
    ], dtype=np.float64)


def _quat_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    half = 0.5 * angle
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


class _PlaneTexture:
    """Smooth RGB texture over 3-D points: low-frequency sinusoid mixture.

    Wavelengths are kept long relative to the pixel footprint on the plane
    so that bilinear resampling (the warp's interpolation) stays within the
    photometric-consistency tolerance used by the tests.
    """

    def __init__(self, rng: np.random.RandomState, n_waves: int = 3):
        # per (channel, wave): direction, wavelength in [14, 30], phase, amp
        dirs = rng.normal(size=(3, n_waves, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        wavelen = rng.uniform(14.0, 30.0, size=(3, n_waves))
        self.k = dirs * (2.0 * np.pi / wavelen)[..., None]   # [3, n, 3]
        self.phase = rng.uniform(0.0, 2.0 * np.pi, size=(3, n_waves))
        amp = rng.uniform(0.5, 1.0, size=(3, n_waves))
        self.amp = 0.42 * amp / amp.sum(axis=1, keepdims=True)  # sum<=0.42

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """points [..., 3] -> rgb [..., 3] in (0, 1).

        Evaluated in float32 with one flat matmul: the renderer is the
        training-throughput bottleneck for infinite-stream runs (f64
        einsum+sin measured ~0.8 s per 4-frame 384^2 sequence).
        """
        flat = points.reshape(-1, 3).astype(np.float32)
        kmat = self.k.reshape(-1, 3).T.astype(np.float32)     # [3, 3*n]
        ph = flat @ kmat + self.phase.reshape(-1).astype(np.float32)
        rgb = 0.5 + (np.sin(ph) * self.amp.reshape(1, -1).astype(np.float32)
                     ).reshape(flat.shape[0], 3, -1).sum(axis=-1)
        return np.clip(rgb, 0.02, 0.98).reshape(points.shape[:-1] + (3,))


def make_sequence(rng: np.random.RandomState, T: int, h: int, w: int) -> Dict[str, np.ndarray]:
    """Render one T-frame sequence of a textured plane.

    Returns a dict with:
      RGB_im:   [T, h, w, 3] float32 in (0, 1)
      depth:    [T, h, w, 1] float32, strictly inside (1, 100)
      rot:      [T, 4] float32 (w,x,y,z); rot[0] = identity
      trans:    [T, 3] float32; trans[0] = 0
      camera_f: [2] float32 (fx, fy) = (w/2, h/2)
      camera_c: [2] float32 (cx, cy) = (w/2, h/2)
    """
    f = np.array([w / 2.0, h / 2.0], dtype=np.float64)
    c = np.array([w / 2.0, h / 2.0], dtype=np.float64)

    # plane in world coords (= camera-0 frame): mild tilt, facing the camera
    tilt = rng.uniform(-0.22, 0.22, size=2)
    normal = np.array([tilt[0], tilt[1], -1.0])
    normal /= np.linalg.norm(normal)
    p0 = np.array([rng.uniform(-1.0, 1.0), rng.uniform(-1.0, 1.0),
                   rng.uniform(5.0, 9.0)])
    plane_d = normal @ p0
    texture = _PlaneTexture(rng)

    # chained camera trajectory: pose t maps camera coords -> world coords
    quats = [np.array([1.0, 0.0, 0.0, 0.0])]
    pos = [np.zeros(3)]
    for _ in range(1, T):
        axis = rng.normal(size=3)
        angle = rng.uniform(0.0, 0.04)
        dq = _quat_axis_angle(axis, angle)
        quats.append(_quat_mul(quats[-1], dq))
        step = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25),
                         rng.uniform(-0.15, 0.35)])
        pos.append(pos[-1] + _quat_to_mat(quats[-2]) @ step)

    # pixel rays (camera frame), shared across frames; the ray-cast runs in
    # f32 — the renderer gates infinite-stream training throughput on
    # single-core hosts (precision is micro-pixel scale, far below the
    # photometric-consistency tolerance)
    us = ((np.arange(w) + 0.5 - c[0]) / f[0]).astype(np.float32)
    vs = ((np.arange(h) + 0.5 - c[1]) / f[1]).astype(np.float32)
    rays = np.stack([np.broadcast_to(us[None, :], (h, w)),
                     np.broadcast_to(vs[:, None], (h, w)),
                     np.ones((h, w), np.float32)], axis=-1)  # [h, w, 3]
    normal32 = normal.astype(np.float32)

    points_seq, rgb_seq, depth_seq, rot_seq, trans_seq = [], [], [], [], []
    for t in range(T):
        R_wt = _quat_to_mat(quats[t]).astype(np.float32)
        dirs = rays @ R_wt.T                              # world ray dirs
        denom = dirs @ normal32                           # bounded below ~0.5
        s = np.float32(plane_d - normal @ pos[t]) / denom  # [h, w] = depth
        points_seq.append(pos[t].astype(np.float32)[None, None, :]
                          + dirs * s[..., None])
        depth_seq.append(s[..., None])

        if t == 0:
            rot_seq.append(np.array([1.0, 0, 0, 0], dtype=np.float32))
            trans_seq.append(np.zeros(3, dtype=np.float32))
        else:
            # X_prev = R_rel X_cur + t_rel with R_rel = R_{w,t-1}^T R_{w,t}
            q_rel = _quat_mul(_quat_conj(quats[t - 1]), quats[t])
            R_prev = _quat_to_mat(quats[t - 1])
            t_rel = R_prev.T @ (pos[t] - pos[t - 1])
            rot_seq.append(q_rel.astype(np.float32))
            trans_seq.append(t_rel.astype(np.float32))

    rgb_seq = texture(np.stack(points_seq))               # one call for all T
    depth = np.stack(depth_seq)
    assert depth.min() > 1.0 and depth.max() < 100.0, (
        "synthetic scene out of depth bounds: "
        f"[{depth.min():.2f}, {depth.max():.2f}]")
    return {
        "RGB_im": np.ascontiguousarray(rgb_seq),
        "depth": depth,
        "rot": np.stack(rot_seq),
        "trans": np.stack(trans_seq),
        "camera_f": f.astype(np.float32),
        "camera_c": c.astype(np.float32),
    }


class SyntheticGeometricDataset:
    """Deterministic pool of batched synthetic sequences.

    ``batches(epoch)`` yields ``n_batches`` dicts shaped for the training
    step (`m4depth_tpu_torch.train.step.batch_camera` schema). The stream is a
    pure function of (seed, epoch, batch index) — re-iterating an epoch
    reproduces it exactly.
    """

    def __init__(self, n_batches: int, batch_size: int, T: int, h: int,
                 w: int, seed: int = 0):
        self.n_batches = n_batches
        self.batch_size = batch_size
        self.T = T
        self.h = h
        self.w = w
        self.seed = seed

    def __len__(self) -> int:
        """Batches per epoch (the train loop's steps_per_epoch)."""
        return self.n_batches

    def batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.n_batches):
            rng = np.random.RandomState(
                (self.seed * 1000003 + epoch * 10007 + i) % (2 ** 31 - 1))
            seqs = [make_sequence(rng, self.T, self.h, self.w)
                    for _ in range(self.batch_size)]
            new_traj = np.zeros((self.batch_size, self.T), bool)
            new_traj[:, 0] = True
            yield {
                "rgb": np.stack([s["RGB_im"] for s in seqs]),
                "depth": np.stack([s["depth"] for s in seqs]),
                "rot": np.stack([s["rot"] for s in seqs]),
                "trans": np.stack([s["trans"] for s in seqs]),
                "camera_f": np.stack([s["camera_f"] for s in seqs]),
                "camera_c": np.stack([s["camera_c"] for s in seqs]),
                "new_traj": new_traj,
            }


class DeviceSyntheticStream:
    """``fit``-compatible infinite scene stream made on the device.

    Wraps :func:`device_batch_sampler` behind the ``SequenceDataset``
    interface the training loop consumes (``__len__``/``batch_size``/
    ``batches``), with epoch boundaries every ``steps_per_epoch`` steps to
    drive the loop's checkpoint and validation cadence. Batch ``i`` of
    epoch ``e`` draws from a ``torch.Generator`` on the device seeded from
    ``(seed, e * steps_per_epoch + i)``, so the stream is a function of
    (seed, epoch, step): resuming at epoch k replays the scenes a
    continuous run would have seen, and no frame crosses from the host.
    """

    depth_type = "map"

    def __init__(self, batch_size: int, T: int, h: int, w: int,
                 steps_per_epoch: int = 1000, seed: int = 1234,
                 device=None):
        self.batch_size = batch_size
        self.T = T
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self.device = resolve_device(device)
        self._gen = device_batch_sampler(batch_size, T, h, w, self.device)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def batches(self, epoch: int):
        for i in range(self.steps_per_epoch):
            g = torch.Generator(device=self.device)
            g.manual_seed(mix_seed(self.seed, epoch * self.steps_per_epoch
                                   + i))
            yield self._gen(g)


def export_midair_format(db_dir: str, records_dir: str, n_traj: int,
                         frames: int, h: int, w: int, seed: int = 7777,
                         image_format: str = "png") -> int:
    """Write synthetic scenes to disk in the Mid-Air on-disk layout.

    Produces what `scripts/midair-split-generator.py` produces from the real dataset: per-trajectory TSV manifests
    (``id  camera_l  disp  qw qx qy qz  tx ty tz``) plus color images and
    float16-bitcast disparity PNGs (disp = 512/depth,
    dataloaders/midair.py:49-55) — so the full CLI train/eval/validation
    stack (adapters, decode, metrics, subprocess validation, best-K ledger)
    runs end-to-end against data with analytically exact ground truth.
    Intrinsics f = c = half-size match the MidAirAdapter convention.

    Returns the number of frames written.
    """
    from m4depth_tpu_torch.data.decode import imwrite

    os.makedirs(db_dir, exist_ok=True)
    written = 0
    for t in range(n_traj):
        rng = np.random.RandomState((seed * 9176 + t) % (2 ** 31 - 1))
        seq = make_sequence(rng, frames, h, w)
        traj_dir = os.path.join(db_dir, f"traj_{t:04d}")
        os.makedirs(traj_dir, exist_ok=True)
        rec_dir = os.path.join(records_dir, f"traj_{t:04d}")
        os.makedirs(rec_dir, exist_ok=True)
        lines = ["id\tcamera_l\tdisp\tqw\tqx\tqy\tqz\ttx\tty\ttz"]
        for i in range(frames):
            rgb8 = np.clip(seq["RGB_im"][i] * 255.0 + 0.5, 0,
                           255).astype(np.uint8)
            img_rel = f"traj_{t:04d}/c_{i:04d}.{image_format}"
            imwrite(os.path.join(db_dir, img_rel), rgb8)
            disp16 = (512.0 / seq["depth"][i, ..., 0]).astype(np.float16)
            d_rel = f"traj_{t:04d}/d_{i:04d}.png"
            imwrite(os.path.join(db_dir, d_rel), disp16.view(np.uint16))
            q = seq["rot"][i]
            tr = seq["trans"][i]
            lines.append(
                f"{i}\t{img_rel}\t{d_rel}\t"
                f"{q[0]:.9g}\t{q[1]:.9g}\t{q[2]:.9g}\t{q[3]:.9g}\t"
                f"{tr[0]:.9g}\t{tr[1]:.9g}\t{tr[2]:.9g}")
            written += 1
        with open(os.path.join(rec_dir, "traj.csv"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return written


def device_batch_sampler(batch_size: int, T: int, h: int, w: int,
                         device=None):
    """Synthetic-batch generator on the device (the scene distribution of
    :func:`make_sequence`, drawn with ``torch`` from a caller's
    generator).

    Returns ``gen(generator) -> batch``, where ``generator`` is a
    ``torch.Generator`` on ``device``, producing the training-step schema:
    rgb [b,T,h,w,3], depth [b,T,h,w,1], rot [b,T,4], trans [b,T,3],
    camera_f/camera_c [b,2], all float32 tensors on the device, and
    new_traj [b,T] (frame 0 of each window starts it).
    """
    from m4depth_tpu_torch.geometry.rotations import rot_mat_quaternion

    dev = resolve_device(device)
    n_waves = 3
    f = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32, device=dev)
    us = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - f[0]) / f[0]
    vs = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - f[1]) / f[1]
    rays = torch.stack([us[None, :].expand(h, w), vs[:, None].expand(h, w),
                        torch.ones((h, w), device=dev)], dim=-1)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)

    def quat_mul(a, b):
        aw, ax, ay, az = a.unbind(-1)
        bw, bx, by, bz = b.unbind(-1)
        return torch.stack([
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw], dim=-1)

    def quat_conj(q):
        return q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=dev)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def gen(g: torch.Generator):
        b = batch_size

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

        def normal(shape):
            return torch.randn(shape, generator=g, device=dev)

        # plane (world = camera-0 frame): mild tilt, facing the camera
        tilt = uniform((b, 2), -0.22, 0.22)
        plane_n = unit(torch.cat([tilt, -torch.ones((b, 1), device=dev)], 1))
        p0 = torch.cat([uniform((b, 2), -1.0, 1.0),
                        uniform((b, 1), 5.0, 9.0)], dim=1)
        plane_d = torch.sum(plane_n * p0, dim=1)              # [b]

        # texture mixture (the distribution of _PlaneTexture)
        dirs_t = unit(normal((b, 3, n_waves, 3)))
        wavelen = uniform((b, 3, n_waves), 14.0, 30.0)
        kvec = dirs_t * (2.0 * math.pi / wavelen)[..., None]  # [b,3,n,3]
        phase = uniform((b, 3, n_waves), 0.0, 2 * math.pi)
        amp = uniform((b, 3, n_waves), 0.5, 1.0)
        amp = 0.42 * amp / amp.sum(dim=2, keepdim=True)

        # chained trajectory: per-step axis/angle rotation + local step
        axis = unit(normal((b, T - 1, 3)))
        ang = uniform((b, T - 1, 1), 0.0, 0.04)
        dq = torch.cat([torch.cos(ang / 2), torch.sin(ang / 2) * axis], -1)
        steps = torch.cat([uniform((b, T - 1, 2), -0.25, 0.25),
                           uniform((b, T - 1, 1), -0.15, 0.35)], dim=-1)

        quats = [identity.expand(b, 4)]
        pos = [torch.zeros((b, 3), device=dev)]
        for t in range(1, T):
            quats.append(quat_mul(quats[-1], dq[:, t - 1]))
            r_prev = rot_mat_quaternion(quats[-2])            # [b,3,3]
            pos.append(pos[-1] + torch.einsum(
                "bij,bj->bi", r_prev, steps[:, t - 1]))

        rgb_seq, depth_seq, rot_seq, trans_seq = [], [], [], []
        for t in range(T):
            r_wt = rot_mat_quaternion(quats[t])               # [b,3,3]
            dirs = torch.einsum("hwk,bjk->bhwj", rays, r_wt)
            denom = torch.sum(dirs * plane_n[:, None, None, :], dim=-1)
            s = (plane_d - torch.sum(plane_n * pos[t], dim=1)
                 )[:, None, None] / denom                     # [b,h,w]
            points = pos[t][:, None, None, :] + dirs * s[..., None]
            ph = torch.einsum("bhwk,bcnk->bhwcn", points, kvec) \
                + phase[:, None, None]
            rgb = 0.5 + torch.sum(torch.sin(ph) * amp[:, None, None], -1)
            rgb_seq.append(torch.clamp(rgb, 0.02, 0.98))
            depth_seq.append(s[..., None])
            if t == 0:
                rot_seq.append(identity.expand(b, 4))
                trans_seq.append(torch.zeros((b, 3), device=dev))
            else:
                rot_seq.append(quat_mul(quat_conj(quats[t - 1]), quats[t]))
                r_prev = rot_mat_quaternion(quats[t - 1])
                trans_seq.append(torch.einsum(
                    "bij,bi->bj", r_prev, pos[t] - pos[t - 1]))

        new_traj = torch.zeros((b, T), dtype=torch.bool, device=dev)
        new_traj[:, 0] = True
        return {
            "rgb": torch.stack(rgb_seq, dim=1),
            "depth": torch.stack(depth_seq, dim=1),
            "rot": torch.stack(rot_seq, dim=1),
            "trans": torch.stack(trans_seq, dim=1),
            "camera_f": f[None].expand(b, 2).clone(),
            "camera_c": f[None].expand(b, 2).clone(),
            "new_traj": new_traj,
        }

    return gen

"""Sequence-consistent data augmentation (host-side numpy). A copy of
``m4depth_tpu/data/augment.py``: this package imports nothing of the JAX
one.

Parity reference: dataloaders/generic.py:189-259 (color jitter, 0.5-prob
color inversion, v/h flips with quaternion/translation/principal-point
fixups) and dataloaders/midair.py:75-106 (square transpose, finetune crop).
One random draw per *sequence* — the reference applies each op to the whole
[T, h, w, c] tensor, keeping augmentation consistent across frames.

Geometric fixups (quaternion (w,x,y,z), translation (x,y,z) camera axes:
x right, y down, z forward):
  * vertical flip (reverse y):   q *= (1,-1, 1,-1), t *= ( 1,-1, 1), cy -> h-cy
  * horizontal flip (reverse x): q *= (1, 1,-1,-1), t *= (-1, 1, 1), cx -> w-cx
  * transpose (swap x/y):        q -> (w, -qy, -qx, -qz), t -> (ty, tx, tz)
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB->HSV on [..., 3] arrays in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros(hsv.shape, hsv.dtype)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    for k, (rr, gg, bb) in enumerate(conds):
        m = i == k
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out


def color_param_ranges(finetune: bool):
    """(lo, hi, max_hue) jitter ranges. Parity: generic.py:189-212 train
    0.75/1.25 hue 0.4; finetune 0.8/1.2 hue 0.2."""
    return (0.8, 1.2, 0.2) if finetune else (0.75, 1.25, 0.4)


def sample_color_params(rng: np.random.RandomState, finetune: bool = False,
                        invert_color: bool = True) -> Dict[str, float]:
    """Draw one sequence's color-jitter parameters (draw ORDER is part of
    the determinism contract with seeded pipelines — keep stable)."""
    lo, hi, max_hue = color_param_ranges(finetune)
    return {
        "brightness": rng.uniform(-0.2, 0.2),
        "contrast": rng.uniform(lo, hi),
        "saturation": rng.uniform(lo, hi),
        "hue": rng.uniform(-max_hue, max_hue),
        "invert": float(invert_color and rng.uniform() < 0.5),
    }


def apply_color(rgb: np.ndarray, p: Dict[str, float]) -> np.ndarray:
    """Deterministic color transform given drawn parameters.

    rgb: [T, h, w, 3] in [0, 1]. The same math runs on-device in
    data/augment_device.py; parity between the two is unit-tested.
    """
    out = rgb.astype(np.float32)
    out = out + np.float32(p["brightness"])
    mean = out.mean(axis=(1, 2), keepdims=True)            # contrast
    out = (out - mean) * np.float32(p["contrast"]) + mean

    # saturation + hue via HSV (values clipped into [0,1] first: TF's HSV
    # ops assume that range)
    hsv = rgb_to_hsv(np.clip(out, 0.0, 1.0))
    hsv[..., 1] = np.clip(hsv[..., 1] * np.float32(p["saturation"]), 0.0, 1.0)
    hsv[..., 0] = (hsv[..., 0] + np.float32(p["hue"])) % 1.0
    out = hsv_to_rgb(hsv)
    if p["invert"]:
        out = 1.0 - out
    return out.astype(np.float32)


def color_augment(rgb: np.ndarray, rng: np.random.RandomState,
                  finetune: bool = False, invert_color: bool = True) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter + optional color inversion.

    rgb: [T, h, w, 3] in [0, 1]. One draw per sequence.
    Parity: dataloaders/generic.py:189-212 (inversion prob 0.5 unless
    disabled — KITTI disables it, dataloaders/kitti.py:51-53).
    """
    return apply_color(rgb, sample_color_params(rng, finetune, invert_color))


def flip_augment(seq: Dict[str, np.ndarray], rng: np.random.RandomState
                 ) -> Dict[str, np.ndarray]:
    """Random vertical/horizontal flips with motion fixups.

    seq keys: RGB_im [T,h,w,3], depth [T,h,w,1], rot [T,4], trans [T,3],
    camera_c [2] (cx, cy), camera_f [2]. Parity: generic.py:215-259.
    """
    h, w = seq["RGB_im"].shape[1:3]
    if rng.uniform() < 0.5:  # vertical
        seq["RGB_im"] = seq["RGB_im"][:, ::-1].copy()
        seq["depth"] = seq["depth"][:, ::-1].copy()
        seq["rot"] = seq["rot"] * np.array([1, -1, 1, -1], np.float32)
        seq["trans"] = seq["trans"] * np.array([1, -1, 1], np.float32)
        seq["camera_c"] = np.array(
            [seq["camera_c"][0], h - seq["camera_c"][1]], np.float32)
    if rng.uniform() < 0.5:  # horizontal
        seq["RGB_im"] = seq["RGB_im"][:, :, ::-1].copy()
        seq["depth"] = seq["depth"][:, :, ::-1].copy()
        seq["rot"] = seq["rot"] * np.array([1, 1, -1, -1], np.float32)
        seq["trans"] = seq["trans"] * np.array([-1, 1, 1], np.float32)
        seq["camera_c"] = np.array(
            [w - seq["camera_c"][0], seq["camera_c"][1]], np.float32)
    return seq


def transpose_augment(seq: Dict[str, np.ndarray], rng: np.random.RandomState
                      ) -> Dict[str, np.ndarray]:
    """Random h/w transpose (square images only). Parity: midair.py:75-89."""
    if seq["RGB_im"].shape[1] != seq["RGB_im"].shape[2]:
        return seq
    if rng.uniform() < 0.5:
        seq["RGB_im"] = seq["RGB_im"].transpose(0, 2, 1, 3).copy()
        seq["depth"] = seq["depth"].transpose(0, 2, 1, 3).copy()
        q = seq["rot"]
        seq["rot"] = np.stack([q[:, 0], -q[:, 2], -q[:, 1], -q[:, 3]], axis=1)
        t = seq["trans"]
        seq["trans"] = np.stack([t[:, 1], t[:, 0], t[:, 2]], axis=1)
    return seq


def crop_augment(seq: Dict[str, np.ndarray], rng: np.random.RandomState,
                 out_size) -> Dict[str, np.ndarray]:
    """Random crop from the intermediate square to out_size, shifting the
    principal point. Parity: midair.py:91-106."""
    h, w = seq["RGB_im"].shape[1:3]
    oh, ow = out_size
    if h == oh and w == ow:
        return seq
    # NOTE: the exclusive upper bound is reference parity — the reference
    # samples tf.random.uniform(maxval=diff), also excluding the rightmost/
    # bottom crop position (midair.py:95,101)
    if oh >= ow:  # long edge is height: crop along width
        off = rng.randint(0, w - ow) if w > ow else 0
        seq["RGB_im"] = seq["RGB_im"][:, :oh, off:off + ow].copy()
        seq["depth"] = seq["depth"][:, :oh, off:off + ow].copy()
        seq["camera_c"] = np.array(
            [seq["camera_c"][0] - off, seq["camera_c"][1]], np.float32)
    else:
        off = rng.randint(0, h - oh) if h > oh else 0
        seq["RGB_im"] = seq["RGB_im"][:, off:off + oh, :ow].copy()
        seq["depth"] = seq["depth"][:, off:off + oh, :ow].copy()
        seq["camera_c"] = np.array(
            [seq["camera_c"][0], seq["camera_c"][1] - off], np.float32)
    return seq

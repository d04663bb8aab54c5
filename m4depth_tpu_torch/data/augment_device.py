"""Sequence-consistent augmentation on the device, inside the train step.
Counterpart of ``m4depth_tpu/data/augment_device.py`` (``--augment_device``).

The host augmentation (``data/augment.py``) runs numpy on the loader's
threads; this one runs the same transforms as tensor ops on the batch
where it lies, so the host only decodes.

Semantics mirror ``data/augment.py``:

  * one random draw per SEQUENCE (batch element), consistent across its
    [T, h, w, c] frames;
  * color: brightness/contrast/saturation/hue jitter + 0.5-prob inversion;
  * geometric (non-finetune): vertical/horizontal flips and, for square
    frames, the h/w transpose, with quaternion/translation/principal-point
    fixups;
  * finetune crop: random crop of the square intermediate to the output
    size with a principal-point shift.

Each sequence draws its parameters from its own ``torch.Generator`` on the
CPU, seeded from ``(seed, step, index)``, with the index taken in the
global batch under data parallelism: a handful of scalars, so the device
is never waited on, and the same (seed, step) gives the same batch on any
device and any number of ranks. A flip that is not drawn is not computed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from m4depth_tpu_torch import mix_seed
from m4depth_tpu_torch.data.augment import color_param_ranges
from m4depth_tpu_torch.parallel.mesh import rank_and_world

Batch = Dict[str, torch.Tensor]
SEQ_KEYS = ("rgb", "depth", "rot", "trans", "camera_c", "camera_f")


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Vectorized RGB->HSV on [..., 3] tensors in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    r = g = b = torch.zeros_like(h)
    for k, (rr, gg, bb) in enumerate(conds):
        m = i == k
        r = torch.where(m, rr, r)
        g = torch.where(m, gg, g)
        b = torch.where(m, bb, b)
    return torch.stack([r, g, b], dim=-1)


def apply_color(rgb: torch.Tensor, p: Dict[str, float]) -> torch.Tensor:
    """The color transform of ``augment.apply_color`` given drawn
    parameters. rgb [T, h, w, 3]; ``invert`` is 0 or 1."""
    out = rgb.float() + p["brightness"]
    mean = out.mean(dim=(1, 2), keepdim=True)
    out = (out - mean) * p["contrast"] + mean
    hsv = rgb_to_hsv(torch.clamp(out, 0.0, 1.0))
    sat = torch.clamp(hsv[..., 1] * p["saturation"], 0.0, 1.0)
    hue = torch.remainder(hsv[..., 0] + p["hue"], 1.0)
    out = hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], dim=-1))
    return 1.0 - out if p["invert"] > 0.5 else out


def _uniform(g: torch.Generator, lo: float = 0.0, hi: float = 1.0) -> float:
    return lo + (hi - lo) * torch.rand((), generator=g, dtype=torch.float64
                                       ).item()


def sample_color_params(g: torch.Generator, finetune: bool,
                        invert_color: bool) -> Dict[str, float]:
    """One sequence's color-jitter parameters, in the ranges of
    ``augment.sample_color_params``."""
    lo, hi, max_hue = color_param_ranges(finetune)
    return {
        "brightness": _uniform(g, -0.2, 0.2),
        "contrast": _uniform(g, lo, hi),
        "saturation": _uniform(g, lo, hi),
        "hue": _uniform(g, -max_hue, max_hue),
        "invert": float(_uniform(g) < 0.5) if invert_color else 0.0,
    }


def _fixup(v: torch.Tensor, signs) -> torch.Tensor:
    return v * torch.tensor(signs, dtype=v.dtype, device=v.device)


def _flip_v(seq: Batch) -> Batch:
    h = seq["rgb"].shape[-3]
    c = seq["camera_c"]
    return {
        **seq,
        "rgb": torch.flip(seq["rgb"], dims=[-3]),
        "depth": torch.flip(seq["depth"], dims=[-3]),
        "rot": _fixup(seq["rot"], [1, -1, 1, -1]),
        "trans": _fixup(seq["trans"], [1, -1, 1]),
        "camera_c": torch.stack([c[0], h - c[1]]),
    }


def _flip_h(seq: Batch) -> Batch:
    w = seq["rgb"].shape[-2]
    c = seq["camera_c"]
    return {
        **seq,
        "rgb": torch.flip(seq["rgb"], dims=[-2]),
        "depth": torch.flip(seq["depth"], dims=[-2]),
        "rot": _fixup(seq["rot"], [1, 1, -1, -1]),
        "trans": _fixup(seq["trans"], [-1, 1, 1]),
        "camera_c": torch.stack([w - c[0], c[1]]),
    }


def _transpose(seq: Batch) -> Batch:
    q, t = seq["rot"], seq["trans"]
    return {
        **seq,
        "rgb": seq["rgb"].transpose(-3, -2),
        "depth": seq["depth"].transpose(-3, -2),
        "rot": torch.stack([q[:, 0], -q[:, 2], -q[:, 1], -q[:, 3]], dim=1),
        "trans": torch.stack([t[:, 1], t[:, 0], t[:, 2]], dim=1),
        "camera_c": torch.flip(seq["camera_c"], dims=[0]),
        "camera_f": torch.flip(seq["camera_f"], dims=[0]),
    }


def crop_offset(g: torch.Generator, hw: Tuple[int, int],
                out_size: Tuple[int, int]) -> int:
    """The crop's offset along the long edge, drawn in [0, excess): the
    exclusive upper bound is the reference's (``augment.crop_augment``)."""
    h, w = hw
    oh, ow = out_size
    excess = w - ow if oh >= ow else h - oh
    return int(torch.randint(0, max(excess, 1), (), generator=g).item())


def _crop(seq: Batch, off: int, out_size: Tuple[int, int]) -> Batch:
    """Crop a square intermediate to ``out_size`` at offset ``off`` along
    the cropped axis, principal point shifted."""
    h, w = seq["rgb"].shape[-3:-1]
    oh, ow = out_size
    if h == oh and w == ow:
        return seq
    oy, ox = (0, off) if oh >= ow else (off, 0)
    c = seq["camera_c"]
    return {
        **seq,
        "rgb": seq["rgb"][:, oy:oy + oh, ox:ox + ow],
        "depth": seq["depth"][:, oy:oy + oh, ox:ox + ow],
        "camera_c": torch.stack([c[0] - ox, c[1] - oy]),
    }


def augment_sequence(seq: Batch, g: torch.Generator, *, usecase: str,
                     geometric: bool, invert_color: bool,
                     crop_to: Optional[Tuple[int, int]] = None) -> Batch:
    """Augment ONE sequence ([T, h, w, c] tensors, [T, 4]/[T, 3] motion,
    [2] intrinsics). Draws, in order: the vertical flip, the horizontal
    flip and the transpose (each with probability 0.5), the crop offset,
    the color parameters."""
    finetune = usecase == "finetune"
    flips = [_uniform(g) < 0.5 for _ in range(3)]
    off = (crop_offset(g, tuple(seq["rgb"].shape[-3:-1]), crop_to)
           if crop_to is not None else 0)
    p = sample_color_params(g, finetune, invert_color)
    if geometric and not finetune:
        if flips[0]:
            seq = _flip_v(seq)
        if flips[1]:
            seq = _flip_h(seq)
        if flips[2] and seq["rgb"].shape[-3] == seq["rgb"].shape[-2]:
            seq = _transpose(seq)
    if crop_to is not None:
        seq = _crop(seq, off, crop_to)
    return {**seq, "rgb": apply_color(seq["rgb"], p)}


def make_batch_augment(*, dataset: str, usecase: str = "train",
                       crop_to: Optional[Tuple[int, int]] = None):
    """``batch_augment(batch, seed, step) -> batch``: each sequence of the
    batch augmented with its own generator, seeded from
    ``(seed, step, index)``, the sequence's index in the global batch (the
    rank times the local batch, plus its index here). The policy is each adapter's host one
    (``datasets.py``): Mid-Air and TartanAir get the geometric transforms
    and inverting color; KITTI color only, no inversion."""
    geometric = dataset in ("midair", "tartanair")
    invert_color = dataset != "kitti-raw"

    def batch_augment(batch: Batch, seed: int, step: int) -> Batch:
        # under data parallelism the batch is this rank's slice of the
        # global one: a sequence is keyed by its index in the global batch,
        # so that no two ranks draw the same transforms and the ranks'
        # slices together are the one-process augmentation of it
        b = batch["rgb"].shape[0]
        first = rank_and_world()[0] * b
        outs = []
        for i in range(b):
            g = torch.Generator().manual_seed(mix_seed(seed, step, first + i))
            seq = {k: batch[k][i] for k in SEQ_KEYS}
            outs.append(augment_sequence(
                seq, g, usecase=usecase, geometric=geometric,
                invert_color=invert_color, crop_to=crop_to))
        return {**batch, **{k: torch.stack([o[k] for o in outs])
                            for k in SEQ_KEYS}}

    return batch_augment

"""Plain float32 PyTorch building blocks of the M4Depth reference: camera
geometry, the TF resize grids, the bilinear warp, the two cost volumes and
the 3x3 'SAME' convolution, written from the published model
(github.com/michael-fonder/M4Depth) with no kernel, cache or batching
trick. Imports nothing but torch.

``Numerics`` says where values are rounded: ``None`` for float32 (the
reference itself), or a lower dtype to compute a control in (bfloat16,
float8): the convs' inputs, weights and outputs to the compute dtype, the
cost volumes' inputs to theirs. A rounding to float8 saturates at the
format's largest value, as float8 pipelines do, so that the control gives
numbers instead of NaN.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

INIT_DEPTH = 1000.0


@dataclasses.dataclass(frozen=True)
class Numerics:
    """The dtype the convs (``compute``) and the cost volumes' inputs
    (``cv``) are rounded to; None keeps float32."""

    compute: Optional[torch.dtype] = None
    cv: Optional[torch.dtype] = None

    def rc(self, x: torch.Tensor) -> torch.Tensor:
        return round_to(x, self.compute)

    def rcv(self, x: torch.Tensor) -> torch.Tensor:
        return round_to(x, self.cv)


FLOAT32 = Numerics()
DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def stated(cfg: dict) -> Numerics:
    """The precision a configuration states: its convs' and its cost
    volumes' dtypes."""
    return Numerics(DTYPES[cfg["compute_dtype"]], DTYPES[cfg["cv_dtype"]])


@contextlib.contextmanager
def no_tf32():
    """cuDNN's convolutions and cuBLAS' products in float32, not TF32
    (PyTorch lets cuDNN use TF32 by default)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def round_to(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32 (saturating for the
    float8 formats); ``x`` as float32 when ``dtype`` is None. The rounding
    passes the gradient through unchanged: a control computes its forward
    in the lower precision and its backward in float32."""
    x = x.float()
    if dtype is None:
        return x
    q = x
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        big = torch.finfo(dtype).max
        q = q.clamp(-big, big)
    return x + (q.to(dtype).float() - x).detach()


# -- geometry -----------------------------------------------------------------


def rot_mat(rot: torch.Tensor) -> torch.Tensor:
    """[b, 4] unit (w, x, y, z) quaternion or [b, 3] small angle -> [b,3,3]."""
    if rot.shape[-1] == 3:
        x, y, z = rot.unbind(-1)
        one = torch.ones_like(x)
        return torch.stack([torch.stack([one, -z, y], -1),
                            torch.stack([z, one, -x], -1),
                            torch.stack([-y, x, one], -1)], -2)
    w, x, y, z = rot.unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     w * w - x * x - y * y + z * z], -1)], -2)


def rays(h: int, w: int, f: torch.Tensor, c: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel rays [b,h,w,3] ((u+.5-cx)/fx, (v+.5-cy)/fy, 1) and the pixel
    centres relative to c, [b,h,w,2] (x, y)."""
    dev = f.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    mesh = torch.stack([xs + 0.5, ys + 0.5], -1)[None] - c[:, None, None, :]
    xy = mesh / f[:, None, None, :]
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1), mesh


def rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R [b,3,3] applied to v [b,h,w,3]."""
    return torch.einsum("bij,bhwj->bhwi", R, v)


def epipolar(h, w, rot, trans, f, c):
    """alpha [b,h,w,1], proj [b,h,w,2], delta [b,h,w,2], rho [b,h,w,1],
    mesh [b,h,w,2] and t_z [b,1,1,1] of the parallax geometry: a ray h,
    rc = R h, alpha = rc_z, proj = rc_xy f / alpha, delta = (t f)_xy -
    t_z proj, rho = |delta|; parallax = rho / (depth alpha + t_z)."""
    ray, mesh = rays(h, w, f, c)
    rc = rotate(rot_mat(rot), ray)
    alpha = rc[..., 2:]
    fb = f[:, None, None, :]
    proj = rc[..., :2] * fb / alpha
    t = trans[:, None, None, :]
    t_z = t[..., 2:]
    delta = t[..., :2] * fb - t_z * proj
    rho = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    return alpha, proj, delta, rho, mesh, t_z


def parallax_to_depth(para, rot, trans, f, c):
    alpha, _, _, rho, _, t_z = epipolar(para.shape[1], para.shape[2], rot,
                                        trans, f, c)
    return (rho / para - t_z) / alpha


def prev_depth_to_parallax(depth, trans, f, c):
    """Parallax now of a point whose depth was measured at the same pixel
    in the previous frame (rotation makes none); no gradient."""
    ray, _ = rays(depth.shape[1], depth.shape[2], f, c)
    f1 = torch.cat([f, torch.ones_like(f[:, :1])], -1)[:, None, None, :]
    t = trans[:, None, None, :]
    t_z = t[..., 2:]
    delta = (t * f1 - t_z * ray * f1) / (depth - t_z)
    return torch.linalg.vector_norm(delta[..., :2], dim=-1,
                                    keepdim=True).detach()


def reprojection_flow(depth, rot, trans, f, c):
    """Backward-warp flow [b,h,w,2] of the motion over ``depth``."""
    ray, mesh = rays(depth.shape[1], depth.shape[2], f, c)
    moved = rotate(rot_mat(rot), ray * depth) + trans[:, None, None, :]
    return moved[..., :2] * f[:, None, None, :] / moved[..., 2:] - mesh


def recompute_depth(depth, rot, trans, f, c):
    """Depth from the new viewpoint of the points at the same pixels,
    the geometry factors without gradient, clipped to [0.1, 2000]."""
    ray, _ = rays(depth.shape[1], depth.shape[2], f, c)
    r3 = rot_mat(rot)[:, 2, :][:, None, None, :]
    scale = (r3 * ray).sum(-1, keepdim=True)
    shift = (r3 * -trans[:, None, None, :]).sum(-1, keepdim=True)
    return (scale.detach() * depth + shift.detach()).clamp(0.1, 2000.0)


# -- resizing (TF's grids) ----------------------------------------------------


def _lerp(x, axis, dst, half_pixel):
    src = x.shape[axis]
    if src == dst:
        return x
    pos = torch.arange(dst, dtype=torch.float32, device=x.device)
    pos = (pos + 0.5) * (src / dst) - 0.5 if half_pixel else pos * (src / dst)
    pos = pos.clamp(0.0, src - 1.0)
    lo = pos.floor().long().clamp(max=src - 1)
    hi = (lo + 1).clamp(max=src - 1)
    shape = [1] * x.dim()
    shape[axis] = dst
    frac = (pos - lo.float()).reshape(shape)
    a, b = x.index_select(axis, lo), x.index_select(axis, hi)
    return a + (b - a) * frac


def resize_bilinear_v1(x, hw):
    """TFv1 bilinear: src = dst * scale, no half-pixel offset."""
    return _lerp(_lerp(x, 1, hw[0], False), 2, hw[1], False)


def resize_bilinear(x, hw):
    """TF2 bilinear: half-pixel centres."""
    return _lerp(_lerp(x, 1, hw[0], True), 2, hw[1], True)


def resize_nearest(x, hw):
    """TF2 nearest: src = floor((dst + 0.5) * scale)."""
    for axis, dst in ((1, hw[0]), (2, hw[1])):
        src = x.shape[axis]
        if src != dst:
            idx = ((torch.arange(dst, device=x.device, dtype=torch.float32)
                    + 0.5) * (src / dst)).floor().clamp(0, src - 1).long()
            x = x.index_select(axis, idx)
    return x


# -- warping and cost volumes ---------------------------------------------------


def warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp of image [n,h,w,c] by flow [n,h,w,2] (dx, dy):
    the corner index clipped to [0, size-2], the fraction to [0, 1]."""
    n, h, w, ch = image.shape
    qx = torch.arange(w, device=image.device, dtype=torch.float32) + flow[..., 0]
    qy = (torch.arange(h, device=image.device, dtype=torch.float32)[:, None]
          + flow[..., 1])
    x0 = qx.floor().nan_to_num(0.0).clamp(0, max(w - 2, 0))
    y0 = qy.floor().nan_to_num(0.0).clamp(0, max(h - 2, 0))
    ax = (qx - x0).clamp(0, 1)[..., None]
    ay = (qy - y0).clamp(0, 1)[..., None]
    flat = image.reshape(n, h * w, ch)
    base = (y0.long() * w + x0.long()).reshape(n, h * w, 1)

    def at(i):
        return flat.gather(1, i.expand(n, h * w, ch)).reshape(n, h, w, ch)

    top = at(base) + (at(base + 1) - at(base)) * ax
    bot = at(base + w) + (at(base + w + 1) - at(base + w)) * ax
    return top + (bot - top) * ay


def dscv(c1, c2, para_prev, centre, rot, trans, f, c, radius, cuts, num):
    """The parallax-sweeping cost volume: c2 warped along the epipolar line
    at 2r+1 parallax hypotheses around ``centre``, correlated with c1 cut by
    cut (mean over a cut's channels); returns ([b,h,w,cuts*(2r+1)],
    cut-major, and ``para_prev`` warped by the centre hypothesis)."""
    b, h, w, C = c1.shape
    s = 2 * radius + 1
    _, proj, delta, rho, mesh, _ = epipolar(h, w, rot, trans, f, c)
    unit = delta / rho.clamp(min=1e-12)
    offs = torch.arange(-radius, radius + 1, device=c1.device,
                        dtype=torch.float32).reshape(1, s, 1, 1, 1)
    disp = (centre[:, None] + offs).clamp(1e-6, 1e6)
    flows = proj[:, None] + unit[:, None] * disp - mesh[:, None]
    a = num.rcv(c1)
    warped = warp(num.rcv(c2)[:, None].expand(b, s, h, w, C)
                  .reshape(b * s, h, w, C), flows.reshape(b * s, h, w, 2))
    prod = a[:, None] * warped.reshape(b, s, h, w, C)
    cv = prod.reshape(b, s, h, w, cuts, C // cuts).mean(-1)
    cv = cv.permute(0, 2, 3, 4, 1).reshape(b, h, w, cuts * s)
    para = num.rcv(para_prev) if num.cv != torch.float16 else round_to(
        para_prev.clamp(-65504.0, 65504.0), torch.float16)
    return cv, warp(para, flows[:, radius])


def sncv(c1, c2, radius, cuts, slope, num):
    """The spatial-neighbourhood cost volume: per offset of the (2r+1)^2
    window (offset-major) and per cut, the mean correlation of c1 with c2
    shifted (zero outside the image), then leaky ReLU."""
    b, h, w, C = c1.shape
    side = 2 * radius + 1
    a = num.rcv(c1)
    pad = F.pad(num.rcv(c2), (0, 0, radius, radius, radius, radius))
    # [b, h, w, C, dy, dx]: c2 at (y + dy - r, x + dx - r)
    win = pad.unfold(1, side, 1).unfold(2, side, 1)
    prod = a[..., None, None] * win
    cv = prod.reshape(b, h, w, cuts, C // cuts, side, side).mean(4)
    cv = cv.permute(0, 1, 2, 4, 5, 3).reshape(b, h, w, side * side * cuts)
    return torch.where(cv > 0, cv, cv * slope)


# -- convolution ----------------------------------------------------------------


def _same(n: int, stride: int) -> Tuple[int, int]:
    out = -(-n // stride)
    total = max(0, (out - 1) * stride + 3 - n)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, params: dict, name: str, num: Numerics,
         stride: int = 1) -> torch.Tensor:
    """3x3 convolution of NHWC ``x`` with TF 'SAME' padding (for stride 2
    on an even size, one row and column after), weights ``name.weight``
    (OIHW) and ``name.bias``; inputs, weights and output rounded to the
    compute dtype."""
    pt, pb = _same(x.shape[1], stride)
    pl, pr = _same(x.shape[2], stride)
    x = F.pad(num.rc(x), (0, 0, pl, pr, pt, pb))
    y = F.conv2d(x.permute(0, 3, 1, 2), num.rc(params[name + ".weight"]),
                 num.rc(params[name + ".bias"]), stride=stride)
    return num.rc(y.permute(0, 2, 3, 1))


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x > 0, x, x * slope)

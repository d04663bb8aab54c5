"""Flow-field backward warping (bilinear resampling), the plain DSCV's
sampler. Counterpart of ``m4depth_tpu/ops/warp.py``.

  output[b, y, x, c] = bilinear_sample(image[b], (x + flow_x, y + flow_y))

with the floor of the sample position clipped to [0, size-2] and the
fraction to [0, 1] (the query clamped into the image). Flow is (dx, dy).
"""

from __future__ import annotations

import torch


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` [..., h, w, c] by ``flow`` [..., h, w, 2];
    the result has the image's shape and dtype."""
    *lead, h, w, c = image.shape
    img = image.reshape(-1, h, w, c)
    flo = flow.reshape(-1, h, w, 2).float()
    b = img.shape[0]
    dev = image.device

    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    qx = gx + flo[..., 0]
    qy = gy + flo[..., 1]

    # a NaN position (from a NaN input) takes the index 0, as the kernel's
    # fmaxf does, and its NaN fraction makes the output NaN: an index cast
    # from NaN would fall outside the image
    x0f = torch.clamp(torch.floor(qx).nan_to_num(0.0), 0.0,
                      float(max(w - 2, 0)))
    y0f = torch.clamp(torch.floor(qy).nan_to_num(0.0), 0.0,
                      float(max(h - 2, 0)))
    ax = torch.clamp(qx - x0f, 0.0, 1.0).to(image.dtype)[..., None]
    ay = torch.clamp(qy - y0f, 0.0, 1.0).to(image.dtype)[..., None]
    base = (y0f.long() * w + x0f.long()).reshape(b, h * w, 1)

    flat = img.reshape(b, h * w, c)

    def gather(lin):
        return torch.gather(flat, 1, lin.expand(b, h * w, c)).reshape(
            b, h, w, c)

    tl = gather(base)
    tr = gather(base + 1)
    bl = gather(base + w)
    br = gather(base + w + 1)

    top = tl + (tr - tl) * ax
    bot = bl + (br - bl) * ax
    out = top + (bot - top) * ay
    return out.reshape(*lead, h, w, c)

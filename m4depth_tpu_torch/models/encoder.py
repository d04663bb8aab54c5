"""Feature pyramid encoder. Counterpart of ``m4depth_tpu/models/encoder.py``.

Each level is a stride-1 3x3 conv (with domain-invariant normalization at
level 0), leaky-relu, a stride-2 3x3 conv and leaky-relu; output i has
stride 2**(i+1). Each conv layer applies the leaky-relu that follows it
(``Conv3x3``'s slope), except level 0's stride-1 conv, which the
normalization follows. Tensors are NHWC at every interface; the convs see
them as channels-last NCHW views, which cuDNN takes without a copy, and
return contiguous NHWC tensors on any conv backend.

The JAX ``FirstConv`` (a TPU lane trick: 9 shifts and a matmul) is the same
function as an ordinary 3x3 conv with the same kernel, which is what runs
here.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.ops.conv_epilogue import conv3x3

# flax's he_normal: a normal truncated at 2 sigma, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _same_pad(n: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' padding of a 3-tap window: total//2 before, the rest after.

    For a stride-2 conv on an even size that is (0, 1), not the symmetric
    padding=1 of PyTorch.
    """
    out = -(-n // stride)
    total = max(0, (out - 1) * stride + 3 - n)
    return total // 2, total - total // 2


class Conv3x3(nn.Module):
    """3x3 convolution on NHWC tensors with TF 'SAME' padding, and the
    leaky ReLU of ``slope`` that follows it in the architecture (None: no
    activation follows).

    Parameters are float32 (weight OIHW); the conv runs in the input's
    dtype, as flax casts its kernel to the compute dtype. The layer runs
    ``ops.conv_epilogue.conv3x3``: on CUDA tensors the bias and the
    activation are one kernel on the conv's output.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 slope: Optional[float] = None):
        super().__init__()
        self.stride = stride
        self.slope = slope
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal (truncated) weights, zero bias, as flax initialises."""
        std = math.sqrt(2.0 / (9 * self.weight.shape[1])) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        pt, pb = _same_pad(h, self.stride)
        pl, pr = _same_pad(w, self.stride)
        if (pt, pl) != (pb, pr):
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
            pt = pl = 0
        return conv3x3(x, self.weight, self.bias, self.stride, (pt, pl),
                       self.slope)


class DomainNorm(nn.Module):
    """Domain-invariant normalization.

    Standardize each channel over space dividing by the *variance* (not the
    std, as the reference does), L2-normalize along channels (eps 1e-12),
    then apply a learned scale and bias. Reductions run in float32.
    """

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = xf.var(dim=(1, 2), keepdim=True, correction=0)
        inv = (1.0 / (var + 1e-12)).to(x.dtype)
        standardized = (x - mean.to(x.dtype)) * inv
        sq = standardized.float().square().sum(dim=-1, keepdim=True)
        normed = standardized * torch.rsqrt(
            torch.clamp(sq, min=1e-12)).to(x.dtype)
        return self.scale.to(x.dtype) * normed + self.bias.to(x.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        slope = cfg.leaky_slope
        ins = (3,) + tuple(cfg.channels[:-1])
        self.dinl = DomainNorm(cfg.channels[0]) if cfg.ablation.dinl else None
        # level 0's stride-1 conv is followed by the normalization, whose
        # output the activation then takes
        self.conv_s1 = nn.ModuleList(
            Conv3x3(cin, ch,
                    slope=None if i == 0 and self.dinl is not None else slope)
            for i, (cin, ch) in enumerate(zip(ins, cfg.channels)))
        self.conv_s2 = nn.ModuleList(
            Conv3x3(ch, ch, stride=2, slope=slope) for ch in cfg.channels)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images: [b, h, w, 3] in [0, 1] -> per-level NHWC feature maps."""
        x = images.to(self.cfg.torch_compute_dtype)
        outputs = []
        for i, (conv_s1, conv_s2) in enumerate(zip(self.conv_s1, self.conv_s2)):
            x = conv_s1(x)
            if self.dinl is not None and i == 0:
                x = leaky_relu(self.dinl(x), self.cfg.leaky_slope)
            x = conv_s2(x)
            outputs.append(x)
        return outputs

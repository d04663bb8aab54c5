"""Random weights of a configuration, drawn from the run's seed on the
run's device in one call: every conv weight He-normal (std sqrt(2 /
fan_in)), every bias normal with std 0.01, the domain norm's scale 1 and
bias 0 moved by the same 0.01 noise. float32, the type the port keeps its
parameters in. The port and the reference both take them by name.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_gpu.reference.m4depth import param_shapes
from bench_gpu.seeds import generator

BIAS_STD = 0.01


def draw(cfg: dict, seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    noise = torch.randn(sum(sizes), generator=generator(device, seed,
                                                        "weights"),
                        device=device)
    params = {}
    for (name, shape), part in zip(shapes.items(), noise.split(sizes)):
        if name.endswith(".weight"):
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            params[name] = (part * std).reshape(shape)
        elif name.endswith("dinl.scale"):
            params[name] = 1.0 + BIAS_STD * part.reshape(shape)
        else:
            params[name] = (BIAS_STD * part).reshape(shape)
    return params

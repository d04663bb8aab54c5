"""M4Depth in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``m4depth_tpu`` (the JAX reference, which this package never
imports). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
Each cost-volume op launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from m4depth_tpu_torch.config import AblationFlags, ModelConfig, TrainConfig

__all__ = ["AblationFlags", "ModelConfig", "TrainConfig", "mix_seed",
           "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given.

    Raises when a CUDA device is asked for (or defaulted to) and none is
    present, so that no run silently continues on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def mix_seed(*parts: int) -> int:
    """One 63-bit ``torch.Generator`` seed from a tuple of non-negative
    ints, such as (seed, step, index): a stream keyed by the tuple."""
    h = 0
    for p in parts:
        h = (h * 1_000_003 + int(p) + 1) % (2 ** 63 - 25)
    return h

"""Seeds of a run: each purpose (weights, frames, the check's sample) gets
a generator of its own, keyed by the run's ``--seed`` and the purpose's
name, so that one seed gives the same inputs everywhere."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def key(seed: int, purpose: str) -> int:
    """A 63-bit seed from the run's seed (any integer) and a purpose."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device: torch.device, seed: int, purpose: str
              ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(key(seed, purpose))
    return g


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(key(seed, purpose))

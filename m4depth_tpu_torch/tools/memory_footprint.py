"""Device memory of streaming inference, against the reference's claim of
~500 MB (its README.md:15). Counterpart of ``tools/memory_footprint.py``.

Streams the compiled ``M4Depth.step`` (``parallel.serving.compile_step``:
its eager warm-up, the CUDA graph's capture, then replays; d``--levels``
at ``--size`` x ``--size``, b=1, bfloat16 convs, ``--cv_dtype`` cost
volumes, weights from seed 0) for a few frames after reading the
allocator at the start, then reports the parameters' and the recurrent
state's bytes, ``memory_allocated()``, the peak above the start
(``max_memory_allocated()``) and the bytes that the graph's private pool
holds (``Compiled.pool_bytes``). On the card:

  python -m m4depth_tpu_torch.tools.memory_footprint

``--device cpu`` runs the same frames and reports the tensors' bytes; the
allocator's numbers are then not measured.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import DTYPES, ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.parallel.serving import compile_step

REFERENCE_CLAIM_MB = 500
WARMUP_FRAMES = 3
MIB = 1024 * 1024


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--cv_dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run(a) -> dict:
    """The footprint, in bytes: ``params``, ``state``, and on the card
    ``allocated``, ``peak_above_start`` and ``graph_pool``."""
    dev = resolve_device(a.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = ModelConfig(num_levels=a.levels, compute_dtype="bfloat16",
                      cv_dtype=a.cv_dtype)
    model = M4Depth(cfg, device=dev, seed=0)
    b = 1
    rng = np.random.RandomState(0)
    state = init_state(cfg, b, a.size, a.size, device=dev)
    rgb = torch.from_numpy(rng.rand(b, a.size, a.size, 3).astype(
        np.float32)).to(dev)
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.0005]], device=dev)
    trans = torch.tensor([[0.05, 0.02, 0.4]], device=dev)
    f = torch.full((b, 2), a.size / 2.0, device=dev)
    cam = Camera(f, f.clone())
    step = compile_step(model)
    with torch.no_grad():
        for t in range(WARMUP_FRAMES):
            state, depth = step(state, rgb, rot, trans, cam,
                                torch.full((b,), t == 0, device=dev))
    out = dict(params=nbytes(list(model.parameters())), state=nbytes(state),
               finite=bool(torch.isfinite(depth).all()))
    if on_card:
        torch.cuda.synchronize(dev)
        out["allocated"] = torch.cuda.memory_allocated(dev) - start
        out["peak_above_start"] = torch.cuda.max_memory_allocated(dev) - start
        out["graph_pool"] = step.pool_bytes()
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    r = run(a)
    print(f"d{a.levels} {a.size}x{a.size} b=1 bf16/{a.cv_dtype}, "
          f"{WARMUP_FRAMES} frames streamed")
    print(f"params:              {r['params'] / MIB:10.3f} MiB")
    print(f"recurrent state:     {r['state'] / MIB:10.3f} MiB")
    if "allocated" in r:
        print(f"memory_allocated():  {r['allocated'] / MIB:10.3f} MiB above "
              "the start")
        print(f"peak above start:    {r['peak_above_start'] / MIB:10.3f} "
              f"MiB (reference claim: ~{REFERENCE_CLAIM_MB} MB, its "
              "README.md:15)")
        print(f"CUDA graph's pool:   {r['graph_pool'] / MIB:10.3f} MiB "
              "(the replayed frame's intermediates)")
    else:
        print("device memory: not measured (no CUDA device in this run)")
    return 0 if r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())

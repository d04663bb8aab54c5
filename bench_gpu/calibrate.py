"""The readings that a cell's correctness limits are set from, in one
process on the card (no measured window):

    python3 -m bench_gpu.calibrate --workload <cell> --seeds 1 2 3 \
        [--controls 3]

For each seed: the cell's set-up and its checked work through the timed
path (a serving cell's check span; a training cell's checked steps), the
program freed, then its numbers against the float32 reference (the lower
reading). On the first ``--controls`` seeds also the control: the
reference computed in float8 (e4m3, saturating) where the configuration
states bfloat16, in the program's place (the upper reading), and the
faults the cell's driver plants (its ``faults()``: a training cell's half
batch and altered loss). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_gpu import spec
from bench_gpu.reference.ops import Numerics

LOWER = {"bfloat16": torch.float8_e4m3fn, "float16": torch.float8_e4m3fn,
         "float32": torch.bfloat16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_gpu.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    cfg = cell.config
    control = Numerics(LOWER[cfg["compute_dtype"]], LOWER[cfg["cv_dtype"]])
    drv = spec.driver(cell.traffic["kind"])
    for n, seed in enumerate(args.seeds):
        c = drv.Cell(cfg, cell.traffic, seed, dev)
        c.check_only()
        line = dict(seed=seed, program=c.compare())
        if n < args.controls:
            line["control"] = c.control(control)
            line.update(c.faults())
        print(json.dumps(line), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

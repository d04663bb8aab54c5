"""The benchmark of ``m4depth_tpu_torch`` on one NVIDIA GPU: one run of one
cell.

    python3 -m bench_gpu.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is read from ``BENCHMARK.json`` and the files it names
(``spec.py``). The run sets up (weights and frames from the seed, the
port's model, warm-up and capture of its compiled program), measures for
``--seconds``, and with ``--trace 1`` then profiles a few more frames or
steps for the per-layer metrics; then it frees the program and checks what
the timed path produced against the float32 reference. Its last line on
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit); the same numbers
and limits end standard error.

It exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), and when the JAX package or JAX is loaded
in this process once the window has closed.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from bench_gpu import spec  # noqa: E402
from bench_gpu.check import judge  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "m4depth_tpu")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m bench_gpu.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``m4depth_tpu_torch`` is the port)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` gives it ("" without it)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ""
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError):
        return ""
    return out.stdout.strip().split("\n")[0]


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, start: float) -> dict:
    """One run of ``cell`` on ``device``: the result line's object."""
    import torch

    print(f"set-up: start to the cell {time.perf_counter() - start:.3f} s",
          flush=True)
    out = spec.driver(cell.traffic["kind"]).run(
        cell.config, cell.traffic, seed, seconds, traced, device)
    values = dict(out["metrics"], setup_s=out["setup_done"] - start)
    numbers = out["checks"]
    result: Dict = dict(
        correct=bool(judge(numbers, cell.limits) and out["failed"] == 0),
        attempted=out["attempted"], failed=out["failed"])
    if traced:
        tr = out["trace"]
        result["metrics"] = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(tr)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value,
                                                    unit=m["unit"])
    else:
        result["metrics"] = {m["name"]: dict(value=values[m["name"]],
                                             unit=m["unit"])
                             for m in cell.end_to_end}
    result["device"] = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=cell.chips, memory_peak_bytes=out["peak_bytes"],
        power_limit=power_limit() if device.type == "cuda" else "")
    if traced:
        result["device"].update(busy_s=tr.busy_s * tr.units,
                                window_s=tr.window_s)
        result["breakdown"] = dict(
            device_ops=[[n, s] for n, s in tr.device_ops],
            idle_gaps=[[n, s] for n, s in tr.idle_gaps])
    result["checks"] = {name: dict(value=numbers.get(name), limit=limit)
                        for name, limit in cell.limits.items()}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                     START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}: "
              "no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

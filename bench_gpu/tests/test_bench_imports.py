"""What the benchmark loads: never JAX or the JAX package (compared by
whole top-level names: ``m4depth_tpu_torch`` is the port), the reference
nothing of the port; without a card, or without the port beside it, a run
exits non-zero and prints no result."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "m4depth_tpu"}

RUN_SMALL_CELLS = """
import json, sys, time, torch
from bench_gpu import run
from bench_gpu.tests.small import CPU, small_cell
for name in ("d6-stream1", "d6-train-b3t4", "v1-stream8"):
    run.execute(small_cell(name), 3, 0.2, False, CPU, time.perf_counter())
import bench_gpu.calibrate
print(json.dumps(sorted(sys.modules)))
"""


def python(code_or_args, cwd=ROOT):
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_nor_the_jax_package():
    out = python(RUN_SMALL_CELLS)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "m4depth_tpu_torch" in loaded
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert (top in sys.stdlib_module_names or top == "torch"
                        or name.startswith("bench_gpu.reference")), (path,
                                                                     name)
    out = python("import sys, bench_gpu.reference.m4depth, "
                 "bench_gpu.reference.train; print(sorted(set("
                 "m.split('.')[0] for m in sys.modules)))")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "m4depth_tpu_torch" not in out.stdout
    assert "'jax'" not in out.stdout


def no_result(stdout: str) -> bool:
    """No line of the run's standard output is a JSON object."""
    return not any(line.startswith("{") for line in stdout.splitlines())


def test_without_a_card_no_result():
    out = python(["-m", "bench_gpu.run", "--workload", "d6-stream1",
                  "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0
    assert no_result(out.stdout)


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = python(RUN_SMALL_CELLS, cwd=tmp_path)
    assert out.returncode != 0
    assert "m4depth_tpu_torch" in out.stderr
    assert no_result(out.stdout)

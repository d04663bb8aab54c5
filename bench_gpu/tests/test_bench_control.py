"""The control comes out not correct: the reference computed in float8
(e4m3, saturating) where the configuration states bfloat16, put in the
program's place and held to the cell's limits, on the CPU at a small size
(``calibrate.py`` reads it on the card at the cells' own sizes)."""

import pytest

from bench_gpu import spec
from bench_gpu.calibrate import LOWER
from bench_gpu.check import judge
from bench_gpu.reference.ops import Numerics
from bench_gpu.tests.small import CPU, small_cell


@pytest.mark.parametrize("name", ["d6-stream1", "d6-train-b3t4",
                                  "v1-stream8"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_float8_control_fails_the_limits(name, seed):
    cell = small_cell(name)
    cfg = cell.config
    c = spec.driver(cell.traffic["kind"]).Cell(cfg, cell.traffic, seed, CPU)
    c.check_only()
    program = c.compare()
    control = c.control(Numerics(LOWER[cfg["compute_dtype"]],
                                 LOWER[cfg["cv_dtype"]]))
    assert judge(program, cell.limits), program
    assert not judge(control, cell.limits), control

"""``flops.py``'s conv count against PyTorch's own count of the
reference's convolutions, and its cost-volume formulas against the
port's ``ops/cost.py`` they were frozen from."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_gpu import flops, scenes, seeds, weights
from bench_gpu.reference import m4depth as ref
from bench_gpu.reference.ops import FLOAT32
from bench_gpu.tests.small import CPU, small_cell

MOTION = {"lateral": [0.1, 0.25], "forward": [-0.02, 0.02],
          "turn": [0.0, 0.02]}


def conv_count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_flop_counts()["Global"].get(
        torch.ops.aten.convolution, 0)


@pytest.mark.parametrize("name", ["d6-stream1", "v1-stream8"])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_conv_flops_equal_pytorch_count(name, hw):
    cfg = small_cell(name).config
    h, w = hw
    params = weights.draw(cfg, 1, CPU)
    sc = scenes.render(2, 2, h, w, MOTION, seeds.generator(CPU, 1, "t"))
    args = [(sc["rgb"][:, t], sc["rot"][:, t], sc["trans"][:, t],
             sc["camera_f"], sc["camera_c"]) for t in range(2)]
    with torch.no_grad():
        state, _ = ref.frame(params, cfg, None, *args[0], None, FLOAT32)
        # a frame with a previous one runs every level's refiner
        counted = conv_count(lambda: ref.frame(params, cfg, state, *args[1],
                                               None, FLOAT32))
    assert flops.conv_flops(cfg, 2, h, w) == counted
    first = conv_count(lambda: ref.frame(params, cfg, None, *args[0], None,
                                         FLOAT32))
    if cfg["family"] == "m4depth":
        assert flops.conv_flops(cfg, 2, h, w, encoder_only=True) == first
    else:
        assert flops.conv_flops(cfg, 2, h, w) == first


def test_cost_formulas_are_the_ports():
    from m4depth_tpu_torch.ops import cost

    for args in ((9216, 16, 1, 3, 2), (36, 192, 8, 4, 4)):
        assert flops.dscv_forward_work(*args) == cost.dscv_forward_work(*args)
        assert flops.dscv_backward_work(*args) == \
            cost.dscv_backward_work(*args)
        for same in (True, False):
            assert flops.sncv_forward_work(*args, same) == \
                cost.sncv_forward_work(*args, same)
            assert flops.sncv_backward_work(*args, same) == \
                cost.sncv_backward_work(*args, same)


def test_d6_frame_at_384():
    """The d6 frame's count at 384x384, b=1 (PERF.md gives it)."""
    cfg = small_cell("d6-stream1").config
    cfg.update(num_levels=6)
    frame = flops.serve_frame(cfg, 1, 384, 384)
    assert frame["flops"] == pytest.approx(44.3776e9, rel=1e-5)

"""The benchmark's plain reference against the port on the same weights, in
float32 on the CPU at a small size: streamed frames of both families with
resets on single streams, and M4Depth's training steps (losses, first
gradients, parameters after Adam)."""

import pytest
import torch

from bench_gpu import program, scenes, seeds, weights
from bench_gpu.check import LEAF_FLOOR
from bench_gpu.reference import m4depth as ref
from bench_gpu.reference.ops import FLOAT32
from bench_gpu.reference.train import train_steps
from bench_gpu.tests.small import CPU, small_cell

MOTION = {"lateral": [0.1, 0.25], "forward": [-0.02, 0.02],
          "turn": [0.0, 0.02]}


def float32_cell(name):
    cell = small_cell(name)
    cell.config.update(compute_dtype="float32", cv_dtype="float32")
    return cell


@pytest.mark.parametrize("name", ["d6-stream1", "v1-stream8"])
def test_streamed_frames_match_the_port(name):
    cfg = float32_cell(name).config
    params = weights.draw(cfg, 7, CPU)
    model = program.build_model(cfg, params, CPU)
    b, T, hw = 2, 5, 64
    sc = scenes.render(b, T, hw, hw, MOTION, seeds.generator(CPU, 7, "t"))
    state = program.init_state(model, b, hw, hw, CPU)
    cam = program.camera(sc["camera_f"], sc["camera_c"])
    rstate = None
    for t in range(T):
        reset = torch.tensor([t == 0, t in (0, 3)])
        args = (sc["rgb"][:, t], sc["rot"][:, t], sc["trans"][:, t])
        state, got = model.step(state, *args, cam, reset)
        rstate, want = ref.stream_step(params, cfg, rstate, *args,
                                       sc["camera_f"], sc["camera_c"], reset,
                                       FLOAT32)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_training_steps_match_the_port():
    cfg = float32_cell("d6-train-b3t4").config
    params = weights.draw(cfg, 3, CPU)
    sc = scenes.render(6, 3, 64, 64, MOTION, seeds.generator(CPU, 3, "t"))
    batches = [{k: v[i * 2:(i + 1) * 2] for k, v in sc.items()}
               for i in range(3)]
    model = program.build_model(cfg, params, CPU)
    step, opt = program.compile_train(model, 1e-3)
    named = dict(model.named_parameters())
    losses = []
    for i, batch in enumerate(batches):
        losses.append(step(batch)["loss"].item())
        if i == 0:
            grads = {k: opt.adam.state[p]["exp_avg"] / 0.1
                     for k, p in named.items()}
    want = train_steps(params, cfg, batches, 1e-3, FLOAT32)
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(want["losses"]), rtol=1e-4,
                               atol=0)
    top = max(g.abs().max().item() for g in want["grads"].values())
    norms = {k: g.norm().item() for k, g in want["grads"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k, g in want["grads"].items():
        torch.testing.assert_close(grads[k], g, rtol=1e-3,
                                   atol=1e-4 * top, msg=k)
        # Adam moves each parameter by about lr a step whatever the size of
        # its gradient, on the gradient's sign: where a gradient is within
        # rounding of zero (the first conv's bias, which the domain norm
        # cancels, and single elements anywhere) the two sides move apart
        # by up to 2 lr, so the parameters are held where the first
        # gradient's sign is sure, in leaves whose gradient is not all
        # rounding (check.LEAF_FLOOR)
        if norms[k] < LEAF_FLOOR * median:
            continue
        sure = g.abs() > 1e-2 * g.abs().max()
        torch.testing.assert_close(named[k].detach()[sure],
                                   want["params"][k][sure], rtol=0,
                                   atol=3e-5, msg=k)

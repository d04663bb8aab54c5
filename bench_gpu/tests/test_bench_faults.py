"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and the same run unbroken comes out
correct; on the CPU at a small size (the harness's look for a chip is
skipped: ``run.execute`` is called with the CPU).

Faults: a step that returns its state unchanged; half of the batch left
out (serving: the cameras of the second half get the first half's depth;
training: the loss and the gradients are the mean over the rest); an
answer altered where it is produced (one frame's depth, one step's loss,
off by a quarter); with several cameras, one camera's slot of the batch
given another camera's frame. The exchange between chips is no fault of
these one-chip cells.
"""

import copy
import time

import pytest
import torch

from bench_gpu import program, run
from bench_gpu.tests.small import CPU, small_cell


def stream_fault(kind):
    real = program.compile_stream

    def compile_stream(model, device):
        step = real(model, device)
        calls = [0]

        def broken(state, rgb, rot, trans, cam, reset):
            calls[0] += 1
            if kind == "state_unchanged":
                _, depth = step(copy.deepcopy(state), rgb, rot, trans, cam,
                                reset)
                return state, depth
            if kind == "half_batch":
                n = rgb.shape[0] - rgb.shape[0] // 2
                # views of the first half: the step updates them in place
                half = [tuple(type(s)(*(t[:n] for t in s))
                              for s in state[0])]
                cam_h = type(cam)(cam.f[:n], cam.c[:n])
                _, depth = step(half, rgb[:n], rot[:n], trans[:n], cam_h,
                                reset[:n])
                return state, torch.cat([depth, depth])[:rgb.shape[0]]
            if kind == "one_camera":
                rgb = torch.cat([rgb[:-1], rgb[:1]])
            state, depth = step(state, rgb, rot, trans, cam, reset)
            if kind == "answer_altered" and calls[0] % 5 == 0:
                depth = depth * 1.25
            return state, depth

        return broken

    return compile_stream


def train_fault(kind):
    real = program.compile_train

    def compile_train(model, lr):
        step, opt = real(model, lr)

        def broken(batch):
            if kind == "state_unchanged":
                keep = copy.deepcopy((model.state_dict(),
                                      opt.adam.state_dict()))
                out = step(batch)
                model.load_state_dict(keep[0])
                opt.adam.load_state_dict(keep[1])
                for p in model.parameters():
                    s = opt.adam.state[p]
                    s["exp_avg"].zero_()
                    s["exp_avg_sq"].zero_()
                return out
            if kind == "half_batch":
                n = batch["rgb"].shape[0] - batch["rgb"].shape[0] // 2
                return step({k: v[:n] for k, v in batch.items()})
            out = dict(step(batch))
            out["loss"] = out["loss"] * 1.25
            return out

        return broken, opt

    return compile_train


def execute(name):
    return run.execute(small_cell(name), 11, 0.2, False, CPU,
                       time.perf_counter())


@pytest.mark.parametrize("name", ["d6-stream1", "v1-stream8",
                                  "d6-train-b3t4"])
def test_a_sound_run_is_correct(name):
    assert execute(name)["correct"]


@pytest.mark.parametrize("name,fault", [
    ("d6-stream1", "state_unchanged"), ("d6-stream1", "answer_altered"),
    ("v1-stream8", "state_unchanged"), ("v1-stream8", "half_batch"),
    ("v1-stream8", "answer_altered"), ("v1-stream8", "one_camera"),
    ("d6-train-b3t4", "state_unchanged"), ("d6-train-b3t4", "half_batch"),
    ("d6-train-b3t4", "answer_altered")])
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    if name == "d6-train-b3t4":
        monkeypatch.setattr(program, "compile_train", train_fault(fault))
    else:
        monkeypatch.setattr(program, "compile_stream", stream_fault(fault))
    result = execute(name)
    assert not result["correct"], result["checks"]

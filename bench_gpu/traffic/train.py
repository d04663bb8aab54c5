"""Training: the port's compiled training step (``compile_train_step``:
the window's forward, the loss, the backward and Adam as one CUDA graph)
over ``[batch, T]`` windows of rendered trajectories.

The windows are made on the card from the seed at set-up, a pool of
``pool_windows`` of them (``scenes.render``), and the steps cycle through
the pool: the host loader is left out on purpose. Each step's loss is read
on the host ``loss_lag`` steps later, for finiteness, as ``fit``'s lagged
tripwire does, so the host runs at most that many steps ahead.

The check: set-up warms the step up (its eager first call, then the
capture, which replays once), puts the weights drawn from the seed and a
fresh Adam state (zero moments, zero counts) back into the tensors the
graph holds, and then drives the same step object through
``CHECKED_STEPS`` replays, the window's own call, on the pool's first
windows (all different rows). It keeps each step's loss, the first step's
gradient as Adam holds it after one step (its first moment is 0.1 times
the gradient), and the parameters after the last. After the window the
float32 reference takes the same steps from the same weights.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from bench_gpu import flops, program, scenes, seeds, trace, weights
from bench_gpu.check import train_gaps
from bench_gpu.reference.ops import FLOAT32, Numerics
from bench_gpu.reference.train import BETAS, train_steps

CHECKED_STEPS = 3
WARM_CALLS = 2          # the eager first call; the capture


class TrainCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, device
        self.b, self.T = traffic["batch"], traffic["window_frames"]
        self.h, self.w = traffic["height"], traffic["width"]
        self.n = traffic["pool_windows"]
        self.lr = traffic["learning_rate"]
        if self.n < CHECKED_STEPS:
            raise ValueError(f"the pool needs {CHECKED_STEPS} windows or more")
        self.i = 0
        self.pending: collections.deque = collections.deque()
        self.failed = 0
        self.spans = False     # the benchmark's spans: on when traced
        self._refs: Dict[tuple, dict] = {}

    def _span(self, name: str):
        return trace.span(name) if self.spans else contextlib.nullcontext()

    def make_pool(self) -> None:
        g = seeds.generator(self.dev, self.seed, "frames")
        sc = scenes.render(self.n * self.b, self.T, self.h, self.w,
                           self.tr["motion"], g)
        if not bool((sc["depth"] > 0.5).all()):
            raise RuntimeError("a rendered trajectory left its plane")
        self.pool = [{k: v[j * self.b:(j + 1) * self.b].contiguous()
                      for k, v in sc.items()} for j in range(self.n)]

    def build(self) -> None:
        """The weights, the model, Adam and the compiled step; its warm-up
        (the eager first call, the capture); the state put back as drawn;
        then the checked steps, replays of the graph the window runs."""
        params = weights.draw(self.cfg, self.seed, self.dev)
        self.model = program.build_model(self.cfg, params, self.dev)
        self.params = {k: v.cpu() for k, v in params.items()}
        del params
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.step_fn, self.opt = program.compile_train(self.model, self.lr)
        for j in range(WARM_CALLS):
            self.step_fn(self.pool[j])
        if self.dev.type == "cuda" and program.graphs(self.step_fn) != 1:
            raise RuntimeError("the warm-up left the step without its graph")
        self.restore()
        named = dict(self.model.named_parameters())
        losses = []
        for j in range(CHECKED_STEPS):
            losses.append(self.step_fn(self.pool[j])["loss"])
            if j == 0:
                state = self.opt.adam.state
                self.grads = {k: state[p]["exp_avg"].cpu() / (1 - BETAS[0])
                              for k, p in named.items()}
        self.losses = [x.item() for x in losses]
        self.change = {k: p.detach().cpu() - self.params[k]
                       for k, p in named.items()}
        self.i = CHECKED_STEPS

    def restore(self) -> None:
        """The weights drawn from the seed and Adam's first state (zero
        moments and step counts), copied into the tensors the step holds."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.params[k])
            for state in self.opt.adam.state.values():
                for t in state.values():
                    t.zero_()
        self.opt.count = 0

    def step(self) -> None:
        with self._span("step"):
            out = self.step_fn(self.pool[self.i % self.n])
        self.pending.append(out["loss"])
        self.i += 1
        if len(self.pending) > self.tr["loss_lag"]:
            with self._span("loss_read"):
                self.read_loss()

    def read_loss(self) -> None:
        if not math.isfinite(self.pending.popleft().item()):
            self.failed += 1

    def drain(self) -> None:
        while self.pending:
            self.read_loss()

    def window(self, seconds: float) -> dict:
        start = self.i
        ends: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()
            ends.append(time.perf_counter() - t0)
        self.drain()
        print("steps issued a second: " + " ".join(
            str(n) for n in np.bincount(np.asarray(ends, int))), flush=True)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        wall = time.perf_counter() - t0
        steps = self.i - start
        print(f"window: {steps} steps of {self.b}x{self.T} frames in "
              f"{wall:.4f} s ({wall / steps * 1e3:.4f} ms a step)",
              flush=True)
        return dict(steps=steps, wall_s=wall,
                    train_frames_per_s=steps * self.b * self.T / wall)

    def profile(self, wall_s: float) -> trace.Trace:
        work = flops.train_step(self.cfg, self.b, self.T, self.h, self.w)
        self.spans = True

        def unit(i):
            self.step()

        tr = trace.profile(unit, self.tr["trace_steps"], wall_s,
                           work["flops"], work["cv_bound_s"])
        self.drain()
        return tr

    def check_only(self) -> None:
        """Set up (which runs the checked steps), with no window; free the
        program."""
        self.make_pool()
        self.build()
        self.release()

    def release(self) -> None:
        del self.step_fn, self.opt, self.model
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, num: Numerics, rows: int = 0) -> dict:
        """The reference's checked steps at ``num`` (on the first ``rows``
        rows of each window when given): losses, first gradients and the
        parameters' change, on the CPU."""
        key = (num, rows)
        if key not in self._refs:
            p = {k: v.to(self.dev) for k, v in self.params.items()}
            batches = [{k: v[:rows] if rows else v for k, v in w.items()}
                       for w in self.pool[:CHECKED_STEPS]]
            ref = train_steps(p, self.cfg, batches, self.lr, num)
            self._refs[key] = dict(
                losses=ref["losses"],
                grads={k: v.cpu() for k, v in ref["grads"].items()},
                change={k: (v - p[k]).cpu() for k, v in ref["params"].items()})
        return self._refs[key]

    def compare(self) -> Dict[str, float]:
        """The checked steps against the float32 reference."""
        ref = self.reference(FLOAT32)
        return train_gaps(self.losses, ref["losses"], self.grads,
                          ref["grads"], self.change, ref["change"])

    def control(self, num: Numerics, rows: int = 0) -> Dict[str, float]:
        """The reference at ``num`` (or on ``rows`` rows a window: half
        the batch left out) in the program's place."""
        got, ref = self.reference(num, rows), self.reference(FLOAT32)
        return train_gaps(got["losses"], ref["losses"], got["grads"],
                          ref["grads"], got["change"], ref["change"])

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The numbers under each fault the cell can have, planted in the
        reference put in the program's place (half the batch left out) or
        in the program's checked steps (each loss off by a quarter). A
        state left unchanged reads 1 on the gradient and the change by
        construction."""
        ref = self.reference(FLOAT32)
        return dict(
            half_batch=self.control(FLOAT32, rows=(self.b + 1) // 2),
            answer_altered=train_gaps(
                [x * 1.25 for x in self.losses], ref["losses"], self.grads,
                ref["grads"], self.change, ref["change"]))


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device: torch.device) -> dict:
    t0 = time.perf_counter()
    cell = TrainCell(cfg, traffic, seed, device)
    cell.make_pool()
    t1 = time.perf_counter()
    cell.build()
    out: Dict = dict(setup_done=time.perf_counter())
    print(f"set-up: frames {t1 - t0:.3f} s, model, compile and warm-up "
          f"{out['setup_done'] - t1:.3f} s", flush=True)
    res = cell.window(seconds)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    out["metrics"] = dict(train_frames_per_s=res["train_frames_per_s"],
                          peak_mem_mib=out["peak_bytes"] / 2 ** 20)
    if traced:
        out["trace"] = cell.profile(res["wall_s"] / res["steps"])
    out["attempted"], out["failed"] = cell.i - CHECKED_STEPS, cell.failed
    cell.release()
    out["checks"] = cell.compare()
    return out


Cell = TrainCell

"""Closed-loop streaming: ``streams`` cameras served batched by one host
thread through the port's compiled step (``sharded_stream`` on one card:
``compile_step`` at batch ``streams``). Each step is one frame of every
camera: its frames are copied from pinned host memory to the card, the
step is replayed, and the depth maps are copied back to pinned host
memory; the next step starts when they are there.

Frames come from a pool of ``pool_trajectories`` rendered trajectories of
``frames_per_trajectory`` frames (``scenes.render``), made on the card
from the seed and staged in pinned host memory. Camera ``s`` at step ``k``
is at position ``q = k + s * offset_stride``: frame ``q % T`` of trajectory
``(q // T * streams + s) % pool``; its frame 0 resets the camera's state,
so resets fall on single elements of the batch, and with a pool of as many
trajectories as cameras or more, no two cameras run the same trajectory at
once. Step 0 resets every camera.

The check: a span of steps ``[k0, k0 + T + (streams - 1) * offset_stride)``,
``k0`` a multiple of T drawn from the seed past the warm-up, holds one
whole trajectory of every camera, from its reset to its last frame. Their
depth maps, as the timed path wrote them to host memory, are compared
after the window with the float32 reference run over the same steps
(``check.py`` says how).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from bench_gpu import flops, program, scenes, seeds, trace, weights
from bench_gpu.check import depth_error
from bench_gpu.reference.m4depth import stream_step
from bench_gpu.reference.ops import FLOAT32, Numerics, stated


class StreamCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, device
        self.b = traffic["streams"]
        self.h, self.w = traffic["height"], traffic["width"]
        self.T = traffic["frames_per_trajectory"]
        self.P = traffic["pool_trajectories"]
        self.off = [s * traffic["offset_stride"] for s in range(self.b)]
        self.period = self.T * self.P
        self.warm = self.T     # warm-up steps: one trajectory's length
        j = int(seeds.rng(seed, "check").integers(0, traffic["check_starts"]))
        self.k0 = self.warm + self.T * j
        self.n_span = self.T + max(self.off)
        self.k = 0
        self.spans = False     # the benchmark's spans: on when traced
        self._refs: Dict[Numerics, torch.Tensor] = {}

    def _span(self, name: str):
        return trace.span(name) if self.spans else contextlib.nullcontext()

    # -- set-up ------------------------------------------------------------

    def where(self, s: int, k: int):
        q = k + self.off[s]
        return (q // self.T * self.b + s) % self.P, q % self.T

    def make_pool(self) -> None:
        """Render the trajectories on the card, stage them in (pinned)
        host memory, and lay out every step's small inputs."""
        cuda = self.dev.type == "cuda"
        g = seeds.generator(self.dev, self.seed, "frames")
        shape = (self.P, self.T, self.h, self.w, 3)
        self.rgb = torch.empty(shape, pin_memory=cuda)
        rot = torch.empty((self.P, self.T, 4))
        trans = torch.empty((self.P, self.T, 3))
        for i in range(self.P):
            sc = scenes.render(1, self.T, self.h, self.w,
                               self.tr["motion"], g)
            if not bool((sc["depth"] > 0.5).all()):
                raise RuntimeError("a rendered trajectory left its plane")
            self.rgb[i].copy_(sc["rgb"][0])
            rot[i], trans[i] = sc["rot"][0].cpu(), sc["trans"][0].cpu()
            f, c = sc["camera_f"], sc["camera_c"]
        self.f = f.cpu().expand(self.b, 2).contiguous()
        self.c = c.cpu().expand(self.b, 2).contiguous()
        # the small inputs of each step of a period, and of step 0
        small_rot = torch.empty((self.period, self.b, 4))
        small_trans = torch.empty((self.period, self.b, 3))
        small_reset = torch.zeros((self.period, self.b), dtype=torch.bool)
        for k in range(self.period):
            for s in range(self.b):
                t, fr = self.where(s, k)
                small_rot[k, s], small_trans[k, s] = rot[t, fr], trans[t, fr]
                small_reset[k, s] = fr == 0
        self.small = [x.pin_memory() if cuda else x
                      for x in (small_rot, small_trans, small_reset)]
        self.all_reset = torch.ones(self.b, dtype=torch.bool)
        if cuda:
            self.all_reset = self.all_reset.pin_memory()
            torch.cuda.synchronize()

    def build(self) -> None:
        """The weights, the port's model and its compiled step, the state
        and the staging buffers; then warm-up (the step's eager first
        call, its capture, replays) over the first trajectory's steps."""
        cuda = self.dev.type == "cuda"
        params = weights.draw(self.cfg, self.seed, self.dev)
        self.model = program.build_model(self.cfg, params, self.dev)
        self.params = {k: v.cpu() for k, v in params.items()}
        del params
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.step_fn = program.compile_stream(self.model, self.dev)
        self.state = [program.init_state(self.model, self.b, self.h, self.w,
                                         self.dev)]
        self.cam = program.camera(self.f.to(self.dev), self.c.to(self.dev))
        self.x_rgb = torch.empty((self.b, self.h, self.w, 3), device=self.dev)
        self.x_rot = torch.empty((self.b, 4), device=self.dev)
        self.x_trans = torch.empty((self.b, 3), device=self.dev)
        self.x_reset = torch.empty((self.b,), dtype=torch.bool,
                                   device=self.dev)
        depth_shape = (self.b, self.h, self.w, 1)
        self.out_scratch = torch.empty(depth_shape, pin_memory=cuda)
        self.out_span = torch.empty((self.n_span,) + depth_shape,
                                    pin_memory=cuda)
        for _ in range(self.warm):
            self.frame()

    # -- one frame -----------------------------------------------------------

    def frame(self) -> float:
        """Step ``self.k``: copy in, replay, copy out, wait; its latency
        in seconds."""
        k, idx = self.k, self.k % self.period
        t0 = time.perf_counter()
        with self._span("copy_in"):
            for s in range(self.b):
                t, fr = self.where(s, k)
                self.x_rgb[s].copy_(self.rgb[t, fr], non_blocking=True)
            self.x_rot.copy_(self.small[0][idx], non_blocking=True)
            self.x_trans.copy_(self.small[1][idx], non_blocking=True)
            self.x_reset.copy_(self.all_reset if k == 0
                               else self.small[2][idx], non_blocking=True)
        with self._span("step"):
            self.state, depth = self.step_fn(
                self.state, self.x_rgb, self.x_rot, self.x_trans, self.cam,
                self.x_reset)
        with self._span("copy_out"):
            in_span = self.k0 <= k < self.k0 + self.n_span
            out = self.out_span[k - self.k0] if in_span else self.out_scratch
            out.copy_(depth, non_blocking=True)
        with self._span("wait"):
            if self.dev.type == "cuda":
                torch.cuda.current_stream(self.dev).synchronize()
        self.k += 1
        return time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        lat: List[float] = []
        ends: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self.frame())
            ends.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        print("steps a second: " + " ".join(
            str(n) for n in np.bincount(np.asarray(ends, int))), flush=True)
        ms = np.asarray(lat) * 1e3
        q = np.percentile(ms, [5, 25, 50, 75, 95, 99])
        print(f"window: {len(lat)} steps of {self.b} frames in {wall:.4f} s;"
              " frame ms p5/p25/median/p75/p95/p99 "
              f"{'/'.join(f'{x:.4f}' for x in q)}, max {ms.max():.4f}",
              flush=True)
        return dict(steps=len(lat), wall_s=wall,
                    frame_ms_p95=float(np.percentile(ms, 95)),
                    frames_per_s=len(lat) * self.b / wall)

    def profile(self, wall_s: float) -> trace.Trace:
        work = flops.serve_frame(self.cfg, self.b, self.h, self.w)
        self.spans = True
        return trace.profile(lambda i: self.frame(), self.tr["trace_steps"],
                             wall_s, work["flops"], work["cv_bound_s"])

    def finish_span(self) -> None:
        """Run on (untimed) until the check's span is complete."""
        while self.k < self.k0 + self.n_span:
            self.frame()

    def check_only(self) -> None:
        """Set up and run the checked span, with no window; free the
        program."""
        self.make_pool()
        self.build()
        self.finish_span()
        self.release()

    def release(self) -> None:
        """Free the program: its graph, pool, model and state."""
        del self.step_fn, self.model, self.state
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def first(self, s: int) -> int:
        """The span's step at which camera ``s`` resets."""
        return (-(self.k0 + self.off[s])) % self.T

    def reference_span(self, num: Numerics) -> torch.Tensor:
        """The reference's depth of every camera at every step of the span,
        run from no state at its first step (a camera is compared from its
        reset on): [span, b, h, w, 1] on the CPU."""
        p = {k: v.to(self.dev) for k, v in self.params.items()}
        f, c = self.f.to(self.dev), self.c.to(self.dev)
        state, out = None, []
        with torch.no_grad():
            for i in range(self.n_span):
                k = self.k0 + i
                rgb = torch.stack([self.rgb[self.where(s, k)]
                                   for s in range(self.b)]).to(self.dev)
                rot, trans, reset = (x[k % self.period].to(self.dev)
                                     for x in self.small)
                state, d = stream_step(p, self.cfg, state, rgb, rot, trans,
                                       f, c, reset, num)
                out.append(d.cpu())
        return torch.stack(out)

    def reference(self, num: Numerics) -> torch.Tensor:
        if num not in self._refs:
            self._refs[num] = self.reference_span(num)
        return self._refs[num]

    def trajectories(self, depths: torch.Tensor) -> List[torch.Tensor]:
        """Each camera's depths over its whole trajectory in the span."""
        return [depths[self.first(s):self.first(s) + self.T, s]
                for s in range(self.b)]

    def gaps(self, got: torch.Tensor) -> Dict[str, float]:
        """``got`` [span, b, h, w, 1] against the float32 reference, in
        units of the reference's own at the configuration's precision."""
        want = self.trajectories(self.reference(FLOAT32))
        err = depth_error(zip(self.trajectories(got), want))
        base = depth_error(zip(self.trajectories(
            self.reference(stated(self.cfg))), want))
        return dict(depth_err_ratio=err / base, depth_rel_p99=err,
                    depth_rel_p99_stated=base)

    def compare(self) -> Dict[str, float]:
        """The timed path's depths (as copied to host memory)."""
        return self.gaps(self.out_span)

    def control(self, num: Numerics) -> Dict[str, float]:
        """The reference computed at ``num`` in the program's place."""
        return self.gaps(self.reference(num))

    def faults(self) -> Dict[str, Dict[str, float]]:
        """Faults read on the card besides the control: none (the tests
        plant them at a small size)."""
        return {}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device: torch.device) -> dict:
    t0 = time.perf_counter()
    cell = StreamCell(cfg, traffic, seed, device)
    cell.make_pool()
    t1 = time.perf_counter()
    cell.build()
    out: Dict = dict(setup_done=time.perf_counter())
    print(f"set-up: frames {t1 - t0:.3f} s, model, compile and warm-up "
          f"{out['setup_done'] - t1:.3f} s", flush=True)
    res = cell.window(seconds)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    out["metrics"] = dict(frame_ms_p95=res["frame_ms_p95"],
                          frames_per_s=res["frames_per_s"],
                          peak_mem_mib=out["peak_bytes"] / 2 ** 20)
    out["attempted"] = res["steps"] * cell.b
    out["failed"] = 0
    if traced:
        out["trace"] = cell.profile(res["wall_s"] / res["steps"])
    cell.finish_span()
    cell.release()
    out["checks"] = cell.compare()
    return out


Cell = StreamCell

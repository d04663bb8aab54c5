"""The traced run's reduction (``trace.profile``) over what the port's
tracing (``m4depth_tpu_torch.utils.tracing``) puts in a profile: its stage
marks are kernels, device work like any other (the "elementwise" class);
its host spans are user annotations, which the profiler also draws on the
device's timeline and the reduction keeps out of device work, as it does
the benchmark's own spans. Fake profiler events go through ``profile``
with ``torch.profiler.profile`` stubbed, and the per-layer readers give the
values written here."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from bench_gpu import spec, trace
from m4depth_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[2]
UNITS, WALL_S = 2, 100e-6


def event(name, start, end, device=True):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def frame(t, marks):
    """One frame at ``t`` us: its host spans and the graph launch; on the
    device a conv (28 us) and an elementwise kernel (19 us), with or
    without the marks of ``encoder`` and ``end`` (1 us each) and the
    device-side range of the port's span."""
    span = tracing.SPAN_PREFIX + "serve.step"
    ev = [event("bench.step", t, t + 90, device=False),
          event(span, t + 1, t + 80, device=False),
          event("cudaGraphLaunch", t + 2, t + 6, device=False),
          event("sm90_xmma_fprop_implicit_gemm_bf16", t + 12, t + 40),
          event("void at::native::elementwise_kernel<128, 4>()", t + 41,
                t + 60)]
    if marks:
        ev += [event(f"void m4d_stage_mark<{tracing.STAGE_INDEX[s]}>()",
                     t + at, t + at + 1)
               for s, at in (("encoder", 10), ("end", 61))]
        ev.append(event(span, t + 3, t + 62))
    return ev


class FakeProfile:
    """``torch.profiler.profile`` that records nothing and gives
    ``events``."""

    def __init__(self, events):
        self._events = events

    def __call__(self, activities):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self._events


def readings(monkeypatch, events) -> dict:
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile(events))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    t = trace.profile(lambda i: None, UNITS, WALL_S, 1e9, 10e-6)
    with open(ROOT / "BENCHMARK.json") as fh:
        names = [m["name"] for m in json.load(fh)["per_layer"]]
    return {n: spec.reader(n)(t) for n in names}


@pytest.mark.parametrize("marks", [False, True])
def test_marks_are_device_work_and_spans_are_not(monkeypatch, marks):
    events = frame(0, marks) + frame(200, marks)
    got = readings(monkeypatch, events)
    mark_us = 2.0 if marks else 0.0
    want = {"conv_us": 28.0, "elementwise_us": 19.0 + mark_us,
            "host_launches": 1.0, "cv_roofline": None,
            "device_idle_pct": 100.0 * (1 - (47.0 + mark_us) * 1e-6
                                        / WALL_S),
            "mfu": 100.0 * 1e9 / WALL_S / 989e12}
    for name, value in got.items():
        expected = want[name.rsplit(".", 1)[0]]
        if expected is None:
            assert value is None, name
        else:
            assert value == pytest.approx(expected), name

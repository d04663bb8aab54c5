"""The port's profiling helpers (``m4depth_tpu_torch.utils.profiling``) on
the CPU: ``device_trace`` writes a trace; ``compiled_cost`` counts a
convolution as the JAX package's ``compiled_cost`` (XLA's cost analysis)
does, and a cost-volume call once, by its analytic work, forward and
backward; ``device_breakdown`` splits a trace's device time without
overlap by the stage marks of ``utils.tracing``, replays included."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.utils.profiling import compiled_cost as jax_compiled_cost
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.ops import (
    cost,
    parallax_sweeping_cv_fused,
    spatial_cost_volume_fused,
)
from m4depth_tpu_torch.utils import tracing
from m4depth_tpu_torch.utils.profiling import (
    compiled_cost,
    device_breakdown,
    device_trace,
)
from torch_inputs import dscv_inputs


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(None) as off:
        torch.ones(3).sum()
    assert off is None
    with device_trace(str(tmp_path)) as trace:
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    assert trace.path and trace.path.startswith(str(tmp_path))
    events = json.load(open(trace.path))["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_conv_cost_matches_jax():
    """A VALID 3x3 convolution (XLA leaves padded taps out of its count,
    FlopCounterMode does not, so no padding): the same flops (2 per
    multiply-add) and the same bytes (input, kernel, output once)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 12).astype(np.float32)
    ref = jax_compiled_cost(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    got = compiled_cost(torch.nn.functional.conv2d,
                        torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w).permute(3, 2, 0, 1))
    assert got["flops"] == ref["flops"] == 2 * 2 * 14 * 14 * 12 * 9 * 8
    assert got["convolution flops"] == got["flops"]
    assert got["bytes accessed"] == ref["bytes accessed"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cost_volume_counts_once_on_cpu(dtype):
    """The plain versions run many aten ops; the calls count only their
    analytic work, forward and backward, once each."""
    args = [torch.from_numpy(a) for a in dscv_inputs(cuts=2)]
    c1, c2, para, centre, rot, trans, f, c = args
    b, h, w, C = c1.shape
    es = torch.finfo(dtype).bits // 8
    sncv = cost.sncv_forward_work(b * h * w, C, 2, 3, es, True)
    sncv_b = cost.sncv_backward_work(b * h * w, C, 2, 3, es, True)
    dscv = cost.dscv_forward_work(b * h * w, C, 2, 4, es)
    dscv_b = cost.dscv_backward_work(b * h * w, C, 2, 4, es)

    def forward():
        spatial_cost_volume_fused(c1, c1, 3, 2, dtype)
        parallax_sweeping_cv_fused(c1, c2, para, centre, rot, trans,
                                   Camera(f, c), 4, 2, dtype)

    got = compiled_cost(forward)
    assert got["cost volume flops"] == got["flops"] == sncv[1] + dscv[1]
    assert got["cost volume bytes"] == got["bytes accessed"] \
        == sncv[0] + dscv[0]

    a = c1.clone().requires_grad_()
    g = torch.randn(b, h, w, 98)

    def both():
        spatial_cost_volume_fused(a, a, 3, 2, dtype).backward(g)

    with cost.counting() as count:
        both()
    assert dict(count.calls) == {"sncv_forward": 1, "sncv_backward": 1}
    got = compiled_cost(both)
    assert got["cost volume flops"] == got["flops"] == sncv[1] + sncv_b[1]
    assert got["cost volume bytes"] == sncv[0] + sncv_b[0]
    # beyond them only the gradient's accumulation into the leaf
    assert got["bytes accessed"] - got["cost volume bytes"] \
        <= 3 * a.numel() * 4 + g.numel() * 4
    assert dscv_b[1] > 0


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def X(name, cat, ts, dur, tid=1, pid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=pid,
                tid=tid, args=args)


def _replay(t, drop=()):
    """Chrome-trace events of one replay at ``t`` us, on stream 7 but a
    cost-volume kernel inside a conv on stream 8: a copy in, the marks of
    ``encoder``, ``glue``, ``refiner1``, ``glue1`` and ``end`` (those in
    ``drop`` left out), kernels between them, a copy out; and the host's
    span, which the profiler also draws on the device's timeline."""
    def mark(stage, at):
        return X(f"void m4d_stage_mark<{tracing.STAGE_INDEX[stage]}>()",
                 "kernel", t + at, 1, pid=0, tid=7)

    ev = [X("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t, 5, pid=0,
            tid=7),
          mark("encoder", 10), X("conv_a", "kernel", t + 12, 20, pid=0,
                                 tid=7),
          mark("glue", 40), X("dscv_forward_kernel", "kernel", t + 42, 10,
                              pid=0, tid=7),
          mark("refiner1", 60), X("conv_b", "kernel", t + 62, 30, pid=0,
                                  tid=7),
          X("void (anonymous namespace)::sncv_forward_kernel<__half, 8, 3>",
            "kernel", t + 70, 10, pid=0, tid=8),
          mark("glue1", 100), X("elementwise", "kernel", t + 102, 8, pid=0,
                                tid=7),
          mark("end", 120),
          X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 130, 4,
            pid=0, tid=7),
          X("m4d#compiled.launch", "gpu_user_annotation", t, 134, pid=0,
            tid=7),
          X("m4d#compiled.launch", "user_annotation", t - 20, 30),
          X("cudaGraphLaunch", "cuda_runtime", t - 15, 10)]
    return [e for e in ev if not any(
        e["name"].endswith(f"<{tracing.STAGE_INDEX[d]}>()") for d in drop)]


def test_device_breakdown_attributes_without_overlap(tmp_path):
    """Each device event takes the stage of the latest mark before it
    (``unmarked`` before the first, ``outside`` after an ``end``: the
    copies between replays); a kernel inside another (on another stream)
    counts only where it is the innermost; the stages sum to the busy
    time. Over three replays, the third without its ``glue`` mark (its
    cost volume then falls in ``encoder``), two are complete units, whose
    stage spans run mark to mark."""
    events = _replay(0) + _replay(200) + _replay(400, drop=("glue",))
    r = device_breakdown(_trace(tmp_path, events[::-1]), n=1)
    assert r["n_events"] == 3 * 12 - 1
    assert r["groups"] == {"unmarked": 5.0, "outside": 22.0,
                           "encoder": 73.0, "glue": 22.0,
                           "refiner1": 93.0, "glue1": 27.0, "end": 3.0}
    assert r["busy_us"] == sum(r["groups"].values()) == 245.0
    assert r["ops"][("conv_b", "refiner1")] == 60.0
    assert r["ops"][("dscv_forward_kernel", "encoder")] == 10.0
    u = r["units"]
    assert (u["complete"], u["seen"]) == (2, 3)
    assert u["stages"]["encoder"] == (30.0, 21.0)
    assert u["span_us"] == 111.0 and u["busy_us"] == 73.0
    third = device_breakdown(_trace(tmp_path, events), n=3)
    assert third["busy_us"] == pytest.approx(245.0 / 3)

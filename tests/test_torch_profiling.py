"""The port's profiling helpers (``m4depth_tpu_torch.utils.profiling``) on
the CPU: ``device_trace`` writes a trace; ``compiled_cost`` counts a
convolution as the JAX package's ``compiled_cost`` (XLA's cost analysis)
does, and a cost-volume call once, by its analytic work, forward and
backward; ``device_breakdown`` splits a trace's device time without
overlap by direction and component."""

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


def test_device_breakdown_attributes_without_overlap(tmp_path):
    """Forward launches take their module's component, the cost-volume
    kernels theirs by name; a launch inside a backward node takes the
    component of the forward op with the node's sequence number; a
    kernel inside another (or overlapping it on another stream) counts
    only where it is the innermost; the groups sum to the busy time."""
    host = [
        X("nn.Module: Encoder_0", "python_function", 0, 100),
        X("aten::convolution", "cpu_op", 10, 20, **{"Sequence number": 1}),
        X("cudaLaunchKernel", "cuda_runtime", 15, 2, correlation=11),
        X("nn.Module: DispRefiner_0", "python_function", 100, 100),
        X("aten::convolution", "cpu_op", 110, 20, **{"Sequence number": 2}),
        X("cudaLaunchKernel", "cuda_runtime", 115, 2, correlation=12),
        X("cudaLaunchKernel", "cuda_runtime", 150, 2, correlation=13),
        # the backward thread's node, whose own event (listed first, out of
        # the module) carries the sequence number too
        X("autograd::engine::evaluate_function: ConvolutionBackward0",
          "cpu_op", 300, 50, tid=2, **{"Sequence number": 2}),
        X("ConvolutionBackward0", "cpu_op", 301, 48, tid=2,
          **{"Sequence number": 2}),
        X("cudaLaunchKernel", "cuda_runtime", 310, 2, tid=2, correlation=14),
    ]
    dev = [
        X("cudnn_conv_a", "kernel", 20, 30, pid=0, tid=7, correlation=11),
        X("cudnn_conv_b", "kernel", 120, 40, pid=0, tid=7, correlation=12),
        # on another stream, inside conv_b: it takes 10 us of conv_b's 40
        X("void (anonymous namespace)::sncv_forward_kernel<__half, 8, 3>",
          "kernel", 130, 10, pid=0, tid=8, correlation=13),
        X("cudnn_conv_dgrad", "kernel", 320, 25, pid=0, tid=7,
          correlation=14),
    ]
    r = device_breakdown(_trace(tmp_path, host[7:] + host[:7] + dev), n=1)
    assert r["n_events"] == 4
    assert r["groups"] == {("fwd", "encoder"): 30.0,
                           ("fwd", "refiner"): 30.0,
                           ("fwd", "sncv"): 10.0,
                           ("bwd", "refiner"): 25.0}
    assert r["busy_us"] == sum(r["groups"].values()) == 95.0
    assert r["ops"][("cudnn_conv_b", "aten::convolution")] == 30.0
    half = device_breakdown(_trace(tmp_path, host + dev), n=2)
    assert half["busy_us"] == 47.5

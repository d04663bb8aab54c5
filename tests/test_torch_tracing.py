"""The port's tracing instruments (``m4depth_tpu_torch/utils/tracing.py``)
on the CPU: stage marks do nothing here; the host spans of the serving and
training steps land in a CPU ``torch.profiler`` run, nested as the steps
open them, and outside a profiler make no ``RecordFunction``; the counters
keep warm-up and capture calls out of a replay's mean (a fake clock and a
fake graph drive ``Compiled``'s card path); a profile's marks reduce to
units whose stages sum to their span, a unit with a dropped mark left out.

The card's side (the marks of one replay's profile, in stage order) is in
``tests/test_torch_cuda.py``.
"""

import collections
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, init_state
from m4depth_tpu_torch.parallel import sharded_stream
from m4depth_tpu_torch.testing import train_batch
from m4depth_tpu_torch.train import compile_train_step, make_optimizer
from m4depth_tpu_torch.utils import graphs, tracing

D2 = dict(num_levels=2, encoder_channels=(8, 12),
          refiner_prep_channels=(16, 16, 8), refiner_est_channels=(8, 8, 5),
          compute_dtype="float32", cv_dtype="float32")
CPU = torch.device("cpu")
ROT = [1.0, 0.001, -0.002, 0.001]
TRANS = [0.3, 0.1, 0.02]


def test_stage_table_matches_the_mark_kernel():
    """``mark.cu`` instantiates one kernel a stage of ``STAGES``, and a
    mark's name as the profiler gives it reads back as its stage."""
    src = (Path(tracing.__file__).parents[1] / "ops" / "csrc"
           / "mark.cu").read_text()
    assert int(re.search(r"kStages = (\d+);", src).group(1)) \
        == len(tracing.STAGES)
    assert len(set(tracing.STAGES)) == len(tracing.STAGES)
    for i, stage in enumerate(tracing.STAGES):
        assert tracing.mark_stage(f"void m4d_stage_mark<{i}>()") == stage
    assert tracing.mark_stage("void sncv_forward_kernel<float, 4>()") is None
    assert tracing.stage_of_level("refiner3") == (3, "refiner")
    assert tracing.stage_of_level("glue") == (None, "glue")


def test_marks_are_no_ops_on_the_cpu():
    """On the CPU a mark launches nothing, also while a profiler records,
    and the model's step gives the same depth under a profiler."""
    model = M4Depth(ModelConfig(**D2), device=CPU, seed=1)
    g = torch.Generator().manual_seed(0)
    rgb = torch.rand((1, 32, 32, 3), generator=g)
    args = (torch.tensor([ROT]), torch.tensor([TRANS]),
            Camera(torch.full((1, 2), 16.0), torch.full((1, 2), 16.0)),
            torch.tensor([True]))
    _, want = model.step(init_state(model.cfg, 1, 32, 32, device=CPU), rgb,
                         *args)
    before = tracing.mark_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for stage in tracing.STAGES:
            assert tracing.mark(stage, CPU) is None
        _, got = model.step(init_state(model.cfg, 1, 32, 32, device=CPU),
                            rgb, *args)
    assert torch.equal(got, want)
    assert tracing.mark_launches() == before
    assert not [e for e in prof.events() if "m4d_stage_mark" in e.name]


def _spans(prof):
    """The profile's ``m4d#`` host spans: [(name, start, end, thread)]."""
    return [(e.name[len(tracing.SPAN_PREFIX):], e.time_range.start,
             e.time_range.end, e.thread) for e in prof.events()
            if e.name.startswith(tracing.SPAN_PREFIX)
            and e.device_type == torch.autograd.DeviceType.CPU]


def _assert_nested(spans, outer: str, inner: str, calls: int):
    """Each of ``calls`` ``outer`` spans holds an ``inner`` span."""
    outers = [s for s in spans if s[0] == outer]
    inners = [s for s in spans if s[0] == inner]
    assert len(outers) == calls, (outer, spans)
    for _, s, e, t in outers:
        assert any(s <= s2 and e2 <= e and t2 == t
                   for _, s2, e2, t2 in inners), (outer, inner)


def test_spans_nest_in_the_serving_and_training_steps():
    """A CPU profile of ``sharded_stream``'s step and of
    ``compile_train_step``'s holds the ``m4d#`` spans: ``serve.step``
    around ``serve.shard`` around ``compiled.signature``; ``train.step``
    around ``train.augment`` and ``compiled.signature``."""
    torch.manual_seed(0)
    model = M4Depth(ModelConfig(**D2), device=CPU, seed=2)
    step = sharded_stream(model, [CPU])
    state = [init_state(model.cfg, 2, 32, 32, device=CPU)]
    rgb = torch.rand((2, 32, 32, 3))
    rot, trans = torch.tensor([ROT] * 2), torch.tensor([TRANS] * 2)
    cam = Camera(torch.full((2, 2), 16.0), torch.full((2, 2), 16.0))
    train = compile_train_step(
        model, make_optimizer(model, TrainConfig(learning_rate=1e-4)),
        augment_fn=lambda batch, seed, count: batch)
    batch = train_batch(1, 2, 32, 0, ROT, TRANS, CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            state, _ = step(state, rgb, rot, trans, cam,
                            torch.tensor([i == 0, False]))
        train(batch)
    spans = _spans(prof)
    _assert_nested(spans, "serve.step", "serve.shard", 2)
    _assert_nested(spans, "serve.shard", "compiled.signature", 2)
    _assert_nested(spans, "train.step", "train.augment", 1)
    _assert_nested(spans, "train.step", "compiled.signature", 1)
    # the CPU runs the bodies: no graph was warmed, captured or replayed
    assert not {n for n, *_ in spans} & {"compiled.warm_up",
                                         "compiled.capture",
                                         "compiled.launch"}


def test_a_span_outside_a_profiler_makes_no_record_function(monkeypatch):
    made = []

    def record(name):
        made.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(tracing, "record_function", record)
    with tracing.span("serve.step") as off:
        pass
    assert off is None and made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("serve.step"):
            pass
    assert made == ["m4d#serve.step"]


class FakeClock:
    """``tracing.clock``: ns that advance only when told."""

    def __init__(self):
        self.ns = 0

    def __call__(self) -> int:
        return self.ns

    def advance(self, ns: int) -> None:
        self.ns += ns


class FakeGraph:
    """A captured graph whose replay takes ``LAUNCH_NS`` on the clock."""

    def __init__(self, clock):
        self.clock = clock

    def replay(self):
        self.clock.advance(LAUNCH_NS)


LAUNCH_NS, WARM_NS, CAPTURE_NS = 100, 5_000, 7_000


@pytest.fixture
def fake_card(monkeypatch):
    """``Compiled``'s card path on the CPU: the signature names a CUDA
    device, the warm-up and the capture take fixed times on a fake clock,
    the graph's replay ``LAUNCH_NS``, and the counters start empty."""
    clock = FakeClock()
    monkeypatch.setattr(tracing, "clock", clock)
    monkeypatch.setattr(tracing, "COUNTERS", tracing.Counters())
    real = graphs._signature
    monkeypatch.setattr(graphs, "_signature", lambda leaves: (
        real(leaves)[0], torch.device("cuda", 0)))

    def warm_up(self, args, device):
        clock.advance(WARM_NS)
        return self.fn(*args)

    def capture(self, leaves, spec, device):
        clock.advance(CAPTURE_NS)
        out, out_spec = graphs.tree_flatten(
            self.fn(*graphs.tree_unflatten(leaves, spec)))
        return graphs._Graph(FakeGraph(clock), list(leaves), out, out_spec,
                             collections.Counter())

    monkeypatch.setattr(graphs.Compiled, "_warm_up", warm_up)
    monkeypatch.setattr(graphs.Compiled, "_capture", capture)
    return clock


def test_counters_keep_warmups_and_captures_out_of_replay_means(fake_card):
    """Four calls of one signature: a warm-up, a capture (which replays
    once), two replays. Only the two replays count in
    ``compiled.replays``, their launch part exactly the graph's time; the
    warm-up and the capture count apart with their own time."""
    fn = graphs.Compiled(lambda x: x * 2)
    x = torch.ones(3)
    kinds = []
    for _ in range(4):
        fn(x)
        kinds.append(fn.replayed)
    assert kinds == [False, False, True, True]
    c = tracing.counters()
    assert c["compiled.warmups"] == dict(calls=1, ns=WARM_NS)
    assert c["compiled.captures"] == dict(calls=1,
                                          ns=CAPTURE_NS + LAUNCH_NS)
    r = c["compiled.replays"]
    assert r["calls"] == 2 and r["launch_ns"] == 2 * LAUNCH_NS
    assert r["prepare_ns"] == r["finish_ns"] == 0
    assert r["ns"] == r["prepare_ns"] + r["launch_ns"] + r["finish_ns"]
    assert tracing.mean_us(c, "compiled.replays", key="launch_ns") \
        == LAUNCH_NS / 1e3
    assert tracing.mean_us(c, "compiled.replays", before=c) is None


def test_serve_step_counts_only_replaying_calls(fake_card, monkeypatch):
    """``sharded_stream``'s step counts in ``serve.step`` only the calls in
    which its replica replayed: not the warm-up's, not the capture's."""

    def fake_model_step(state, rgb, rot, trans, camera, new_traj):
        fake_card.advance(10)
        return state, rgb[..., :1] * 2

    model = M4Depth(ModelConfig(**D2), device=CPU, seed=3)
    monkeypatch.setattr(model, "step", fake_model_step)
    step = sharded_stream(model, [CPU])
    state = [init_state(model.cfg, 1, 32, 32, device=CPU)]
    args = (torch.rand((1, 32, 32, 3)), torch.tensor([ROT]),
            torch.tensor([TRANS]),
            Camera(torch.full((1, 2), 16.0), torch.full((1, 2), 16.0)),
            torch.tensor([False]))
    for _ in range(5):
        state, _ = step(state, *args)
    c = tracing.counters()
    assert c["serve.step"]["calls"] == c["compiled.replays"]["calls"] == 3
    assert c["serve.step"]["ns"] == 3 * LAUNCH_NS


def _unit(t, drop=()):
    """Device events of one replay at ``t`` us: a copy in, the encoder,
    the decoder's start, level 1's refiner (a cost-volume kernel inside a
    conv, on another stream) and glue, ``end``, a copy out; the marks in
    ``drop`` left out."""
    def mk(stage, at):
        return (f"void m4d_stage_mark<{tracing.STAGE_INDEX[stage]}>()",
                t + at, t + at + 1)

    ev = [("Memcpy HtoD", t, t + 5), mk("encoder", 10),
          ("conv_a", t + 12, t + 32), mk("glue", 40),
          ("dscv_forward_kernel", t + 42, t + 52), mk("refiner1", 60),
          ("conv_b", t + 62, t + 92), ("sncv_forward_kernel", t + 70, t + 80),
          mk("glue1", 100), ("elementwise", t + 102, t + 110),
          mk("end", 120), ("Memcpy DtoH", t + 130, t + 134)]
    return [e for e in ev if not any(
        e[0].endswith(f"<{tracing.STAGE_INDEX[d]}>()") for d in drop)]


def test_units_read_stages_and_leave_out_a_unit_with_a_dropped_mark():
    """Three replays, the third without its ``glue`` mark: two complete
    units, each stage spanning mark to mark, the spans summing to the
    unit's span (first mark to ``end``'s end) and the busy times to the
    device time inside it; the summary reads the complete ones."""
    events = _unit(0) + _unit(200) + _unit(400, drop=("glue",))
    found = tracing.units(events)
    assert [u.complete for u in found] == [True, True, False]
    u = found[0]
    assert u.stages == [("encoder", 30, 21), ("glue", 20, 11),
                        ("refiner1", 40, 31), ("glue1", 20, 9),
                        ("end", 1, 1)]
    assert u.span_us == sum(sp for _, sp, _ in u.stages) == 111
    assert u.busy_us == 73
    s = tracing.summarize(found)
    assert (s["complete"], s["seen"]) == (2, 3)
    assert s["stages"]["refiner1"] == (40, 31)
    assert s["gap_pct"] == pytest.approx(100 * (1 - 73 / 111))
    # told the sequence, the reduction needs no majority
    want = ("encoder", "refiner1", "glue1", "end")
    assert [u.complete for u in tracing.units(events, want)] \
        == [False, False, True]
    assert tracing.summarize([])["complete"] == 0
    # marks after the last end make no unit
    assert len(tracing.units(_unit(0) + _unit(200, drop=("end",)))) == 1

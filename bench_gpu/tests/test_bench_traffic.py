"""The traffic and the weights are functions of the seed: one seed gives the
same inputs twice, another seed other ones, and seeds past 32 bits are
taken."""

import pytest
import torch

from bench_gpu import spec, weights
from bench_gpu.tests.small import CPU, small_cell

BIG = 2 ** 31 + 12345


def inputs(name, seed):
    cell = small_cell(name)
    drv = spec.driver(cell.traffic["kind"])
    if cell.traffic["kind"] == "stream":
        c = drv.Cell(cell.config, cell.traffic, seed, CPU)
        c.make_pool()
        out = dict(rgb=c.rgb, rot=c.small[0], trans=c.small[1],
                   reset=c.small[2], f=c.f, k0=torch.tensor(c.k0))
    else:
        c = drv.Cell(cell.config, cell.traffic, seed, CPU)
        c.make_pool()
        out = {f"{k}{i}": v for i, w in enumerate(c.pool)
               for k, v in w.items()}
    out.update({f"w.{k}": v for k, v in
                weights.draw(cell.config, seed, CPU).items()})
    return out


@pytest.mark.parametrize("name", ["d6-stream1", "d6-train-b3t4",
                                  "v1-stream8"])
def test_same_seed_same_inputs_other_seed_others(name):
    a, b, c = inputs(name, BIG), inputs(name, BIG), inputs(name, BIG + 1)
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    differ = [k for k in a if not torch.equal(a[k], c[k])]
    assert any(k.startswith("rgb") for k in differ)
    assert any(k.startswith("w.") for k in differ)


def test_frames_are_in_range_and_depth_positive():
    cell = small_cell("d6-train-b3t4")
    c = spec.driver("train").Cell(cell.config, cell.traffic, 5, CPU)
    c.make_pool()
    for w in c.pool:
        assert 0.0 < w["rgb"].min() and w["rgb"].max() < 1.0
        assert w["depth"].min() > 0.5
        q = w["rot"].norm(dim=-1)
        torch.testing.assert_close(q, torch.ones_like(q))


@pytest.mark.parametrize("seed", [1, BIG])
def test_each_camera_of_the_check_runs_its_own_trajectory(seed):
    cell = spec.load_cell("v1-stream8")
    c = spec.driver("stream").Cell(cell.config, cell.traffic, seed, CPU)
    runs = [c.where(s, c.k0 + c.first(s)) for s in range(c.b)]
    assert all(frame == 0 for _, frame in runs)
    assert len({traj for traj, _ in runs}) == c.b
    for s in range(c.b):
        traj = runs[s][0]
        assert all(c.where(s, c.k0 + c.first(s) + i) == (traj, i)
                   for i in range(c.T))

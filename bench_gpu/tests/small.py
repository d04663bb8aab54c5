"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: three
levels, 64x64 frames, short trajectories. Only the tests use it."""

from __future__ import annotations

import torch

from bench_gpu import spec

CPU = torch.device("cpu")


def small_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config.update(num_levels=3)
    cell.traffic.update(height=64, width=64)
    if cell.traffic["kind"] == "stream":
        cell.traffic.update(frames_per_trajectory=8, offset_stride=2,
                            check_starts=2, pool_trajectories=max(
                                2, cell.traffic["streams"]))
    else:
        cell.traffic.update(pool_windows=3)
    return cell

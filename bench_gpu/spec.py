"""What a cell is, read from files by name: its entry in ``BENCHMARK.json``
(configuration, traffic, chips), ``configs/<config>.json`` (the model),
``traffic/<traffic>.json`` (the mix: its kind and parameters),
``workloads/<cell>.json`` (the limits of its correctness check, with the
readings they were set from), and, for each metric the cell reports, its
reader ``metrics/<metric>.py``. Adding a cell, a configuration, a mix or
a metric adds files and entries; no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]          # the BENCHMARK.json entries it reports
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reported(metrics: List[dict], cell: str, e2e: set) -> List[dict]:
    """The metrics a cell reports: those that list it under ``workloads``,
    and those without the key whose end-to-end metric it reports (an
    end-to-end metric without the key: every cell)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in e2e:
            out.append(m)
    return out


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    base = root / "bench_gpu"
    e2e = _reported(bench["end_to_end"], name, set())
    per_layer = _reported(bench["per_layer"], name, {m["name"] for m in e2e})
    return Cell(name=name, chips=entry["chips"],
                config=_load_json(base / "configs" / f"{entry['config']}.json"),
                traffic=_load_json(base / "traffic"
                                   / f"{entry['traffic']}.json"),
                limits=_load_json(base / "workloads" / f"{name}.json")
                ["limits"],
                end_to_end=e2e, per_layer=per_layer)


def driver(kind: str):
    """The traffic driver of a mix's ``kind``: ``traffic/<kind>.py``."""
    return importlib.import_module(f"bench_gpu.traffic.{kind}")


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(trace)`` of ``metrics/<metric>.py`` (the name may hold dots,
    so the file is loaded by its path)."""
    path = root / "bench_gpu" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_gpu.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

"""The harness is driven by data: a cell, a configuration, a traffic mix and
a per-layer metric added as files and ``BENCHMARK.json`` entries are found
by name; and ``BENCHMARK.json`` keeps the benchmark contract's shapes."""

import json
import re
import shutil
from pathlib import Path

import pytest

from bench_gpu import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture
def bench():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def test_a_new_cell_config_mix_and_metric_are_found(tmp_path, bench):
    shutil.copytree(ROOT / "bench_gpu", tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "bench_gpu"
    cfg = json.loads((base / "configs" / "m4depth-d6.json").read_text())
    cfg["cv_dtype"] = "float16"
    (base / "configs" / "m4depth-d6-f16cv.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "stream-b1.json").read_text())
    mix["streams"] = 2
    (base / "traffic" / "stream-b2.json").write_text(json.dumps(mix))
    (base / "workloads" / "d6f16-stream2.json").write_text(json.dumps(
        {"limits": {"depth_rel_median": 0.5}}))
    (base / "metrics" / "busy_us.serve.py").write_text(
        "def read(t):\n    return 1e6 * t.busy_s\n")
    bench["configs"].append(dict(name="m4depth-d6-f16cv", source="x",
                                 file="bench_gpu/configs/m4depth-d6-f16cv"
                                 ".json", reduced=[], why="x"))
    bench["workloads"].append(dict(name="d6f16-stream2",
                                   config="m4depth-d6-f16cv",
                                   traffic="stream-b2", chips=1, why="x"))
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms_p95", "frames_per_s"):
            m["workloads"].append("d6f16-stream2")
    bench["per_layer"].append(dict(name="busy_us.serve", unit="us/frame",
                                   better="lower", source="device_trace",
                                   layer="device", moves="frame_ms_p95"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("d6f16-stream2", root=tmp_path)
    assert cell.config["cv_dtype"] == "float16"
    assert cell.traffic["streams"] == 2
    assert cell.limits == {"depth_rel_median": 0.5}
    assert {m["name"] for m in cell.end_to_end} == {
        "frame_ms_p95", "frames_per_s", "peak_mem_mib", "setup_s"}
    # a metric without "workloads" is reported wherever its end-to-end
    # metric is; those that list cells are not reported in a new one
    assert [m["name"] for m in cell.per_layer] == ["busy_us.serve"]
    assert spec.load_cell("d6-stream1", root=tmp_path).per_layer[-1][
        "name"] == "busy_us.serve"
    read = spec.reader("busy_us.serve", root=tmp_path)
    assert read(type("T", (), {"busy_s": 2e-3})()) == pytest.approx(2e3)
    assert spec.driver(cell.traffic["kind"]).run
    assert spec.driver(cell.traffic["kind"]).Cell


def test_every_cell_of_the_benchmark_loads(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        drv = spec.driver(cell.traffic["kind"])
        assert drv.run and drv.Cell
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and cell.limits
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in names


def test_names_units_and_keys_keep_the_contract(bench):
    assert set(bench) == TOP_KEYS
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("bench_gpu/") and (ROOT / c["file"]
                                                       ).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert configs == {w["config"] for w in bench["workloads"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024

"""``run.py`` end to end on a tiny model through the kernels' CPU paths, and
``BENCHMARK.json`` against the files the harness finds by name."""

import os
import re

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT, bench_json, tiny_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_batch_cell_end_to_end():
    spec = tiny_spec("distil-large-v3.batch32")
    line = run.run_workload(spec, 2**31 + 7, 1.0, False, "cpu")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 2 * spec["mix"]["rows"] and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s", "peak_mem_gib", "setup_s"}
    assert line["metrics"]["audio_s_per_s"]["value"] > 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["rows_short"]["value"] == 0
    assert line["judged_tokens"] > 0


def test_live_cell_end_to_end():
    spec = tiny_spec("distil-large-v3.live", streams=2, max_streams=2, check_rows=1)
    line = run.run_workload(spec, 5, 20.0, False, "cpu")
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"lat_p95_ms", "lat_p50_ms", "peak_mem_gib", "setup_s"}
    assert line["metrics"]["lat_p50_ms"]["value"] <= line["metrics"]["lat_p95_ms"]["value"]
    assert line["checks"]["audio_drops"]["value"] == 0
    assert line["stream_windows"] > 0 and line["feeder_late_ms"]["max"] >= 0


def test_per_layer_readers_find_nothing_without_a_trace():
    spec = tiny_spec("distil-large-v3.batch32")
    line = run.run_workload(spec, 3, 0.5, True, "cpu")
    # No device trace on the CPU: the trace readers leave their metrics out.
    assert set(line["metrics"]) == {"dispatch_ms.batch", "mfu.batch"}
    assert "trace_kernels" not in line


def test_benchmark_json_contract():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cfgs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in cfgs and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for name in cfgs | cells:
        assert NAME.match(name)
    # Every cell reports setup_s, another end-to-end metric and a per-layer one.
    for cell in cells:
        mine = lambda m: cell in m.get("workloads", [cell])
        assert len([m for m in b["end_to_end"] if mine(m)]) >= 2
        assert any(mine(m) for m in b["per_layer"])


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        run.load_spec(ROOT, "no-such-cell")

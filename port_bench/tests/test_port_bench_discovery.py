"""BENCHMARK.json against the files the harness finds by name, and the
contract's limits on its entries."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _run_module():
    spec = importlib.util.spec_from_file_location("port_bench_run", ROOT / "port_bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"} and NAME.match(conf["name"])
    path = ROOT / conf["file"]
    assert conf["file"].startswith("port_bench/") and path.exists()
    data = json.loads(path.read_text())
    assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"]
    assert all(k in data and NAME.match(k) for k in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and NAME.match(cell["name"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert (ROOT / "port_bench" / "traffic" / f"{cell['traffic']}.json").exists()
    limits = json.loads((ROOT / "port_bench" / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    run = _run_module()
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = run.cell_metrics(BENCH, cell["name"], True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = ROOT / "port_bench" / "metrics" / f"{metric['name']}.py"
    assert path.exists()
    assert callable(getattr(_run_module().__dict__.get("read_metric"), "__call__", None))
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_metric_selection_by_trace_flag():
    run = _run_module()
    tum = "tum_rgbd_dsp.shapes"
    assert {m["name"] for m in run.cell_metrics(BENCH, tum, False)} == {"frame_ms", "shape_frame_ms", "setup_s"}
    assert "k1_roofline_pct" in {m["name"] for m in run.cell_metrics(BENCH, tum, True)}

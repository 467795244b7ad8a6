"""The readers of the program's own spans and counters against a tiny run
of the cell on the CPU: each gives a value, in its range, and where the
program has no tracer (the parent of the change that added it) each gives
None without raising."""

import json
from pathlib import Path

import pytest

from port_bench_tiny import tiny_run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["track_features_ms", "track_search_ms", "track_pose_ms", "pose_lm_iters", "host_reads_per_frame",
                "local_ba_trips", "object_planes_ms", "object_fit_ms", "object_refine_ms", "shape_gather_ms",
                "shape_trip_ms", "shape_jacobian_pct"]


def _read(name, run):
    from port_bench.run import read_metric

    return read_metric(name, run)


@pytest.fixture(scope="module")
def run():
    return tiny_run("tum_rgbd_dsp.shapes")


def test_every_span_metric_is_declared_for_the_cell():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        m = declared[name]
        assert m["source"] == "program_span" and m["workloads"] == ["tum_rgbd_dsp.shapes"], name


def test_the_span_readers_read_the_tiny_cell(run):
    got = {name: _read(name, run) for name in SPAN_METRICS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["pose_lm_iters"] <= 40 and got["local_ba_trips"] <= 15
    assert got["shape_jacobian_pct"] < 100
    # the stages lie inside the frame's tracking span
    track = _read("track_ms", run)
    assert got["track_features_ms"] + got["track_search_ms"] + got["track_pose_ms"] <= track


def test_the_readers_find_nothing_without_the_programs_tracer(run, monkeypatch):
    from qsp_slam_tpu_torch.utils import tracing

    monkeypatch.delattr(tracing, "TRACER")
    assert all(_read(name, run) is None for name in SPAN_METRICS)
    assert all(_read(name, dict(run, span_rows=[])) is None for name in SPAN_METRICS)

"""Both cells' control flow at a tiny size on the CPU through the
program's plain kernel versions: set-up through the first shape step,
a window of whole shape periods, the comparison, and every reader."""

import json
from pathlib import Path

import pytest

from port_bench_tiny import tiny_run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _read(name, run):
    from port_bench.run import read_metric

    return read_metric(name, run)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_tiny_run_of_each_cell(workload):
    run = tiny_run(workload)
    assert run["periods"] >= 3 and run["attempted"] == len(run["window"])
    assert sum(r["shape_steps"] for r in run["window"]) == run["periods"]
    assert run["window"][-1]["shape_steps"]  # the window ends on a shape step
    assert run["numbers"]["k1_calls"] == 3 and run["numbers"]["k2_calls"] >= 3
    assert run["correct"], {k: (run["numbers"].get(k), v) for k, v in run["limits"].items()}
    for m in BENCH["end_to_end"]:
        assert _read(m["name"], run) > 0
    run["trace"] = None  # no profiler on the CPU: the trace readers find nothing
    for m in BENCH["per_layer"]:
        if workload not in m["workloads"]:
            continue
        v = _read(m["name"], run)
        assert v is None or v > 0, m["name"]
    assert _read("shape_step_ms", run) > 0 and _read("track_ms", run) > 0

#!/usr/bin/env python3
"""The benchmark of qsp_slam_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints the card's name and power limit, the window's periods,
frames, keyframes and shape steps, every number of the comparison beside
its limit (the last lines of standard error), and, as the last line of
standard output, one JSON object: `correct`, `attempted` (the window's
frames), `failed` (frames the system lost), `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` a `breakdown`, and `checks`.
Exits non-zero, printing no result, without a card, with fewer cards
than the cell asks for, without the program, or when JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qsp_slam_tpu")
T0 = time.perf_counter()  # set-up runs from here: before torch is imported

# Every cache of the program and its libraries lives at a fixed path inside
# the checkout, so only a checkout's first run builds and compiles.
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metric(name: str, run: dict):
    path = ROOT / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("port_bench.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The end-to-end metrics this cell reports, or with `trace` its
    per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power.limit not read (nvidia-smi failed)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.exists() or importlib.util.find_spec("qsp_slam_tpu_torch") is None:
        print("the checkout lacks BENCHMARK.json or the program qsp_slam_tpu_torch", file=sys.stderr)
        return 3
    bench = json.loads(bench_file.read_text())
    cell_entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell_entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 3

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_entry["chips"]:
        print(f"the cell needs {cell_entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, {torch.cuda.device_count()} visible, {cell_entry['chips']} used; nvidia-smi: "
          f"{card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr, flush=True)

    from port_bench.harness import cell as cell_mod

    run = cell_mod.run(cell_mod.load_cell(args.workload, bench), args.seed, args.seconds, bool(args.trace),
                       t_start=T0)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark must not load JAX or the JAX package", file=sys.stderr)
        return 4

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell_entry["chips"],
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    result = {"correct": bool(run["correct"]), "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        t = run["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    nums, limits = run["numbers"], run["limits"]
    print(f"reference took {run['reference_s']:.3f} s; numbers not compared: "
          + ", ".join(f"{k} {v}" for k, v in nums.items() if k not in limits), file=sys.stderr)
    result["checks"] = {k: {"value": nums.get(k), "limit": v} for k, v in limits.items()}
    for k, v in limits.items():
        print(f"check {k}: {nums.get(k)} (limit {v})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder: the harness is the package port_bench
    sys.exit(main())

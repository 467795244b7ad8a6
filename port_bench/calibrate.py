#!/usr/bin/env python3
"""Readings for the limits of `correct` and a rehearsal of a cell, many
seeds in one process on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds S1,S2,... [--control-seeds C1,...]
        [--seconds S] [--out FILE]

For each seed, one run of the cell as `run.py` makes it (the same set-up,
window and comparison), then, for each control seed, the same run with
the program's TF32 path switched on (TF32 matmuls and cuDNN: the nearest
precision below the configuration's float32), which the comparison has
to find not correct.  Prints (and appends to FILE) one JSON line per run:
the numbers compared, the end-to-end metrics, the window's periods and
frames.  With --fault-seeds, the same again with each fault of
`harness/faults.py` planted.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault-seeds", default="", help="seeds of runs with each planted fault (harness/faults.py)")
    ap.add_argument("--faults", default="", help="comma-separated fault names; default all")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from port_bench.harness import cell as cell_mod
    from port_bench.run import read_metric

    cell = cell_mod.load_cell(args.workload)
    from port_bench.harness import faults

    names = [f for f in args.faults.split(",") if f] or list(faults.NAMES)
    plan = [(int(s), False, None) for s in args.seeds.split(",") if s] + \
           [(int(s), True, None) for s in args.control_seeds.split(",") if s] + \
           [(int(s), False, f) for s in args.fault_seeds.split(",") if s for f in names]
    failures = 0
    for seed, control, fault in plan:
        t0 = time.perf_counter()
        try:
            torch.cuda.reset_peak_memory_stats()
            run = cell_mod.run(cell, seed, args.seconds, bool(args.trace), control=control, t_start=t0,
                               fault=faults.make(fault) if fault else None)
            line = {"workload": args.workload, "seed": seed, "control": control, "fault": fault,
                    "correct": run["correct"],
                    "numbers": run["numbers"], "periods": run["periods"], "frames": run["attempted"],
                    "failed": run["failed"], "window_s": run["window_s"], "reference_s": run["reference_s"],
                    "memory_peak_bytes": run["memory_peak_bytes"], "lm_costs": run["lm_costs"],
                    "steps": [(s["frame"], s["hyps"], s["ms"], s.get("needed_flop")) for s in run["shape_steps"]],
                    "metrics": {m: read_metric(m, run) for m in ("frame_ms", "shape_frame_ms", "setup_s")}}
            if args.trace:
                line["per_layer"] = {m["name"]: read_metric(m["name"], run) for m in cell["bench"]["per_layer"]}
                line["trace"] = {k: v for k, v in run["trace"].items() if k != "idle_gaps"}
        except Exception as e:  # a run that raises is a reading too (a control that crashes has failed)
            failures += 1
            line = {"workload": args.workload, "seed": seed, "control": control, "fault": fault, "error": repr(e),
                    "traceback": traceback.format_exc()[-2000:]}
        line["wall_s"] = time.perf_counter() - t0
        text = json.dumps(line, default=str)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())

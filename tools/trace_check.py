#!/usr/bin/env python3
"""Two checks of the port's tracer (`qsp_slam_tpu_torch/utils/tracing.py`)
on the card, outside any timed path.

    python3 tools/trace_check.py [--workload tum_rgbd_dsp.shapes] [--seed 12345] [--frames 5] [--spans 100000]

1. Span cost: `--spans` empty spans of a fresh tracer, each with its pair
   of timing events, and as many counter increments, timed on the host
   clock, then the same loops with the tracer off; microseconds per span
   and per increment.
2. Host reads: builds the benchmark cell's system and frames as
   `port_bench/harness/cell.py` does, tracks the leading frames up to and
   including the first shape step, then at least `--frames` more, until
   one keyframe and one shape step have passed, under
   `torch.cuda.set_sync_debug_mode("warn")`.  Per frame it compares the
   tracer's `host_reads` with the synchronising calls the warnings report
   plus the calls of `torch.cuda.synchronize`, and where they differ
   prints both by site (file, function and line of the program).  It also
   gives the spans, timing events and counters each frame recorded.

Prints the card's name and power limit and, last, one JSON line.  Exits 1
when a frame's count differs, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from qsp_slam_tpu_torch.utils import tracing  # noqa: E402

PKG = str(ROOT / "qsp_slam_tpu_torch")
TRACING = str(ROOT / "qsp_slam_tpu_torch" / "utils" / "tracing.py")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi failed"


def site() -> str:
    """The innermost frame of the program below this call, the tracer's
    own module left out; else the innermost frame outside this file and
    the warnings module."""
    stack = traceback.extract_stack()[:-2]
    for fr in reversed(stack):
        if fr.filename.startswith(PKG) and fr.filename != TRACING:
            return f"{Path(fr.filename).relative_to(ROOT)}:{fr.name}:{fr.lineno}"
    for fr in reversed(stack):
        if fr.filename not in (__file__, warnings.__file__):
            return f"outside the program: {fr.filename}:{fr.name}:{fr.lineno}"
    return "outside the program"


def span_cost(n: int) -> dict:
    out = {}
    for enabled in (True, False):
        tr = tracing.Tracer(enabled=enabled, capacity=n)
        for _ in range(1000):
            with tr.span("warm"):
                pass
        torch.cuda.synchronize()
        tr.clear()
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("empty"):
                pass
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        recs = tr.records()
        tr.clear()
        t0 = time.perf_counter()
        for _ in range(n):
            tr.count("empty")
        dc = time.perf_counter() - t0
        out["on" if enabled else "off"] = {"us_per_span": dt / n * 1e6, "us_per_count": dc / n * 1e6,
                                           "records": len(recs),
                                           "stream_ms_resolved": sum(r.ms is not None for r in recs)}
    return out


class Audit:
    """The synchronising calls of one block, by site: warned (the sync
    debug mode's warnings), synced (calls of torch.cuda.synchronize, whose
    own warnings are not counted again) and counted (the tracer's
    host_reads)."""

    def __init__(self):
        self.warned, self.synced, self.counted = Counter(), Counter(), Counter()
        self._in_sync = self._armed = False

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            if self._armed and not self._in_sync:
                self.warned[site()] += 1
        else:
            self._showwarning(message, category, filename, lineno, file, line)

    def _sync(self, *a, **k):
        self.synced[site()] += 1
        self._in_sync = True
        try:
            return self._synchronize(*a, **k)
        finally:
            self._in_sync = False

    def _count(self, name, n=1):
        if name == tracing.HOST_READS:
            self.counted[site()] += n
        return self._tracer_count(name, n)

    def __enter__(self):
        self._warn_ctx = warnings.catch_warnings()
        self._warn_ctx.__enter__()
        warnings.simplefilter("always")
        self._showwarning, warnings.showwarning = warnings.showwarning, self._show
        self._synchronize, torch.cuda.synchronize = torch.cuda.synchronize, self._sync
        self._tracer_count, tracing.TRACER.count = tracing.TRACER.count, self._count
        torch.cuda.set_sync_debug_mode("warn")  # its first call in a process warns of itself
        self._armed = True
        return self

    def __exit__(self, *exc):
        self._armed = False
        torch.cuda.set_sync_debug_mode("default")
        del tracing.TRACER.count
        torch.cuda.synchronize = self._synchronize
        warnings.showwarning = self._showwarning
        self._warn_ctx.__exit__(*exc)

    def by_function(self, c: Counter) -> Counter:
        out = Counter()
        for k, v in c.items():
            out[k.rsplit(":", 1)[0]] += v
        return out


def host_reads(workload: str, seed: int, frames: int) -> dict:
    from port_bench.harness import cell as cell_mod
    from port_bench.harness import setup
    from port_bench.traffic.generator import generate, seeds

    from qsp_slam_tpu_torch.ops import build

    cell = cell_mod.load_cell(workload)
    cfg = cell["config"]
    s_weights, _ = seeds(seed, 2)
    build.build(["fast_nms", "hamming"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cam = setup.camera(cfg)
    traffic = generate(cell["traffic"], cam, "cuda")
    sysm = setup.build_system(cfg, setup.decoder_weights(cfg, s_weights, "cuda"), "cuda")
    tr = tracing.TRACER

    def shape_step() -> bool:  # an LM trip in the frame just tracked
        return any(r.name == "shapes.trip" and r.frame == tr.frame for r in tr.records())

    i = 0
    while True:
        sysm.track_rgbd(*traffic.frames[i])
        i += 1
        if shape_step():
            break
    torch.cuda.synchronize()
    rows = []
    while i < len(traffic.frames):
        kfs = sysm.stats["keyframes"]
        with Audit() as a:
            sysm.track_rgbd(*traffic.frames[i])
            torch.cuda.synchronize()  # the frame's end, as the benchmark's frame rows end
        recs = [r for r in tr.records() if r.frame == tr.frame]
        spans = [r for r in recs if isinstance(r, tracing.Span)]
        counts = Counter()
        for r in recs:
            if isinstance(r, tracing.Count):
                counts[r.name] += r.n
        reported = sum(a.warned.values()) + sum(a.synced.values()) - 1  # less the audit's own synchronize
        row = {"frame": i, "keyframe": sysm.stats["keyframes"] > kfs, "shape_step": shape_step(),
               "host_reads": counts[tracing.HOST_READS], "reported": reported, "spans": len(spans),
               "events": 2 * len(spans), "counters": dict(counts)}
        if row["host_reads"] != reported:
            warned = a.by_function(a.warned) + a.by_function(a.synced)
            counted = a.by_function(a.counted)
            row["differ"] = {k: [warned[k], counted[k]] for k in sorted(set(warned) | set(counted))
                             if warned[k] != counted[k]}
            row["warned_sites"] = dict(a.warned + a.synced)
            row["counted_sites"] = dict(a.counted)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        i += 1
        if len(rows) >= frames and any(r["keyframe"] for r in rows) and any(r["shape_step"] for r in rows):
            break
    return {"frames": rows, "equal": all(r["host_reads"] == r["reported"] for r in rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="tum_rgbd_dsp.shapes")
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--spans", type=int, default=100000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", file=sys.stderr, flush=True)
    torch.zeros(1, device="cuda")
    out = {"span_cost": span_cost(args.spans)}
    print(json.dumps(out), file=sys.stderr, flush=True)
    out["host_reads"] = host_reads(args.workload, args.seed, args.frames)
    print(json.dumps(out))
    return 0 if out["host_reads"]["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())

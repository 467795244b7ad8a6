"""One run of one cell: set-up, the measured window of whole shape periods,
the comparison that decides `correct`, and the numbers the metric readers
read.

Set-up renders the cell's frames and detections as its sensor takes them
(`harness/sensors/`; host memory), makes the decoder's weights on the
device, builds the program's system and tracks the leading frames (each
through the sensor's call) up to and including the first frame that runs
a shape step, which warms every kernel and shape the window
uses.  The window starts at the next frame and ends at the first frame
that completes a shape step once `seconds` have passed and at least
MIN_PERIODS periods have run, so it holds only whole shape periods (the
frames from one shape step to the next).  If
the frames run out first it ends at the last whole period and a warning
says so.  With `trace`, a `torch.profiler` trace covers the window's
first period, and the span readers read the periods after it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..traffic.generator import generate, seeds
from . import checks, hooks, setup
from . import trace as trace_mod

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
MIN_PERIODS = 3
SAMPLED_FRAMES = 3  # window frames whose kernel calls are compared
SAMPLE_SPAN = 12  # ... drawn among the window's first frames


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_state() -> str:
    """The card's SM clock (now and its maximum), power draw and limit,
    temperature and active throttle reasons, as nvidia-smi reads them."""
    query = "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu,clocks_throttle_reasons.active"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return f"{query}: {out.stdout.strip().splitlines()[0]}"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read (nvidia-smi failed)"


def load_cell(workload: str, bench: dict | None = None) -> dict:
    """The cell's entry, its configuration and traffic files, its limits."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"bench": bench, "cell": cell, "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((BENCH / "limits" / f"{workload}.json").read_text())}


class Frames:
    """The host clock of every tracked frame (synchronised at both ends)
    and what the system's `stats` gained in it.  Each frame goes to the
    program through the sensor's call; `capture` (or None) keeps the
    sensor's shape-step depth image of the frames whose shape step the
    comparison reads."""

    def __init__(self, sysm, sensor, traffic, shape, kernels, k1, k2, capture=None):
        self.sysm, self.traffic, self.shape, self.kernels = sysm, traffic, shape, kernels
        self.call, self.capture = getattr(sysm, sensor.CALL), capture
        self.k1, self.k2 = k1, k2  # the kernels' entries, which hold their launch counters
        self.rows = []

    def track(self, i: int, profiled: bool = False) -> dict:
        a, b, det = self.traffic.frames[i]
        st = self.sysm.stats
        before = {k: len(st.get(k, [])) for k in ("track_ms", "ba_ms", "obj_ms", "track_ok")}
        kfs, n_steps = st["keyframes"], len(self.shape.steps)
        k1_0, k2_0 = self.k1.launches, dict(self.k2.shapes)
        self.shape.frame = self.kernels.frame = i
        if self.capture is not None:
            self.capture.frame = i
        hooks.sync()
        t0 = time.perf_counter()
        if profiled:
            with torch.profiler.record_function(f"frame_{i}"):
                self.call(a, b, det)
        else:
            self.call(a, b, det)
        hooks.sync()
        t1 = time.perf_counter()
        steps = self.shape.steps[n_steps:]
        if self.capture is not None and not (steps and self.shape.keep):
            self.capture.by_frame.pop(i, None)
        row = {"frame": i, "t0": t0, "t1": t1, "ms": (t1 - t0) * 1e3, "keyframe": st["keyframes"] > kfs,
               "shape_ms": sum(s["ms"] for s in steps), "shape_steps": len(steps), "profiled": profiled,
               "k1_launches": self.k1.launches - k1_0,
               "k2_shapes": {k: v - k2_0.get(k, 0) for k, v in self.k2.shapes.items() if v - k2_0.get(k, 0)},
               **{k: list(st.get(k, []))[before[k]:] for k in before}}
        row["lost"] = not all(row.pop("track_ok")) if "track_ok" in st else False
        self.rows.append(row)
        return row



def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda", control: bool = False,
        fault=None, t_start: float | None = None) -> dict:
    """One run; returns everything the result line and the readers need.
    `control` turns the program's TF32 path on (the control of
    `correct`); `fault(shape, kernels)` plants a fault under the timed
    path, beneath the benchmark's own hooks (`harness/faults.py`)."""
    from qsp_slam_tpu_torch.models import shape_opt
    from qsp_slam_tpu_torch.ops import build, fast_nms, hamming
    from qsp_slam_tpu_torch.slam import shape_mapping

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", time.perf_counter())]
    cfg, traffic_p = cell["config"], cell["traffic"]
    sensor = setup.sensor(cfg)
    s_weights, s_sample = seeds(seed, 2)
    if device == "cuda":
        build.build(["fast_nms", "hamming"])
    marks.append(("kernels built", time.perf_counter()))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(control)
    torch.set_float32_matmul_precision("high" if control else "highest")
    cam = setup.camera(cfg)
    raw = setup.decoder_weights(cfg, s_weights, device)
    marks.append(("weights", time.perf_counter()))
    traffic = generate(traffic_p, cam, device, sensor)
    marks.append((f"{len(traffic.frames)} frames rendered", time.perf_counter()))
    sysm = setup.build_system(cfg, raw, device)
    n = len(traffic.frames)
    rng = np.random.default_rng(s_sample)

    shape = hooks.ShapeSteps(shape_mapping.reconstruct_due_objects, shape_opt.reconstruct_object)
    kern = hooks.KernelCaptures(fast_nms.fast_score_nms_pyramid, hamming.hamming_packed)
    depth_func = sensor.capture()
    capture = hooks.Capture(depth_func) if depth_func is not None else None
    if fault is not None:
        fault(shape, kern)
    frames = Frames(sysm, sensor, traffic, shape, kern, fast_nms.fast_score_nms_pyramid, hamming.hamming_packed,
                    capture)
    with shape, kern, capture or contextlib.nullcontext():
        shape.keep = False
        first = None
        for i in range(n):
            if frames.track(i)["shape_steps"]:
                first = i
                break
        if first is None:
            raise RuntimeError("no shape step in the whole traffic: the cell's traffic never makes an object due")
        start = first + 1
        kern.frames = {start + int(k) for k in rng.choice(SAMPLE_SPAN, SAMPLED_FRAMES, replace=False)}
        shape.keep = True
        hooks.sync()
        marks.append((f"{start} leading frames", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        t_win = time.perf_counter()
        prof, profiled_until = None, None
        if trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            k2_shapes0 = dict(hamming.hamming_packed.shapes)
        end, ran_out = None, True
        for i in range(start, n):
            row = frames.track(i, profiled=prof is not None and profiled_until is None)
            if prof is not None and profiled_until is None and row["shape_steps"]:
                hooks.sync()
                prof.stop()
                profiled_until = i
                k2_shapes = {k: v - k2_shapes0.get(k, 0) for k, v in hamming.hamming_packed.shapes.items()
                             if v - k2_shapes0.get(k, 0)}
            if row["shape_steps"]:
                end = i
                periods = sum(1 for r in frames.rows[start:] if r["shape_steps"])
                if time.perf_counter() - t_win >= seconds and periods >= MIN_PERIODS:
                    ran_out = False
                    break
    if end is None:
        raise RuntimeError("the frames ran out before the window's first shape period ended")
    window = [r for r in frames.rows if start <= r["frame"] <= end]
    periods = sum(1 for r in window if r["shape_steps"])
    if ran_out:
        log(f"warning: the rendered frames ran out after {n} frames; the window ends at the last whole shape "
            f"period (frame {end}), {window[-1]['t1'] - t_win:.3f} s after it began, short of {seconds} s: "
            f"the traffic file needs more frames for this program")
    if periods < MIN_PERIODS:
        raise RuntimeError(f"the window holds {periods} shape periods, fewer than {MIN_PERIODS}")
    window_s = window[-1]["t1"] - t_win
    if device == "cuda":
        log(f"card as the window closed: {card_state()}")
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; before the harness {marks[0][1] - t_start:.3f} s")
    log(f"window: {periods} shape periods, {len(window)} frames ({window[0]['frame']}-{window[-1]['frame']}), "
        f"{sum(r['keyframe'] for r in window)} keyframes, {sum(r['shape_steps'] for r in window)} shape steps, "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s with {start} leading frames")

    got = {"setup_s": setup_s, "window_s": window_s, "window": window, "periods": periods,
           "shape_steps": [s for s in shape.steps if s["frame"] >= start],
           "attempted": len(window), "failed": sum(r["lost"] for r in window),
           "memory_peak_bytes": memory_peak, "config": cfg, "traffic": traffic_p, "cell": cell["cell"],
           "camera": cam, "trace": None}
    if prof is not None:
        got["trace"] = {**trace_mod.reduce(prof), "frames": profiled_until - start + 1, "k2_shapes": k2_shapes}
        got["span_rows"] = [r for r in window if r["frame"] > profiled_until]
        del prof
    else:
        got["span_rows"] = window
    got["needed_flop"] = checks.needed_flop(got["shape_steps"], setup.decoder_dims(cfg),
                                            setup.shape_opt(cfg)["iters"])

    # The program's state goes before the reference runs.
    state = {"trajectory": np.stack(sysm.trajectory),
             "objects": sysm.objects.ellipsoid[sysm.objects.valid].double().cpu().numpy()}
    del sysm, frames
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    captured = capture.by_frame if capture is not None else {}
    got["numbers"] = checks.compare(cfg, sensor, traffic, s_weights, got["shape_steps"], kern, captured, device)
    got["numbers"].update(checks.truth_numbers(traffic, state, window))
    got["lm_costs"] = got["numbers"].pop("lm_costs")
    got["reference_s"] = time.perf_counter() - t_ref
    got["limits"] = cell["limits"]
    got["correct"] = all(k in got["numbers"] and got["numbers"][k] <= v for k, v in cell["limits"].items())
    return got

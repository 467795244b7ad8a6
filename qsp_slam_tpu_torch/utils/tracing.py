"""Per-stage tracing and memory telemetry (counterpart of
`qsp_slam_tpu/utils/tracing.py`): named spans accumulate wall-clock
statistics, `report()` gives a machine-readable summary, and
`device_trace` captures a `torch.profiler` trace around any block.
"""

from __future__ import annotations

import json
import resource
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Tracer:
    """Named spans of host wall-clock time.  A span does not synchronise
    the device: work queued on a card inside it may finish after the span
    ends, so a caller that wants device time synchronises inside the span
    (for example `torch.cuda.synchronize()` as its last statement)."""

    enabled: bool = True
    spans: dict = field(default_factory=lambda: defaultdict(list))

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append((time.perf_counter() - t0) * 1e3)

    def max_rss_mb(self) -> float:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    def report(self) -> dict:
        out = {"max_rss_mb": round(self.max_rss_mb(), 1)}
        for name, times in sorted(self.spans.items()):
            out[name] = {
                "count": len(times),
                "median_ms": round(float(np.median(times)), 2),
                "mean_ms": round(float(np.mean(times)), 2),
                "total_ms": round(float(np.sum(times)), 1),
            }
        return out

    def dump(self, path: str | None = None) -> str:
        s = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextmanager
def device_trace(log_dir: str, device=None):
    """Capture a `torch.profiler` trace (TensorBoard / Chrome JSON, through
    `tensorboard_trace_handler`) of the block into `log_dir`: CPU activity,
    and the card's kernels when `device` names a CUDA device.  Yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof

"""Per-stage tracing and memory telemetry (counterpart of
`qsp_slam_tpu/utils/tracing.py`): named spans and counters at the
program's layer boundaries, `report()` gives a machine-readable summary,
and `device_trace` captures a `torch.profiler` trace around any block.

`TRACER` is the program's one tracer, process-wide and on by default;
`TRACER.enabled = False` turns it off.  A span records its name, the
frame (one per `track_*` call, `Tracer.new_frame`), its parent span, its
host interval on `time.perf_counter` and, once the CUDA runtime is up,
the stream interval between two timing events recorded at its start and
end on the stream current at its start.  The tracer never synchronises
for its own sake: an event pair is resolved once its end event has
completed, checked at the next frame's start or when the records are
read, so a span's stream time is None until then.  On the CPU the stream
interval is the host interval.  While a `torch.profiler` is running,
each span is also a `record_function` range of the same name, so the
program's stages appear in the device trace.  A counter (`count`) is
attributed to the frame and the enclosing span; `fetch` makes a
device-to-host read or a synchronise and counts it under `HOST_READS`.
The records are kept in a bounded buffer (the last `capacity`).

Span names are dotted (`track.pose`) and never start with `frame_`,
which the benchmark keeps for its own frames.
"""

from __future__ import annotations

import json
import resource
import time
from collections import defaultdict, deque
from contextlib import contextmanager

import numpy as np
import torch

HOST_READS = "host_reads"
CAPACITY = 65536
PENDING = 1024  # ended spans past which `end` resolves event pairs itself


class Span:
    """One span: `name`, `frame`, `parent` (the enclosing Span or None),
    host start and end `t0`, `t1` (perf_counter seconds) and `ms`, the
    stream interval in milliseconds (None until its events complete)."""

    __slots__ = ("name", "frame", "parent", "t0", "t1", "ms", "_ev", "_rf", "_counts")

    def __init__(self, name, frame, parent):
        self.name, self.frame, self.parent = name, frame, parent
        self.t1 = self.ms = self._ev = self._rf = None
        self.t0 = 0.0
        self._counts = {}  # name -> Count, while the span is open

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class Count:
    """The counter `name`'s increments in one frame inside one `parent`
    (the enclosing Span or None), summed in `n`; `t` is the host time of
    the first."""

    __slots__ = ("name", "n", "frame", "parent", "t")

    def __init__(self, name, n, frame, parent, t):
        self.name, self.n, self.frame, self.parent, self.t = name, n, frame, parent, t


class _Timer:
    """What a disabled tracer's span gives: the host interval alone, for
    callers that keep their own durations (`SlamSystem.stats`)."""

    __slots__ = ("t0", "t1")

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t1 = None

    host_ms = Span.host_ms


class _Scope:
    __slots__ = ("tracer", "name", "rec")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.rec = self.tracer.begin(self.name)
        return self.rec

    def __exit__(self, *exc):
        self.tracer.end(self.rec)
        return False


class Tracer:
    """Spans and counters of the program (see the module docstring).
    `spans` maps each span name to its host milliseconds, oldest first."""

    def __init__(self, enabled: bool = True, capacity: int = CAPACITY):
        self.enabled = enabled
        self.frame = -1
        self._records = deque(maxlen=capacity)
        self._stack = []  # open spans, innermost last
        self._pending = deque()  # ended spans whose event pair is unresolved, in end order
        self._events = []  # free timing events
        self._counts = {}  # name -> this frame's Count outside any span

    # -- spans ----------------------------------------------------------------------
    def span(self, name: str):
        """`with tracer.span(name) as s:` ... `s.host_ms` after the block."""
        return _Scope(self, name)

    def begin(self, name: str):
        """Open a span that `end` closes (for an interval that starts and
        ends in different functions); spans nest inside it meanwhile."""
        if not self.enabled:
            return _Timer()
        rec = Span(name, self.frame, self._stack[-1] if self._stack else None)
        if torch.autograd._profiler_enabled():
            rec._rf = torch.autograd.profiler.record_function(name)
            rec._rf.__enter__()
        if torch.cuda.is_initialized():
            rec._ev = (self._event(), self._event(), torch.cuda.current_stream())
            rec._ev[0].record(rec._ev[2])
        self._stack.append(rec)
        rec.t0 = time.perf_counter()
        return rec

    def end(self, rec) -> None:
        rec.t1 = time.perf_counter()
        if isinstance(rec, _Timer):
            return
        if rec._ev is not None:
            rec._ev[1].record(rec._ev[2])
            self._pending.append(rec)
            if len(self._pending) > PENDING:  # spans outside any frame
                self._resolve()
        else:
            rec.ms = rec.host_ms
        if rec._rf is not None:
            rec._rf.__exit__(None, None, None)
            rec._rf = None
        rec._counts = None
        if self._stack and self._stack[-1] is rec:
            self._stack.pop()
        elif rec in self._stack:
            self._stack.remove(rec)
        self._records.append(rec)

    def _event(self):
        return self._events.pop() if self._events else torch.cuda.Event(enable_timing=True)

    def _resolve(self) -> None:
        """Stream times of the ended spans whose end event has completed;
        their events go back to the pool.  Never waits."""
        while self._pending and self._pending[0]._ev[1].query():
            rec = self._pending.popleft()
            e0, e1, _ = rec._ev
            rec.ms, rec._ev = e0.elapsed_time(e1), None
            self._events += (e0, e1)

    # -- frames and counters --------------------------------------------------------
    def new_frame(self) -> None:
        """A frame starts: spans left open by a frame that raised are
        dropped, and completed event pairs are resolved."""
        if not self.enabled:
            return
        while self._stack:
            rec = self._stack.pop()
            if rec._rf is not None:
                rec._rf.__exit__(None, None, None)
        self.frame += 1
        self._counts.clear()
        self._resolve()

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        parent = self._stack[-1] if self._stack else None
        counts = parent._counts if parent is not None else self._counts
        rec = counts.get(name)
        if rec is None:
            rec = counts[name] = Count(name, 0, self.frame, parent, time.perf_counter())
            self._records.append(rec)
        rec.n += n

    def records(self) -> list:
        """The buffer, oldest first, after resolving what has completed."""
        self._resolve()
        return list(self._records)

    def clear(self) -> None:
        self._records.clear()
        self._counts.clear()

    # -- summaries ------------------------------------------------------------------
    @property
    def spans(self) -> dict:
        out = defaultdict(list)
        for rec in self._records:
            if isinstance(rec, Span):
                out[rec.name].append(rec.host_ms)
        return out

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


TRACER = Tracer()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of `TRACER`."""
    TRACER.count(name, n)


def fetch(t: torch.Tensor | None = None, *, device: torch.device | None = None):
    """The port's device-to-host read: `t` copied to the host, or with
    `device` (and no `t`) a synchronise of that device.  Either is counted
    under `HOST_READS`, whatever the device, so a CPU run counts the reads
    a card run makes.  Implicit reads (a device tensor's `int`, `bool`,
    `torch.nonzero`, boolean-mask indexing, a linear-algebra call that
    checks its result on the host, a copy from host memory to the card)
    are counted where they stand with `count(HOST_READS)`."""
    TRACER.count(HOST_READS)
    if t is not None:
        return t.cpu()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return None


@contextmanager
def device_trace(log_dir: str, device=None):
    """Capture a `torch.profiler` trace (TensorBoard / Chrome JSON, through
    `tensorboard_trace_handler`) of the block into `log_dir`: CPU activity,
    and the card's kernels when `device` names a CUDA device.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof

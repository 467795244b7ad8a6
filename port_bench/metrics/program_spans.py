"""What the program's own tracer (`qsp_slam_tpu_torch.utils.tracing.TRACER`)
recorded in the window's frames outside the traced period: its records
whose host start (`perf_counter`, the clock of the frame rows) lies
inside a row of `run["span_rows"]`.  Span times are the stream
milliseconds of each span's event pair.  Every function gives None where
the program has no such tracer or recorded nothing there."""

from bisect import bisect_right


def records(run) -> list:
    try:
        from qsp_slam_tpu_torch.utils import tracing
    except ImportError:
        return []
    tracer = getattr(tracing, "TRACER", None)
    if tracer is None or not hasattr(tracer, "records"):
        return []
    rows = sorted((r["t0"], r["t1"]) for r in run["span_rows"])
    starts = [a for a, _ in rows]
    out = []
    for rec in tracer.records():
        t = getattr(rec, "t0", getattr(rec, "t", None))
        i = bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= rows[i][1]:
            out.append(rec)
    return out


def spans(run, name: str) -> list:
    """Stream milliseconds of the spans named `name`."""
    return [r.ms for r in records(run) if getattr(r, "ms", None) is not None and r.name == name]


def count(run, name: str, parent: str | None = None) -> int:
    """The sum of the counter `name`, inside spans named `parent` if given."""
    return sum(r.n for r in records(run) if hasattr(r, "n") and r.name == name
               and (parent is None or (r.parent is not None and r.parent.name == parent)))


def per(run, name: str, unit: str):
    """The stream milliseconds of the spans `name` summed over the number
    of spans `unit` (the tracked frames, keyframes, ...)."""
    n = len(spans(run, unit))
    ms = spans(run, name)
    return sum(ms) / n if n and ms else None


def count_per(run, name: str, unit: str, parent: str | None = None):
    n = len(spans(run, unit))
    c = count(run, name, parent)
    return c / n if n and c else None


def mean(run, name: str):
    ms = spans(run, name)
    return sum(ms) / len(ms) if ms else None

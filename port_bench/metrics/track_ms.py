"""track_ms: the mean of the system's `stats["track_ms"]` over the
window's frames outside the traced period (the facade and tracking;
synchronised by the frame's one device-to-host copy)."""


def read(run):
    ms = [v for r in run["span_rows"] for v in r["track_ms"]]
    return sum(ms) / len(ms) if ms else None

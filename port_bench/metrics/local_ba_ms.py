"""local_ba_ms: the mean of `stats["ba_ms"]` per keyframe of the window
outside the traced period (local BA, point fusion and culling,
synchronised)."""


def read(run):
    ms = [v for r in run["span_rows"] for v in r["ba_ms"]]
    return sum(ms) / len(ms) if ms else None

"""object_step_ms: per keyframe of the window outside the traced period,
`stats["obj_ms"]` less the benchmark's shape span in the same keyframe,
averaged: the object step without its shape step."""


def read(run):
    ms = [sum(r["obj_ms"]) - r["shape_ms"] for r in run["span_rows"] if r["obj_ms"]]
    return sum(ms) / len(ms) if ms else None

"""shape_step_ms: the benchmark's own span (host clock around a
synchronise) around each call of `reconstruct_due_objects` that had due
objects, averaged over the window outside the traced period."""


def read(run):
    frames = {r["frame"] for r in run["span_rows"]}
    ms = [s["ms"] for s in run["shape_steps"] if s["frame"] in frames]
    return sum(ms) / len(ms) if ms else None

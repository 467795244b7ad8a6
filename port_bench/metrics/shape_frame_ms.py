"""shape_frame_ms: the mean wall time (host clock around `track_*`,
synchronised) of the window's frames that ran a shape step."""


def read(run):
    ms = [r["ms"] for r in run["window"] if r["shape_steps"]]
    return sum(ms) / len(ms) if ms else None

"""frame_ms: the window's wall time (host clock, synchronised at both
ends) over the number of frames in it; the window holds whole shape
periods only."""


def read(run):
    return run["window_s"] * 1e3 / len(run["window"])

"""launches_per_frame: the device kernels the profiler saw in the traced
period (memory copies and sets left out) over its frames."""


def read(run):
    t = run["trace"]
    return t["launches"] / t["frames"] if t else None

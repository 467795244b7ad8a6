"""k2_roofline_pct: K2's least time summed over the traced period's
launches at their shapes (the program's per-shape launch counter) over
the profiler's device time of those launches, in percent."""

from .bounds import k2_launch, least_s


def read(run):
    t = run["trace"]
    k = t["kernels"]["k2"] if t else None
    if not k or not k["launches"]:
        return None
    bound = sum(n * least_s(k2_launch(a, b)) for (a, b), n in t["k2_shapes"].items())
    return 100.0 * bound / k["device_s"]

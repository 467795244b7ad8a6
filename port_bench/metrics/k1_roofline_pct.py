"""k1_roofline_pct: K1's least time per launch at the levels a launch
covers (`bounds.k1_launch` over `setup.k1_level_shapes`: one pyramid per
image of the sensor's launch) over the profiler's device time per K1
launch in the traced period, in percent."""

from ..harness.setup import k1_level_shapes
from .bounds import k1_launch, least_s


def read(run):
    t = run["trace"]
    k = t["kernels"]["k1"] if t else None
    if not k or not k["launches"]:
        return None
    return 100.0 * k["launches"] * least_s(k1_launch(k1_level_shapes(run["config"]))) / k["device_s"]

"""mfu_pct: the whole frame stream's share of the card's peak: the least
time of the work the window's frames need, summed, over their wall time
(outside the traced period), in percent.  The work needed is the shape
steps' decoder FLOP (`flop.py`) at the float32 peak, and each K1 and K2
launch's least time at its shapes (`bounds.py`; a K1 launch covers the
levels of `setup.k1_level_shapes`, and the program's launch counters
give the launches per frame); the rest of a frame (pose and
bundle-adjustment solves, elementwise work) is small beside them and
left out."""

from ..harness.setup import k1_level_shapes
from .bounds import k1_launch, k2_launch, least_s
from .peaks import FP32_FLOP_S


def read(run):
    rows = run["span_rows"]
    frames = {r["frame"] for r in rows}
    k1 = least_s(k1_launch(k1_level_shapes(run["config"])))
    least = sum(st["needed_flop"] for st in run["shape_steps"] if st["frame"] in frames) / FP32_FLOP_S
    least += sum(r["k1_launches"] * k1 + sum(n * least_s(k2_launch(a, b)) for (a, b), n in r["k2_shapes"].items())
                 for r in rows)
    wall = sum(r["ms"] for r in rows) / 1e3
    return 100.0 * least / wall if least > 0 and wall > 0 else None

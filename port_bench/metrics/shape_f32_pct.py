"""shape_f32_pct: the decoder FLOP the window's shape steps need
(`flop.py`) over their summed spans, against the card's float32 peak
outside the tensor cores (`peaks.py`), in percent.  Nothing to read (no
result) where the steps' inputs mark no point valid."""

from .peaks import FP32_FLOP_S


def read(run):
    frames = {r["frame"] for r in run["span_rows"]}
    steps = [s for s in run["shape_steps"] if s["frame"] in frames]
    flop, s = sum(st["needed_flop"] for st in steps), sum(st["ms"] for st in steps) / 1e3
    return 100.0 * flop / s / FP32_FLOP_S if flop > 0 and s > 0 else None

"""The least time of each hand-written kernel's launch on the card, from
its shapes: the larger of its operations over the peak rate and its
bytes over the memory bandwidth, counting each input byte read once and
each output byte written once (the arithmetic behind PERF.md's kernel
table, copied from the port's smoke script and `tools/k2_popc_roof.py`).
"""

from __future__ import annotations

from .peaks import FP32_FLOP_S, HBM_BYTES_S, INT8_OPS_S

K1_OPS_PER_PX = 140  # per (pixel, threshold): 16 ring taps x ~7 operations, the arc test and the 3x3 maximum


def k1_launch(level_shapes, thresholds: int = 2) -> dict:
    """K1 (FAST score + 3x3 NMS) over one launch's levels (every pyramid
    the launch covers, `setup.k1_level_shapes`): f32 pixels in, one f32
    score map per threshold out."""
    px = sum(h * w for h, w in level_shapes)
    return {"operations": K1_OPS_PER_PX * px * thresholds / FP32_FLOP_S,
            "bytes": (4 * px + 4 * px * thresholds) / HBM_BYTES_S}


def k2_launch(A: int, B: int) -> dict:
    """K2 (packed Hamming): (A + B) 32-byte descriptors in, an (A, B) int32
    matrix out; the product as +-1 int8 on the tensor cores."""
    return {"operations": 2 * A * B * 256 / INT8_OPS_S, "bytes": ((A + B) * 32 + A * B * 4) / HBM_BYTES_S}


def least_s(bound: dict) -> float:
    return max(bound.values())

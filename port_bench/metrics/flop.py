"""The decoder FLOP that a shape step needs, whatever implements it.

The shape step's LM (per hypothesis, `iters` trips) minimises a cost
whose residuals are one SDF value per surface point and one expected
depth per ray from 32 samples along it.  Each decoder evaluation is a
scalar function of its own (xyz, code) input, so one reverse pass over
all points gives every point's derivative with respect to its own
(xyz, code), and the Jacobian with respect to the pose (sim(3)) and the
code follows by the chain rule through xyz and through the render's
cheap per-ray arithmetic.  What the LM needs, per hypothesis:

  the starting cost:        1 forward pass
  per trip: the residuals   1 forward pass
            the Jacobian    1 backward pass = 2 forward passes' FLOP
            the trial cost  1 forward pass
  so  passes = 1 + 4 * iters  forward-pass equivalents,

each over the points that the inputs mark valid: the valid surface
points and 32 samples of each valid ray.  A forward pass costs 2 FLOP
per multiply-add of the decoder's linear layers per point
(sum of in * out over the layers).  The normal equations, the solve and
the elementwise work are left out: they are small beside the decoder.

A program that computes Jacobians in forward mode over the 7 + C
tangents does far more arithmetic than this, and one that skips masked
points less: the count stays the same for both.
"""

from __future__ import annotations

RENDER_SAMPLES = 32


def macs_per_point(dims) -> int:
    """Multiply-adds of one decoder evaluation; `dims` (in, out) per layer."""
    return sum(i * o for i, o in dims)


def passes(iters: int) -> int:
    return 1 + 4 * iters


def shape_step_flop(dims, iters: int, valid_counts) -> float:
    """`valid_counts`: per LM call, (valid surface points (B,), valid rays
    (B,)) of its hypotheses, as tensors or sequences."""
    total = 0
    for pts_ok, rays_ok in valid_counts:
        points = int(sum(int(p) for p in pts_ok)) + RENDER_SAMPLES * int(sum(int(r) for r in rays_ok))
        total += points
    return float(2 * macs_per_point(dims) * passes(iters) * total)

"""shape_jacobian_pct: the share of the shape LM's trips spent in their
Jacobian (`vmap` of `jvp` over the 7 + C tangents): the `shapes.jacobian`
spans' stream milliseconds over the `shapes.trip` spans', in percent, in
the window outside the traced period."""

from .program_spans import spans


def read(run):
    trip, jac = sum(spans(run, "shapes.trip")), sum(spans(run, "shapes.jacobian"))
    return 100.0 * jac / trip if trip > 0 and jac > 0 else None

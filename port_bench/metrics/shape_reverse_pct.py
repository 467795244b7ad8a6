"""shape_reverse_pct: the share of the shape LM's trips whose Jacobian
was built by one reverse pass over the decoder: the program's
`shape_reverse_jacobians` counter (one per such Jacobian) over the
number of `shapes.trip` spans, in percent, in the window outside the
traced period.  None where the program has no such counter."""

from .program_spans import count, spans


def read(run):
    trips, n = len(spans(run, "shapes.trip")), count(run, "shape_reverse_jacobians")
    return 100.0 * n / trips if trips and n else None

"""shape_trip_ms: the program's `shapes.trip` span (one trip of the shape
LM over one chunk of hypotheses), mean stream milliseconds over the
window outside the traced period."""

from .program_spans import mean


def read(run):
    return mean(run, "shapes.trip")

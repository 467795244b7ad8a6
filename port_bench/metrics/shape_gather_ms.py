"""shape_gather_ms: the program's `shapes.gather` span (each object's
surface points and rays from the keyframe's depth and masks), mean stream
milliseconds per shape step of the window outside the traced period."""

from .program_spans import mean


def read(run):
    return mean(run, "shapes.gather")

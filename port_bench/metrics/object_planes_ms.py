"""object_planes_ms: the program's `objects.planes` span (the ground
plane RANSAC and fusion, the Manhattan planes), stream milliseconds per
object step (`objects` span, one per keyframe) of the window outside the
traced period."""

from .program_spans import per


def read(run):
    return per(run, "objects.planes", "objects")

"""object_fit_ms: the program's `objects.fit` span (one ellipsoid fit per
detection), stream milliseconds per object step of the window outside
the traced period."""

from .program_spans import per


def read(run):
    return per(run, "objects.fit", "objects")

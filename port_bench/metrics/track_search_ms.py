"""track_search_ms: the program's `track.search` span (projection, K2,
both radius searches, duplicate resolution), stream milliseconds per
tracked frame of the window outside the traced period."""

from .program_spans import per


def read(run):
    return per(run, "track.search", "track")

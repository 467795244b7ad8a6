"""track_features_ms: the program's `track.features` span (decode, pyramid,
K1, ORB, depth sampling), stream milliseconds per tracked frame (`track`
span) of the window outside the traced period."""

from .program_spans import per


def read(run):
    return per(run, "track.features", "track")

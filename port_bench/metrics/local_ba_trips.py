"""local_ba_trips: the program's `local_ba_trips` counter (LM trips run by
the local BA, at most 5 + 10 after the first evaluation) inside the
`map.local_ba` span, per keyframe of the window outside the traced
period."""

from .program_spans import count_per


def read(run):
    return count_per(run, "local_ba_trips", "map.local_ba", parent="map.local_ba")

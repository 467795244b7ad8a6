"""track_pose_ms: the program's `track.pose` span (the pose LM), stream
milliseconds per tracked frame of the window outside the traced period."""

from .program_spans import per


def read(run):
    return per(run, "track.pose", "track")

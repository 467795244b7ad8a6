"""pose_lm_iters: the program's `pose_lm_iters` counter (one per pose LM
iteration run, at most 4 rounds x 10), per tracked frame of the window
outside the traced period."""

from .program_spans import count_per


def read(run):
    return count_per(run, "pose_lm_iters", "track")

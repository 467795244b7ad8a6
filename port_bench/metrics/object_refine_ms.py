"""object_refine_ms: the program's `objects.refine` span (association,
integration, relations, the refinement LM, merging and culling), stream
milliseconds per object step of the window outside the traced period."""

from .program_spans import per


def read(run):
    return per(run, "objects.refine", "objects")

"""host_reads_per_frame: the program's `host_reads` counter (every
device-to-host read, synchronise and copy from host memory that waits
for the card, `tracing.fetch`), per frame of the window outside the
traced period."""

from .program_spans import count


def read(run):
    n = len(run["span_rows"])
    c = count(run, "host_reads")
    return c / n if n and c else None

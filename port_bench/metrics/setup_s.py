"""setup_s: process start to the window's first frame: imports, kernel
builds or loads, the decoder's weights, rendering the traffic, and the
leading frames up to and including the first shape step."""


def read(run):
    return run["setup_s"]

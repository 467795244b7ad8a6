#!/usr/bin/env python3
"""The JAX package's `run_synthetic --objects` on the CPU: the numbers
`chip_smoke.py` phase 18 runs beside (the port's `run_synthetic` at the
same defaults: three objects on the floor seen 25 degrees down, the
renderer's detections and instance masks, 1000 features, a toy DeepSDF
prior of code 16, hidden 96 and 6 layers trained on the fly).

    JAX_PLATFORMS=cpu python tools/shape_reference.py [num_frames]

Prints the command line's JSON line, then one more with the wall time.
The reference computes every object slot's four flip hypotheses at every
keyframe, so 30 frames take minutes on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qsp_slam_tpu import run_synthetic

    t0 = time.perf_counter()
    out = run_synthetic.main([argv[0] if argv else "30", "--objects", "--cpu"])
    print(json.dumps({"wall_s": time.perf_counter() - t0}))
    return out


if __name__ == "__main__":
    main()

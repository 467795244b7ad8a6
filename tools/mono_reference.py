#!/usr/bin/env python3
"""The JAX package's monocular command line on its own fabricated
sequence, with the numbers `chip_smoke.py` phase 11 is gated against.

    JAX_PLATFORMS=cpu python tools/mono_reference.py OUT_DIR [--frames 60] [--port]

Writes the sequence of phase 11 with the JAX `make_tum` (`--objects 3
--detections --step 0.025 --pitch 0.4 --seed 2`) into OUT_DIR, runs
`qsp_slam_tpu.run_mono` on it with `--detections` at its defaults on the
CPU, and prints its JSON line and then one more: the keyframe frames (the
first two are the bootstrap's reference and second frame), the live
objects' labels and ellipsoids, and local-BA and object ms per keyframe.
With `--port`, the port's `run_mono` then runs the same sequence on the
CPU twice, on the reference's RANSAC draws and on its own, each followed
by the same extra line.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _run(cli, system, argv) -> dict:
    """`cli.main(argv)` with the system it builds caught at `summary()`."""
    seen = []
    summary = system.SlamSystem.summary

    def keep(self):
        seen.append(self)
        return summary(self)

    system.SlamSystem.summary = keep
    try:
        out = cli.main(argv)
    finally:
        system.SlamSystem.summary = summary
    sysm = seen[-1]
    valid = [bool(v) for v in sysm.objects.valid]
    extra = {
        "kf_frames": sysm.stats.get("kf_frames"),
        "labels": [int(lab) for lab, v in zip(sysm.objects.label, valid) if v],
        "ellipsoids": [[float(x) for x in e] for e, v in zip(sysm.objects.ellipsoid, valid) if v],
        "ba_ms": sysm.stats["ba_ms"],
        "obj_ms": sysm.stats["obj_ms"],
        "resets": sysm.stats.get("resets", 0),
    }
    print(json.dumps(extra))
    return {**out, **extra}


def _reference_draws():
    """The port's draw functions replaced by the reference's `jax.random`
    numbers for the same seeds (the two-view choice and the plane's
    uniforms)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    def two_view(valid, gen, num_hyp):
        kE, kH = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        v = jnp.asarray(valid.cpu().numpy())
        p = v.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        return tuple(torch.from_numpy(np.array(jax.random.choice(k, v.shape[0], shape=(num_hyp, n), p=p)))
                     for k, n in ((kE, 8), (kH, 4)))

    def plane(gen, num_hyp):
        key = jax.random.PRNGKey(gen.initial_seed())
        return (torch.from_numpy(np.array(jax.random.uniform(key, (num_hyp, 3)))),
                torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 1), (num_hyp,)))))

    return two_view, plane


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--port", action="store_true", help="also run the port's command line on the CPU")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from qsp_slam_tpu import run_mono
    from qsp_slam_tpu.data import make_tum
    from qsp_slam_tpu.slam import system

    seq = os.path.join(args.out_dir, "seq")
    make_tum.main([seq, "--frames", str(args.frames), "--objects", "3", "--detections", "--step", "0.025",
                   "--pitch", "0.4", "--seed", "2"])
    flags = [seq, "--detections", os.path.join(seq, "detections"), "--cpu"]
    results = [_run(run_mono, system, flags)]
    if args.port:
        from qsp_slam_tpu_torch import run_mono as port_mono
        from qsp_slam_tpu_torch.perception import groundplane
        from qsp_slam_tpu_torch.slam import mono
        from qsp_slam_tpu_torch.slam import system as port_system

        two_view, plane = _reference_draws()
        saved = (port_system.mono_initialize, port_system.estimate_ground_plane_points)
        port_system.mono_initialize = functools.partial(mono.mono_initialize, draw=two_view)
        port_system.estimate_ground_plane_points = functools.partial(groundplane.estimate_ground_plane_points,
                                                                     draw=plane)
        try:
            results.append(_run(port_mono, port_system, flags))
        finally:
            port_system.mono_initialize, port_system.estimate_ground_plane_points = saved
        results.append(_run(port_mono, port_system, flags))
    return results


if __name__ == "__main__":
    main()

"""Monocular command line (counterpart of `qsp_slam_tpu/run_mono.py`):
reads a TUM-format sequence (the gray images; depth is ignored), tracks
every frame with `SlamSystem.track_mono`, and prints one JSON line:
`SlamSystem.summary()` and, when the sequence has ground truth, the
Sim(3)-aligned ATE (`ate_rmse_m_sim3`, in the ground truth's units).  With
`--detections DIR` the per-frame caches `DIR/<frame>.npz` feed the object
landmarks (objects are on exactly then).  `--save-dir` writes
`CameraTrajectory.txt`.  It runs on CUDA unless given `--cpu`.

    python -m qsp_slam_tpu_torch.run_mono SEQUENCE_DIR [--config seq.yaml]
        [--save-dir out] [--max-frames F] [--detections DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence", help="TUM-format directory (rgb.txt is read; depth is ignored)")
    ap.add_argument("--config", default=None, help="sequence YAML")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--detections", default=None,
                    help="directory of per-frame detection caches (<frame>.npz): object landmarks "
                         "from boxes, the ground plane and aspect priors")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    from .data.io import load_detection_cache, save_trajectory_tum
    from .data.tum import TumSequence
    from .eval.ate import ate_rmse
    from .slam.system import SlamSystem
    from .slam.tracking import TrackingConfig

    if args.config:
        from .slam.config import tracking_config_from_yaml

        cfg = tracking_config_from_yaml(args.config)
    else:
        cfg = TrackingConfig()
    seq = TumSequence(args.sequence)
    sysm = SlamSystem(cfg, enable_objects=args.detections is not None, device="cpu" if args.cpu else None)
    timestamps, gt = [], []
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    for gray, _depth, t, T_cw_gt, idx in seq.prefetch_iter(list(range(n))):
        det = None
        if args.detections:
            p = os.path.join(args.detections, f"{idx}.npz")
            if os.path.exists(p):
                det = load_detection_cache(p)
        sysm.track_mono(gray, det)
        timestamps.append(t)
        gt.append(T_cw_gt)

    out = sysm.summary()
    est = np.stack(sysm.trajectory)
    if gt and all(g is not None for g in gt):
        out["ate_rmse_m_sim3"] = ate_rmse(est, np.stack(gt), with_scale=True)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        save_trajectory_tum(os.path.join(args.save_dir, "CameraTrajectory.txt"), timestamps, est)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Train the learned 2D detector on the synthetic renderer's ground truth
and save its weights (counterpart of `qsp_slam_tpu/train_detector2d.py`;
no dataset and no pretrained weights are needed).  It runs on CUDA unless
given `--cpu`, and prints one JSON line (`out`, `steps`, `final_loss`, the
mean of the last 20 losses, and `backend`).

    python -m qsp_slam_tpu_torch.train_detector2d --out detector2d.npz
        [--steps 2600] [--scenes 4] [--lr 2e-3] [--seed 0] [--half] [--cpu]

The weights file is the JAX package's npz: either package loads it.
Then: python -m qsp_slam_tpu_torch.run_tum SEQ --detector detector2d.npz
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=2600)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--half", action="store_true",
                    help="train at 240x320 (detect_objects mean-pools 480x640 frames)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .perception.detector2d import DetectorConfig, save_detector2d, train_detector
    from .slam.tracking import TrackingConfig

    dev = resolve_device("cpu" if args.cpu else None)
    if args.half:
        cfg = DetectorConfig(input_hw=(240, 320))
        intr = TrackingConfig(fx=260.45, fy=260.5, cx=162.55, cy=124.85, width=320, height=240).intr
    else:
        cfg, intr = DetectorConfig(), None
    params, losses = train_detector(args.seed, cfg, steps=args.steps, scenes=args.scenes, lr=args.lr, intr=intr,
                                    device=dev)
    save_detector2d(args.out, params, cfg)
    out = {"out": args.out, "steps": args.steps, "final_loss": float(np.mean(losses[-20:])), "backend": dev.type}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

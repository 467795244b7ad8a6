"""Train the learned 3D detector on procedural LiDAR scans and save its
weights (counterpart of `qsp_slam_tpu/train_detector3d.py`; no dataset
and no pretrained weights are needed).  It runs on CUDA unless given
`--cpu`, and prints one JSON line (`out`, `steps`, `final_loss`, the mean
of the last 20 losses, and `backend`).

    python -m qsp_slam_tpu_torch.train_detector3d --out detector3d.npz [--steps 800] [--seed 0] [--cpu]

The weights file is the JAX package's npz: either package loads it.
Then: python -m qsp_slam_tpu_torch.run_kitti SEQ --detector3d detector3d.npz
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .perception.detector3d import Detector3DConfig, save_detector3d, train_detector3d

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = Detector3DConfig()
    params, losses = train_detector3d(args.seed, cfg, steps=args.steps, device=dev)
    save_detector3d(args.out, params, cfg)
    out = {"out": args.out, "steps": args.steps, "final_loss": float(np.mean(losses[-20:])), "backend": dev.type}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

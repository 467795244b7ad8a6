#!/usr/bin/env python3
"""How far the map-sharded BA at world sizes 1 and 2 parts on the CPU.

    python tools/dist_world_gap.py [OUT_DIR] [--world W]

Runs `chip_smoke.py` phase 21's point problem (`dist_problems`: 128
stereo keyframes, 16384 points, 8 observations each, 5% outliers, 10 LM
trips) through `map_sharded_ba` as one gloo rank and as W (default 2) on
the CPU, and prints the cost, pose and point gaps between them, the
points' by their number of observations and the most any point with 4
or more inlier observations moves.  The sums run in another order
at each world size, so the gaps are what f32 rounding leaves of this
problem's solution: the scale of phase 21's gates.  About 2 minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from qsp_slam_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out_dir or tmp)
        out.mkdir(parents=True, exist_ok=True)
        inliers = cs.dist_problems(out / "all.npz")
        z = np.load(out / "all.npz")
        cases = [dict(c, time=False) for c in json.loads(str(z["cases"])) if c["name"] == "map"]
        np.savez(out / "map.npz", cases=np.array(json.dumps(cases)), **{k: z[k] for k in z.files if k != "cases"})
        for w in (1, args.world):
            spawn_ranks(w, [str(out / "map.npz"), str(out / f"w{w}"), "--cpu"], target=cs.REPLAY, cpu=True,
                        timeout=3600)
        a, b = (np.load(out / f"w{w}" / "rank0.npz") for w in (1, args.world))
        d = np.linalg.norm(a["map/points"] - b["map/points"], axis=1)
        obs = np.bincount(z["p/pt_idx"], minlength=d.shape[0])
        res = {"cost": [float(a["map/cost"]), float(b["map/cost"])],
               "cost_rel_gap": abs(float(a["map/cost"]) - float(b["map/cost"])) / float(a["map/cost"]),
               "poses_gap": float(np.abs(a["map/Tcw"] - b["map/Tcw"]).max()),
               "points_gap": {q: float(np.percentile(d, q)) for q in (50, 90, 99, 99.9)} | {"max": float(d.max())},
               "points_gap_max_4_inliers": float(d[inliers >= 4].max()),
               "points_gap_by_observations": {int(c): {"points": int((obs == c).sum()), "max": float(d[obs == c].max())}
                                              for c in np.unique(obs)}}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where one LM trip of the map-sharded BA spends its time on the card.

    python tools/dist_trip_profile.py [--worlds 1 2]

For each world size, starts that many ranks on the card (`spawn_ranks`;
NCCL with a card per rank, gloo when they share one) on `chip_smoke.py`
phase 21's problem (128 stereo keyframes, 16384 points, 32 objects).
Each rank warms both solvers up, times the point BA (`map_sharded_ba`)
and the joint BA (`map_sharded_joint_ba`) at 10 trips and at 0 (the
difference over 10 is one trip) and profiles a 2-trip call of each with
`torch.profiler`; rank 0 prints the tables (by device time, and by host
time).  Needs a card; about a minute.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rank_main(argv) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from qsp_slam_tpu_torch.opt.joint_ba import ObjectPoseEdges
    from qsp_slam_tpu_torch.opt.reproj import ReprojEdges
    from qsp_slam_tpu_torch.parallel.map_sharded_ba import edges_to_slots, map_sharded_ba, map_sharded_joint_ba
    from qsp_slam_tpu_torch.parallel.mesh import make_mesh

    path = argv[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    z = np.load(path)

    def t(name):
        return torch.from_numpy(np.array(z[f"p/{name}"])).to(dev)

    from qsp_slam_tpu_torch.core.camera import Intrinsics

    intr = Intrinsics(*(float(x) for x in z["p/intr"]))
    bf = float(z["p/bf"])
    T0, p0, fix = t("Tcw"), t("points"), t("cam_fixed")
    slots = edges_to_slots(ReprojEdges(*(t(f) for f in ReprojEdges._fields)), p0.shape[0])
    Tow, ofix = t("Tow"), t("obj_fixed")
    oe = ObjectPoseEdges(*(t(f"obj_{f}") for f in ObjectPoseEdges._fields))
    mesh = make_mesh(axis="map", device=dev)
    solvers = {
        "point": lambda n: map_sharded_ba(mesh, T0, p0, fix, slots, intr, bf, iters=n),
        "joint": lambda n: map_sharded_joint_ba(mesh, T0, Tow, p0, fix, ofix, slots, oe, intr, bf, iters=n),
    }
    for name, run in solvers.items():
        run(2)
        ts = {}
        for n in (10, 0):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize(dev)
            ts[n] = (time.perf_counter() - t0) * 1e3
        print(f"[rank {mesh.rank}/{mesh.size} {mesh.backend}] {name}: {(ts[10] - ts[0]) / 10:.3f} ms per LM trip "
              f"(10 trips {ts[10]:.1f} ms, entry {ts[0]:.1f} ms)", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            run(2)
            torch.cuda.synchronize(dev)
        if mesh.rank == 0:
            ka = pr.key_averages()
            print(f"--- {name}, world {mesh.size}: a 2-trip call, by device time", flush=True)
            print(ka.table(sort_by="cuda_time_total", row_limit=12), flush=True)
            print(f"--- {name}, world {mesh.size}: by host time", flush=True)
            print(ka.table(sort_by="cpu_time_total", row_limit=10), flush=True)
        dist.barrier()


def main(argv=None) -> None:
    import tempfile

    import chip_smoke as cs
    from qsp_slam_tpu_torch.parallel.multihost import spawn_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args(argv)
    print(f"card: {cs.card_line()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cs.dist_problems(Path(tmp, "p.npz"))
        for w in args.worlds:
            for r in spawn_ranks(w, [str(Path(tmp, "p.npz"))], target="tools.dist_trip_profile:rank_main",
                                 timeout=600):
                print(r.stdout, flush=True)


if __name__ == "__main__":
    main()

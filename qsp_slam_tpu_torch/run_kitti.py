"""KITTI odometry stereo command line (counterpart of
`qsp_slam_tpu/run_kitti.py`): tracks a sequence's stereo pairs with loop
closing on, with object landmarks from per-frame detection caches
(`--detections`) or from the velodyne scans at keyframes only: geometric
proposals (`--lidar-detections`) or the learned 3D detector's boxes
(`--detector3d`, which implies `--lidar-detections`), and prints one JSON
line:
`SlamSystem.summary()` plus, given `--poses`, the ATE, RPE and keyframe
ATE (the keyframe chain after loop correction).  With `--save-dir` it
writes `trajectory.txt` (KITTI format) and `report.json` (the summary
with `loop_events`, `loop_scan`, `capacity_events`, `resets`,
`relocalizations`, `global_ba` (each whole-map BA's branch), `peak_rss_mb` and, with LiDAR detections,
`det_ms_median` and `det_keyframes`).  It runs on CUDA unless given
`--cpu`.

    python -m qsp_slam_tpu_torch.run_kitti SEQ_DIR [--poses poses.txt]
        [--save-dir out] [--max-frames F] [--detections DIR |
        --lidar-detections [--detector3d PARAMS_NPZ]] [--global-ba] [--mesh N] [--cpu]

With `--mesh N` (N > 1) the command runs itself as N ranks
(`parallel.multihost.spawn_ranks`): every rank tracks every frame with
its replica of the system, the post-loop and final global BA run
map-sharded over the ranks from rank 0's state (joint with the objects
when they have pose measurements), rank 0 alone writes `--save-dir` and
prints, each rank writes its final map's SHA-256 on stderr (`[rank r/N]
map ...`), and a failed rank fails the command.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys

import numpy as np


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence", help=".../sequences/NN directory")
    ap.add_argument("--poses", default=None, help="ground-truth poses file for ATE")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--detections", default=None, help="directory of per-frame detection caches (<index>.npz)")
    ap.add_argument("--lidar-detections", action="store_true",
                    help="detections from the velodyne scans (ground removal + clustering), at keyframes")
    ap.add_argument("--detector3d", default=None, metavar="PARAMS_NPZ",
                    help="learned 3D detector's weights (train_detector3d); implies --lidar-detections")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run the post-loop and final global BA map-sharded over N ranks, started here as N "
                         "processes (gloo on the CPU or on a shared card, NCCL with a card per rank); only rank "
                         "0 prints and saves")
    ap.add_argument("--global-ba", action="store_true",
                    help="one full-map optimization pass after the sequence")
    ap.add_argument("--kmax", type=int, default=128)
    ap.add_argument("--nmax", type=int, default=16384)
    ap.add_argument("--emax", type=int, default=131072)
    ap.add_argument("--num-features", type=int, default=2000)
    args = ap.parse_args(argv)
    from .parallel.multihost import cli_mesh

    mesh, ranks_out = cli_mesh("qsp_slam_tpu_torch.run_kitti", argv, args.mesh, args.cpu)
    if ranks_out is not None:
        return ranks_out
    lead = mesh is None or mesh.rank == 0

    from .data.io import load_detection_cache, save_trajectory_kitti
    from .data.kitti import KittiSequence
    from .eval.ate import ate_rmse, rpe
    from .frontend.orb import OrbConfig
    from .frontend.pyramid import PyramidConfig
    from .perception.lidar_detect import lidar_detections
    from .slam.system import SlamSystem
    from .slam.tracking import TrackingConfig

    seq = KittiSequence(args.sequence, args.poses)
    intr = seq.intrinsics
    g0, _ = seq.load_gray_pair(0)
    H, W = g0.shape
    cfg = TrackingConfig(
        # The reference's KITTI feature budget (KITTI00-02.yaml).
        orb=OrbConfig(num_features=args.num_features, pyramid=PyramidConfig(height=H, width=W)),
        fx=float(intr["fx"]), fy=float(intr["fy"]), cx=float(intr["cx"]), cy=float(intr["cy"]),
        width=W, height=H, baseline=seq.baseline, depth_max=60.0,
        # Bound per-frame tracking cost on long drives.
        local_map_budget=8192,
    )
    sysm = SlamSystem(cfg, kmax=args.kmax, nmax=args.nmax, emax=args.emax, mesh=mesh,
                      device="cpu" if args.cpu else None)
    d3d = None
    if args.detector3d:
        from .perception.detector3d import lidar_detections_learned, load_detector3d

        d3d = load_detector3d(args.detector3d, device=sysm.device)
        args.lidar_detections = True
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    # Stereo pairs decode ahead on the native worker pool.
    for idx, (gl, gr) in zip(range(n), seq.prefetch_pairs(range(n))):
        det = None
        if args.detections:
            p = os.path.join(args.detections, f"{idx}.npz")
            if os.path.exists(p):
                det = load_detection_cache(p)
        elif args.lidar_detections:
            # A lazy provider: the system calls it at keyframes only.
            def det(i=idx):
                pts_cam = seq.transform_velo_to_cam(seq.load_velodyne(i, max_points=30000))
                if d3d is not None:
                    return lidar_detections_learned(*d3d, pts_cam, cfg.intr, W, H)
                return lidar_detections(pts_cam, cfg.intr, W, H, device=sysm.device)
        sysm.track_stereo(gl, gr, det)
        if (idx + 1) % 50 == 0:
            print(f"[{idx + 1}/{n}] kfs={sysm.stats['keyframes']}", file=sys.stderr)

    if args.global_ba:
        sysm.run_global_ba()
    out = sysm.summary()
    if args.global_ba:
        out["global_ba"] = True
    if mesh is not None:
        from .parallel.mesh import tree_digest

        out["mesh"] = {"size": mesh.size, "backend": mesh.backend}
        # Every rank's final map: after a global BA the ranks hold rank 0's.
        print(f"[rank {mesh.rank}/{mesh.size}] map {tree_digest((sysm.map_state, sysm.objects))}", file=sys.stderr)
    est = np.stack(sysm.trajectory)
    if seq.poses is not None:
        gt_Tcw = np.stack([np.linalg.inv(T) for T in seq.poses[:n]])
        out["ate_rmse_m"] = ate_rmse(est, gt_Tcw)
        out.update(rpe(est, gt_Tcw))
        # Keyframe-trajectory ATE: reflects loop-closure and global-BA
        # corrections, which the frozen per-frame history does not.
        kf_frames = sysm.stats.get("kf_frames", [])
        n_kf = int(sysm.map_state.num_kfs)
        if len(kf_frames) >= 2 and len(kf_frames) == n_kf:
            live = sysm.map_state.kf_valid[:n_kf].cpu().numpy()
            kf_est = sysm.map_state.kf_Tcw[:n_kf].cpu().numpy()[live]
            if len(kf_est) >= 2:
                out["kf_ate_rmse_m"] = ate_rmse(kf_est, gt_Tcw[np.asarray(kf_frames)[live]])
    if not lead:
        return out
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        save_trajectory_kitti(os.path.join(args.save_dir, "trajectory.txt"), est)
        # `ate_rmse_m` is the frozen per-frame history, `kf_ate_rmse_m` the
        # corrected keyframe chain: the pair is the before and after of the
        # loop closures listed here.
        report = dict(out)
        for key, default in (("loop_events", []), ("loop_scan", []), ("capacity_events", []),
                             ("resets", 0), ("relocalizations", 0), ("global_ba", [])):
            report[key] = sysm.stats.get(key, default)
        det_ms = sysm.stats.get("det_ms", [])
        if det_ms:
            report["det_ms_median"] = float(np.median(det_ms))
            report["det_keyframes"] = len(det_ms)
        report["peak_rss_mb"] = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)
        with open(os.path.join(args.save_dir, "report.json"), "w") as f:
            json.dump(report, f)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

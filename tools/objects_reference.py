#!/usr/bin/env python3
"""The JAX package's RGB-D and stereo object command lines on its own
fabricated sequences, with the numbers `chip_smoke.py` phases 13 and 14
are gated against.

    JAX_PLATFORMS=cpu python tools/objects_reference.py OUT_DIR [--frames 60] [--only tum|kitti]

RGB-D (phase 13): the JAX `make_tum` writes phase 11's sequence (`--objects
3 --detections --step 0.025 --pitch 0.4 --seed 2`) into OUT_DIR/tum, and
`qsp_slam_tpu.run_tum` runs it with `--detections` at 4000 features (a
one-line YAML) on the CPU.  Stereo (phase 14): the JAX `make_kitti`
writes phase 9's drive (1241x376, seed 2) into OUT_DIR/kitti, and
`qsp_slam_tpu.run_kitti` runs it at its defaults with `--poses
--lidar-detections --global-ba`, and then its `SlamSystem` drives the
same frames with a perfect 3D detector's detections (`chip_smoke.py`'s
`drive_detections`, the measured-ellipsoid branch) and `run_global_ba`,
the second run of phase 14.  Each run prints its JSON line and then one
more: the keyframe frames, the live objects' labels and ellipsoids,
the objects with camera-object pose measurements, the Manhattan planes
with two or more votes, object ms per keyframe and, for the RGB-D scene,
`evaluate_objects` against the scene's ground truth in the first
camera's frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _run(cli, system, argv, gt=None) -> dict:
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
    valid = np.asarray(sysm.objects.valid)
    est, labels = np.asarray(sysm.objects.ellipsoid)[valid], np.asarray(sysm.objects.label)[valid]
    votes, pvalid = np.asarray(sysm.plane_set.votes), np.asarray(sysm.plane_set.valid)
    extra = {
        "kf_frames": sysm.stats.get("kf_frames"),
        "labels": [int(x) for x in labels],
        "ellipsoids": [[round(float(x), 5) for x in e] for e in est],
        "objects_with_pose_measurements": int(((np.asarray(sysm.objects.pm_kf) >= 0).sum(1) > 0)[valid].sum()),
        "planes_2_votes": int((pvalid & (votes >= 2)).sum()),
        "plane_votes": [int(v) for v in votes[pvalid]],
        "obj_ms": [round(x, 1) for x in sysm.stats["obj_ms"]],
        "det_ms": [round(x, 1) for x in sysm.stats.get("det_ms", [])],
    }
    if gt is not None:
        from qsp_slam_tpu.eval.objects import evaluate_objects

        res = evaluate_objects(est, labels, *gt)
        extra["eval"] = {"precision": res.precision, "recall": res.recall, "mean_iou": res.mean_iou,
                         "mean_center_err": res.mean_center_err, "matches": res.matches}
        d = [np.linalg.norm(gt[0][:, :3] - e[:3], axis=1) for e in est]
        extra["matched_0.4m_same_label"] = int(sum(dd.min() < 0.4 and gt[1][dd.argmin()] == lab
                                                   for dd, lab in zip(d, labels)))
    print(json.dumps(extra))
    return {**out, **extra}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--only", choices=("tum", "kitti"), default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from qsp_slam_tpu import run_kitti, run_tum
    from qsp_slam_tpu.core import quadric
    from qsp_slam_tpu.data import make_kitti, make_tum
    from qsp_slam_tpu.data.render import make_scene, orbit_trajectory
    from qsp_slam_tpu.slam import system

    results = []
    if args.only in (None, "tum"):
        seq = os.path.join(args.out_dir, "tum")
        make_tum.main([seq, "--frames", str(args.frames), "--objects", "3", "--detections", "--step", "0.025",
                       "--pitch", "0.4", "--seed", "2"])
        conf = os.path.join(args.out_dir, "tum.yaml")
        with open(conf, "w") as f:
            f.write("ORBextractor.nFeatures: 4000\n")
        scene = make_scene(num_objects=3, seed=2)
        first = orbit_trajectory(1, step=0.025, pitch=0.4)[0]  # the SLAM world is camera 0's frame
        gt = (np.asarray(quadric.transform_ellipsoid(scene.ellipsoids, jnp.asarray(first))), np.asarray(scene.labels))
        results.append(_run(run_tum, system, [seq, "--detections", os.path.join(seq, "detections"), "--config", conf,
                                              "--cpu"], gt))
    if args.only in (None, "kitti"):
        seq = os.path.join(args.out_dir, "kitti")
        poses = os.path.join(args.out_dir, "kitti_poses.txt")
        make_kitti.main([seq, "--frames", str(args.frames), "--height", "376", "--width", "1241", "--seed", "2",
                         "--poses-out", poses])
        results.append(_run(run_kitti, system, [seq, "--poses", poses, "--lidar-detections", "--global-ba", "--cpu"]))
        results.append(_drive_gt3d(seq, poses, args.frames))
    return results


def _drive_gt3d(seq_dir: str, poses: str, frames: int) -> dict:
    """The JAX stereo system on the drive with a perfect 3D detector's
    detections, at `run_kitti`'s configuration, then `run_global_ba`."""
    from chip_smoke import drive_detections
    from qsp_slam_tpu.data.kitti import KittiSequence
    from qsp_slam_tpu.eval.ate import ate_rmse, rpe
    from qsp_slam_tpu.frontend.orb import OrbConfig
    from qsp_slam_tpu.frontend.pyramid import PyramidConfig
    from qsp_slam_tpu.slam import joint_mapping, system
    from qsp_slam_tpu.slam.tracking import TrackingConfig
    from qsp_slam_tpu_torch.data.kitti import KittiSequence as PortKittiSequence

    seq = KittiSequence(seq_dir, poses)
    intr = seq.intrinsics
    H, W = seq.load_gray_pair(0)[0].shape
    cfg = TrackingConfig(orb=OrbConfig(num_features=2000, pyramid=PyramidConfig(height=H, width=W)),
                         fx=float(intr["fx"]), fy=float(intr["fy"]), cx=float(intr["cx"]), cy=float(intr["cy"]),
                         width=W, height=H, baseline=seq.baseline, depth_max=60.0, local_map_budget=8192)
    dets = drive_detections(PortKittiSequence(seq_dir, poses), frames)
    windows = []
    step = joint_mapping.joint_ba_step

    def counted(m, objects, cfg, window=8):
        windows.append(window)
        return step(m, objects, cfg, window)

    joint_mapping.joint_ba_step = counted
    try:
        sysm = system.SlamSystem(cfg, kmax=128, nmax=16384, emax=131072)
        for i in range(frames):
            sysm.track_stereo(*seq.load_gray_pair(i), dets[i])
        sysm.run_global_ba()
    finally:
        joint_mapping.joint_ba_step = step
    gt = np.stack([np.linalg.inv(T) for T in seq.poses[:frames]])
    est = np.stack(sysm.trajectory)
    n_kf = int(sysm.map_state.num_kfs)
    valid = np.asarray(sysm.objects.valid)
    out = {"kf_frames": sysm.stats["kf_frames"], "ate_rmse_m": ate_rmse(est, gt), **rpe(est, gt),
           "kf_ate_rmse_m": ate_rmse(np.asarray(sysm.map_state.kf_Tcw[:n_kf]), gt[np.asarray(sysm.stats["kf_frames"])]),
           "objects": int(valid.sum()), "labels": [int(x) for x in np.asarray(sysm.objects.label)[valid]],
           "pose_measurements": int((np.asarray(sysm.objects.pm_kf) >= 0).sum()), "joint_ba_windows": windows,
           "obj_ms": [round(x, 1) for x in sysm.stats["obj_ms"]]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

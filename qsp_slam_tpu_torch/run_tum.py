"""TUM RGB-D command line (counterpart of `qsp_slam_tpu/run_tum.py`):
reads a TUM-format sequence, tracks every `--skip`-th frame (with the
frame's detection cache `<index>.npz` from `--detections`, when there is
one, feeding the object landmarks; or, with `--detector`, the learned 2D
detector's boxes at keyframes), and prints one JSON line:
`SlamSystem.summary()`, the ATE, RPE and keyframe ATE against the ground
truth when it has one, and `decoded_by`, the number of frames each
decoder read.  With `--save-dir` it writes `CameraTrajectory.txt` (TUM
format), `map.npz` with the objects, the scene's PLYs (`map_points.ply`,
`object_wireframes.ply`, `trajectory.ply`; `viz/export.export_scene`)
and, when there are objects, `objects_render.png` (the object map
rendered from the final camera over its gray frame).  With
`--save-frames DIR` every `--frame-every`-th tracked frame is drawn into
`DIR/<index>.png` (`viz/frame_draw`: keypoints, tracked in green, the
frame's detection boxes and a status bar).  It runs on CUDA unless given
`--cpu`.

    python -m qsp_slam_tpu_torch.run_tum SEQUENCE_DIR [--config seq.yaml]
        [--save-dir out] [--save-frames DIR [--frame-every N]] [--skip N]
        [--max-frames F] [--detections DIR | --detector PARAMS_NPZ]
        [--global-ba] [--mesh N] [--cpu]

With `--mesh N` (N > 1) the command runs itself as N ranks
(`parallel.multihost.spawn_ranks`): every rank tracks every frame with
its replica of the system, the global BA runs map-sharded over the ranks
from rank 0's state, rank 0 alone writes `--save-dir` and
`--save-frames` and prints, each
rank writes its final map's SHA-256 on stderr (`[rank r/N] map ...`), and
a failed rank fails the command.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
from collections import Counter

import numpy as np


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--config", default=None, help="sequence YAML")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--skip", type=int, default=1, help="process every Nth frame")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--detections", default=None, help="directory of per-frame detection caches (<index>.npz)")
    ap.add_argument("--detector", default=None, metavar="PARAMS_NPZ",
                    help="learned 2D detector's weights (train_detector2d): detect online at keyframes")
    ap.add_argument("--save-frames", default=None, metavar="DIR", help="write annotated frames to DIR")
    ap.add_argument("--frame-every", type=int, default=10, help="with --save-frames, draw every Nth frame")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run the post-loop and final global BA map-sharded over N ranks, started here as N "
                         "processes (gloo on the CPU or on a shared card, NCCL with a card per rank); only rank "
                         "0 prints and saves")
    ap.add_argument("--global-ba", action="store_true",
                    help="one full-map optimization pass after the sequence")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)
    from .parallel.multihost import cli_mesh

    mesh, ranks_out = cli_mesh("qsp_slam_tpu_torch.run_tum", argv, args.mesh, args.cpu)
    if ranks_out is not None:
        return ranks_out
    lead = mesh is None or mesh.rank == 0

    from .data.io import load_detection_cache, save_map, save_trajectory_tum
    from .data.tum import TumSequence
    from .eval.ate import ate_rmse, rpe
    from .slam.system import SlamSystem
    from .slam.tracking import TrackingConfig
    from .viz import frame_draw
    from .viz.export import export_scene

    if args.config:
        from .slam.config import tracking_config_from_yaml

        cfg = tracking_config_from_yaml(args.config)
    else:
        cfg = TrackingConfig()
    seq = TumSequence(args.sequence)
    detector = None
    if args.detector:
        from .perception.detector2d import load_detector2d

        detector = load_detector2d(args.detector, device="cpu" if args.cpu else None)
    draw = lead and args.save_frames is not None
    sysm = SlamSystem(cfg, detector=detector, mesh=mesh, keep_frame_info=draw, device="cpu" if args.cpu else None)
    timestamps, gt = [], []
    indices = list(range(0, len(seq), args.skip))
    if args.max_frames:
        indices = indices[: args.max_frames]
    # Frames decode ahead on the native worker pool.
    for gray, depth, t, T_cw_gt, idx in seq.prefetch_iter(indices):
        det = None
        if args.detections:
            p = os.path.join(args.detections, f"{idx}.npz")
            if os.path.exists(p):
                det = load_detection_cache(p)
        sysm.track_rgbd(gray, depth, det)
        if draw and len(timestamps) % args.frame_every == 0:
            info = sysm.last_frame_info or {}
            frame_draw.save_annotated(os.path.join(args.save_frames, f"{idx:06d}.png"), gray,
                                      kp_xy=info.get("kp_xy"), kp_tracked=info.get("kp_tracked"),
                                      bboxes=det.get("bbox") if det else None,
                                      labels=det.get("label") if det else None,
                                      probs=det.get("prob") if det else None,
                                      bbox_valid=det.get("valid") if det else None,
                                      status=frame_draw.frame_status(sysm, idx))
        timestamps.append(t)
        gt.append(T_cw_gt)
        if len(timestamps) % 50 == 0:
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
            print(f"[{len(timestamps)}] kfs={sysm.stats['keyframes']} rss={rss}MB", file=sys.stderr)

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
    if gt and all(g is not None for g in gt):
        gt_arr = np.stack(gt)
        out["ate_rmse_m"] = ate_rmse(est, gt_arr)
        out.update(rpe(est, gt_arr))
        # Keyframe-trajectory ATE: reflects what global BA corrects, which
        # the per-frame history above does not.
        kf_frames = sysm.stats.get("kf_frames", [])
        n_kf = int(sysm.map_state.num_kfs)
        if len(kf_frames) >= 2 and len(kf_frames) == n_kf:
            live = sysm.map_state.kf_valid[:n_kf].cpu().numpy()
            kf_est = sysm.map_state.kf_Tcw[:n_kf].cpu().numpy()[live]
            if len(kf_est) >= 2:
                out["kf_ate_rmse_m"] = ate_rmse(kf_est, gt_arr[np.asarray(kf_frames)[live]])
    out["decoded_by"] = dict(Counter(seq.decoded_by.values()))
    if not lead:
        return out
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        save_trajectory_tum(os.path.join(args.save_dir, "CameraTrajectory.txt"), timestamps, est)
        save_map(os.path.join(args.save_dir, "map.npz"), sysm.map_state, sysm.objects)
        export_scene(args.save_dir, sysm.map_state, sysm.objects, trajectory=est)
        if int(sysm.objects.valid.sum()) > 0:
            from .viz.object_render import render_objects_png

            render_objects_png(os.path.join(args.save_dir, "objects_render.png"), sysm.objects, sysm.Tcw, cfg.intr,
                               cfg.height, cfg.width, gray=gray, shape_prior=sysm.shape_prior)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

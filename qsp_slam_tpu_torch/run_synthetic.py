"""End-to-end synthetic RGB-D run (counterpart of
`qsp_slam_tpu/run_synthetic.py`): renders a sequence with known ground
truth, runs tracking and mapping, and prints one JSON line with the
summary, the ATE and RPE.  Point-only by default (the textured room on an
orbit); with `--objects`, three objects on the floor seen 25 degrees down
with the renderer's detections and instance masks, and a toy DeepSDF
prior trained on the fly (code 16, hidden 96, 6 layers) reconstructing
them: the JSON then adds the object map's precision, recall, mean IoU and
centre error against the scene, and `shapes_reconstructed`.  `--detector`
(which implies `--objects`) trains the learned 2D detector on the
renderer's ground truth first (3000 steps over 8 scenes, lr 2e-3, seed 7)
and tracks without detections: the detector supplies them at keyframes.
It runs on CUDA unless given `--cpu`.

    python -m qsp_slam_tpu_torch.run_synthetic [num_frames] [--objects] [--detector] [--cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {a for a in argv if a.startswith("--")}
    unknown = flags - {"--cpu", "--objects", "--detector"}
    if unknown:
        raise SystemExit(f"run_synthetic: unknown options {sorted(unknown)}")
    if "--detector" in flags:
        flags.add("--objects")
    pos = [a for a in argv if not a.startswith("--")]
    num_frames = int(pos[0]) if pos else 120

    from . import resolve_device
    from .core import lie, quadric
    from .data.render import gt_detections, make_room, make_scene, orbit_trajectory, render_frame, render_scene
    from .eval.ate import ate_rmse, rpe
    from .frontend.orb import OrbConfig
    from .slam.system import SlamSystem
    from .slam.tracking import TrackingConfig

    dev = resolve_device("cpu" if "--cpu" in flags else None)
    cfg = TrackingConfig(orb=OrbConfig(num_features=1000))
    Tcw_gt = orbit_trajectory(num_frames)
    if "--objects" in flags:
        from .models.deepsdf import DeepSDFConfig, train_toy_decoder

        dec_cfg = DeepSDFConfig(code_dim=16, hidden=96, num_layers=6, latent_in=(3,))
        params, _, _ = train_toy_decoder(0, dec_cfg, num_shapes=8, steps=300, batch=512, device=dev)
        scene = make_scene(num_objects=3, seed=2, device=dev)
        pitch = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0], dtype=torch.float32)).numpy()
        Tcw_gt = np.einsum("fij,jk->fik", Tcw_gt, pitch).astype(np.float32)
        detector = None
        if "--detector" in flags:
            from .perception.detector2d import DetectorConfig, train_detector

            dcfg = DetectorConfig()
            detector = (train_detector(7, dcfg, steps=3000, scenes=8, lr=2e-3, device=dev)[0], dcfg)
        sysm = SlamSystem(cfg, shape_prior=(params, dec_cfg), detector=detector, device=dev)
        for T in Tcw_gt:
            gray, depth, inst = render_scene(scene, T, cfg.intr)
            if detector is not None:
                sysm.track_rgbd(gray, depth, None)
                continue
            det = gt_detections(scene, T, cfg.intr, instance=inst)
            sysm.track_rgbd(gray, depth, {k: v.cpu().numpy() for k, v in det.items()})
    else:
        room = make_room(device=dev)
        sysm = SlamSystem(cfg, device=dev)
        for T in Tcw_gt:
            sysm.track_rgbd(*render_frame(room, T, cfg.intr))

    est = np.stack(sysm.trajectory)
    out = sysm.summary()
    out["num_frames"] = num_frames
    out["ate_rmse_m"] = ate_rmse(est, Tcw_gt[: len(est)])
    out.update(rpe(est, Tcw_gt[: len(est)]))
    out["backend"] = dev.type
    if "--objects" in flags:
        objs = sysm.objects
        valid = (objs.valid & (objs.obs_count >= 2)).cpu()
        if bool(valid.any()):
            from .eval.objects import evaluate_objects

            # The SLAM world is the first camera's frame.
            est_e = quadric.transform_ellipsoid(objs.ellipsoid.cpu()[valid], lie.inv_se3(torch.from_numpy(Tcw_gt[0])))
            res = evaluate_objects(est_e.numpy(), objs.label.cpu().numpy()[valid.numpy()],
                                   scene.ellipsoids.cpu().numpy(), scene.labels.cpu().numpy())
            out["obj_precision"] = round(res.precision, 3)
            out["obj_recall"] = round(res.recall, 3)
            out["obj_mean_iou"] = round(res.mean_iou, 3)
            out["obj_center_err_m"] = round(res.mean_center_err, 4)
        out["shapes_reconstructed"] = int((objs.shape_ok.cpu() & valid).sum())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

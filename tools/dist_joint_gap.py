#!/usr/bin/env python3
"""Where the sharded whole-map BA and the single-device one part on
`chip_smoke.py` phase 21's KITTI drive.

    python tools/dist_joint_gap.py OUT_DIR [--runs N]              # the card
    JAX_PLATFORMS=cpu python tools/dist_joint_gap.py OUT_DIR --reference

On the card: phase 9's drive (`make_kitti` seed 2, 60 stereo frames at
1241x376) with phase 14's perfect 3D detector's caches through `run_kitti
--detections --global-ba` on one device, N times.  Each run's map and
objects as they stand before the final global BA are saved, cut to the
capacity they use (`OUT_DIR/state<i>.npz`), and from each the port runs
the four whole-map BAs: single-device joint (`joint_ba_step` over every
keyframe slot) and point (`global_ba_step`), and map-sharded joint and
point on a one-rank mesh (`global_joint_ba_sharded`, `global_ba_sharded`).
It prints the card's name and power limit, then one JSON line per run:
the keyframe ATE (m) before and after each, and the objects that have
pose measurements.

With --reference, on the CPU: the same four BAs from each saved state
through the JAX package (its sharded solvers under `jax.jit` on a
one-device mesh) and through the port, so that the card, the port and
the reference can be told apart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cut(z: dict, kmax: int, nmax: int, emax: int) -> dict:
    """The map's arrays cut from their capacity to (kmax, nmax, emax)."""
    K, N, E = z["kf_Tcw"].shape[0], z["pt_xyz"].shape[0], z["ob_kf"].shape[0]
    out = {}
    for k, v in z.items():
        if k.startswith("obj/") or k in ("kf_frames", "gt_Tcw", "intr", "bf", "size") or v.ndim == 0:
            out[k] = v
        else:
            out[k] = v[: {K: kmax, N: nmax, E: emax}[v.shape[0]]]
    return out


def _kf_ate(kf_Tcw, z) -> float:
    from qsp_slam_tpu_torch.eval.ate import ate_rmse

    n = int(z["num_kfs"])
    live = np.asarray(z["kf_valid"][:n], bool)
    return float(ate_rmse(np.asarray(kf_Tcw)[:n][live], z["gt_Tcw"][z["kf_frames"]][live]))


def _port_bas(z: dict, device: str) -> dict:
    import torch

    from qsp_slam_tpu_torch.convert import map_state_from_numpy, object_table_from_numpy
    from qsp_slam_tpu_torch.frontend.orb import OrbConfig
    from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig
    from qsp_slam_tpu_torch.parallel.mesh import make_mesh
    from qsp_slam_tpu_torch.slam.distributed_mapping import global_ba_sharded, global_joint_ba_sharded
    from qsp_slam_tpu_torch.slam.joint_mapping import joint_ba_step
    from qsp_slam_tpu_torch.slam.local_mapping import global_ba_step
    from qsp_slam_tpu_torch.slam.map import MapState
    from qsp_slam_tpu_torch.slam.objects import ObjectTable
    from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

    fx, fy, cx, cy = (float(v) for v in z["intr"])
    H, W = (int(v) for v in z["size"])
    cfg = TrackingConfig(orb=OrbConfig(num_features=2000, pyramid=PyramidConfig(height=H, width=W)),
                         fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H, baseline=float(z["bf"]) / fx,
                         depth_max=60.0, local_map_budget=8192)
    m = map_state_from_numpy({f: z[f] for f in MapState._fields}, device=device)
    o = object_table_from_numpy({f: z[f"obj/{f}"] for f in ObjectTable._fields}, device=device)
    mesh = make_mesh(1, axis="map", device=device)
    K = m.kf_Tcw.shape[0]
    with torch.no_grad():
        runs = {"joint": joint_ba_step(m, o, cfg, window=K)[0], "point": global_ba_step(m, cfg, iters=10),
                "joint_sharded": global_joint_ba_sharded(m, o, cfg, mesh)[0],
                "point_sharded": global_ba_sharded(m, cfg, mesh)}
    return {k: _kf_ate(v.kf_Tcw.cpu().numpy(), z) for k, v in runs.items()}


def _reference_bas(z: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from qsp_slam_tpu.parallel import map_sharded_ba as jmsb
    from qsp_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from qsp_slam_tpu.slam import distributed_mapping as jdm
    from qsp_slam_tpu.slam.joint_mapping import joint_ba_step as jjoint
    from qsp_slam_tpu.slam.local_mapping import global_ba_step as jglobal
    from qsp_slam_tpu.slam.map import MapState as JMapState
    from qsp_slam_tpu.slam.objects import ObjectTable as JObjectTable
    from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig

    fx, fy, cx, cy = (float(v) for v in z["intr"])
    H, W = (int(v) for v in z["size"])
    cfg = JTrackingConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H, baseline=float(z["bf"]) / fx,
                          depth_max=60.0)
    m = JMapState(**{f: jnp.asarray(z[f]) for f in JMapState._fields})
    o = JObjectTable(**{f: jnp.asarray(z[f"obj/{f}"]) for f in JObjectTable._fields})
    opts = ("iters", "axis", "pre_padded")
    jdm.map_sharded_ba = jax.jit(jmsb.map_sharded_ba, static_argnums=0, static_argnames=opts + ("use_huber",))
    jdm.map_sharded_joint_ba = jax.jit(jmsb.map_sharded_joint_ba, static_argnums=0, static_argnames=opts)
    mesh = jmake_mesh(1, axis="map")
    K = m.kf_Tcw.shape[0]
    runs = {"joint": jjoint(m, o, cfg, window=K)[0], "point": jglobal(m, cfg, iters=10),
            "joint_sharded": jdm.global_joint_ba_sharded(m, o, cfg, mesh)[0],
            "point_sharded": jdm.global_ba_sharded(m, cfg, mesh)}
    return {k: _kf_ate(np.asarray(v.kf_Tcw), z) for k, v in runs.items()}


def _drive_states(out: Path, runs: int) -> list[Path]:
    """Run the drive `runs` times on the card; save each run's state before
    its final global BA."""
    import torch

    import chip_smoke as cs
    from qsp_slam_tpu_torch import run_kitti
    from qsp_slam_tpu_torch.data.io import save_detection_cache
    from qsp_slam_tpu_torch.data.kitti import KittiSequence
    from qsp_slam_tpu_torch.slam.system import SlamSystem

    tmp = tempfile.mkdtemp()
    kitti_dir, poses, det_dir = (os.path.join(tmp, n) for n in ("kitti", "kitti_poses.txt", "dets"))
    cs.make_kitti.main([kitti_dir, "--frames", str(cs.KITTI_FRAMES), "--height", str(cs.KITTI_H), "--width",
                        str(cs.KITTI_W), "--seed", "2", "--poses-out", poses])
    os.makedirs(det_dir)
    seq = KittiSequence(kitti_dir, poses)
    for i, det in enumerate(cs.drive_detections(seq, cs.KITTI_FRAMES)):
        save_detection_cache(os.path.join(det_dir, f"{i}.npz"), det)
    gt = np.stack([np.linalg.inv(T) for T in seq.poses[: cs.KITTI_FRAMES]]).astype(np.float32)
    saved = []
    original = SlamSystem.run_global_ba

    def spy(self, iters: int = 10):
        m, o, n = self.map_state, self.objects, len(saved)
        z = {f: getattr(m, f).cpu().numpy() for f in m._fields}
        z.update({f"obj/{f}": getattr(o, f).cpu().numpy() for f in o._fields})
        z.update(kf_frames=np.asarray(self.stats["kf_frames"]), gt_Tcw=gt, bf=np.float32(self.cfg.bf),
                 intr=np.asarray([self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy], np.float32),
                 size=np.asarray([self.cfg.height, self.cfg.width]))
        num = [int(z["num_kfs"]), int(z["num_pts"]), int(z["num_obs"])]
        cap = [max(16, 1 << (num[0] - 1).bit_length()), 1 << (num[1] - 1).bit_length(),
               1 << (num[2] - 1).bit_length()]
        path = out / f"state{n}.npz"
        np.savez(path, **_cut(z, *cap))
        saved.append(path)
        return original(self, iters)

    SlamSystem.run_global_ba = spy
    try:
        for _ in range(runs):
            run_kitti.main([kitti_dir, "--poses", poses, "--detections", det_dir, "--global-ba"])
            torch.cuda.synchronize()
    finally:
        SlamSystem.run_global_ba = original
    return saved


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    lines = []
    if args.reference:
        for path in sorted(out.glob("state*.npz")):
            z = dict(np.load(path))
            line = {"state": path.name, "before": _kf_ate(z["kf_Tcw"], z),
                    "port_cpu": _port_bas(z, "cpu"), "reference_cpu": _reference_bas(z)}
            print(json.dumps(line), flush=True)
            lines.append(line)
        return lines
    import chip_smoke as cs

    print(json.dumps({"card": cs.card_line()}), flush=True)
    for path in _drive_states(out, args.runs):
        z = dict(np.load(path))
        measured = int(np.sum(np.asarray(z["obj/valid"]) & (np.asarray(z["obj/pm_kf"]) >= 0).sum(-1).astype(bool)))
        line = {"state": path.name, "keyframes": int(z["num_kfs"]), "objects": int(np.sum(z["obj/valid"])),
                "objects_measured": measured, "before": _kf_ate(z["kf_Tcw"], z), "port_card": _port_bas(z, "cuda")}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()

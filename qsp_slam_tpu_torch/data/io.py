"""Persistence: trajectories, map snapshots, detection caches (counterpart
of `qsp_slam_tpu/data/io.py`).

  * `save_trajectory_tum` / `load_trajectory_tum`: `t tx ty tz qx qy qz qw`,
    camera to world;
  * `save_trajectory_kitti`: 12 numbers per line (3x4 camera to world);
  * `save_map` / `load_map`: the SoA map and the object table as one
    compressed npz, with the JAX package's keys; `export_map_txt`:
    MapPoints.txt, Cameras.txt and MapObjects.txt;
  * the detection caches (plain numpy), the replay seam of detections.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import lie

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    return lie.rotmat_to_quat(torch.from_numpy(np.asarray(R, np.float32))).numpy()


def save_trajectory_tum(path: str, timestamps, Tcw_stack: np.ndarray) -> None:
    with open(path, "w") as f:
        for t, Tcw in zip(timestamps, Tcw_stack):
            T_wc = np.linalg.inv(Tcw)
            q = _quat_from_R(T_wc[:3, :3])
            tx, ty, tz = T_wc[:3, 3]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_trajectory_kitti(path: str, Tcw_stack: np.ndarray) -> None:
    with open(path, "w") as f:
        for Tcw in Tcw_stack:
            f.write(" ".join(f"{x:.9e}" for x in np.linalg.inv(Tcw)[:3].reshape(-1)) + "\n")


def load_trajectory_tum(path: str):
    """(timestamps (F,), T_cw (F, 4, 4) f32)."""
    from .tum import parse_trajectory

    entries = parse_trajectory(path)
    ts = np.array([t for t, _ in entries])
    return ts, np.stack([np.linalg.inv(T) for _, T in entries]).astype(np.float32)


def save_map(path: str, map_state, objects=None, codes=None) -> None:
    """The SoA map (keyframes, points, observations), with `objects` the
    object table's geometry, labels and shape state, as one npz."""
    m = map_state
    data = {k: _np(getattr(m, k)) for k in (
        "kf_Tcw", "kf_valid", "pt_xyz", "pt_valid", "pt_desc",
        "ob_kf", "ob_pt", "ob_uv", "ob_ur", "ob_valid")}
    for k in ("num_kfs", "num_obs", "num_pts"):
        data[k] = int(getattr(m, k))
    if objects is not None:
        for k in ("ellipsoid", "label", "prob", "valid", "code", "Tow_shape", "shape_ok"):
            data[f"obj_{k}"] = _np(getattr(objects, k))
    if codes is not None:
        data["obj_codes"] = _np(codes)
    np.savez_compressed(path, **data)


def load_map(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def export_map_txt(path_dir: str, map_state, objects=None) -> None:
    """MapPoints.txt (x y z per valid point), Cameras.txt (`k tx ty tz
    qx qy qz qw`, camera to world, per keyframe) and, with `objects`,
    MapObjects.txt (`id label` and the 9-vector per live object)."""
    os.makedirs(path_dir, exist_ok=True)
    pts = _np(map_state.pt_xyz)[_np(map_state.pt_valid)]
    with open(os.path.join(path_dir, "MapPoints.txt"), "w") as f:
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
    kf_Tcw = _np(map_state.kf_Tcw)
    with open(os.path.join(path_dir, "Cameras.txt"), "w") as f:
        for k in range(int(map_state.num_kfs)):
            T_wc = np.linalg.inv(kf_Tcw[k])
            q = _quat_from_R(T_wc[:3, :3])
            t = T_wc[:3, 3]
            f.write(f"{k} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
    if objects is not None:
        ells, labels = _np(objects.ellipsoid), _np(objects.label)
        with open(os.path.join(path_dir, "MapObjects.txt"), "w") as f:
            for i in np.where(_np(objects.valid))[0]:
                f.write(f"{i} {labels[i]} " + " ".join(str(x) for x in ells[i]) + "\n")


# A 3D detector's measured ellipsoids (camera frame) and their flags, kept
# when given: the stereo object step seeds its objects from them.
MEASURED_FIELDS = ("ellipsoid_cam", "fit_ok")


def save_detection_cache(path: str, detections: dict) -> None:
    """Per-frame detections as npz; instance masks are bit-packed along
    the width.  The reference's reader takes the boxes and masks only."""
    arrs = {k: np.asarray(detections[k]) for k in ("bbox", "label", "prob", "valid")}
    arrs.update({k: np.asarray(detections[k]) for k in MEASURED_FIELDS if k in detections})
    if "mask" in detections:
        m = np.asarray(detections["mask"]).astype(bool)
        arrs["mask"] = np.packbits(m, axis=-1)
        arrs["mask_width"] = np.asarray(m.shape[-1])
    np.savez_compressed(path, **arrs)


def load_detection_cache(path: str) -> dict:
    with np.load(path) as z:
        out = {k: z[k] for k in ("bbox", "label", "prob", "valid")}
        out.update({k: z[k] for k in MEASURED_FIELDS if k in z.files})
        if "mask" in z.files:
            W = int(z["mask_width"]) if "mask_width" in z.files else None
            m = np.unpackbits(z["mask"], axis=-1)
            out["mask"] = (m[..., :W] if W else m).astype(bool)
    return out

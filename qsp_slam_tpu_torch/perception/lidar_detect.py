"""LiDAR object proposals: ground removal, clustering and projection to
detection boxes (counterpart of `qsp_slam_tpu/perception/lidar_detect.py`).
The ground plane is fitted on the device (draws from a CPU generator
seeded 0, as the reference seeds its key); the clustering is host-side
union-find over occupied voxels, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Intrinsics
from .groundplane import Draw, estimate_ground_plane_points, plane_sample


def _voxel_cluster(pts: np.ndarray, voxel: float = 0.5) -> np.ndarray:
    """Connected-component labels (N,) over occupied voxels (26-neighbour
    adjacency), compacted to 0..C-1."""
    keys = np.floor(pts / voxel).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    parent = np.arange(len(uniq))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    index = {tuple(v): i for i, v in enumerate(uniq)}
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
    for i, v in enumerate(uniq):
        for o in offs:
            j = index.get((v[0] + o[0], v[1] + o[1], v[2] + o[2]))
            if j is not None:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[rb] = ra
    roots = np.array([find(i) for i in range(len(uniq))])
    _, compact = np.unique(roots, return_inverse=True)
    return compact.reshape(-1)[inv]


def lidar_detections(
    pts_cam: np.ndarray,  # (N, 3) LiDAR points in the camera frame
    intr: Intrinsics,
    width: int,
    height: int,
    ground_margin: float = 0.25,
    voxel: float = 0.5,
    min_pts: int = 40,
    size_range=((0.8, 0.8, 1.5), (6.0, 3.0, 8.0)),
    max_dets: int = 8,
    camera_up_hint=(0.0, -1.0, 0.0),
    device=None,
    draw: Draw = plane_sample,
) -> dict:
    """Geometric proposals as a detection dict (numpy): bbox (D, 4), label
    (D,) (0, the car class), prob (D,), valid (D,), padded to `max_dets`.
    Points above the ground (when one is found) and ahead of the camera are
    clustered; a car-sized cluster with enough points in the image gives
    the box of its projection."""
    dev = resolve_device(device)
    gp = estimate_ground_plane_points(
        torch.from_numpy(np.ascontiguousarray(pts_cam, np.float32)).to(dev),
        torch.ones(len(pts_cam), dtype=torch.bool, device=dev), torch.Generator().manual_seed(0),
        camera_up_hint=camera_up_hint, draw=draw,
    )
    got = torch.cat([gp.plane, gp.ok.to(gp.plane.dtype)[None]]).cpu().numpy()
    pi, ok = got[:4], bool(got[4])
    above = pts_cam @ pi[:3] + pi[3] > ground_margin if ok else np.ones(len(pts_cam), bool)
    pts = pts_cam[above & (pts_cam[:, 2] > 0.5)]

    bboxes = np.zeros((max_dets, 4), np.float32)
    labels = np.zeros(max_dets, np.int32)
    probs = np.zeros(max_dets, np.float32)
    valid = np.zeros(max_dets, bool)
    if len(pts) < min_pts:
        return dict(bbox=bboxes, label=labels, prob=probs, valid=valid)
    labels_c = _voxel_cluster(pts, voxel)
    fx, fy, cx, cy = (float(v) for v in intr)
    lo, hi = np.asarray(size_range[0]), np.asarray(size_range[1])
    d = 0
    for cid in np.unique(labels_c):
        sel = pts[labels_c == cid]
        if len(sel) < min_pts or d >= max_dets:
            continue
        ext = sel.max(0) - sel.min(0)
        if not ((np.sort(ext) >= np.sort(lo) * 0.5).all() and (ext <= hi).all()):
            continue
        z = sel[:, 2]
        u = fx * sel[:, 0] / z + cx
        v = fy * sel[:, 1] / z + cy
        inside = (u >= 0) & (u < width) & (v >= 0) & (v < height)
        if inside.sum() < min_pts // 2:
            continue
        bboxes[d] = [u[inside].min(), v[inside].min(), u[inside].max(), v[inside].max()]
        labels[d] = 0
        probs[d] = min(1.0, len(sel) / 500.0 + 0.5)
        valid[d] = True
        d += 1
    return dict(bbox=bboxes, label=labels, prob=probs, valid=valid)

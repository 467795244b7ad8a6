"""Offline visualization artifacts (counterpart of
`qsp_slam_tpu/viz/export.py`): PLY point clouds and meshes, ellipsoid
wireframes and the camera trajectory, written as ASCII files that open in
any point-cloud or mesh viewer.

The writers take numpy arrays or tensors (moved to the host) and format
each number with `str()` of its numpy scalar, so the same float32 arrays
give the same bytes as the JAX package's writers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import quadric
from ..data.io import _np


def save_ply_points(path: str, pts, colors=None) -> None:
    """ASCII PLY point cloud: pts (N, 3); colors (N, 3) uint8, optional."""
    pts = _np(pts)
    colors = None if colors is None else _np(colors)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(len(pts)):
            row = f"{pts[i, 0]} {pts[i, 1]} {pts[i, 2]}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def save_ply_mesh(path: str, vertices, faces) -> None:
    """ASCII PLY triangle mesh: vertices (V, 3), faces (T, 3)."""
    vertices, faces = _np(vertices), _np(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def ellipsoid_wireframe(e, segments: int = 24) -> np.ndarray:
    """Polyline vertices of the three principal ellipses of an ellipsoid
    (9-vector). (3 * segments, 3)."""
    T = quadric.similarity_transform(torch.as_tensor(_np(e), dtype=torch.float32).cpu()).numpy()
    th = np.linspace(0, 2 * np.pi, segments)
    c, s, z = np.cos(th), np.sin(th), np.zeros_like(th)
    rings = (np.stack([c, s, z], -1), np.stack([c, z, s], -1), np.stack([z, c, s], -1))
    return np.concatenate([ring @ T[:3, :3].T + T[:3, 3] for ring in rings])


def export_scene(out_dir: str, map_state=None, objects=None, meshes: dict | None = None, trajectory=None) -> None:
    """Write what a run holds into out_dir: `map_points.ply` (the valid map
    points), `object_wireframes.ply` (72 vertices per valid object),
    `object_<name>.ply` per mesh and `trajectory.ply` (the camera centres
    of the T_cw stack)."""
    os.makedirs(out_dir, exist_ok=True)
    if map_state is not None:
        pts = _np(map_state.pt_xyz)[_np(map_state.pt_valid)]
        save_ply_points(os.path.join(out_dir, "map_points.ply"), pts)
    if objects is not None:
        ells = _np(objects.ellipsoid)
        wire = [ellipsoid_wireframe(ells[i]) for i in np.where(_np(objects.valid))[0]]
        if wire:
            save_ply_points(os.path.join(out_dir, "object_wireframes.ply"), np.concatenate(wire))
    for name, mesh in (meshes or {}).items():
        save_ply_mesh(os.path.join(out_dir, f"object_{name}.ply"), mesh.vertices, mesh.faces)
    if trajectory is not None:
        centers = np.stack([np.linalg.inv(Tcw)[:3, 3] for Tcw in _np(trajectory)])
        save_ply_points(os.path.join(out_dir, "trajectory.ply"), centers)

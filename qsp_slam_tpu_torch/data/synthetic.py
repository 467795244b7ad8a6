"""Synthetic problems with known ground truth (counterpart of
`qsp_slam_tpu/data/synthetic.py`): the look-at pose the detector's
training schedule aims with, and the BAL-style bundle-adjustment problem
the BA tests, the sharded solvers and their measurements run on.  The
draws are numpy's, so a seed gives the reference's arrays; the initial
poses pass through the port's f32 `exp_se3`, which rounds like the
reference's to about 1e-7.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.camera import Intrinsics
from ..opt.reproj import ReprojEdges

TUM_INTR = dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480)


class SyntheticBA(NamedTuple):
    Tcw_gt: np.ndarray  # (K, 4, 4)
    points_gt: np.ndarray  # (N, 3)
    Tcw_init: np.ndarray  # (K, 4, 4) perturbed
    points_init: np.ndarray  # (N, 3) perturbed
    kf_idx: np.ndarray  # (E,)
    pt_idx: np.ndarray  # (E,)
    uv: np.ndarray  # (E, 2)
    u_right: np.ndarray  # (E,)
    inv_sigma2: np.ndarray  # (E,)
    valid: np.ndarray  # (E,) bool
    is_outlier: np.ndarray  # (E,) bool, the true outlier labels
    intr: Intrinsics


def _lookat(cpos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """T_cw (4, 4) float64 of a camera at `cpos` looking at `target`, y
    down (world y is down and the camera's +y follows it), as
    `orbit_trajectory`'s poses and the ground estimator's up hint
    (0, -1, 0) expect."""
    z = target - cpos
    z = z / np.linalg.norm(z)
    down = np.array([0.0, 1.0, 0.0])
    x = np.cross(down, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T_wc = np.eye(4)
    T_wc[:3, :3] = np.stack([x, y, z], axis=1)
    T_wc[:3, 3] = cpos
    return np.linalg.inv(T_wc)


def make_ba_problem(
    num_cams: int = 20,
    num_points: int = 2000,
    obs_per_point: int = 6,
    pix_noise: float = 0.5,
    outlier_frac: float = 0.05,
    pose_noise: float = 0.05,
    point_noise: float = 0.05,
    stereo: bool = False,
    baseline: float = 0.08,
    seed: int = 0,
    dtype=np.float32,
) -> SyntheticBA:
    """A local-BA problem with known ground truth: cameras on an arc around
    a 5 x 3 x 5 m point cloud, each point seen by `obs_per_point`
    consecutive cameras (local BA's banded camera-point pattern), pixel
    noise, a share of gross outliers, and perturbed starting poses
    (camera 0 exact, the gauge) and points."""
    rng = np.random.default_rng(seed)
    intr = Intrinsics(**{k: float(dtype(v)) for k, v in TUM_INTR.items() if k not in ("width", "height")})
    W, H = TUM_INTR["width"], TUM_INTR["height"]

    points = rng.uniform([-2.5, -1.5, -2.5], [2.5, 1.5, 2.5], size=(num_points, 3))
    angles = np.linspace(-0.45 * np.pi, 0.45 * np.pi, num_cams)
    Tcw = np.stack([_lookat(np.array([6.0 * np.sin(a), 0.4 * np.sin(3 * a), -6.0 * np.cos(a)]), np.zeros(3))
                    for a in angles])

    first = rng.integers(0, max(1, num_cams - obs_per_point + 1), size=num_points)
    kf_idx = (first[:, None] + np.arange(obs_per_point)[None, :]).reshape(-1)
    pt_idx = np.repeat(np.arange(num_points), obs_per_point)
    keep = kf_idx < num_cams
    kf_idx, pt_idx = kf_idx[keep], pt_idx[keep]

    p_c = np.einsum("eij,ej->ei", Tcw[kf_idx, :3, :3], points[pt_idx]) + Tcw[kf_idx, :3, 3]
    z = p_c[:, 2]
    u = intr.fx * p_c[:, 0] / z + intr.cx
    v = intr.fy * p_c[:, 1] / z + intr.cy
    vis = (z > 0.3) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    kf_idx, pt_idx, u, v, z = kf_idx[vis], pt_idx[vis], u[vis], v[vis], z[vis]
    E = len(u)

    uv = np.stack([u, v], axis=-1) + rng.normal(0, pix_noise, size=(E, 2))
    is_outlier = rng.random(E) < outlier_frac
    uv[is_outlier] += rng.uniform(10, 60, size=(is_outlier.sum(), 2)) * rng.choice(
        [-1, 1], size=(is_outlier.sum(), 2))
    if stereo:
        u_right = u - baseline * intr.fx / z + rng.normal(0, pix_noise, size=E)
    else:
        u_right = np.full(E, -1.0)

    xi = rng.normal(0, pose_noise, size=(num_cams, 6)) * np.array([1, 1, 1, 0.3, 0.3, 0.3])
    xi[0] = 0.0
    Tcw_init = lie.exp_se3(torch.from_numpy(xi.astype(np.float32))).numpy() @ Tcw
    points_init = points + rng.normal(0, point_noise, size=points.shape)

    return SyntheticBA(
        Tcw_gt=Tcw.astype(dtype),
        points_gt=points.astype(dtype),
        Tcw_init=Tcw_init.astype(dtype),
        points_init=points_init.astype(dtype),
        kf_idx=kf_idx.astype(np.int32),
        pt_idx=pt_idx.astype(np.int32),
        uv=uv.astype(dtype),
        u_right=u_right.astype(dtype),
        inv_sigma2=np.ones(E, dtype=dtype),
        valid=np.ones(E, dtype=bool),
        is_outlier=is_outlier,
        intr=intr,
    )


def ba_edges(problem: SyntheticBA, device=None) -> ReprojEdges:
    """A SyntheticBA's observation table as ReprojEdges on `device` (CUDA
    unless named)."""
    from .. import resolve_device

    dev = resolve_device(device)
    return ReprojEdges(*(torch.from_numpy(getattr(problem, f)).to(dev) for f in ReprojEdges._fields))

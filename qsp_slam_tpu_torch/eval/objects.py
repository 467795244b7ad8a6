"""Object-map evaluation: Hungarian matching of estimated to ground-truth
ellipsoids by Monte-Carlo 3D IoU, precision, recall, F1, centre and yaw
errors (counterpart of `qsp_slam_tpu/eval/objects.py`).  Host code, numpy
and scipy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ObjectEvalResult(NamedTuple):
    precision: float
    recall: float
    f1: float
    mean_iou: float  # over matched pairs
    mean_center_err: float
    mean_yaw_err: float
    matches: list  # (est_idx, gt_idx, iou)


def _similarity_transform(e: np.ndarray) -> np.ndarray:
    """The unit sphere -> ellipsoid map [[R diag(s), t], [0, 1]] in f32, R
    from XYZ Euler angles (`core.quadric.similarity_transform`)."""
    e = np.asarray(e, np.float32)
    r, p, y = e[3], e[4], e[5]
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    R = np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                  [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                  [-sp, cp * sr, cp * cr]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R * e[6:9][None, :]
    T[:3, 3] = e[0:3]
    return T


def ellipsoid_iou_mc(e_a: np.ndarray, e_b: np.ndarray, samples: int = 8000, seed: int = 0) -> float:
    """Monte-Carlo IoU of two ellipsoids: uniform points in a box around
    both, counted inside each."""
    rng = np.random.default_rng(seed)
    lo = np.minimum(e_a[0:3] - e_a[6:9].max(), e_b[0:3] - e_b[6:9].max())
    hi = np.maximum(e_a[0:3] + e_a[6:9].max(), e_b[0:3] + e_b[6:9].max())
    pts = rng.uniform(lo, hi, size=(samples, 3)).astype(np.float32)

    def inside(e):
        inv = np.linalg.inv(_similarity_transform(e))
        q = pts @ inv[:3, :3].T + inv[:3, 3]
        return (q * q).sum(-1) <= 1.0

    ia, ib = inside(e_a), inside(e_b)
    return float((ia & ib).sum()) / max(int((ia | ib).sum()), 1)


def yaw_error(e_a: np.ndarray, e_b: np.ndarray) -> float:
    """Smallest yaw difference modulo pi/2 (a box has 4-fold symmetry)."""
    d = abs(e_a[5] - e_b[5]) % (np.pi / 2)
    return float(min(d, np.pi / 2 - d))


def evaluate_objects(
    est: np.ndarray,  # (A, 9) estimated ellipsoids
    est_labels: np.ndarray,
    gt: np.ndarray,  # (B, 9)
    gt_labels: np.ndarray,
    iou_threshold: float = 0.1,
) -> ObjectEvalResult:
    """Hungarian matching on same-label IoU; pairs at or above
    `iou_threshold` count as true positives."""
    from scipy.optimize import linear_sum_assignment

    A, B = len(est), len(gt)
    if A == 0 or B == 0:
        return ObjectEvalResult(0.0, 0.0, 0.0, 0.0, np.inf, np.inf, [])
    iou = np.zeros((A, B))
    for i in range(A):
        for j in range(B):
            if est_labels[i] == gt_labels[j]:
                iou[i, j] = ellipsoid_iou_mc(est[i], gt[j])
    ri, cj = linear_sum_assignment(-iou)
    matches = [(int(i), int(j), float(iou[i, j])) for i, j in zip(ri, cj) if iou[i, j] >= iou_threshold]
    tp = len(matches)
    precision, recall = tp / A, tp / B
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    if not matches:
        return ObjectEvalResult(precision, recall, f1, 0.0, np.inf, np.inf, [])
    mean_iou = float(np.mean([m[2] for m in matches]))
    mean_c = float(np.mean([np.linalg.norm(est[i][0:3] - gt[j][0:3]) for i, j, _ in matches]))
    mean_y = float(np.mean([yaw_error(est[i], gt[j]) for i, j, _ in matches]))
    return ObjectEvalResult(precision, recall, f1, mean_iou, mean_c, mean_y, matches)

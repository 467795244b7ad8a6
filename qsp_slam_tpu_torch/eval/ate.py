"""Trajectory evaluation: ATE RMSE after Umeyama alignment and the
relative pose error (counterpart of `qsp_slam_tpu/eval/ate.py`; numpy on
the host)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity (s, R, t) with dst ~ s R src + t ((N, 3) each)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src))) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def positions_from_Tcw(Tcw: np.ndarray) -> np.ndarray:
    """Camera centres from world->camera poses (K, 4, 4) -> (K, 3)."""
    return -np.einsum("kji,kj->ki", Tcw[:, :3, :3], Tcw[:, :3, 3])


def ate_rmse(Tcw_est: np.ndarray, Tcw_gt: np.ndarray, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after alignment (meters)."""
    p_est = positions_from_Tcw(np.asarray(Tcw_est, np.float64))
    p_gt = positions_from_Tcw(np.asarray(Tcw_gt, np.float64))
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
    p_al = (s * (R @ p_est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((p_al - p_gt) ** 2, axis=-1))))


def rpe(Tcw_est: np.ndarray, Tcw_gt: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over a fixed frame delta (the TUM RPE protocol):
    translational RMSE (m per delta) and rotational RMSE (degrees per
    delta) of the estimated relative motions against the ground truth's."""
    est = np.asarray(Tcw_est, np.float64)
    gt = np.asarray(Tcw_gt, np.float64)
    n = min(len(est), len(gt)) - delta
    if n <= 0:
        return {"rpe_trans_rmse": 0.0, "rpe_rot_rmse_deg": 0.0, "pairs": 0}
    t_err2, r_err2 = [], []
    for i in range(n):
        rel_est = est[i + delta] @ np.linalg.inv(est[i])
        rel_gt = gt[i + delta] @ np.linalg.inv(gt[i])
        E = np.linalg.inv(rel_gt) @ rel_est
        t_err2.append(float(np.sum(E[:3, 3] ** 2)))
        c = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_err2.append(float(np.arccos(c)) ** 2)
    return {
        "rpe_trans_rmse": float(np.sqrt(np.mean(t_err2))),
        "rpe_rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(r_err2)))),
        "pairs": n,
    }

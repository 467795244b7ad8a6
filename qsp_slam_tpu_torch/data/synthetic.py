"""Synthetic camera poses (counterpart of `qsp_slam_tpu/data/synthetic.py`;
for now only the look-at pose the detector's training schedule aims
with)."""

from __future__ import annotations

import numpy as np


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

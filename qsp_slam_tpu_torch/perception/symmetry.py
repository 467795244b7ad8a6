"""Reflection-symmetry completion of an object cloud (counterpart of
`qsp_slam_tpu/perception/symmetry.py`): candidate symmetry planes are a
fan of vertical planes through the cloud's centroid, scored by one-sided
chamfer consistency (reflected points must land near observed ones); the
best of `num_yaw` coarse yaws is refined over 16 fine yaws around it.
Batched over leading dimensions of the cloud.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ellipsoid_fit import jax_linspace


class SymmetryResult(NamedTuple):
    plane: torch.Tensor  # (..., 4) best symmetry plane (camera frame)
    score: torch.Tensor  # (...) mean chamfer residual (lower is better)
    ok: torch.Tensor  # (...) bool
    completed: torch.Tensor  # (..., 2N, 3) original and mirrored points
    completed_ok: torch.Tensor  # (..., 2N)


def _reflect(pts: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """p - 2 (n . p + d) n for planes (..., Y, 4) and points (..., N, 3) ->
    (..., Y, N, 3)."""
    n = plane[..., :3]
    s = torch.einsum("...ni,...yi->...yn", pts, n) + plane[..., 3:4]
    return pts[..., None, :, :] - 2.0 * s[..., None] * n[..., None, :]


def estimate_symmetry(
    pts: torch.Tensor,  # (..., N, 3) object cloud (camera frame)
    valid: torch.Tensor,  # (..., N)
    up: torch.Tensor,  # (3,) up direction (from the ground plane)
    num_yaw: int = 24,
    chamfer_tol: float = 0.04,
) -> SymmetryResult:
    up = up / torch.linalg.vector_norm(up)
    w = valid.to(pts.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    ctr = torch.einsum("...n,...ni->...i", w, pts) / wsum[..., None]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=pts.dtype, device=pts.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=pts.dtype, device=pts.device)
    a = torch.where(torch.abs(up[0]) < 0.9, ex, ey)
    b1 = a - up * torch.dot(a, up)
    b1 = b1 / torch.linalg.vector_norm(b1)
    b2 = torch.linalg.cross(up, b1)

    def score(yaw):  # yaw (..., Y) -> costs (..., Y), planes (..., Y, 4)
        n = torch.cos(yaw)[..., None] * b1 + torch.sin(yaw)[..., None] * b2
        plane = torch.cat([n, -torch.sum(n * ctr[..., None, :], dim=-1, keepdim=True)], dim=-1)
        refl = _reflect(pts, plane)  # (..., Y, N, 3)
        dist = torch.cdist(refl, pts[..., None, :, :].expand(refl.shape),
                           compute_mode="donot_use_mm_for_euclid_dist")
        nn = torch.amin(torch.where(valid[..., None, None, :], dist, torch.inf), dim=-1)  # (..., Y, N)
        cost = torch.sum(torch.where(valid[..., None, :], torch.clamp(nn, max=0.2), 0.0), dim=-1)
        return cost / wsum[..., None], plane

    lead = pts.shape[:-2]
    yaws = jax_linspace(0.0, np.pi, num_yaw, endpoint=False).to(pts.device)
    costs, _ = score(yaws.expand(*lead, num_yaw))
    best = yaws[torch.argmin(costs, dim=-1)]
    step = np.pi / num_yaw
    fine = best[..., None] + jax_linspace(-step, step, 16).to(pts.device)
    costs_f, planes_f = score(fine)
    best_f = torch.argmin(costs_f, dim=-1)
    plane = torch.gather(planes_f, -2, best_f[..., None, None].expand(*lead, 1, 4))[..., 0, :]
    sc = torch.gather(costs_f, -1, best_f[..., None])[..., 0]
    refl = _reflect(pts, plane[..., None, :])[..., 0, :, :]
    return SymmetryResult(plane=plane, score=sc, ok=sc < chamfer_tol, completed=torch.cat([pts, refl], dim=-2),
                          completed_ok=torch.cat([valid, valid], dim=-1))

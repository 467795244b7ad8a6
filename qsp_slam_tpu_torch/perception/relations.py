"""Object-plane relation typing and support-plane selection (counterpart
of `qsp_slam_tpu/perception/relations.py`): each (object, plane) pair is
SUPPORT (the object's bottom rests on a horizontal plane), LEAN_ON (a side
touches a vertical plane) or NONE, batched over the (O, P) grid; the
relations route each object's supporting plane into the refinement, and
the extractor completes a point set down to the plane just below it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import quadric

NONE = 0
SUPPORT = 1
LEAN_ON = 2


class Relations(NamedTuple):
    kind: torch.Tensor  # (O, P) int32 in {NONE, SUPPORT, LEAN_ON}
    distance: torch.Tensor  # (O, P) contact distance


def _unit_planes(planes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 4) -> unit normals (..., 3) and offsets (...)."""
    nrm = torch.clamp(torch.linalg.vector_norm(planes[..., :3], dim=-1, keepdim=True), min=1e-9)
    return planes[..., :3] / nrm, planes[..., 3] / nrm[..., 0]


def _oriented_up(n: torch.Tensor, d: torch.Tensor, up: torch.Tensor):
    """Flip each plane so its normal points along `up`."""
    nu = torch.sum(n * up, dim=-1)
    s = torch.sign(torch.where(nu == 0.0, 1.0, nu))
    return n * s[..., None], d * s


def extract_relations(
    ellipsoids: torch.Tensor,  # (O, 9) world frame
    obj_valid: torch.Tensor,  # (O,)
    planes: torch.Tensor,  # (P, 4) world frame
    plane_valid: torch.Tensor,  # (P,)
    up_w: torch.Tensor,  # (3,) world up direction
    contact_tol: float = 0.08,
    horiz_tol: float = 0.15,
) -> Relations:
    up = up_w / torch.linalg.vector_norm(up_w)
    R = quadric.euler_to_rotmat(ellipsoids[:, 3:6])
    centers, half = ellipsoids[:, 0:3], ellipsoids[:, 6:9]
    bottom = centers - R[:, :, 2] * half[:, 2:3]
    n, d = _unit_planes(planes)
    horizontal = torch.abs(n @ up) > 1.0 - horiz_tol
    vertical = torch.abs(n @ up) < horiz_tol
    # SUPPORT: the bottom point lies on a horizontal plane.
    bot_dist = torch.abs(bottom @ n.T + d[None, :])
    support = horizontal[None, :] & (bot_dist < contact_tol)
    # LEAN_ON: the centre's distance equals the support radius along the normal.
    c_dist = torch.abs(centers @ n.T + d[None, :])
    Rn = torch.einsum("oji,pj->opi", R, n)  # the normal in the object frame
    radius = torch.linalg.vector_norm(Rn * half[:, None, :], dim=-1)
    lean = vertical[None, :] & (torch.abs(c_dist - radius) < contact_tol)
    gate = obj_valid[:, None] & plane_valid[None, :]
    kind = torch.where(gate & support, SUPPORT, torch.where(gate & lean, LEAN_ON, NONE)).to(torch.int32)
    return Relations(kind=kind, distance=torch.where(support, bot_dist, torch.abs(c_dist - radius)))


def support_planes_for_objects(
    rel: Relations,
    planes_w: torch.Tensor,  # (P, 4) world frame
    plane_valid: torch.Tensor,  # (P,)
    ground_w: torch.Tensor,  # (4,) fallback
) -> torch.Tensor:
    """Each object's supporting plane (O, 4): its closest SUPPORT plane
    (normal up), else the ground plane."""
    up = ground_w[:3] / torch.linalg.vector_norm(ground_w[:3])
    n, d = _oriented_up(*_unit_planes(planes_w), up)
    planes_up = torch.cat([n, d[:, None]], dim=-1)
    dist = torch.where((rel.kind == SUPPORT) & plane_valid[None, :], rel.distance, torch.inf)
    best = torch.argmin(dist, dim=1)
    has = torch.isfinite(torch.amin(dist, dim=1))
    return torch.where(has[:, None], planes_up[best], ground_w[None])


def select_support_plane(
    pts: torch.Tensor,  # (..., N, 3) candidate object points (camera frame)
    ok: torch.Tensor,  # (..., N)
    planes_cam: torch.Tensor,  # (P, 4) Manhattan set, camera frame
    plane_valid: torch.Tensor,  # (P,)
    ground_cam: torch.Tensor,  # (4,) fallback ground plane
    horiz_tol: float = 0.15,
    below_tol: float = 0.08,
) -> torch.Tensor:
    """The horizontal plane that supports each point set: among the planes
    whose 5th-percentile point height is above -`below_tol`, the lowest;
    else the ground.  -> (..., 4), normal pointing up."""
    up = ground_cam[:3] / torch.linalg.vector_norm(ground_cam[:3])
    n, d = _oriented_up(*_unit_planes(planes_cam), up)
    horizontal = (n @ up) > 1.0 - horiz_tol
    N = pts.shape[-2]
    h = pts @ n.T + d  # (..., N, P)
    big = torch.sort(torch.where(ok[..., None], h, torch.inf), dim=-2).values
    cnt = torch.clamp(torch.sum(ok, dim=-1), min=1)
    idx = torch.clamp(cnt * 5 // 100, 0, N - 1).long()
    low = torch.gather(big, -2, idx[..., None, None].expand(*idx.shape, 1, n.shape[0]))[..., 0, :]  # (..., P)
    cand = plane_valid & horizontal & (low > -below_tol)
    score = torch.where(cand, low, torch.inf)
    best = torch.argmin(score, dim=-1)
    use = torch.gather(cand & torch.isfinite(score), -1, best[..., None])[..., 0]
    pick = torch.cat([n[best], d[best][..., None]], dim=-1)
    nrm = torch.linalg.vector_norm(ground_cam[:3])
    g = torch.cat([ground_cam[:3] / nrm, (ground_cam[3] / nrm)[None]])
    return torch.where(use[..., None], pick, g)

"""Quadric (ellipsoid) factors and the per-object LM refinement
(counterpart of `qsp_slam_tpu/opt/quadric_factors.py`).

Every object's refinement is an independent small LM problem over its
9-vector with the keyframe poses fixed, so a whole table refines in one
batched solve: residuals (O, R), Jacobians (O, R, 9) from forward-mode
derivatives (one `jvp` per tangent direction, `vmap` over the basis only,
as in `opt/pose_graph.py`), and batched 9x9 solves.  The `iters` trips
select the accepted step with `where`, so no trip reads the device; a
step that is not finite is rejected, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jvp, vmap

from ..core import quadric


class ObjectObservations(NamedTuple):
    """Padded observation history of each object (slot axis after the
    object axis)."""

    Tcw: torch.Tensor  # (..., M, 4, 4) keyframe poses (fixed)
    bbox: torch.Tensor  # (..., M, 4) detected boxes
    weight: torch.Tensor  # (..., M) detection confidence (0 = empty slot)


def bbox_residual(e: torch.Tensor, Tcw: torch.Tensor, K: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """4-vector box-projection residual; broadcasts e (..., 9) against the
    poses (..., 4, 4) and boxes (..., 4)."""
    return quadric.project_bbox(e, Tcw, K) - bbox


def border_edge_mask(bbox: torch.Tensor, img_wh: tuple, margin: float = 2.0) -> torch.Tensor:
    """(..., 4) True where a detected box edge hugs the image border (a
    truncation, not an object boundary); edge order xmin, ymin, xmax, ymax."""
    W, H = img_wh
    return torch.stack([
        bbox[..., 0] <= margin, bbox[..., 1] <= margin,
        bbox[..., 2] >= W - 1 - margin, bbox[..., 3] >= H - 1 - margin,
    ], dim=-1)


def gravity_residual(e: torch.Tensor, ground_normal_w: torch.Tensor) -> torch.Tensor:
    """(..., 2): the object z axis's components orthogonal to `up`; the up
    vector (3,) or one per object (..., 3)."""
    z_axis = quadric.euler_to_rotmat(e[..., 3:6])[..., :, 2]
    up = ground_normal_w / torch.linalg.vector_norm(ground_normal_w, dim=-1, keepdim=True)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=up.dtype, device=up.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=up.dtype, device=up.device)
    a = torch.where(torch.abs(up[..., 0:1]) < 0.9, ex, ey)
    b1 = a - up * torch.sum(a * up, dim=-1, keepdim=True)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(up, b1, dim=-1)
    return torch.stack([torch.sum(z_axis * b1, dim=-1), torch.sum(z_axis * b2, dim=-1)], dim=-1)


def support_residual(e: torch.Tensor, ground_plane_w: torch.Tensor) -> torch.Tensor:
    """(..., 1): signed distance of the object's bottom point (centre -
    c * z axis) to the plane (4,) or to each object's plane (..., 4)."""
    R = quadric.euler_to_rotmat(e[..., 3:6])
    bottom = e[..., 0:3] - R[..., :, 2] * e[..., 8:9]
    n = ground_plane_w[..., :3]
    return ((torch.sum(bottom * n, dim=-1) + ground_plane_w[..., 3]) / torch.linalg.vector_norm(n, dim=-1))[..., None]


def bbox_term(e, obs: ObjectObservations, K, w_bbox: float, bbox_sigma: float, img_wh):
    """Weighted box residuals of objects e (O, 9) over their histories -> (O, 4 M)."""
    rb = bbox_residual(e[:, None, :], obs.Tcw, K, obs.bbox)
    if img_wh is not None:
        rb = torch.where(border_edge_mask(obs.bbox, img_wh), 0.0, rb)
    w = torch.sqrt(torch.clamp(obs.weight, min=0.0))[..., None] * (w_bbox / bbox_sigma)
    return (rb * w).reshape(e.shape[0], -1)


def lm_refine(residual: Callable[[torch.Tensor], torch.Tensor], e_init: torch.Tensor,
              lmbda0: float, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LM over objects: `residual` maps (O, 9) -> (O, R), each row
    depending on its own object only.  Damping lambda * diag(H) + 1e-8,
    the half-axes clipped to [0.02, 5] after each step; a step is taken
    when it lowers the cost.  -> (e (O, 9), cost (O,))."""
    O = e_init.shape[0]
    basis = torch.eye(9, dtype=e_init.dtype, device=e_init.device)
    eye = basis.expand(O, 9, 9)

    def cost(e):
        r = residual(e)
        return torch.sum(r * r, dim=-1)

    e = e_init
    lmbda = torch.full((O,), lmbda0, dtype=e.dtype, device=e.device)
    c = cost(e)
    for _ in range(iters):
        r, J = vmap(lambda v: jvp(residual, (e,), (v.expand(O, 9),)))(basis)  # (9, O, R) each
        r, J = r[0], J.permute(1, 2, 0)  # (O, R), (O, R, 9)
        H = J.transpose(-1, -2) @ J
        g = -(J.transpose(-1, -2) @ r[..., None])
        delta = torch.linalg.solve_ex(H + lmbda[:, None, None] * H * eye + 1e-8 * eye, g)[0][..., 0]
        e_try = e + delta
        e_try = torch.cat([e_try[:, :6], torch.clamp(e_try[:, 6:9], 0.02, 5.0)], dim=-1)
        c_try = cost(e_try)
        accept = c_try < c
        e = torch.where(accept[:, None], e_try, e)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        c = torch.where(accept, c_try, c)
    return e, c


def refine_object(
    e_init: torch.Tensor,  # (O, 9)
    obs: ObjectObservations,  # (O, M, ...)
    K: torch.Tensor,
    ground_plane_w: torch.Tensor,  # (4,), or (O, 4): each object's supporting plane
    iters: int = 10,
    w_bbox: float = 1.0,
    w_gravity: float = 100.0,
    w_support: float = 100.0,
    bbox_sigma: float = 10.0,
    img_wh: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LM of each object against its box history plus the gravity and
    support priors -> (e (O, 9), cost (O,)); a per-object plane feeds both
    priors of its object.  `img_wh` drops box edges on the image border
    from the residual."""
    up = -ground_plane_w[..., :3]

    def residual(e):
        return torch.cat([
            bbox_term(e, obs, K, w_bbox, bbox_sigma, img_wh),
            gravity_residual(e, up) * w_gravity,
            support_residual(e, ground_plane_w) * w_support,
        ], dim=-1)

    return lm_refine(residual, e_init, 1e-3, iters)

"""Semantic-prior ellipsoids, the monocular object path (counterpart of
`qsp_slam_tpu/perception/prior_infer.py`): with no depth, an object's
ellipsoid comes from its 2D box, the ground plane and per-label aspect
priors (half-axis ratios d = a/c, e = b/c), then is refined against its
box history with gravity, support and aspect priors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import quadric
from ..core.camera import Intrinsics, pixel_rays
from ..opt.quadric_factors import ObjectObservations, bbox_term, gravity_residual, lm_refine, support_residual


class AspectPriors(NamedTuple):
    """Per-label half-axis ratios a/c and b/c."""

    d: torch.Tensor  # (L,)
    e: torch.Tensor  # (L,)
    weight: torch.Tensor  # (L,) prior strength (0 disables)


def default_priors(num_labels: int = 16, device=None) -> AspectPriors:
    one = torch.ones(num_labels, dtype=torch.float32, device=device)
    return AspectPriors(d=one, e=one.clone(), weight=one.clone())


def generate_init_guess(
    bbox: torch.Tensor,  # (D, 4) detection boxes
    ground_plane_cam: torch.Tensor,  # (4,)
    intr: Intrinsics,
    aspect_d: torch.Tensor,  # (D,)
    aspect_e: torch.Tensor,  # (D,)
) -> torch.Tensor:
    """Box-only ellipsoid initialization -> camera-frame 9-vectors (D, 9).
    The ray through a box's bottom centre meets the ground at the
    footprint (its distance clipped to [0.3, 50]); the box height at that
    depth sets the vertical half-axis, the aspect priors the horizontal
    ones; the object's z axis is up, its x axis the camera's x projected
    to the ground (the yaw is unknown)."""
    n, d0 = ground_plane_cam[:3], ground_plane_cam[3]
    up = n / torch.linalg.vector_norm(n)
    bc = torch.stack([(bbox[:, 0] + bbox[:, 2]) * 0.5, bbox[:, 3]], dim=-1)
    ray = pixel_rays(bc, intr)  # (D, 3)
    denom = ray @ n
    t = torch.clamp(-d0 / torch.where(torch.abs(denom) < 1e-6, 1e-6, denom), 0.3, 50.0)
    foot = ray * t[:, None]
    h_px = torch.clamp(bbox[:, 3] - bbox[:, 1], min=4.0)
    half_c = torch.clamp(h_px * foot[:, 2] / intr.fy * 0.5, min=0.03)
    center = foot + up * half_c[:, None]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=up.dtype, device=up.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=up.dtype, device=up.device)
    a_ref = torch.where(torch.abs(up[0]) < 0.9, ex, ey)
    x_ax = a_ref - up * torch.dot(a_ref, up)
    x_ax = x_ax / torch.linalg.vector_norm(x_ax)
    rpy = quadric.rotmat_to_euler(torch.stack([x_ax, torch.linalg.cross(up, x_ax), up], dim=1))
    half = torch.stack([half_c * aspect_d, half_c * aspect_e, half_c], dim=-1)
    return torch.cat([center, rpy.expand(bbox.shape[0], 3), half], dim=-1)


def refine_with_priors(
    e_init: torch.Tensor,  # (O, 9) world frame
    obs: ObjectObservations,  # (O, M, ...)
    K: torch.Tensor,
    ground_plane_w: torch.Tensor,  # (4,)
    aspect_d: torch.Tensor,  # (O,)
    aspect_e: torch.Tensor,  # (O,)
    iters: int = 12,
    w_bbox: float = 1.0,
    w_gravity: float = 20.0,
    w_support: float = 20.0,
    w_aspect: float = 10.0,
    bbox_sigma: float = 10.0,
    img_wh: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LM of each object against its box history with gravity, support and
    aspect priors -> (e (O, 9), cost (O,)).  The aspect residual is the
    log-ratio error on (a/c, b/c); the plane priors are softer than the
    depth path's because the monocular ground comes from a sparse,
    gauge-free map."""
    up = -ground_plane_w[:3]
    log_d, log_e = torch.log(aspect_d), torch.log(aspect_e)

    def residual(e):
        ra = torch.stack([torch.log(e[:, 6] / e[:, 8]) - log_d, torch.log(e[:, 7] / e[:, 8]) - log_e], dim=-1)
        return torch.cat([
            bbox_term(e, obs, K, w_bbox, bbox_sigma, img_wh),
            gravity_residual(e, up) * w_gravity,
            support_residual(e, ground_plane_w) * w_support,
            ra * w_aspect,
        ], dim=-1)

    return lm_refine(residual, e_init, 1e-2, iters)

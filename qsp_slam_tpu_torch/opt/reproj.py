"""Reprojection factors: residuals and analytic Jacobians batched over
edges (counterpart of `qsp_slam_tpu/opt/reproj.py`).

Camera state is T_cw perturbed on the left, T' = exp(xi) T with
xi = [v, w]; for p_c = R p_w + t, d p_c/d xi = [I | -hat(p_c)] and
d p_c/d p_w = R.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import Intrinsics


class ReprojEdges(NamedTuple):
    """SoA edge table; `u_right < 0` marks a monocular edge."""

    kf_idx: torch.Tensor  # (E,) int — camera index
    pt_idx: torch.Tensor  # (E,) int — point index
    uv: torch.Tensor  # (E, 2) f32 measured pixel
    u_right: torch.Tensor  # (E,) f32 right-camera u, -1 for mono
    inv_sigma2: torch.Tensor  # (E,) f32 information by octave
    valid: torch.Tensor  # (E,) bool

    @property
    def is_stereo(self) -> torch.Tensor:
        return self.u_right >= 0.0


def pinhole_jacobian(p_cam: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """d uv / d p_cam for camera-frame points (..., 3) -> (..., 2, 3)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([intr.fx * iz, zero, -intr.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, intr.fy * iz, -intr.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def residuals_and_jacobians(
    Tcw: torch.Tensor,
    points: torch.Tensor,
    edges: ReprojEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    with_jacobians: bool = True,
):
    """All reprojection residuals (and Jacobians) in one pass.

    Returns (r (E, 3), Jc (E, 3, 6), Jp (E, 3, 3), row_mask (E, 3), depth (E,));
    Jc and Jp are None when `with_jacobians` is False.  The third residual
    row (right-camera u, u_r = u - bf/z) counts only for stereo edges.
    """
    T_e = Tcw[edges.kf_idx]  # (E, 4, 4)
    p_w = points[edges.pt_idx]  # (E, 3)
    R = T_e[..., :3, :3]
    p_c = torch.einsum("eij,ej->ei", R, p_w) + T_e[..., :3, 3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)

    u = intr.fx * x / z_safe + intr.cx
    v = intr.fy * y / z_safe + intr.cy
    u_r = u - baseline_fx / z_safe
    r = torch.stack(
        [u - edges.uv[..., 0], v - edges.uv[..., 1], u_r - edges.u_right], dim=-1
    )
    stereo = edges.is_stereo
    ones = torch.ones_like(z)
    row_mask = torch.stack([ones, ones, stereo.to(z.dtype)], dim=-1)
    row_mask = row_mask * edges.valid[..., None].to(z.dtype)
    if not with_jacobians:
        return r, None, None, row_mask, z

    J_pin = pinhole_jacobian(p_c, intr)  # (E, 2, 3)
    iz2 = 1.0 / (z_safe * z_safe)
    zeros = torch.zeros_like(z)
    bf_row = J_pin[..., 0, :] + torch.stack([zeros, zeros, baseline_fx * iz2], dim=-1)
    J_proj = torch.cat([J_pin, bf_row[..., None, :]], dim=-2)  # (E, 3, 3)
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -lie.hat(p_c)], dim=-1)  # (E, 3, 6)
    Jc = J_proj @ dpc_dxi
    Jp = J_proj @ R
    return r, Jc, Jp, row_mask, z


def edge_chi2(r: torch.Tensor, row_mask: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    """Per-edge chi2 = |r|^2 * inv_sigma2 over active rows. (E,)."""
    return torch.sum(r * r * row_mask, dim=-1) * inv_sigma2

"""Ellipsoid and dual-quadric algebra (counterpart of
`qsp_slam_tpu/core/quadric.py`).

An ellipsoid is the minimal 9-vector e = [x, y, z, roll, pitch, yaw, a,
b, c]: centre, XYZ Euler angles and half-axes.  Every function broadcasts
over leading dimensions, so a whole object table projects in one call.
"""

from __future__ import annotations

import torch

from . import lie


def euler_to_rotmat(rpy: torch.Tensor) -> torch.Tensor:
    """XYZ Euler (roll, pitch, yaw) -> R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p), torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def rotmat_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Inverse of `euler_to_rotmat` (pitch clipped at the gimbal poles)."""
    p = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    r = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([r, p, y], dim=-1)


def pose_of(e: torch.Tensor) -> torch.Tensor:
    """Minimal vector -> object-to-world pose T_wo (..., 4, 4)."""
    return lie.rt_to_se3(euler_to_rotmat(e[..., 3:6]), e[..., 0:3])


def scale_of(e: torch.Tensor) -> torch.Tensor:
    """Half-axes (..., 3)."""
    return e[..., 6:9]


def from_pose_scale(Two: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """SE(3) pose and half-axes -> minimal 9-vector."""
    return torch.cat([Two[..., :3, 3], rotmat_to_euler(Two[..., :3, :3]), scale], dim=-1)


def similarity_transform(e: torch.Tensor) -> torch.Tensor:
    """T = [[R diag(s), t], [0, 1]], mapping the unit sphere to the ellipsoid."""
    Rs = euler_to_rotmat(e[..., 3:6]) * e[..., None, 6:9]
    return lie.rt_to_se3(Rs, e[..., 0:3])


def dual_quadric(e: torch.Tensor) -> torch.Tensor:
    """Dual quadric Q* = T diag(1, 1, 1, -1) T^T."""
    T = similarity_transform(e)
    D = torch.tensor([1.0, 1.0, 1.0, -1.0], dtype=e.dtype, device=e.device)
    return torch.einsum("...ij,j,...kj->...ik", T, D, T)


def transform_ellipsoid(e: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """The ellipsoid moved by a rigid or similarity transform T; a
    similarity's scale multiplies the half-axes."""
    s = lie.sim3_scale(T)
    R_T = T[..., :3, :3] / s[..., None, None]
    Two = pose_of(e)
    R_new = torch.einsum("...ij,...jk->...ik", R_T, Two[..., :3, :3])
    t_new = torch.einsum("...ij,...j->...i", T[..., :3, :3], Two[..., :3, 3]) + T[..., :3, 3]
    return torch.cat([t_new, rotmat_to_euler(R_new), e[..., 6:9] * s[..., None]], dim=-1)


def project_to_conic(e: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Dual conic C* = P Q* P^T of the ellipsoid under P = K [R | t]
    (..., 3, 4), normalized so C[2, 2] = -1."""
    C = torch.einsum("...ij,...jk,...lk->...il", P, dual_quadric(e), P)
    c22 = C[..., 2:3, 2:3]
    return C / torch.where(torch.abs(c22) < 1e-12, 1e-12, -c22)


def conic_center(C: torch.Tensor) -> torch.Tensor:
    return torch.stack([C[..., 0, 2] / C[..., 2, 2], C[..., 1, 2] / C[..., 2, 2]], dim=-1)


def conic_bbox(C: torch.Tensor) -> torch.Tensor:
    """Axis-aligned box [umin, vmin, umax, vmax] of the dual conic's
    ellipse, from the tangent lines l^T C* l = 0.  Degenerate projections
    give finite, meaningless boxes; callers gate on `is_ellipse` and
    `check_observability`."""
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c02, c12 = C[..., 0, 2], C[..., 1, 2]
    du = torch.sqrt(torch.clamp(c02 * c02 - c00 * c22, min=0.0)) / torch.abs(c22)
    dv = torch.sqrt(torch.clamp(c12 * c12 - c11 * c22, min=0.0)) / torch.abs(c22)
    u0, v0 = c02 / c22, c12 / c22
    return torch.stack([u0 - du, v0 - dv, u0 + du, v0 + dv], dim=-1)


def is_ellipse(C: torch.Tensor) -> torch.Tensor:
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c02, c12 = C[..., 0, 2], C[..., 1, 2]
    return (c02 * c02 - c00 * c22 > 0.0) & (c12 * c12 - c11 * c22 > 0.0)


def check_observability(e: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """True where the ellipsoid's centre is in front of the camera (the
    conic test is blind to cheirality)."""
    return lie.transform_points(T_cw, e[..., None, 0:3])[..., 0, 2] > 0.0


def project_bbox(e: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Ellipsoid -> image box [umin, vmin, umax, vmax]."""
    P = torch.einsum("...ij,...jk->...ik", K, T_cw[..., :3, :4])
    return conic_bbox(project_to_conic(e, P))


def bbox_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of [umin, vmin, umax, vmax] boxes; broadcasts."""
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a + area_b - inter
    return inter / torch.where(union <= 0.0, 1.0, union)


def ellipsoid_log_error(e_est: torch.Tensor, e_obs: torch.Tensor) -> torch.Tensor:
    """9-dof error [dt, dw, dlog s] between two ellipsoids."""
    dt = e_obs[..., 0:3] - e_est[..., 0:3]
    dR = torch.einsum("...ji,...jk->...ik", euler_to_rotmat(e_est[..., 3:6]), euler_to_rotmat(e_obs[..., 3:6]))
    ds = torch.log(torch.clamp(e_obs[..., 6:9], min=1e-6)) - torch.log(torch.clamp(e_est[..., 6:9], min=1e-6))
    return torch.cat([dt, lie.log_so3(dR), ds], dim=-1)


def rotate_about_z(e: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """The ellipsoid turned about its own z axis."""
    z = torch.zeros_like(yaw)
    Rz = euler_to_rotmat(torch.stack([z, z, yaw], dim=-1))
    rpy = rotmat_to_euler(torch.einsum("...ij,...jk->...ik", euler_to_rotmat(e[..., 3:6]), Rz))
    return torch.cat([e[..., 0:3], rpy, e[..., 6:9]], dim=-1)


def center_distance_2d(e_a: torch.Tensor, e_b: torch.Tensor) -> torch.Tensor:
    """(x, y) centre distance."""
    return torch.linalg.vector_norm(e_a[..., 0:2] - e_b[..., 0:2], dim=-1)

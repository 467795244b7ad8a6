"""Rigid-body and ellipsoid algebra for the benchmark's generator and
reference, in plain PyTorch (any float dtype, any device).

An ellipsoid is the 9-vector [x, y, z, roll, pitch, yaw, a, b, c]:
centre, XYZ Euler angles (R = Rz(yaw) Ry(pitch) Rx(roll)) and half-axes.
A pose T_cw maps world points into the camera (x right, y down, z ahead).
"""

from __future__ import annotations

import torch


def euler_to_rotmat(rpy: torch.Tensor) -> torch.Tensor:
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p), torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from R (..., 3, 3) and t (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) applied to (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def look_at(eye, target, up=(0.0, -1.0, 0.0)) -> torch.Tensor:
    """T_cw (f64) of a camera at `eye` looking at `target`, image y along
    the world's down (+y) as far as the view allows."""
    eye, target = torch.as_tensor(eye, dtype=torch.float64), torch.as_tensor(target, dtype=torch.float64)
    z = target - eye
    z = z / torch.linalg.vector_norm(z)
    x = torch.linalg.cross(-torch.as_tensor(up, dtype=torch.float64), z)
    x = x / torch.linalg.vector_norm(x)
    y = torch.linalg.cross(z, x)
    R_wc = torch.stack([x, y, z], dim=1)
    return inv_se3(rt(R_wc, eye))


def similarity(e: torch.Tensor) -> torch.Tensor:
    """The similarity mapping the unit sphere onto the ellipsoid."""
    return rt(euler_to_rotmat(e[..., 3:6]) * e[..., None, 6:9], e[..., 0:3])


def project_bbox(e: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Image box [umin, vmin, umax, vmax] of the ellipsoid's outline: the
    dual conic C* = P Q* P^T and its tangent lines."""
    S = similarity(e)
    D = torch.tensor([1.0, 1.0, 1.0, -1.0], dtype=e.dtype, device=e.device)
    Q = torch.einsum("...ij,j,...kj->...ik", S, D, S)
    P = torch.einsum("...ij,...jk->...ik", K, T_cw[..., :3, :4])
    C = torch.einsum("...ij,...jk,...lk->...il", P, Q, P)
    c22 = C[..., 2:3, 2:3]
    C = C / torch.where(torch.abs(c22) < 1e-12, 1e-12, -c22)
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c02, c12 = C[..., 0, 2], C[..., 1, 2]
    du = torch.sqrt(torch.clamp(c02 * c02 - c00 * c22, min=0.0)) / torch.abs(c22)
    dv = torch.sqrt(torch.clamp(c12 * c12 - c11 * c22, min=0.0)) / torch.abs(c22)
    u0, v0 = c02 / c22, c12 / c22
    return torch.stack([u0 - du, v0 - dv, u0 + du, v0 + dv], dim=-1)


def in_front(e: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """Centre ahead of the camera."""
    return transform_points(T_cw, e[..., None, 0:3])[..., 0, 2] > 0.0


def intrinsic_matrix(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype, device=device)

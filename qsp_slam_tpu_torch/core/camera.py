"""Pinhole camera model and batched projection utilities.

Counterpart of `qsp_slam_tpu/core/camera.py`.  Intrinsics are python floats
holding float32 values, so `tensor * fx` rounds exactly as the JAX package's
float32 scalars do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_K(K) -> "Intrinsics":
        """From a (3, 3) matrix (array or tensor), each entry rounded to f32."""
        K = np.asarray(K.detach().cpu() if isinstance(K, torch.Tensor) else K, np.float32)
        return Intrinsics(*(float(K[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))))


def intrinsic_matrix(intr: Intrinsics, device=None) -> torch.Tensor:
    """The (3, 3) f32 matrix K."""
    return torch.tensor([[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def pixel_rays(uv: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Unit-depth rays K^-1 [u, v, 1] for pixels (..., 2) -> (..., 3)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def project(pts_cam: torch.Tensor, intr: Intrinsics) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> pixels (..., 2), depth (...).

    Depth <= 0 points still give finite pixels; callers mask on depth.
    """
    z = pts_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = intr.fx * pts_cam[..., 0] / z_safe + intr.cx
    v = intr.fy * pts_cam[..., 1] / z_safe + intr.cy
    return torch.stack([u, v], dim=-1), z


def backproject(uv: torch.Tensor, depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Pixels (..., 2) at depth (...) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - intr.cx) / intr.fx * depth
    y = (uv[..., 1] - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def _distort_delta(x, y, dist):
    """Radial scale and tangential offsets of the Brown-Conrady model at
    normalized coords; `dist` = (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = (float(np.float32(c)) for c in dist)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return radial, tx, ty


def distort_points(uv: torch.Tensor, intr: Intrinsics, dist) -> torch.Tensor:
    """Ideal pinhole pixels (..., 2) -> distorted pixels (the forward
    Brown-Conrady model)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    radial, tx, ty = _distort_delta(x, y, dist)
    xd = x * radial + tx
    yd = y * radial + ty
    return torch.stack([intr.fx * xd + intr.cx, intr.fy * yd + intr.cy], dim=-1)


def undistort_points(uv: torch.Tensor, intr: Intrinsics, dist, iters: int = 8) -> torch.Tensor:
    """Distorted pixels (..., 2) -> ideal pinhole pixels (fixed-point inverse
    of the Brown-Conrady model, `iters` iterations)."""
    xd = (uv[..., 0] - intr.cx) / intr.fx
    yd = (uv[..., 1] - intr.cy) / intr.fy
    x, y = xd, yd
    for _ in range(iters):
        radial, tx, ty = _distort_delta(x, y, dist)
        r_safe = torch.where(torch.abs(radial) < 1e-6, 1e-6, radial)
        x = (xd - tx) / r_safe
        y = (yd - ty) / r_safe
    return torch.stack([intr.fx * x + intr.cx, intr.fy * y + intr.cy], dim=-1)


def projection_matrix(T_cw: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """P = K [R|t] from world->camera transforms (..., 4, 4) -> (..., 3, 4)."""
    return torch.einsum("ij,...jk->...ik", intrinsic_matrix(intr, T_cw.device), T_cw[..., :3, :4])


def in_image(uv: torch.Tensor, width: int, height: int, border: int = 0) -> torch.Tensor:
    """Mask of pixels inside the image bounds (exclusive of `border`)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < width - border) & (v >= border) & (v < height - border)

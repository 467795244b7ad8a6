"""Plane algebra: 4-vector planes (n, d) with n . x + d = 0 (counterpart of
`qsp_slam_tpu/core/plane.py`).  Every function broadcasts over leading
dimensions."""

from __future__ import annotations

import torch


def normalize(pi: torch.Tensor) -> torch.Tensor:
    """Scale so the normal part has unit norm. (..., 4) -> (..., 4)."""
    n = torch.linalg.vector_norm(pi[..., :3], dim=-1, keepdim=True)
    return pi / torch.where(n == 0.0, 1.0, n)


def from_normal_point(normal: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """The plane through `point` with normal `normal`. (..., 3) -> (..., 4)."""
    n = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return torch.cat([n, -torch.sum(n * point, dim=-1, keepdim=True)], dim=-1)


def point_distance(pi: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Signed distances of points (..., N, 3) to the plane (..., 4) -> (..., N)."""
    pi = normalize(pi)
    return torch.einsum("...ni,...i->...n", pts, pi[..., :3]) + pi[..., 3:4]


def transform(pi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """The plane moved by T (points map as x' = T x): pi' = T^-T pi."""
    Tinv_T = torch.linalg.inv(T).transpose(-1, -2)
    return normalize(torch.einsum("...ij,...j->...i", Tinv_T, pi))


def angle_between(pi_a: torch.Tensor, pi_b: torch.Tensor) -> torch.Tensor:
    """Unsigned angle in [0, pi/2] between the planes' normals."""
    na = pi_a[..., :3] / torch.linalg.vector_norm(pi_a[..., :3], dim=-1, keepdim=True)
    nb = pi_b[..., :3] / torch.linalg.vector_norm(pi_b[..., :3], dim=-1, keepdim=True)
    return torch.arccos(torch.clamp(torch.abs(torch.sum(na * nb, dim=-1)), 0.0, 1.0))

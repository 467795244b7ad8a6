"""Manhattan-frame dominant planes (counterpart of
`qsp_slam_tpu/perception/manhattan.py`): each keyframe extracts planes
perpendicular or parallel to the ground by masked RANSAC rounds, and
recurring planes gather votes in a small fixed-capacity set that the
relation typing and the support-plane selection read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import plane as plane_mod
from .groundplane import Draw, plane_sample, ransac_plane


class PlaneSet(NamedTuple):
    planes: torch.Tensor  # (P, 4) world frame
    votes: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool


def empty_plane_set(pmax: int = 8, device=None) -> PlaneSet:
    dev = resolve_device(device)
    return PlaneSet(planes=torch.zeros((pmax, 4), dtype=torch.float32, device=dev),
                    votes=torch.zeros(pmax, dtype=torch.int32, device=dev),
                    valid=torch.zeros(pmax, dtype=torch.bool, device=dev))


def extract_manhattan_planes(
    pts: torch.Tensor,  # (M, 3) camera-frame cloud
    valid: torch.Tensor,  # (M,)
    ground_cam: torch.Tensor,  # (4,) ground plane, camera frame
    gen: torch.Generator | None,
    rounds: int = 3,
    inlier_th: float = 0.03,
    min_inliers: int = 150,
    angle_tol: float = 0.15,
    draw: Draw = plane_sample,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`rounds` RANSAC rounds, each on the points the earlier rounds left;
    a plane is kept when it has `min_inliers` and is within `angle_tol` of
    perpendicular or parallel to the ground.  Each round draws once from
    `gen`.  -> (planes (rounds, 4), ok (rounds,))."""
    up = ground_cam[:3] / torch.linalg.vector_norm(ground_cam[:3])
    planes, oks = [], []
    remaining = valid
    for _ in range(rounds):
        pi, inl = ransac_plane(pts, remaining, gen, inlier_th=inlier_th, draw=draw)
        align = torch.abs(torch.dot(pi[:3], up))
        oks.append((inl >= min_inliers) & ((align > 1.0 - angle_tol) | (align < angle_tol)))
        planes.append(pi)
        remaining = remaining & (torch.abs(pts @ pi[:3] + pi[3]) > inlier_th)
    return torch.stack(planes), torch.stack(oks)


def update_plane_set(
    ps: PlaneSet,
    new_planes_w: torch.Tensor,  # (R, 4) world frame
    new_ok: torch.Tensor,  # (R,)
    angle_tol: float = 0.15,
    dist_tol: float = 0.15,
) -> PlaneSet:
    """Vote-merge new planes into the set in order (a later plane sees the
    slot an earlier one claimed): a plane matching a live one (normal and
    |offset| within tolerance) votes for the first match, another takes
    the first free slot with one vote, or is dropped when the set is full.
    Row updates with `where`, so the loop never reads the device."""
    planes, votes, valid = ps
    ids = torch.arange(planes.shape[0], device=planes.device)
    for r in range(new_planes_w.shape[0]):
        pi = plane_mod.normalize(new_planes_w[r])
        cosang = torch.abs(planes[:, :3] @ pi[:3])
        doff = torch.abs(torch.abs(planes[:, 3]) - torch.abs(pi[3]))
        same = valid & (cosang > 1 - angle_tol) & (doff < dist_tol)
        has_match = same.any()
        match = ids == torch.argmax(same.to(torch.uint8))  # the first match
        add = new_ok[r] & ~has_match & ~valid.all() & (ids == torch.argmin(valid.to(torch.uint8)))
        votes = torch.where(new_ok[r] & has_match & match, votes + 1, torch.where(add, 1, votes))
        planes = torch.where(add[:, None], pi, planes)
        valid = valid | add
    return PlaneSet(planes=planes, votes=votes.to(torch.int32), valid=valid)


def dominant_planes(ps: PlaneSet, min_votes: int = 3) -> np.ndarray:
    """Host helper: the confirmed planes (>= `min_votes` votes)."""
    keep = ps.valid.cpu().numpy() & (ps.votes.cpu().numpy() >= min_votes)
    return ps.planes.cpu().numpy()[keep]

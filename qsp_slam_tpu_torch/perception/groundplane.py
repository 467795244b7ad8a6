"""Ground-plane estimation: batched-hypothesis RANSAC (counterpart of
`qsp_slam_tpu/perception/groundplane.py`).

A fixed batch of hypothesis planes (random point triples, and with an up
hint also single points with the hint's normal) is scored against the
cloud in one pass; the winner is refined by a least-squares fit on its
inliers.  `ransac_plane` is split so the random half can be replaced:
`plane_sample` draws the uniform numbers the hypotheses index with, and
the rest is deterministic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import plane as plane_mod
from ..core.camera import Intrinsics, backproject
from ..utils.tracing import HOST_READS, count


class GroundPlaneResult(NamedTuple):
    plane: torch.Tensor  # (4,) normalized (n, d)
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor  # () bool, enough support


def depth_to_cloud(depth: torch.Tensor, intr: Intrinsics, stride: int = 8):
    """Subsampled back-projection: depth (H, W) -> points (M, 3), valid (M,)."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    yy = torch.arange(H, dtype=torch.float32, device=d.device)[:, None].expand(H, W) * stride
    xx = torch.arange(W, dtype=torch.float32, device=d.device)[None, :].expand(H, W) * stride
    z = d.reshape(-1)
    return backproject(torch.stack([xx, yy], dim=-1).reshape(-1, 2), z, intr), z > 0.0


Draw = Callable[["torch.Generator | None", int], tuple]


def plane_sample(gen: torch.Generator | None, num_hyp: int = 256):
    """Uniform numbers in [0, 1): (num_hyp, 3) for the triples, then
    (num_hyp,) for the hint-normal single points.  They are drawn on the
    generator's device; the solve moves them to the cloud's."""
    dev = gen.device if gen is not None else None
    u = torch.rand((num_hyp, 3), generator=gen, device=dev)
    return u, torch.rand((num_hyp,), generator=gen, device=dev)


def _pick(pool: torch.Tensor, u: torch.Tensor, n, M: int) -> torch.Tensor:
    return pool[torch.clamp((u * n).to(torch.int32), 0, M - 1).long()]


def ransac_plane(
    pts: torch.Tensor,  # (M, 3)
    valid: torch.Tensor,  # (M,)
    gen: torch.Generator | None,
    num_hyp: int = 256,
    inlier_th: float | torch.Tensor = 0.02,
    normal_hint: torch.Tensor | None = None,
    hint_cos_min: float = 0.0,
    below_frac: float = 0.0,
    draw: Draw = plane_sample,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dominant plane -> (plane (4,), num_inliers).

    Triples index the valid points (compact, then draw).  With a hint and
    `below_frac`, half the triples come from the lowest quarter of the
    valid points along the hint (the ground is the lowest structure) and a
    hypothesis with more than max(3, below_frac * valid) points clearly
    below it is infeasible; with a hint, only normals within
    acos(hint_cos_min) of it compete, and the refit falls back to the raw
    winner when it leaves that cone or breaks feasibility."""
    M = pts.shape[0]
    dev = pts.device
    count(HOST_READS, 2)  # the draws' copies from host memory wait for the card
    u, u1 = (x.to(dev) for x in draw(gen, num_hyp))
    V = torch.clamp(torch.sum(valid.to(torch.int32)), min=1)
    pool_u = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid indices first
    lowest = below_frac > 0.0 and normal_hint is not None
    if lowest:
        hint_u = normal_hint / torch.linalg.vector_norm(normal_hint)
        pool = torch.argsort(torch.where(valid, pts @ hint_u, torch.inf), stable=True)
        count(HOST_READS)  # a copy from host memory: waits for the card
        Vp = torch.maximum((V + 3) // 4, torch.minimum(V, torch.tensor(3, device=dev)))
        half = num_hyp // 2
        idx = torch.cat([_pick(pool, u[:half], Vp, M), _pick(pool_u, u[half:], V, M)])
    else:
        pool, Vp = pool_u, V
        idx = _pick(pool, u, Vp, M)
    tri = pts[idx]  # (H, 3, 3)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(nn < 1e-9, 1.0, nn)
    d = -torch.sum(n * tri[:, 0], dim=-1)
    degenerate = (nn[:, 0] < 1e-9) | ~valid[idx].all(dim=-1)
    if normal_hint is not None:
        # Single points with the hint's normal: on a sparse cloud a random
        # triple rarely lands on the ground, one point does.
        hint = normal_hint / torch.linalg.vector_norm(normal_hint)
        idx1 = _pick(pool, u1, Vp, M)
        n = torch.cat([n, hint.expand(num_hyp, 3)])
        d = torch.cat([d, -(pts[idx1] @ hint)])
        degenerate = torch.cat([degenerate, ~valid[idx1]])
        nh = n @ hint
        sflip = torch.sign(torch.where(nh == 0.0, 1.0, nh))  # "below" is signed
        n, d = n * sflip[:, None], d * sflip
    signed = n @ pts.T + d[:, None]  # (H, M)
    score = torch.sum((torch.abs(signed) < inlier_th) & valid[None, :], dim=-1)
    if lowest:
        below = torch.sum((signed < -3.0 * inlier_th) & valid[None, :], dim=-1)
        max_below = torch.clamp((below_frac * V).to(torch.int32), min=3)
        score = torch.where(below <= max_below, score, -1)
    score = torch.where(degenerate, -1, score)
    if normal_hint is not None:
        score = torch.where(torch.abs(n @ hint) >= hint_cos_min, score, -1)
    best = torch.argmax(score).reshape(1)  # a (1,) index: indexing with it reads nothing back
    best_ok = score[best][0] > 0
    n_b, d_b = n[best][0], d[best][0]

    # Least squares on the inliers: weighted centroid and the smallest
    # eigenvector of the scatter, oriented like the winner.
    w = ((torch.abs(pts @ n_b + d_b) < inlier_th) & valid).to(pts.dtype)
    mu = torch.sum(pts * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    X = (pts - mu) * w[:, None]
    count(HOST_READS)  # `eigh` checks its result on the host
    n_r = torch.linalg.eigh(X.T @ X)[1][:, 0]
    n_r = n_r * torch.sign(torch.sum(n_r * n_b) + 1e-12)
    d_r = -torch.dot(n_r, mu)
    refined = torch.cat([n_r, d_r[None]])
    inl = torch.sum((torch.abs(pts @ n_r + d_r) < inlier_th) & valid)
    if normal_hint is not None:
        keep_raw = torch.abs(torch.dot(n_r, hint)) < hint_cos_min
        if below_frac > 0.0:
            below_r = torch.sum(((pts @ n_r + d_r) < -3.0 * inlier_th) & valid)
            keep_raw = keep_raw | (below_r > torch.clamp((below_frac * V).to(torch.int32), min=3))
        inl_raw = torch.sum((torch.abs(pts @ n_b + d_b) < inlier_th) & valid)
        refined = torch.where(keep_raw, torch.cat([n_b, d_b[None]]), refined)
        inl = torch.where(keep_raw, inl_raw, inl)
    inl = torch.where(best_ok, inl, 0)  # no hypothesis passed the gates
    return plane_mod.normalize(refined), inl


def adaptive_inlier_th(pts: torch.Tensor, valid: torch.Tensor, rel: float = 0.025) -> torch.Tensor:
    """Scale-adaptive threshold for gauge-free (monocular) clouds: `rel`
    times the median point distance from the origin."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    srt = torch.sort(torch.where(valid, r, torch.inf)).values
    mid = torch.clamp((torch.sum(valid) - 1) // 2, 0, r.shape[0] - 1).reshape(1)
    return rel * torch.clamp(srt[mid][0], min=1e-3)


def estimate_ground_plane_points(
    pts: torch.Tensor,
    valid: torch.Tensor,
    gen: torch.Generator | None,
    min_inlier_frac: float = 0.10,
    camera_up_hint: tuple = (0.0, -1.0, 0.0),
    inlier_th: torch.Tensor | None = None,
    draw: Draw = plane_sample,
) -> GroundPlaneResult:
    """The ground plane of a point set (keypoint clouds, map points),
    oriented toward `camera_up_hint`; the threshold defaults to
    `adaptive_inlier_th`."""
    count(HOST_READS)  # a copy from host memory: waits for the card
    hint = torch.tensor(camera_up_hint, dtype=pts.dtype, device=pts.device)
    if inlier_th is None:
        inlier_th = adaptive_inlier_th(pts, valid)
    pi, inl = ransac_plane(pts, valid, gen, inlier_th=inlier_th, normal_hint=hint,
                           hint_cos_min=0.7, below_frac=0.05, draw=draw)
    pi = pi * torch.sign(torch.sum(pi[:3] * hint) + 1e-12)
    ok = inl > min_inlier_frac * torch.clamp(torch.sum(valid), min=1)
    return GroundPlaneResult(plane=pi, num_inliers=inl, ok=ok)


def estimate_ground_plane(
    depth: torch.Tensor,
    intr: Intrinsics,
    gen: torch.Generator | None,
    stride: int = 8,
    min_inlier_frac: float = 0.05,
    camera_up_hint: tuple = (0.0, -1.0, 0.0),
    draw: Draw = plane_sample,
) -> GroundPlaneResult:
    """The ground plane of one depth image; ok needs inliers on more than
    15% of the sampled pixels."""
    pts, valid = depth_to_cloud(depth, intr, stride)
    res = estimate_ground_plane_points(pts, valid, gen, min_inlier_frac=0.0,
                                       camera_up_hint=camera_up_hint, draw=draw)
    return res._replace(ok=res.num_inliers > 0.15 * pts.shape[0])

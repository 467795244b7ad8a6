"""Absolute pose from 3D-2D correspondences: a fixed batch of DLT and
planar hypotheses, one scoring pass, LM polish (counterpart of
`qsp_slam_tpu/frontend/pnp.py`).

`pnp_ransac` is split in two so the random half can be replaced:
`pnp_sample` draws the hypothesis point indices (`torch.multinomial` with
an explicit generator), and `pnp_solve` does everything else
deterministically: batched SVDs of the 12x12 (6-point DLT), 8x9 (4-point
homography), 4x3 and 3x3 systems, scoring every hypothesis against every
correspondence, the centre-hint gate, the argmax and the LM polish of the
winner on its inliers.  Every function takes optional leading batch
dimensions, so relocalization solves all its candidate keyframes at once.

The SVD null vectors are the reference's: where a sample is degenerate
(coplanar or repeated points) the null space has more than one dimension
and LAPACK or cuSOLVER may return another basis vector, which changes that
hypothesis, not the well-conditioned ones.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core import lie
from ..core.camera import Intrinsics, project
from ..opt.pose_opt import optimize_pose
from ..opt.reproj import ReprojEdges


class PnPResult(NamedTuple):
    Tcw: torch.Tensor  # (..., 4, 4)
    inliers: torch.Tensor  # (..., M) bool
    num_inliers: torch.Tensor  # (...,) int
    ok: torch.Tensor  # (...,) bool


def _proper_rotation(U: torch.Tensor, Vt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest rotation U diag(1, 1, det(U Vt)) Vt and that determinant."""
    det = torch.linalg.det(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * d[..., None, :]) @ Vt, det


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """6-point calibrated DLT: X (..., 6, 3) world points, xn (..., 6, 2)
    normalized image coordinates -> T_cw (..., 4, 4).  Null vector of the
    12x12 design matrix, nearest rotation, sign by cheirality."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., 6, 4)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)  # (..., 6, 12)
    rows_v = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 12, 12)
    P = torch.linalg.svd(A).Vh[..., -1, :].reshape(A.shape[:-2] + (3, 4))
    U, S, Vt2 = torch.linalg.svd(P[..., :3])
    R, det = _proper_rotation(U, Vt2)
    scale = torch.mean(S, dim=-1) * det
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    # Cheirality: a majority of the 6 points in front.
    z = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    flip = torch.sum(z > 0, dim=-1) < 3
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    R = R * torch.where(torch.linalg.det(R) < 0, -1.0, 1.0)[..., None, None]
    return lie.rt_to_se3(R, t)


def _planar_pose(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """4-point homography pose, exact for coplanar points (where the DLT
    design matrix is rank-deficient).  X (..., 4, 3), xn (..., 4, 2)."""
    c = torch.mean(X, dim=-2)
    Xc = X - c[..., None, :]
    B = torch.linalg.svd(Xc).Vh  # rows: two in-plane directions, normal
    q = Xc @ B.transpose(-1, -2)  # plane coordinates, q[..., 2] ~ 0
    ones = torch.ones_like(q[..., :1])
    qh = torch.cat([q[..., :2], ones], dim=-1)  # (..., 4, 3)
    zeros = torch.zeros_like(qh)
    rows_u = torch.cat([qh, zeros, -xn[..., 0:1] * qh], dim=-1)
    rows_v = torch.cat([zeros, qh, -xn[..., 1:2] * qh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 8, 9)
    H = torch.linalg.svd(A).Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    nrm = torch.linalg.vector_norm(h1, dim=-1) + torch.linalg.vector_norm(h2, dim=-1)
    lam = 2.0 / torch.clamp(nrm, min=1e-12)
    # Cheirality: positive projective depth.
    proj = qh @ H.transpose(-1, -2) * torch.cat([xn, ones], dim=-1)
    lam = lam * torch.sign(torch.sum(proj, dim=(-2, -1)) + 1e-12)
    r1, r2, t = lam[..., None] * h1, lam[..., None] * h2, lam[..., None] * h3
    R_approx = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    U, _, Vt3 = torch.linalg.svd(R_approx)
    R_cp, _ = _proper_rotation(U, Vt3)
    T_pw = lie.rt_to_se3(B, -torch.einsum("...ij,...j->...i", B, c))
    return lie.rt_to_se3(R_cp, t) @ T_pw


def pnp_sample(valid: torch.Tensor, gen: torch.Generator | None, num_hyp: int = 256):
    """Hypothesis point indices drawn from the valid rows, with replacement:
    (..., num_hyp // 2, 6) for the DLT pool and (..., num_hyp - num_hyp // 2,
    4) for the planar pool.  A row with no valid correspondence draws
    uniformly; its hypotheses are rejected anyway.  The draw runs on the
    generator's device and lands on `valid`'s (a CPU generator gives the
    card the draws of a CPU run)."""
    n6, n4 = num_hyp // 2, num_hyp - num_hyp // 2
    w = valid.reshape(-1, valid.shape[-1]).to(torch.float32)
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0, w, torch.ones_like(w))
    if gen is not None:
        w = w.to(gen.device)
    idx = torch.multinomial(w, n6 * 6 + n4 * 4, replacement=True, generator=gen).to(valid.device)
    lead = valid.shape[:-1]
    return idx[:, : n6 * 6].reshape(lead + (n6, 6)), idx[:, n6 * 6:].reshape(lead + (n4, 4))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, C) gathered at idx (..., H, n) -> (..., H, n, C)."""
    flat = idx.reshape(idx.shape[:-2] + (-1,)).long()
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + x.shape[-1:]))
    return out.reshape(idx.shape + x.shape[-1:])


def pnp_solve(
    pts_w: torch.Tensor,  # (..., M, 3)
    uv: torch.Tensor,  # (..., M, 2)
    valid: torch.Tensor,  # (..., M)
    intr: Intrinsics,
    idx6: torch.Tensor,  # (..., H6, 6)
    idx4: torch.Tensor,  # (..., H4, 4)
    inlier_px: float = 4.0,
    min_inliers: int = 12,
    center_hint: torch.Tensor | None = None,  # (..., 3)
    max_center_dist: float = math.inf,
) -> PnPResult:
    """The deterministic half of `pnp_ransac` on given hypothesis indices.
    `center_hint` rejects hypotheses whose camera centre is farther than
    `max_center_dist` from it (the planar twisted-pair ambiguity)."""
    xn = torch.stack([(uv[..., 0] - intr.cx) / intr.fx, (uv[..., 1] - intr.cy) / intr.fy], dim=-1)
    Ts = torch.cat([
        _dlt_pose(_rows(pts_w, idx6), _rows(xn, idx6)),
        _planar_pose(_rows(pts_w, idx4), _rows(xn, idx4)),
    ], dim=-3)  # (..., H, 4, 4)
    vcol = valid[..., None]
    ok_h = torch.cat([_rows(vcol, idx6).all(dim=-2)[..., 0], _rows(vcol, idx4).all(dim=-2)[..., 0]], dim=-1)

    R, t = Ts[..., :3, :3], Ts[..., :3, 3]
    pc = torch.einsum("...hij,...mj->...hmi", R, pts_w) + t[..., None, :]
    uv_h, z = project(pc, intr)
    err = torch.linalg.vector_norm(uv_h - uv[..., None, :, :], dim=-1)
    inl = (err < inlier_px) & (z > 0.05) & valid[..., None, :]
    finite = torch.isfinite(Ts).all(dim=-1).all(dim=-1)
    score = torch.where(ok_h & finite, torch.sum(inl, dim=-1), -1)
    if center_hint is not None:
        centers = -torch.einsum("...hji,...hj->...hi", R, t)
        near = torch.linalg.vector_norm(centers - center_hint[..., None, :], dim=-1) < max_center_dist
        score = torch.where(near, score, -1)
    best = torch.argmax(score, dim=-1)
    T_best = torch.gather(Ts, -3, best[..., None, None, None].expand(best.shape + (1, 4, 4)))[..., 0, :, :]
    inliers0 = torch.gather(inl, -2, best[..., None, None].expand(best.shape + (1, inl.shape[-1])))[..., 0, :]
    score_best = torch.gather(score, -1, best[..., None])[..., 0]

    # LM polish of each winner on its inliers (a loop over the batch: the
    # pose optimizer's early exit is per problem).
    M = pts_w.shape[-2]
    flat = [x.reshape((-1,) + x.shape[len(best.shape):]) for x in (T_best, pts_w, uv, inliers0)]
    outs = []
    for T0, P, q, inl0 in zip(*flat):
        edges = ReprojEdges(
            kf_idx=torch.zeros(M, dtype=torch.int64, device=P.device),
            pt_idx=torch.arange(M, dtype=torch.int64, device=P.device),
            uv=q,
            u_right=torch.full((M,), -1.0, dtype=q.dtype, device=q.device),
            inv_sigma2=torch.ones(M, dtype=q.dtype, device=q.device),
            valid=inl0,
        )
        outs.append(optimize_pose(T0, P, edges, intr, rounds=2, iters_per_round=8))
    lead = best.shape
    n = torch.stack([o.num_inliers for o in outs]).reshape(lead)
    return PnPResult(
        Tcw=torch.stack([o.Tcw for o in outs]).reshape(lead + (4, 4)),
        inliers=torch.stack([o.inlier for o in outs]).reshape(lead + (M,)),
        num_inliers=n,
        ok=(n >= min_inliers) & (score_best > 0),
    )


Draw = Callable[[torch.Tensor, "torch.Generator | None", int], tuple]


def pnp_ransac(
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    intr: Intrinsics,
    gen: torch.Generator | None,
    num_hyp: int = 256,
    inlier_px: float = 4.0,
    min_inliers: int = 12,
    center_hint: torch.Tensor | None = None,
    max_center_dist: float = math.inf,
    draw: Draw = pnp_sample,
) -> PnPResult:
    """PnP-RANSAC: `draw(valid, gen, num_hyp)` gives the hypothesis indices
    (`pnp_sample` unless a caller supplies its own), `pnp_solve` the rest."""
    idx6, idx4 = draw(valid, gen, num_hyp)
    return pnp_solve(pts_w, uv, valid, intr, idx6, idx4, inlier_px, min_inliers,
                     center_hint, max_center_dist)

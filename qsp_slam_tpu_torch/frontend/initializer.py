"""Monocular two-view initialization: essential and homography RANSAC,
model selection, pose disambiguation and triangulation (counterpart of
`qsp_slam_tpu/frontend/initializer.py`).

`two_view_init` is split in two so the random half can be replaced:
`two_view_sample` draws the hypothesis samples (weighted by validity,
with replacement, `torch.multinomial` on an explicit generator), and the
rest is deterministic: both hypothesis families as batched SVDs, scored
against every match in one pass, the ORB-SLAM score ratio choosing the
model, a weighted refit on the winner's inliers, and the four candidate
poses of the refit scored by triangulated cheirality and parallax.

Sign and basis freedoms of the SVDs and of `eigh` (the null vector's
sign, the basis of the essential matrix's double singular value) change
the order of the candidate stack, not the candidates; a candidate's score
does not depend on them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core import lie
from ..core.camera import Intrinsics, pixel_rays


class TwoViewInit(NamedTuple):
    ok: torch.Tensor  # () bool
    T_cw2: torch.Tensor  # (4, 4) second camera pose (the first is the identity)
    points: torch.Tensor  # (M, 3) triangulated world points, match-aligned
    pt_ok: torch.Tensor  # (M,) inlier, in front of both cameras, with parallax
    used_homography: torch.Tensor  # () bool


def _triangulate(rays1: torch.Tensor, rays2: torch.Tensor, T_cw2: torch.Tensor):
    """Midpoint triangulation of unit-plane rays (M, 3), camera 1 at the
    identity and camera 2 at T_cw2: solves [R r1, -r2] [d1; d2] = -t in
    least squares.  -> points (M, 3) in camera 1, depth 1, depth 2."""
    R, t = T_cw2[:3, :3], T_cw2[:3, 3]
    a = rays1 @ R.T  # (M, 3)
    b = -rays2
    A = torch.stack([a, b], dim=-1)  # (M, 3, 2)
    AtA = torch.einsum("mij,mik->mjk", A, A)
    Atb = torch.einsum("mij,i->mj", A, -t)
    det = AtA[:, 0, 0] * AtA[:, 1, 1] - AtA[:, 0, 1] * AtA[:, 1, 0]
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    d1 = (AtA[:, 1, 1] * Atb[:, 0] - AtA[:, 0, 1] * Atb[:, 1]) / det
    d2 = (-AtA[:, 1, 0] * Atb[:, 0] + AtA[:, 0, 0] * Atb[:, 1]) / det
    return rays1 * d1[:, None], d1, d2


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _essential_8pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point essential matrices from normalized coords (..., 8, 2) each,
    projected to singular values (1, 1, 0) -> (..., 3, 3)."""
    X1, X2 = _homog(x1), _homog(x2)
    A = (X2[..., :, None] * X1[..., None, :]).reshape(x1.shape[:-1] + (9,))  # x2^T E x1 = 0
    E = torch.linalg.svd(A).Vh[..., -1, :].reshape(x1.shape[:-2] + (3, 3))
    return _rank2(E)


def _rank2(E: torch.Tensor) -> torch.Tensor:
    U, _, Vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s) @ Vt


def _homography_4pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """4-point DLT homographies on normalized coords (..., 4, 2) each ->
    (..., 3, 3) with x2 ~ H x1."""
    X1 = _homog(x1)
    zeros = torch.zeros_like(X1)
    rows_u = torch.cat([X1, zeros, -x2[..., 0:1] * X1], dim=-1)
    rows_v = torch.cat([zeros, X1, -x2[..., 1:2] * X1], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 8, 9)
    return torch.linalg.svd(A).Vh[..., -1, :].reshape(x1.shape[:-2] + (3, 3))


def _epipolar_err(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Symmetric epipolar distance on the normalized plane: E (..., 3, 3),
    x (M, 2) -> (..., M)."""
    X1, X2 = _homog(x1), _homog(x2)
    l2 = X1 @ E.transpose(-1, -2)  # lines in image 2
    l1 = X2 @ E  # lines in image 1
    num = torch.abs(torch.sum(X2 * l2, dim=-1))
    d2 = num / torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = num / torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return d1 + d2


def _dehomog(x: torch.Tensor) -> torch.Tensor:
    return x[..., :2] / torch.where(torch.abs(x[..., 2:]) < 1e-12, 1e-12, x[..., 2:])


def _homography_err(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer error on the normalized plane: H (..., 3, 3),
    x (M, 2) -> (..., M).  A singular H gives non-finite errors (no
    inliers), as in the reference."""
    X1, X2 = _homog(x1), _homog(x2)
    Hx1 = _dehomog(X1 @ H.transpose(-1, -2))
    Hx2 = _dehomog(X2 @ torch.linalg.inv_ex(H).inverse.transpose(-1, -2))
    return torch.linalg.vector_norm(Hx1 - x2, dim=-1) + torch.linalg.vector_norm(Hx2 - x1, dim=-1)


def _decompose_E(E: torch.Tensor) -> torch.Tensor:
    """The 4 candidate poses (R1|±t, R2|±t) of an essential matrix -> (4, 4, 4)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))  # proper rotations
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return lie.rt_to_se3(torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t]))


def _decompose_H(H: torch.Tensor, x1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Candidate poses of a normalized-coords homography x2 ~ H x1 with
    H = R + t n^T (plane at unit distance, normal n in camera 1): the DLT
    sign is fixed by an inlier vote (physical points have (H x1)_3 > 0),
    H is scaled to middle singular value 1, the extreme eigenvectors of
    H^T H - I span the two normals, and for each of ±n_a, ±n_b: R from
    H e = R e on the plane, t = (H - R) n.  -> (4, 4, 4)."""
    dt, dev = H.dtype, H.device
    sgn = torch.sign(torch.sum(w * (_homog(x1) @ H.T)[:, 2]) + 1e-12)
    S_h = torch.linalg.svdvals(H)
    Hs = sgn * H / torch.clamp(S_h[1], min=1e-12)
    lam, V = torch.linalg.eigh(Hs.T @ Hs - torch.eye(3, dtype=dt, device=dev))  # ascending
    zeta = torch.sqrt(torch.clamp(lam[2], min=0.0))
    eta = torch.sqrt(torch.clamp(-lam[0], min=0.0))
    denom = torch.clamp(torch.sqrt(zeta ** 2 + eta ** 2), min=1e-12)
    n_a = (zeta * V[:, 2] + eta * V[:, 0]) / denom
    n_b = (zeta * V[:, 2] - eta * V[:, 0]) / denom
    n = torch.stack([n_a, -n_a, n_b, -n_b])  # (4, 3): each normal up to sign

    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
    a = torch.where((torch.abs(n[:, 0]) < 0.9)[:, None], ex, ey)
    e1 = a - n * torch.sum(a * n, dim=-1, keepdim=True)
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-12)
    e2 = torch.linalg.cross(n, e1)
    r1 = e1 @ Hs.T
    r1 = r1 / torch.clamp(torch.linalg.vector_norm(r1, dim=-1, keepdim=True), min=1e-12)
    r2 = e2 @ Hs.T
    r2 = r2 - r1 * torch.sum(r1 * r2, dim=-1, keepdim=True)
    r2 = r2 / torch.clamp(torch.linalg.vector_norm(r2, dim=-1, keepdim=True), min=1e-12)
    r3 = torch.linalg.cross(r1, r2)
    R = torch.stack([r1, r2, r3], dim=-1) @ torch.stack([e1, e2, n], dim=-1).transpose(-1, -2)
    t = torch.einsum("kij,kj->ki", Hs - R, n)
    return lie.rt_to_se3(R, t)


Draw = Callable[[torch.Tensor, "torch.Generator | None", int], tuple]


def two_view_sample(valid: torch.Tensor, gen: torch.Generator | None, num_hyp: int = 128):
    """Hypothesis samples drawn with replacement from the valid matches:
    (num_hyp, 8) indices for the essential family, then (num_hyp, 4) for
    the homography family.  With no valid match the draw is uniform (no
    hypothesis can win then).  The draw runs on the generator's device and
    lands on `valid`'s, so a CPU generator gives the card a CPU run's draws."""
    w = valid.to(torch.float32)
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    if gen is not None:
        w = w.to(gen.device)
    idx8 = torch.multinomial(w, num_hyp * 8, replacement=True, generator=gen)
    idx4 = torch.multinomial(w, num_hyp * 4, replacement=True, generator=gen)
    return idx8.reshape(num_hyp, 8).to(valid.device), idx4.reshape(num_hyp, 4).to(valid.device)


def two_view_init(
    uv1: torch.Tensor,  # (M, 2) matched pixels in frame 1
    uv2: torch.Tensor,  # (M, 2) matched pixels in frame 2
    valid: torch.Tensor,  # (M,)
    intr: Intrinsics,
    gen: torch.Generator | None,
    num_hyp: int = 128,
    inlier_norm: float = 0.006,  # ~3 px at f = 520 on the normalized plane
    min_inliers: int = 40,
    min_parallax_deg: float = 0.6,
    draw: Draw = two_view_sample,
) -> TwoViewInit:
    """The two-view bootstrap from matched pixel pairs; `draw(valid, gen,
    num_hyp)` gives the samples (`two_view_sample` unless a caller
    supplies its own).  The map is scaled to median depth 1."""
    M = uv1.shape[0]
    x1 = pixel_rays(uv1, intr)[:, :2]
    x2 = pixel_rays(uv2, intr)[:, :2]
    idx8, idx4 = draw(valid, gen, num_hyp)
    idx8, idx4 = idx8.long(), idx4.long()

    Es = _essential_8pt(x1[idx8], x2[idx8])  # (H, 3, 3)
    inlE = (_epipolar_err(Es, x1, x2) < inlier_norm) & valid[None]
    scoreE = torch.sum(inlE, dim=-1)
    bE = torch.argmax(scoreE)
    Hs = _homography_4pt(x1[idx4], x2[idx4])
    inlH = (_homography_err(Hs, x1, x2) < 2 * inlier_norm) & valid[None]
    scoreH = torch.sum(inlH, dim=-1)
    bH = torch.argmax(scoreH)

    # Model selection (ORB-SLAM's ratio): the homography when it explains
    # more than 45%.
    rH = scoreH[bH].to(torch.float32) / torch.clamp(scoreH[bH] + scoreE[bE], min=1).to(torch.float32)
    use_H = rH > 0.45
    inl_best = torch.where(use_H, inlH[bH], inlE[bE])
    w = inl_best.to(x1.dtype)
    X1, X2 = _homog(x1), _homog(x2)
    # Essential refit: weighted 8-point least squares on the inliers.
    A = (X2[:, :, None] * X1[:, None, :]).reshape(M, 9) * w[:, None]
    E_ref = _rank2(torch.linalg.svd(A, full_matrices=False).Vh[-1].reshape(3, 3))
    # Homography refit: weighted DLT (E is degenerate on a plane).
    zeros = torch.zeros_like(X1)
    rows_u = torch.cat([X1, zeros, -x2[:, 0:1] * X1], dim=-1)
    rows_v = torch.cat([zeros, X1, -x2[:, 1:2] * X1], dim=-1)
    Ah = torch.cat([rows_u * w[:, None], rows_v * w[:, None]])
    H_ref = torch.linalg.svd(Ah, full_matrices=False).Vh[-1].reshape(3, 3)

    cands = torch.where(use_H, _decompose_H(H_ref, x1, w), _decompose_E(E_ref))  # (4, 4, 4)
    rays1, rays2 = _homog(x1), _homog(x2)
    cos_min = math.cos(math.radians(min_parallax_deg))
    counts, ptss, oks = [], [], []
    for T in cands:
        pts, d1, d2 = _triangulate(rays1, rays2, T)
        c2 = -T[:3, :3].T @ T[:3, 3]
        v2 = pts - c2
        cosang = torch.sum(pts * v2, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(pts, dim=-1) * torch.linalg.vector_norm(v2, dim=-1), min=1e-12)
        # The parallax gate is part of the score: a near-identity candidate
        # puts everything in front of a zero baseline, with no parallax.
        ok = (d1 > 0.01) & (d2 > 0.01) & inl_best & (cosang < cos_min)
        counts.append(torch.sum(ok))
        ptss.append(pts)
        oks.append(ok)
    counts = torch.stack(counts)
    best = torch.argmax(counts)
    T_best, pts, ok_pts = cands[best], torch.stack(ptss)[best], torch.stack(oks)[best]

    # Scale: the median triangulated depth becomes 1 (the monocular gauge).
    zs = torch.sort(torch.where(ok_pts, pts[:, 2], torch.inf)).values
    n_ok = torch.sum(ok_pts)
    med = zs[torch.clamp((torch.clamp(n_ok, min=1) - 1) // 2, 0, M - 1)]
    med = torch.where((med <= 0) | ~torch.isfinite(med), 1.0, med)
    T_scaled = T_best.clone()
    T_scaled[:3, 3] = T_best[:3, 3] / med
    ok = (n_ok >= min_inliers) & (counts[best] > 0.7 * torch.sum(inl_best))
    return TwoViewInit(ok=ok, T_cw2=T_scaled, points=pts / med, pt_ok=ok_pts, used_homography=use_H)

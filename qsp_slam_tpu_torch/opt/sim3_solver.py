"""Closed-form Sim(3)/SE(3) alignment (Horn) and batched RANSAC
(counterpart of `qsp_slam_tpu/opt/sim3_solver.py`).

Hypotheses are a fixed batch of minimal triples scored in one pass: the
3x3 covariances of all triples go through one batched `torch.linalg.svd`,
and every hypothesis is scored against every correspondence at once.

The RANSAC functions are split as `pnp_ransac` is: `sim3_sample` draws
the (H, 3) raw indices (`torch.randint` with an explicit generator), and
the deterministic rest maps them onto the valid rows and scores them.  A
caller passes `draw` to supply the raw indices instead (the parity tests
feed the reference's `jax.random.randint` draws).  Two quirks of the
reference are kept: a triple may repeat a row (the draws are independent),
and the image-space polish keeps the residuals of points behind either
camera, zeroed (`refine_sim3_reproj`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import lie
from ..core.camera import Intrinsics, project


def horn_alignment(
    pts_src: torch.Tensor,  # (..., N, 3)
    pts_dst: torch.Tensor,  # (..., N, 3)
    weights: torch.Tensor,  # (..., N) >= 0
    with_scale: bool = True,
) -> torch.Tensor:
    """Weighted least-squares similarity T (..., 4, 4) with dst ~ T src,
    sR in the top-left block (s = 1 without scale).  Degenerate inputs
    give garbage; callers gate."""
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.einsum("...n,...ni->...i", w, pts_src)
    mu_d = torch.einsum("...n,...ni->...i", w, pts_dst)
    xs = pts_src - mu_s[..., None, :]
    xd = pts_dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, xd, xs)
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        var_s = torch.einsum("...n,...ni->...", w, xs * xs)
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(det)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return lie.rt_to_se3(s[..., None, None] * R, t)


Draw = Callable[[int, "torch.Generator | None", int], torch.Tensor]


def sim3_sample(n_rows: int, gen: torch.Generator | None, num_hyp: int) -> torch.Tensor:
    """(num_hyp, 3) raw row draws in [0, n_rows), the reference's
    `jax.random.randint(key, (H, 3), 0, N)`."""
    dev = gen.device if gen is not None else None
    return torch.randint(0, n_rows, (num_hyp, 3), generator=gen, device=dev)


def _sample_valid_triples(valid: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Raw draws -> (H, 3) triples of valid rows: the valid rows first (a
    stable sort), draws taken modulo their count."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    V = torch.clamp(torch.sum(valid), min=1)
    return order[raw.to(valid.device).long() % V]


class Sim3RansacResult(NamedTuple):
    T_ds: torch.Tensor  # (4, 4) dst <- src similarity
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor  # () bool


def _hypotheses(pts_src, pts_dst, idx, with_scale):
    ones = torch.ones(idx.shape, dtype=pts_src.dtype, device=pts_src.device)
    return horn_alignment(pts_src[idx], pts_dst[idx], ones, with_scale)  # (H, 4, 4)


def ransac_sim3(
    pts_src: torch.Tensor,
    pts_dst: torch.Tensor,
    valid: torch.Tensor,
    gen: torch.Generator | None,
    num_hyp: int = 128,
    inlier_th: float = 0.10,
    min_inliers: int = 12,
    with_scale: bool = True,
    draw: Draw = sim3_sample,
) -> Sim3RansacResult:
    """RANSAC with a metric 3D inlier threshold: H minimal triples, one
    scoring pass, Horn refinement on the winner's inliers."""
    idx = _sample_valid_triples(valid, draw(valid.shape[0], gen, num_hyp))
    Ts = _hypotheses(pts_src, pts_dst, idx, with_scale)
    ok_hyp = valid[idx].all(dim=-1) & (torch.sum(valid) >= 3)
    pred = lie.transform_points(Ts, pts_src)  # (H, N, 3)
    err = torch.linalg.vector_norm(pred - pts_dst[None], dim=-1)
    inl = (err < inlier_th) & valid[None, :]
    score = torch.where(ok_hyp, torch.sum(inl, dim=-1), -1)
    best = torch.argmax(score)
    T_ref = horn_alignment(pts_src, pts_dst, inl[best].to(pts_src.dtype), with_scale)
    pred_r = lie.transform_points(T_ref, pts_src)
    inliers = (torch.linalg.vector_norm(pred_r - pts_dst, dim=-1) < inlier_th) & valid
    n = torch.sum(inliers)
    return Sim3RansacResult(T_ds=T_ref, inliers=inliers, num_inliers=n, ok=n >= min_inliers)


def sim3_image_inliers(
    T: torch.Tensor,  # (..., 4, 4)
    pts_src: torch.Tensor,
    pts_dst: torch.Tensor,
    uv_src: torch.Tensor,
    uv_dst: torch.Tensor,
    sigma2_src: torch.Tensor,
    sigma2_dst: torch.Tensor,
    valid: torch.Tensor,
    intr: Intrinsics,
    with_scale: bool = False,
    chi2: float = 9.21,
) -> torch.Tensor:
    """(..., N) bool: the two-sided image gate.  A pair is an inlier when
    the src point through T lands within chi2 * sigma2 of its dst pixel,
    the dst point through T^-1 within chi2 * sigma2 of its src pixel, both
    in front of their cameras."""
    inv = lie.inv_sim3 if with_scale else lie.inv_se3
    uv1, z1 = project(lie.transform_points(T, pts_src), intr)
    e1 = torch.sum((uv1 - uv_dst) ** 2, dim=-1)
    uv2, z2 = project(lie.transform_points(inv(T), pts_dst), intr)
    e2 = torch.sum((uv2 - uv_src) ** 2, dim=-1)
    return (e1 < chi2 * sigma2_dst) & (e2 < chi2 * sigma2_src) & (z1 > 0) & (z2 > 0) & valid


def refine_sim3_reproj(
    T0: torch.Tensor,  # (4, 4) initial dst <- src similarity
    pts_src: torch.Tensor,  # (N, 3)
    pts_dst: torch.Tensor,  # (N, 3)
    uv_src: torch.Tensor,  # (N, 2)
    uv_dst: torch.Tensor,  # (N, 2)
    sigma2_src: torch.Tensor,  # (N,)
    sigma2_dst: torch.Tensor,  # (N,)
    weights: torch.Tensor,  # (N,) >= 0
    intr: Intrinsics,
    with_scale: bool = False,
    iters: int = 10,
) -> torch.Tensor:
    """Damped Gauss-Newton polish of T against the two-sided reprojection
    residuals: T = exp(delta) T0 (delta in se(3), plus the log-scale with
    scale), `iters` trips with accept-if-better as a selection, so the
    loop never reads the device."""
    P = 7 if with_scale else 6
    dt = pts_src.dtype
    w = weights / torch.clamp(torch.sum(weights), min=1e-9)
    isig_d = torch.sqrt(w / sigma2_dst)
    isig_s = torch.sqrt(w / sigma2_src)
    block = torch.zeros(4, 4, dtype=torch.bool, device=T0.device)
    block[:3, :3] = True

    def apply_T(p):
        # Batched as (1, 6): forward-mode AD promotes 0-dim tensors met
        # with Python floats to float64.
        T = lie.exp_se3(p[None, :6])[0] @ T0
        if with_scale:
            T = torch.where(block, T * torch.exp(p[6]), T)
        return T

    def residuals(p):
        T = apply_T(p)
        uv1, z1 = project(lie.transform_points(T, pts_src), intr)
        r1 = (uv1 - uv_dst) * isig_d[:, None] * (z1 > 0.0).to(dt)[:, None]
        Ti = lie.inv_sim3(T) if with_scale else lie.inv_se3(T)
        uv2, z2 = project(lie.transform_points(Ti, pts_dst), intr)
        r2 = (uv2 - uv_src) * isig_s[:, None] * (z2 > 0.0).to(dt)[:, None]
        return torch.cat([r1.reshape(-1), r2.reshape(-1)])

    def with_aux(p):
        r = residuals(p)
        return r, r

    eye = torch.eye(P, dtype=dt, device=T0.device)
    p = torch.zeros(P, dtype=dt, device=T0.device)
    lam = torch.tensor(1e-4, dtype=dt, device=T0.device)
    c = torch.sum(residuals(p) ** 2)
    for _ in range(iters):
        J, r = torch.func.jacfwd(with_aux, has_aux=True)(p)  # (4N, P), (4N,)
        delta = torch.linalg.solve_ex(J.T @ J + lam * eye, -(J.T @ r))[0]
        p_try = p + delta
        c_try = torch.sum(residuals(p_try) ** 2)
        ok = c_try < c
        p = torch.where(ok, p_try, p)
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 3.0), 1e-9, 1e3)
        c = torch.where(ok, c_try, c)
    return apply_T(p)


def ransac_sim3_reproj(
    pts_src: torch.Tensor,  # (N, 3) points in the src camera
    pts_dst: torch.Tensor,  # (N, 3) points in the dst camera
    uv_src: torch.Tensor,  # (N, 2) src pixel of each pair
    uv_dst: torch.Tensor,  # (N, 2) dst pixel of each pair
    sigma2_src: torch.Tensor,  # (N,) octave variance of the src keypoint
    sigma2_dst: torch.Tensor,  # (N,) octave variance of the dst keypoint
    valid: torch.Tensor,
    gen: torch.Generator | None,
    intr: Intrinsics,
    num_hyp: int = 256,
    chi2: float = 9.21,
    min_inliers: int = 12,
    with_scale: bool = True,
    draw: Draw = sim3_sample,
) -> Sim3RansacResult:
    """RANSAC Sim3 scored by the two-sided image gate (Horn triples on the
    3D pairs, inliers by reprojection in both images); the winner's
    inliers get a Horn refit, kept when it counts more inliers."""
    def count_inliers(T):
        return sim3_image_inliers(T, pts_src, pts_dst, uv_src, uv_dst, sigma2_src, sigma2_dst,
                                  valid, intr, with_scale, chi2)

    idx = _sample_valid_triples(valid, draw(valid.shape[0], gen, num_hyp))
    Ts = _hypotheses(pts_src, pts_dst, idx, with_scale)
    ok_hyp = (valid[idx].all(dim=-1) & (torch.sum(valid) >= 3)
              & torch.isfinite(Ts).all(dim=-1).all(dim=-1))
    inl = count_inliers(Ts)  # (H, N)
    score = torch.where(ok_hyp, torch.sum(inl, dim=-1), -1)
    best = torch.argmax(score)
    s_best = score[best]
    T_ref = horn_alignment(pts_src, pts_dst, inl[best].to(pts_src.dtype), with_scale)
    inl_ref = count_inliers(T_ref)
    better = torch.sum(inl_ref) > s_best
    inliers = torch.where(better, inl_ref, inl[best]) & (s_best > 0)
    n = torch.sum(inliers)
    return Sim3RansacResult(
        T_ds=torch.where(better, T_ref, Ts[best]), inliers=inliers, num_inliers=n,
        ok=(n >= min_inliers) & (s_best > 0),
    )

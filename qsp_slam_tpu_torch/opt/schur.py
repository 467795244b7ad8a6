"""Schur-complement normal equations for bundle adjustment (counterpart of
`qsp_slam_tpu/opt/schur.py`).

Local BA's normal blocks form from per-edge Jacobians without floating-
point scatters (so its sums are deterministic on the card): camera sums
through a one-hot product over the K window cameras, point sums through a
per-point edge-slot table.  The joint camera-point-object BA uses the
scatter-add build (`build_normal_blocks`) and the dense solve over stacked
pose vertices (`solve_dense_pose_system`).  Points are marginalized with
closed-form 3x3 inverses and the reduced systems are solved densely.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class NormalBlocks(NamedTuple):
    H_cc: torch.Tensor  # (K, 6, 6) camera diagonal blocks
    b_c: torch.Tensor  # (K, 6) camera rhs (-J^T W r)
    H_pp: torch.Tensor  # (N, 3, 3) point diagonal blocks
    b_p: torch.Tensor  # (N, 3) point rhs
    B_nk: torch.Tensor  # (N, K, 6, 3) camera-point coupling, by point


def build_normal_blocks(
    r: torch.Tensor,
    Jc: torch.Tensor,
    Jp: torch.Tensor,
    w: torch.Tensor,
    kf_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    num_cams: int,
    num_points: int,
    cam_fixed: torch.Tensor,
) -> NormalBlocks:
    """Weighted normal blocks from r (E, R), Jc (E, R, 6), Jp (E, R, 3) and
    per-row weights w (E, R), summed per camera, per point and per (point,
    camera) pair by scatter-adds (on the card in no fixed order); fixed
    cameras get zero Jacobians."""
    free = 1.0 - cam_fixed.to(r.dtype)
    Jc = Jc * free[kf_idx][:, None, None]
    JcW = Jc * w[..., None]
    JpW = Jp * w[..., None]
    kf, pt = kf_idx.long(), pt_idx.long()

    def segment_sum(x, idx, n):
        return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)

    H_cc = segment_sum(torch.einsum("era,erb->eab", JcW, Jc), kf, num_cams)
    b_c = segment_sum(-torch.einsum("era,er->ea", JcW, r), kf, num_cams)
    H_pp = segment_sum(torch.einsum("era,erb->eab", JpW, Jp), pt, num_points)
    b_p = segment_sum(-torch.einsum("era,er->ea", JpW, r), pt, num_points)
    # A point sees a camera at most once, so this sum is a layout change.
    B_nk = segment_sum(torch.einsum("era,erb->eab", JcW, Jp), pt * num_cams + kf, num_points * num_cams)
    return NormalBlocks(H_cc, b_c, H_pp, b_p, B_nk.reshape(num_points, num_cams, 6, 3))


def point_slot_table(
    pt_idx: torch.Tensor, valid: torch.Tensor, num_points: int, slots: int
) -> torch.Tensor:
    """Edge list -> per-point edge-slot table (N, S) of edge ids (-1 empty).

    Edges of a point fill its slots in edge order (stable sort); a point
    with more than `slots` observations drops the excess."""
    E = pt_idx.shape[0]
    dev = pt_idx.device
    key = torch.where(valid, pt_idx.long(), num_points)
    order = torch.argsort(key, stable=True)
    sorted_pt = key[order]
    first = torch.searchsorted(sorted_pt, torch.arange(num_points + 1, device=dev))
    pos = torch.arange(E, device=dev) - first[torch.clamp(sorted_pt, 0, num_points)]
    ok = (sorted_pt < num_points) & (pos < slots)
    # Rejected edges park in a dump row that is cut off below.
    row = torch.where(ok, sorted_pt, num_points)
    col = torch.clamp(pos, 0, slots - 1)
    table = torch.full(((num_points + 1) * slots,), -1, dtype=torch.int64, device=dev)
    table[torch.where(ok, row * slots + col, num_points * slots)] = torch.where(ok, order, -1)
    return table.reshape(num_points + 1, slots)[:num_points]


def build_normal_blocks_fast(
    r: torch.Tensor,
    Jc: torch.Tensor,
    Jp: torch.Tensor,
    w: torch.Tensor,
    kf_idx: torch.Tensor,
    slot_table: torch.Tensor,  # (N, S) from point_slot_table
    num_cams: int,
    cam_fixed: torch.Tensor,
) -> NormalBlocks:
    """Weighted normal blocks from r (E, R), Jc (E, R, 6), Jp (E, R, 3) and
    per-row weights w (E, R); fixed cameras get zero Jacobians."""
    N, S = slot_table.shape
    free = 1.0 - cam_fixed.to(r.dtype)
    Jc = Jc * free[kf_idx][:, None, None]
    JcW = Jc * w[..., None]
    JpW = Jp * w[..., None]

    onehot_k = F.one_hot(kf_idx.long(), num_cams).to(r.dtype)  # (E, K)
    H_cc = (onehot_k.T @ torch.einsum("era,erb->eab", JcW, Jc).reshape(-1, 36)).reshape(-1, 6, 6)
    b_c = -(onehot_k.T @ torch.einsum("era,er->ea", JcW, r))

    eid = slot_table
    mask = (eid >= 0).to(r.dtype)[..., None]
    eid_c = torch.clamp(eid, min=0)
    Jp_g = Jp[eid_c] * mask[..., None]  # (N, S, R, 3)
    JpW_g = JpW[eid_c] * mask[..., None]
    r_g = r[eid_c] * mask  # (N, S, R)
    JcW_g = JcW[eid_c] * mask[..., None]  # (N, S, R, 6)
    H_pp = torch.einsum("nsra,nsrb->nab", JpW_g, Jp_g)
    b_p = -torch.einsum("nsra,nsr->na", JpW_g, r_g)
    onehot_nk = F.one_hot(kf_idx[eid_c].long(), num_cams).to(r.dtype)  # (N, S, K)
    B_ns = torch.einsum("nsra,nsrb->nsab", JcW_g, Jp_g)  # (N, S, 6, 3)
    B_nk = torch.einsum("nsab,nsk->nkab", B_ns, onehot_nk)
    return NormalBlocks(H_cc, b_c, H_pp, b_p, B_nk)


def _inv3x3_spd(A: torch.Tensor, lm_lambda: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of Marquardt-damped 3x3 blocks (..., 3, 3):
    A + lambda diag(A) + 1e-6 I (the floor keeps empty padding blocks
    invertible)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    A = A + lm_lambda * A * eye + 1e-6 * eye
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = c * h - b * i
    C02 = b * f - c * e
    C10 = f * g - d * i
    C11 = a * i - c * g
    C12 = c * d - a * f
    C20 = d * h - e * g
    C21 = b * g - a * h
    C22 = a * e - b * d
    det = a * C00 + b * C10 + c * C20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([C00, C01, C02], dim=-1),
            torch.stack([C10, C11, C12], dim=-1),
            torch.stack([C20, C21, C22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def cholesky_solve_or_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b by Cholesky; NaN where the factorization fails, as
    `jax.scipy.linalg.cho_factor` gives (the LM accept test then rejects
    the step instead of raising)."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def _jacobi_cholesky_solve(S: torch.Tensor, rhs: torch.Tensor, fixed: torch.Tensor) -> torch.Tensor:
    """Solve the damped system S (n, n) x = rhs (n,) with identity rows and
    columns and zero rhs for the `fixed` (n,) unknowns, symmetrized and
    Jacobi-scaled to unit diagonal so the f32 Cholesky survives the ~1e9
    raw condition number of vision Hessians; NaN where it fails."""
    S = torch.where(fixed[:, None] | fixed[None, :], 0.0, S)
    S = S + torch.diag(fixed.to(S.dtype))
    rhs = rhs * (1.0 - fixed.to(S.dtype))
    S = 0.5 * (S + S.T)
    dinv = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    y = cholesky_solve_or_nan(S * dinv[:, None] * dinv[None, :], rhs * dinv)
    return y * dinv


def solve_dense_pose_system(
    S: torch.Tensor,  # (V, 6, V, 6) damped normal or Schur system over pose vertices
    rhs: torch.Tensor,  # (V, 6)
    fixed_v: torch.Tensor,  # (V,) bool
) -> torch.Tensor:
    """Dense solve over V stacked 6-DoF pose vertices -> delta (V, 6); fixed
    vertices take no update."""
    V = S.shape[0]
    return _jacobi_cholesky_solve(S.reshape(V * 6, V * 6), rhs.reshape(-1),
                                  torch.repeat_interleave(fixed_v, 6)).reshape(V, 6)


def solve_reduced_camera(
    H_cc: torch.Tensor,  # (K, 6, 6) undamped camera blocks
    U: torch.Tensor,  # (K, 6, K, 6)
    rhs: torch.Tensor,  # (K, 6)
    lm_lambda: torch.Tensor,
    cam_fixed: torch.Tensor,
) -> torch.Tensor:
    """Dense solve of the Schur-reduced camera system -> delta_c (K, 6).

    Fixed cameras get identity blocks and zero rhs; the system is
    symmetrized and Jacobi-scaled to unit diagonal before the f32 Cholesky.
    """
    K = H_cc.shape[0]
    dtype = H_cc.dtype
    eye6 = torch.eye(6, dtype=dtype, device=H_cc.device)
    H_cc_d = H_cc + lm_lambda * H_cc * eye6  # Marquardt damping
    S = -U.reshape(K * 6, K * 6) + torch.block_diag(*H_cc_d.unbind(0))
    return _jacobi_cholesky_solve(S, rhs.reshape(-1), torch.repeat_interleave(cam_fixed, 6)).reshape(K, 6)


def solve_schur(
    blocks: NormalBlocks, lm_lambda: torch.Tensor, cam_fixed: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Marginalize points, solve the reduced camera system, back-substitute
    -> (delta_c (K, 6), delta_p (N, 3))."""
    Y = _inv3x3_spd(blocks.H_pp, lm_lambda)  # (N, 3, 3)
    A = torch.einsum("nkac,ncd->nkad", blocks.B_nk, Y)  # (N, K, 6, 3)
    U = torch.einsum("nkad,nqbd->kaqb", A, blocks.B_nk)  # (K, 6, K, 6)
    Yb = torch.einsum("nab,nb->na", Y, blocks.b_p)
    rhs = blocks.b_c - torch.einsum("nkac,nc->ka", blocks.B_nk, Yb)
    delta_c = solve_reduced_camera(blocks.H_cc, U, rhs, lm_lambda, cam_fixed)
    Bt_dc = torch.einsum("nkac,ka->nc", blocks.B_nk, delta_c)
    delta_p = torch.einsum("nab,nb->na", Y, blocks.b_p - Bt_dc)
    return delta_c, delta_p

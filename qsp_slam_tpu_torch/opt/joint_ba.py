"""Joint camera-point-object bundle adjustment (counterpart of
`qsp_slam_tpu/opt/joint_ba.py`).

Object vertices (T_ow, world -> object) join the cameras, linked to them
by relative-pose edges whose measurement is a keyframe's camera-object
transform T_oc: r = log(M^-1 T_ow T_cw^-1), information 1e3 I, Huber
delta^2 = 0.1 * 1e3.  The pose state is one stack (K cameras, then O
objects).  Reprojection edges give the Schur-reduced camera blocks; the
object edges add 6x6 blocks to the same dense system (by accumulating
scatters: many edges share a block), which one Jacobi-scaled Cholesky
solves.  The LM trips select the accepted step with `where`, so no trip
reads the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..core import lie
from ..core.camera import Intrinsics
from . import robust
from .reproj import ReprojEdges, edge_chi2, residuals_and_jacobians
from .schur import _inv3x3_spd, build_normal_blocks, solve_dense_pose_system

OBJ_EDGE_INFO = 1e3  # information scale (1e3 I)
OBJ_EDGE_HUBER2 = 0.1 * 1e3  # delta^2


class ObjectPoseEdges(NamedTuple):
    cam_idx: torch.Tensor  # (E2,) int camera vertex (0..K-1)
    obj_idx: torch.Tensor  # (E2,) int object vertex (0..O-1)
    T_oc: torch.Tensor  # (E2, 4, 4) measured camera -> object transform
    valid: torch.Tensor  # (E2,) bool


class JointBAResult(NamedTuple):
    Tcw: torch.Tensor  # (K, 4, 4)
    Tow: torch.Tensor  # (O, 4, 4)
    points: torch.Tensor  # (N, 3)
    inlier: torch.Tensor  # (E,) reprojection edges surviving
    obj_inlier: torch.Tensor  # (E2,) object edges surviving
    cost: torch.Tensor


def _obj_edge_residual(xi_c, xi_o, Tcw, Tow, M_inv):
    """r = log(M^-1 exp(xi_o) T_ow (exp(xi_c) T_cw)^-1) in se(3), batched
    over edges (E, 6); M^-1 is taken outside the differentiated path."""
    T_oc_pred = (lie.exp_se3(xi_o) @ Tow) @ lie.inv_se3(lie.exp_se3(xi_c) @ Tcw)
    return lie.log_se3(M_inv @ T_oc_pred)


def _obj_edge_system(Tcw_e, Tow_e, M_inv):
    """Residuals (E, 6) of the edges at zero tangents and their Jacobians
    (E, 6, 6) with respect to the camera's and the object's left
    perturbations: one forward-mode pass per basis tangent, `vmap` over the
    basis only (batched primals under `vmap(jacfwd)` give NaN past the
    first element through `linalg.inv`)."""
    E = Tcw_e.shape[0]
    zeros = torch.zeros(E, 6, dtype=Tcw_e.dtype, device=Tcw_e.device)
    basis = torch.eye(6, dtype=Tcw_e.dtype, device=Tcw_e.device)

    def res(xi_c, xi_o):
        return _obj_edge_residual(xi_c, xi_o, Tcw_e, Tow_e, M_inv)

    r, Jc = vmap(lambda v: jvp(res, (zeros, zeros), (v.expand(E, 6), zeros)))(basis)
    _, Jo = vmap(lambda v: jvp(res, (zeros, zeros), (zeros, v.expand(E, 6))))(basis)
    return r[0], Jc.permute(1, 2, 0), Jo.permute(1, 2, 0)


def _blocks_index(i: torch.Tensor, j: torch.Tensor):
    """Row and column indices (E, 6, 6) of the 6x6 blocks (i, j) of a dense
    (6V, 6V) system."""
    ar = torch.arange(6, device=i.device)
    E = i.shape[0]
    return (i[:, None] * 6 + ar)[:, :, None].expand(E, 6, 6), (j[:, None] * 6 + ar)[:, None, :].expand(E, 6, 6)


def joint_bundle_adjustment(
    Tcw: torch.Tensor,  # (K, 4, 4)
    Tow: torch.Tensor,  # (O, 4, 4)
    points: torch.Tensor,  # (N, 3)
    cam_fixed: torch.Tensor,  # (K,) bool
    obj_fixed: torch.Tensor,  # (O,) bool
    edges: ReprojEdges,
    obj_edges: ObjectPoseEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    iters_robust: int = 5,
    iters_final: int = 10,
) -> JointBAResult:
    """Two-stage robust LM over cameras, objects and points: `iters_robust`
    Huber trips, a chi2 gate on both edge kinds, `iters_final` plain trips
    on the inliers."""
    K, O, N = Tcw.shape[0], Tow.shape[0], points.shape[0]
    V = K + O
    dt, dev = Tcw.dtype, Tcw.device
    delta2 = torch.where(edges.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    ci, oi = obj_edges.cam_idx.long(), obj_edges.obj_idx.long()
    M_inv = torch.linalg.inv_ex(obj_edges.T_oc)[0]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    free_c = 1.0 - cam_fixed.to(dt)
    free_o = 1.0 - obj_fixed.to(dt)
    fixed_v = torch.cat([cam_fixed, obj_fixed])
    rows_cc, cols_cc = _blocks_index(ci, ci)
    rows_oo, cols_oo = _blocks_index(K + oi, K + oi)
    rows_co, cols_co = _blocks_index(ci, K + oi)
    rows_oc, cols_oc = _blocks_index(K + oi, ci)
    idx_k = torch.arange(K, device=dev)
    idx_o = K + torch.arange(O, device=dev)

    huber2 = torch.tensor(OBJ_EDGE_HUBER2, dtype=dt, device=dev)

    def obj_chi2(Tcw_, Tow_):
        """Object-edge chi2 (E2,) at zero tangents."""
        r = lie.log_se3(M_inv @ (Tow_[oi] @ lie.inv_se3(Tcw_[ci])))
        return torch.sum(r * r, dim=-1) * OBJ_EDGE_INFO

    def stage(Tcw_, Tow_, pts_, edge_valid, obj_valid, iters, use_huber):
        e = edges._replace(valid=edge_valid)

        def full_cost(Tc, To, P):
            r, _, _, rm, _ = residuals_and_jacobians(Tc, P, e, intr, baseline_fx, with_jacobians=False)
            chi2 = torch.sum(r * r * rm, dim=-1) * e.inv_sigma2
            c1 = robust.huber_rho(chi2, delta2) if use_huber else chi2
            c1 = torch.sum(torch.where(rm[..., 0] > 0, c1, 0.0))
            chio = obj_chi2(Tc, To)
            c2 = robust.huber_rho(chio, huber2) if use_huber else chio
            return c1 + torch.sum(torch.where(obj_valid, c2, 0.0))

        lmbda = torch.tensor(1e-3, dtype=dt, device=dev)
        cost = full_cost(Tcw_, Tow_, pts_)
        for _ in range(iters):
            r, Jc, Jp, rm, _ = residuals_and_jacobians(Tcw_, pts_, e, intr, baseline_fx)
            chi2 = edge_chi2(r, rm, e.inv_sigma2)
            w_edge = robust.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
            blocks = build_normal_blocks(r, Jc, Jp, rm * (e.inv_sigma2 * w_edge)[:, None], e.kf_idx, e.pt_idx,
                                         K, N, cam_fixed)
            # The object edges' blocks over the stacked pose state.
            ro, Jce, Joe = _obj_edge_system(Tcw_[ci], Tow_[oi], M_inv)
            chio = torch.sum(ro * ro, dim=-1) * OBJ_EDGE_INFO
            wo = robust.huber_weight(chio, huber2) if use_huber else torch.ones_like(chio)
            wo = wo * OBJ_EDGE_INFO * obj_valid.to(dt)
            Jce = Jce * free_c[ci][:, None, None]
            Joe = Joe * free_o[oi][:, None, None]
            JceW, JoeW = Jce * wo[:, None, None], Joe * wo[:, None, None]

            # The dense (6V, 6V) system: Schur-reduced cameras, then objects.
            Y = _inv3x3_spd(blocks.H_pp, lmbda)
            A = torch.einsum("nkac,ncd->nkad", blocks.B_nk, Y)
            U = torch.einsum("nkad,nqbd->kaqb", A, blocks.B_nk)  # (K, 6, K, 6)
            S = torch.zeros(V * 6, V * 6, dtype=dt, device=dev)
            S[:K * 6, :K * 6] = -U.reshape(K * 6, K * 6)
            S4 = S.view(V, 6, V, 6)
            S4[idx_k, :, idx_k, :] += blocks.H_cc + lmbda * blocks.H_cc * eye6
            S.index_put_((rows_cc, cols_cc), torch.einsum("eri,erj->eij", JceW, Jce), accumulate=True)
            S.index_put_((rows_oo, cols_oo), torch.einsum("eri,erj->eij", JoeW, Joe), accumulate=True)
            S.index_put_((rows_co, cols_co), torch.einsum("eri,erj->eij", JceW, Joe), accumulate=True)
            S.index_put_((rows_oc, cols_oc), torch.einsum("eri,erj->eij", JoeW, Jce), accumulate=True)
            # Marquardt damping of the object diagonal blocks.
            S4[idx_o, :, idx_o, :] += lmbda * S4[idx_o, :, idx_o, :] * eye6

            Yb = torch.einsum("nab,nb->na", Y, blocks.b_p)
            rhs = torch.zeros(V, 6, dtype=dt, device=dev)
            rhs[:K] = blocks.b_c - torch.einsum("nkac,nc->ka", blocks.B_nk, Yb)
            rhs.index_add_(0, ci, -torch.einsum("eri,er->ei", JceW, ro))
            rhs.index_add_(0, K + oi, -torch.einsum("eri,er->ei", JoeW, ro))
            delta = solve_dense_pose_system(S4, rhs, fixed_v)

            dc, do = delta[:K], delta[K:]
            dp = torch.einsum("nab,nb->na", Y, blocks.b_p - torch.einsum("nkac,ka->nc", blocks.B_nk, dc))
            Tcw_try, Tow_try, pts_try = lie.exp_se3(dc) @ Tcw_, lie.exp_se3(do) @ Tow_, pts_ + dp
            c_try = full_cost(Tcw_try, Tow_try, pts_try)
            accept = c_try < cost
            Tcw_ = torch.where(accept, Tcw_try, Tcw_)
            Tow_ = torch.where(accept, Tow_try, Tow_)
            pts_ = torch.where(accept, pts_try, pts_)
            lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
            cost = torch.where(accept, c_try, cost)
        return Tcw_, Tow_, pts_, cost

    th = torch.where(edges.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

    def gate(Tc, P, valid):
        r, _, _, rm, depth = residuals_and_jacobians(Tc, P, edges, intr, baseline_fx, with_jacobians=False)
        return valid & (edge_chi2(r, rm, edges.inv_sigma2) <= th) & (depth > 0)

    Tcw1, Tow1, pts1, _ = stage(Tcw, Tow, points, edges.valid, obj_edges.valid, iters_robust, True)
    inlier1 = gate(Tcw1, pts1, edges.valid)
    obj_inlier1 = obj_edges.valid & (obj_chi2(Tcw1, Tow1) <= 4.0 * OBJ_EDGE_HUBER2)
    Tcw2, Tow2, pts2, cost = stage(Tcw1, Tow1, pts1, inlier1, obj_inlier1, iters_final, False)
    return JointBAResult(Tcw=Tcw2, Tow=Tow2, points=pts2, inlier=gate(Tcw2, pts2, inlier1),
                         obj_inlier=obj_inlier1, cost=cost)

"""Local bundle adjustment: LM over cameras + points with Schur reduction
(counterpart of `qsp_slam_tpu/opt/local_ba.py`).

Two stages (5 robust iterations, chi2 gate, 10 more on inliers), Huber at
the 95% chi-square quantile, anchor cameras, depth-positivity gating.  The
iterate sequence is the reference's retrospective LM: each trip evaluates
the current proposal once (cost and normal blocks from one residual +
Jacobian pass), accepts it against the carried best (the first trip
against +inf), and solves the next proposal from the accepted state, with
lambda * 0.33 on accept and * 3 on reject.  The early exit is a Python
loop with one `.item()` per trip, for the reason given in `pose_opt.py`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import Intrinsics
from ..utils.tracing import HOST_READS, count, fetch
from . import robust
from .reproj import ReprojEdges, edge_chi2, residuals_and_jacobians
from .schur import NormalBlocks, build_normal_blocks_fast, point_slot_table, solve_schur

# Max observations per point in the slot table (local windows rarely exceed
# the keyframe count per point).
MAX_OBS_PER_POINT = 16


class BAResult(NamedTuple):
    Tcw: torch.Tensor  # (K, 4, 4)
    points: torch.Tensor  # (N, 3)
    inlier: torch.Tensor  # (E,) bool — edges surviving the final chi2 gate
    cost: torch.Tensor  # () cost at the solution
    num_inliers: torch.Tensor  # () int


def _total_cost(r, row_mask, inv_sigma2, use_huber, delta2):
    chi2 = torch.sum(r * r * row_mask, dim=-1) * inv_sigma2
    cost_e = robust.huber_rho(chi2, delta2) if use_huber else chi2
    active = row_mask[..., 0] > 0.0  # row 0 mask == edge validity
    return torch.sum(torch.where(active, cost_e, 0.0))


def _lm_stage(
    Tcw,
    points,
    cam_fixed,
    edges: ReprojEdges,
    intr: Intrinsics,
    baseline_fx,
    iters: int,
    use_huber: bool,
    init_lambda: float = 1e-3,
    early_exit_rtol: float = 1e-5,
):
    K = Tcw.shape[0]
    N = points.shape[0]
    delta2 = torch.where(edges.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    slot_table = point_slot_table(edges.pt_idx, edges.valid, N, min(MAX_OBS_PER_POINT, K))

    def eval_at(Tcw_, points_):
        r, Jc, Jp, row_mask, _ = residuals_and_jacobians(
            Tcw_, points_, edges, intr, baseline_fx
        )
        cost = _total_cost(r, row_mask, edges.inv_sigma2, use_huber, delta2)
        chi2 = edge_chi2(r, row_mask, edges.inv_sigma2)
        w_edge = robust.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
        w_row = row_mask * (edges.inv_sigma2 * w_edge)[:, None]
        blocks = build_normal_blocks_fast(
            r, Jc, Jp, w_row, edges.kf_idx, slot_table, K, cam_fixed
        )
        return cost, blocks

    if iters == 0:
        # Cost-only query (the global BA's final report): one residual pass.
        r, _, _, row_mask, _ = residuals_and_jacobians(Tcw, points, edges, intr, baseline_fx, with_jacobians=False)
        return Tcw, points, _total_cost(r, row_mask, edges.inv_sigma2, use_huber, delta2)

    def step(acc, prop):
        Tcw_a, points_a, blocks_a, lmbda, cost = acc
        Tcw_p, points_p = prop
        new_cost, blocks_p = eval_at(Tcw_p, points_p)
        accept = new_cost < cost

        def sel(a, b):
            return torch.where(accept, a, b)

        Tcw_n = sel(Tcw_p, Tcw_a)
        points_n = sel(points_p, points_a)
        blocks_n = blocks_p if blocks_a is None else NormalBlocks(
            *(sel(p, a) for p, a in zip(blocks_p, blocks_a))
        )
        cost_n = sel(new_cost, cost)
        lmbda_n = torch.clamp(sel(lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        delta_c, delta_p = solve_schur(blocks_n, lmbda_n, cam_fixed)
        prop_n = (lie.exp_se3(delta_c) @ Tcw_n, points_n + delta_p)
        # Converged when an accepted step barely moves the cost (never on
        # the first trip, whose reference cost is +inf).
        converged = accept & (cost - new_cost <= early_exit_rtol * cost) & torch.isfinite(cost)
        return (Tcw_n, points_n, blocks_n, lmbda_n, cost_n), prop_n, converged

    count(HOST_READS, 2)  # the two scalars below are copies from host memory: each waits for the card
    lmbda0 = torch.tensor(init_lambda, dtype=Tcw.dtype, device=Tcw.device)
    inf0 = torch.tensor(math.inf, dtype=Tcw.dtype, device=Tcw.device)
    acc, prop, _ = step((Tcw, points, None, lmbda0, inf0), (Tcw, points))
    for _ in range(iters):
        acc, prop, conv = step(acc, prop)
        count("local_ba_trips")
        if early_exit_rtol > 0.0 and bool(fetch(conv)):
            break
    return acc[0], acc[1], acc[4]


def _gate(Tcw, points, edges: ReprojEdges, intr, baseline_fx):
    """Outlier gate: chi2 above the 95% quantile or non-positive depth."""
    r, _, _, row_mask, depth = residuals_and_jacobians(
        Tcw, points, edges, intr, baseline_fx, with_jacobians=False
    )
    chi2 = edge_chi2(r, row_mask, edges.inv_sigma2)
    th = torch.where(edges.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    return edges.valid & (chi2 <= th) & (depth > 0.0)


def local_bundle_adjustment(
    Tcw: torch.Tensor,
    points: torch.Tensor,
    cam_fixed: torch.Tensor,
    edges: ReprojEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    iters_robust: int = 5,
    iters_final: int = 10,
) -> BAResult:
    """Two-stage local BA (robust 5 + final 10)."""
    Tcw, points, _ = _lm_stage(
        Tcw, points, cam_fixed, edges, intr, baseline_fx, iters_robust, use_huber=True
    )
    inlier1 = _gate(Tcw, points, edges, intr, baseline_fx)
    edges2 = edges._replace(valid=inlier1)
    Tcw, points, cost = _lm_stage(
        Tcw, points, cam_fixed, edges2, intr, baseline_fx, iters_final, use_huber=False
    )
    inlier = _gate(Tcw, points, edges2, intr, baseline_fx)
    return BAResult(Tcw, points, inlier, cost, torch.sum(inlier))


def global_bundle_adjustment(
    Tcw: torch.Tensor,
    points: torch.Tensor,
    edges: ReprojEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    iters: int = 10,
    fix_first: bool = True,
) -> BAResult:
    """Full-map BA: `iters` Huber trips with camera 0 fixed as the gauge
    (when `fix_first`), the chi2 gate, and the plain cost of the inliers."""
    cam_fixed = torch.zeros(Tcw.shape[0], dtype=torch.bool, device=Tcw.device)
    cam_fixed[0] = fix_first
    Tcw, points, _ = _lm_stage(Tcw, points, cam_fixed, edges, intr, baseline_fx, iters, use_huber=True)
    inlier = _gate(Tcw, points, edges, intr, baseline_fx)
    r_cost = _lm_stage(Tcw, points, cam_fixed, edges._replace(valid=inlier), intr, baseline_fx, 0,
                       use_huber=False)[2]
    return BAResult(Tcw, points, inlier, r_cost, torch.sum(inlier))

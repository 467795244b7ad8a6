"""Motion-only pose optimization against fixed points (counterpart of
`qsp_slam_tpu/opt/pose_opt.py`): 4 rounds of at most 10 LM iterations,
Huber in rounds 0-1, chi2 re-gating between rounds (an edge can come back).

Early exit: each round stops once an accepted step improves the cost by no
more than `early_exit_rtol`.  The JAX package does this in a
`lax.while_loop`; here it is a Python loop with one `.item()` per
iteration.  A frame that starts at the motion-model prediction converges
in 2-3 iterations, and in eager PyTorch every skipped iteration saves its
~40 kernel launches, which costs more than the one host sync that decides
to skip it.  The iterates are the reference's either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import Intrinsics
from ..utils.tracing import HOST_READS, count, fetch
from . import robust
from .reproj import ReprojEdges, edge_chi2, residuals_and_jacobians


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # (4, 4)
    inlier: torch.Tensor  # (E,) bool
    num_inliers: torch.Tensor  # () int
    cost: torch.Tensor  # ()


def solve_or_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b; NaN where the factorization fails.  The reference's
    `jnp.linalg.solve` returns non-finite values on a singular system, and
    the LM accept test (`new_cost < cost`) then rejects the step; torch's
    `solve` would raise instead."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where(info[..., None] == 0, x, torch.nan)


def optimize_pose(
    Tcw: torch.Tensor,
    points: torch.Tensor,
    edges: ReprojEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    rounds: int = 4,
    iters_per_round: int = 10,
    early_exit_rtol: float = 1e-5,
) -> PoseOptResult:
    """LM pose-only optimization; `edges.pt_idx` indexes `points` (M, 3),
    `edges.kf_idx` is ignored (one camera)."""
    delta2 = torch.where(edges.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    edges = edges._replace(kf_idx=torch.zeros_like(edges.kf_idx))
    eye6 = torch.eye(6, dtype=Tcw.dtype, device=Tcw.device)

    def residuals(Tcw_, with_jacobians):
        return residuals_and_jacobians(
            Tcw_[None], points, edges, intr, baseline_fx, with_jacobians
        )

    def cost_at(Tcw_, active, use_huber):
        r, _, _, row_mask, _ = residuals(Tcw_, False)
        row_mask = row_mask * active[:, None]
        chi2 = torch.sum(r * r * row_mask, dim=-1) * edges.inv_sigma2
        cost_e = robust.huber_rho(chi2, delta2) if use_huber else chi2
        return torch.sum(torch.where(active > 0.0, cost_e, 0.0))

    def lm_iter(Tcw_, lmbda, cost, use_huber, active):
        r, Jc, _, row_mask, _ = residuals(Tcw_, True)
        row_mask = row_mask * active[:, None]
        chi2 = edge_chi2(r, row_mask, edges.inv_sigma2)
        w_edge = robust.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
        w_row = row_mask * (edges.inv_sigma2 * w_edge)[:, None]
        JW = (Jc * w_row[..., None]).reshape(-1, 6)  # (E*3, 6)
        H = JW.T @ Jc.reshape(-1, 6)
        H = H + lmbda * H * eye6 + 1e-6 * eye6  # multiplicative Marquardt damping
        b = -(JW.T @ r.reshape(-1))
        delta = solve_or_nan(H, b)
        Tcw_try = lie.exp_se3(delta) @ Tcw_
        new_cost = cost_at(Tcw_try, active, use_huber)
        accept = new_cost < cost
        return (
            torch.where(accept, Tcw_try, Tcw_),
            torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6),
            torch.where(accept, new_cost, cost),
        )

    def gate(Tcw_):
        r, _, _, row_mask, depth = residuals(Tcw_, False)
        chi2 = edge_chi2(r, row_mask, edges.inv_sigma2)
        return edges.valid & (chi2 <= delta2) & (depth > 0.0)

    active = edges.valid
    cost = torch.zeros((), dtype=Tcw.dtype, device=Tcw.device)
    for rnd in range(rounds):
        use_huber = rnd < 2
        act_f = active.to(Tcw.dtype)
        count(HOST_READS)  # a copy from host memory: waits for the card
        lmbda = torch.tensor(1e-3, dtype=Tcw.dtype, device=Tcw.device)
        cost = cost_at(Tcw, act_f, use_huber)
        for _ in range(iters_per_round):
            prev = cost
            Tcw, lmbda, cost = lm_iter(Tcw, lmbda, cost, use_huber, act_f)
            count("pose_lm_iters")
            if early_exit_rtol > 0.0 and bool(
                fetch((cost < prev) & (prev - cost <= early_exit_rtol * prev))
            ):
                break
        active = gate(Tcw)
    return PoseOptResult(Tcw, active, torch.sum(active), cost)

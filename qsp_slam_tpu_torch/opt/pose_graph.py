"""Relative-pose graph optimization over SE(3) or Sim(3) (counterpart of
`qsp_slam_tpu/opt/pose_graph.py`).

Vertices hold world->frame transforms T_iw (Sim3: sR | t).  Edge (i, j)
with measurement M_ij ~ T_iw T_jw^-1 contributes the tangent residual
r = log(M_ij^-1 T_iw T_jw^-1).  Its Jacobians with respect to the left
perturbations of both endpoints are forward-mode derivatives
(`edge_jacobians`); the dense (V d)^2 Hessian is assembled
with `index_put_(..., accumulate=True)`; LM solves it with Jacobi-scaled
Cholesky.  The `iters` trips run with the accept step as a selection, so
the loop never reads the device; a factorization that fails gives NaN (as
the reference's does), whose step is then rejected.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..core import lie


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor  # (E,) int
    j: torch.Tensor  # (E,) int
    T_ij: torch.Tensor  # (E, 4, 4) measured relative transform T_iw T_jw^-1
    weight: torch.Tensor  # (E,) f32 information scale (0 disables)


def _residual(T_i, T_j, M_inv, sim3: bool):
    rel = M_inv @ T_i @ (lie.inv_sim3(T_j) if sim3 else lie.inv_se3(T_j))
    return lie.log_sim3(rel) if sim3 else lie.log_se3(rel)


def edge_jacobians(T_i: torch.Tensor, T_j: torch.Tensor, M_inv: torch.Tensor, sim3: bool):
    """Residuals (E, d) of the edges at xi = 0 and their Jacobians (E, d, d)
    with respect to the left perturbations xi_i and xi_j: d forward-mode
    passes per endpoint, each pushing one basis tangent through every edge
    (edges are independent, so these are exactly the per-edge `jacfwd`
    blocks).  `vmap` runs over the basis only: batched primals under
    `vmap(jacfwd)` give NaN from `linalg.det` and `linalg.solve` past the
    first batch element."""
    E = T_i.shape[0]
    d = 7 if sim3 else 6
    exp = lie.exp_sim3 if sim3 else lie.exp_se3
    zeros = torch.zeros(E, d, dtype=T_i.dtype, device=T_i.device)
    basis = torch.eye(d, dtype=T_i.dtype, device=T_i.device)

    def res(xi_i, xi_j):
        return _residual(exp(xi_i) @ T_i, exp(xi_j) @ T_j, M_inv, sim3)

    def column(v, left):
        v = v.expand(E, d)
        return jvp(res, (zeros, zeros), (v, zeros) if left else (zeros, v))

    r, Ji = vmap(lambda v: column(v, True))(basis)  # (d, E, d) each
    _, Jj = vmap(lambda v: column(v, False))(basis)
    return r[0], Ji.permute(1, 2, 0), Jj.permute(1, 2, 0)


def optimize_pose_graph(
    poses: torch.Tensor,  # (V, 4, 4) T_iw
    fixed: torch.Tensor,  # (V,) bool
    edges: PoseGraphEdges,
    sim3: bool = False,
    iters: int = 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LM pose-graph optimization; returns (poses, final cost)."""
    V = poses.shape[0]
    d = 7 if sim3 else 6
    dt, dev = poses.dtype, poses.device
    exp = lie.exp_sim3 if sim3 else lie.exp_se3
    ei, ej = edges.i.long(), edges.j.long()
    E = ei.shape[0]
    w = edges.weight
    M_inv = torch.linalg.inv_ex(edges.T_ij)[0]

    free = 1.0 - fixed.to(dt)
    fixed_d = fixed.repeat_interleave(d)
    free_d = 1.0 - fixed_d.to(dt)
    ar = torch.arange(d, device=dev)
    rows_i = (ei[:, None] * d + ar)[:, :, None].expand(E, d, d)
    cols_i = (ei[:, None] * d + ar)[:, None, :].expand(E, d, d)
    rows_j = (ej[:, None] * d + ar)[:, :, None].expand(E, d, d)
    cols_j = (ej[:, None] * d + ar)[:, None, :].expand(E, d, d)

    def cost_at(P):
        r = _residual(P[ei], P[ej], M_inv, sim3)
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def build(P):
        r, Ji, Jj = edge_jacobians(P[ei], P[ej], M_inv, sim3)
        # Fixed vertices take no update.
        Ji = Ji * free[ei][:, None, None]
        Jj = Jj * free[ej][:, None, None]
        JiW, JjW = Ji * w[:, None, None], Jj * w[:, None, None]
        H = torch.zeros(V * d, V * d, dtype=dt, device=dev)
        H.index_put_((rows_i, cols_i), torch.einsum("eri,erj->eij", JiW, Ji), accumulate=True)
        H.index_put_((rows_j, cols_j), torch.einsum("eri,erj->eij", JjW, Jj), accumulate=True)
        H.index_put_((rows_i, cols_j), torch.einsum("eri,erj->eij", JiW, Jj), accumulate=True)
        H.index_put_((rows_j, cols_i), torch.einsum("eri,erj->eij", JjW, Ji), accumulate=True)
        g = torch.zeros(V * d, dtype=dt, device=dev)
        g.index_put_(((ei[:, None] * d + ar).reshape(-1),),
                     -torch.einsum("eri,er->ei", JiW, r).reshape(-1), accumulate=True)
        g.index_put_(((ej[:, None] * d + ar).reshape(-1),),
                     -torch.einsum("eri,er->ei", JjW, r).reshape(-1), accumulate=True)
        return H, g

    lmbda = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = cost_at(poses)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    for _ in range(iters):
        H, g = build(poses)
        H = torch.where(fixed_d[:, None] | fixed_d[None, :], 0.0, H)
        H = H + torch.diag(lmbda * torch.diagonal(H) + 1e-8 + fixed_d.to(dt))
        g = g * free_d
        dinv = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        H_sc = 0.5 * (H + H.T) * dinv[:, None] * dinv[None, :]
        L, info = torch.linalg.cholesky_ex(H_sc)
        L = torch.where(info == 0, L, nan)
        delta = (torch.cholesky_solve((g * dinv)[:, None], L)[:, 0] * dinv).reshape(V, d)
        poses_try = exp(delta) @ poses
        c_try = cost_at(poses_try)
        accept = c_try < cost
        poses = torch.where(accept, poses_try, poses)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-8, 1e6)
        cost = torch.where(accept, c_try, cost)
    return poses, cost


def relative_measurement(T_iw: torch.Tensor, T_jw: torch.Tensor, sim3: bool = False) -> torch.Tensor:
    """The edge measurement M_ij = T_iw T_jw^-1 from two poses."""
    return T_iw @ (lie.inv_sim3(T_jw) if sim3 else lie.inv_se3(T_jw))

"""Bundle adjustment with the reprojection edges sharded over the ranks of
a mesh (counterpart of `qsp_slam_tpu/parallel/sharded_ba.py`).

Every rank holds the whole replicated state (poses, points, the fixed
mask) and the whole edge table, and works on its contiguous block of the
edges.  Per LM trip each rank builds the normal blocks (H_cc, b_c, H_pp,
b_p, B_nk) of its edges; one `all_reduce` of those blocks, fused into one
flat buffer, and one of the candidate's cost are the trip's collectives,
as the reference's two `psum`s.  The Schur solve then runs replicated on
identical sums, so every rank takes the same step.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..core.camera import Intrinsics
from ..opt import robust
from ..opt.reproj import ReprojEdges, residuals_and_jacobians
from ..opt.schur import NormalBlocks, build_normal_blocks, solve_schur
from .mesh import Mesh, all_reduce, all_reduce_flat, broadcast, local_block, make_mesh


def pad_edges_for_mesh(edges: ReprojEdges, num_shards: int) -> ReprojEdges:
    """Pad the edge table so its length divides the mesh size (inert rows:
    invalid, monocular)."""
    E = edges.kf_idx.shape[0]
    pad = -(-E // num_shards) * num_shards - E
    if pad == 0:
        return edges

    def padf(x, fill=0):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])

    return ReprojEdges(
        kf_idx=padf(edges.kf_idx),
        pt_idx=padf(edges.pt_idx),
        uv=padf(edges.uv),
        u_right=padf(edges.u_right, -1.0),
        inv_sigma2=padf(edges.inv_sigma2),
        valid=padf(edges.valid, False),
    )


def sharded_local_ba(
    mesh: Mesh,
    Tcw: torch.Tensor,
    points: torch.Tensor,
    cam_fixed: torch.Tensor,
    edges: ReprojEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    iters: int = 10,
    use_huber: bool = True,
    axis: str = "edges",
    pre_padded: bool = False,
):
    """LM bundle adjustment with the edges sharded over `mesh.shape[axis]`
    ranks -> (Tcw, points, cost), the same on every rank.  Rank 0's inputs
    are broadcast first, so every rank solves one problem.  `pre_padded`
    skips the padding (`multihost.global_ba_inputs` pads)."""
    S = mesh.shape[axis]
    K, N = Tcw.shape[0], points.shape[0]
    if not pre_padded:
        edges = pad_edges_for_mesh(edges, S)
    elif edges.kf_idx.shape[0] % S:
        raise ValueError(f"pre_padded edges: {edges.kf_idx.shape[0]} rows do not divide into {S} blocks")
    Tcw, points, cam_fixed = broadcast(mesh, (Tcw, points, cam_fixed))
    edges = broadcast(mesh, edges)
    e = ReprojEdges(*(x[local_block(mesh, x.shape[0])] for x in edges))
    d2 = torch.where(e.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

    def chi2_at(T, p, with_jacobians):
        r, Jc, Jp, row_mask, _ = residuals_and_jacobians(T, p, e, intr, baseline_fx, with_jacobians)
        chi2 = torch.sum(r * r * row_mask, dim=-1) * e.inv_sigma2
        return r, Jc, Jp, row_mask, chi2

    def cost_at(T, p):
        _, _, _, row_mask, chi2 = chi2_at(T, p, False)
        c = robust.huber_rho(chi2, d2) if use_huber else chi2
        return all_reduce(mesh, torch.sum(torch.where(row_mask[..., 0] > 0, c, 0.0)))

    T, p = Tcw, points
    lmbda = torch.tensor(1e-3, dtype=Tcw.dtype, device=Tcw.device)
    cost = cost_at(T, p)
    for _ in range(iters):
        r, Jc, Jp, row_mask, chi2 = chi2_at(T, p, True)
        w_edge = robust.huber_weight(chi2, d2) if use_huber else torch.ones_like(chi2)
        w_row = row_mask * (e.inv_sigma2 * w_edge)[:, None]
        local = build_normal_blocks(r, Jc, Jp, w_row, e.kf_idx, e.pt_idx, K, N, cam_fixed)
        blocks = NormalBlocks(*all_reduce_flat(mesh, local))
        delta_c, delta_p = solve_schur(blocks, lmbda, cam_fixed)
        T_try = lie.exp_se3(delta_c) @ T
        p_try = p + delta_p
        new_cost = cost_at(T_try, p_try)
        accept = new_cost < cost
        T = torch.where(accept, T_try, T)
        p = torch.where(accept, p_try, p)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return T, p, cost


def make_edge_mesh(num_devices: int | None = None, axis: str = "edges", device=None) -> Mesh:
    return make_mesh(num_devices, axis, device)

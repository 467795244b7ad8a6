"""Bundle adjustment with the map POINTS sharded over the ranks of a mesh
(counterpart of `qsp_slam_tpu/parallel/map_sharded_ba.py`).

Each rank owns a contiguous block of points and every observation of
them, as a dense per-point slot table (`SlotEdges`): the whole-map global
BA for maps that outgrow one card.  Everything point-indexed divides by
the mesh size: the points, H_pp, Y and the (n, K, 6, 3) camera-point
coupling tensor B, the largest term.  The K camera poses stay replicated.

Per LM trip two collectives: one `all_reduce` of the point-marginalized
camera system (H_cc, U, rhs) fused into one flat buffer, and one of the
candidate's scalar cost (plus one cost sum before the first trip).  The
3x3 marginalization, the residuals and Jacobians and the back-substitution
stay on the rank.  Rank 0's inputs are broadcast first; the point blocks
are all-gathered at the end, so every rank returns the same map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import lie
from ..core.camera import Intrinsics
from ..opt import robust
from ..opt.reproj import ReprojEdges, residuals_and_jacobians
from ..opt.schur import _inv3x3_spd, point_slot_table, solve_reduced_camera
from .mesh import Mesh, all_gather_blocks, all_reduce, all_reduce_flat, broadcast, local_block, make_mesh


class SlotEdges(NamedTuple):
    """Per-point observation table: row n holds every edge of point n in
    `S` slots; `valid` masks the empty ones."""

    kf: torch.Tensor  # (N, S) int32 observing camera (0 where empty)
    uv: torch.Tensor  # (N, S, 2)
    u_right: torch.Tensor  # (N, S) right-camera u, -1 for mono
    inv_sigma2: torch.Tensor  # (N, S)
    valid: torch.Tensor  # (N, S) bool


def required_slots(edges: ReprojEdges, num_points: int) -> int:
    """Slot capacity that drops no observation (the most valid edges of any
    point)."""
    key = torch.where(edges.valid, edges.pt_idx.long(), num_points)
    return int(torch.bincount(key, minlength=num_points + 1)[:num_points].max())


def edges_to_slots(edges: ReprojEdges, num_points: int, slots: int | None = None) -> SlotEdges:
    """Regroup an edge list by point into the (N, S) slot layout, edges of a
    point in edge order.  `slots=None` sizes the table from the data; an
    explicit capacity below the most observations of a point raises, since
    the dropped edges would make the sharded solve optimize another graph."""
    need = required_slots(edges, num_points)
    if slots is None:
        slots = max(need, 1)
    elif need > slots:
        raise ValueError(f"edges_to_slots: slot capacity {slots} < max observations per point {need}; "
                         "observations would be silently dropped")
    table = point_slot_table(edges.pt_idx, edges.valid, num_points, slots)
    ok = table >= 0
    eid = torch.clamp(table, min=0)
    return SlotEdges(
        kf=torch.where(ok, edges.kf_idx[eid], 0).to(torch.int32),
        uv=torch.where(ok[..., None], edges.uv[eid], 0.0),
        u_right=torch.where(ok, edges.u_right[eid], -1.0),
        inv_sigma2=torch.where(ok, edges.inv_sigma2[eid], 0.0),
        valid=ok & edges.valid[eid],
    )


def pad_points_for_mesh(points: torch.Tensor, slots: SlotEdges, num_shards: int) -> tuple[torch.Tensor, SlotEdges]:
    """Pad the point axis so it divides the mesh size (inert rows)."""
    N = points.shape[0]
    pad = -(-N // num_shards) * num_shards - N
    if pad == 0:
        return points, slots

    def padf(x, fill=0):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])

    return padf(points), SlotEdges(
        kf=padf(slots.kf),
        uv=padf(slots.uv),
        u_right=padf(slots.u_right, -1.0),
        inv_sigma2=padf(slots.inv_sigma2),
        valid=padf(slots.valid, False),
    )


def _shard(mesh: Mesh, axis: str, points, slots, pre_padded: bool):
    """Broadcast rank 0's point axis, pad it and cut this rank's block."""
    S = mesh.shape[axis]
    if not pre_padded:
        points, slots = pad_points_for_mesh(points, slots, S)
    elif points.shape[0] % S:
        raise ValueError(f"pre_padded points: {points.shape[0]} rows do not divide into {S} blocks")
    points = broadcast(mesh, (points,))[0]
    slots = broadcast(mesh, slots)
    blk = local_block(mesh, points.shape[0])
    return points[blk], SlotEdges(*(x[blk] for x in slots))


class _Shard:
    """One rank's block of points as a flat edge list, and what every trip
    of the two solvers computes from it."""

    def __init__(self, s: SlotEdges, K: int, intr: Intrinsics, baseline_fx: float, dtype):
        self.n, self.S = s.kf.shape
        self.kf = s.kf.long()
        self.e = ReprojEdges(
            kf_idx=self.kf.reshape(-1),
            pt_idx=torch.arange(self.n, device=s.kf.device).repeat_interleave(self.S),
            uv=s.uv.reshape(-1, 2),
            u_right=s.u_right.reshape(-1),
            inv_sigma2=s.inv_sigma2.reshape(-1),
            valid=s.valid.reshape(-1),
        )
        self.d2 = torch.where(self.e.is_stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
        self.onehot_k = F.one_hot(self.kf, K).to(dtype)  # (n, S, K)
        self.intr, self.bf = intr, baseline_fx

    def local_cost(self, T, p, use_huber: bool) -> torch.Tensor:
        r, _, _, row_mask, _ = residuals_and_jacobians(T, p, self.e, self.intr, self.bf, with_jacobians=False)
        chi2 = torch.sum(r * r * row_mask, dim=-1) * self.e.inv_sigma2
        c = robust.huber_rho(chi2, self.d2) if use_huber else chi2
        return torch.sum(torch.where(row_mask[..., 0] > 0, c, 0.0))

    def reduced_system(self, T, p, free_c, lmbda, use_huber: bool):
        """This block's share of the point-marginalized camera system,
        (H_cc, U, rhs), and the local pieces of the back-substitution."""
        n, S = self.n, self.S
        r, Jc, Jp, row_mask, _ = residuals_and_jacobians(T, p, self.e, self.intr, self.bf)
        chi2 = torch.sum(r * r * row_mask, dim=-1) * self.e.inv_sigma2
        w_edge = robust.huber_weight(chi2, self.d2) if use_huber else torch.ones_like(chi2)
        w = (row_mask * (self.e.inv_sigma2 * w_edge)[:, None]).reshape(n, S, 3)
        r_s = r.reshape(n, S, 3)
        Jc_s = Jc.reshape(n, S, 3, 6) * free_c[self.kf][..., None, None]
        Jp_s = Jp.reshape(n, S, 3, 3)
        JcW = Jc_s * w[..., None]
        JpW = Jp_s * w[..., None]
        oh = self.onehot_k
        H_cc = torch.einsum("nsk,nsab->kab", oh, torch.einsum("nsra,nsrb->nsab", JcW, Jc_s))
        b_c = -torch.einsum("nsk,nsa->ka", oh, torch.einsum("nsra,nsr->nsa", JcW, r_s))
        H_pp = torch.einsum("nsra,nsrb->nab", JpW, Jp_s)
        b_p = -torch.einsum("nsra,nsr->na", JpW, r_s)
        B = torch.einsum("nsk,nsab->nkab", oh, torch.einsum("nsra,nsrb->nsab", JcW, Jp_s))
        Y = _inv3x3_spd(H_pp, lmbda)  # (n, 3, 3)
        A = torch.einsum("nkac,ncd->nkad", B, Y)
        U = torch.einsum("nkad,nqbd->kaqb", A, B)
        Yb = torch.einsum("nab,nb->na", Y, b_p)
        rhs = b_c - torch.einsum("nkac,nc->ka", B, Yb)
        return (H_cc, U, rhs), (B, Y, b_p)

    @staticmethod
    def back_substitute(B, Y, b_p, delta_c):
        return torch.einsum("nab,nb->na", Y, b_p - torch.einsum("nkac,ka->nc", B, delta_c))


def map_sharded_ba(
    mesh: Mesh,
    Tcw: torch.Tensor,
    points: torch.Tensor,
    cam_fixed: torch.Tensor,
    slots: SlotEdges,
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    iters: int = 10,
    use_huber: bool = True,
    axis: str = "map",
    pre_padded: bool = False,
):
    """LM bundle adjustment with the points sharded over `mesh.shape[axis]`
    ranks -> (Tcw, points, cost), the same on every rank."""
    K, N_orig = Tcw.shape[0], points.shape[0]
    Tcw, cam_fixed = broadcast(mesh, (Tcw, cam_fixed))
    p, s = _shard(mesh, axis, points, slots, pre_padded)
    sh = _Shard(s, K, intr, baseline_fx, Tcw.dtype)
    free_c = 1.0 - cam_fixed.to(Tcw.dtype)

    def cost_at(T, p_):
        return all_reduce(mesh, sh.local_cost(T, p_, use_huber))

    T = Tcw
    lmbda = torch.tensor(1e-3, dtype=Tcw.dtype, device=Tcw.device)
    cost = cost_at(T, p)
    for _ in range(iters):
        local, (B, Y, b_p) = sh.reduced_system(T, p, free_c, lmbda, use_huber)
        H_cc, U, rhs = all_reduce_flat(mesh, local)  # the trip's one fused sum
        delta_c = solve_reduced_camera(H_cc, U, rhs, lmbda, cam_fixed)
        T_try = lie.exp_se3(delta_c) @ T
        p_try = p + sh.back_substitute(B, Y, b_p, delta_c)
        new_cost = cost_at(T_try, p_try)
        accept = new_cost < cost
        T = torch.where(accept, T_try, T)
        p = torch.where(accept, p_try, p)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return T, all_gather_blocks(mesh, p)[:N_orig], cost


def _place_blocks(i: torch.Tensor, j: torch.Tensor, blocks: torch.Tensor, V: int) -> torch.Tensor:
    """Sum of 6x6 `blocks` (E, 6, 6) at block positions (i, j) of a
    (V, 6, V, 6) system, by one-hot products: a fixed summation order, so
    ranks on one card add the replicated object edges to the same bits
    (an atomic scatter-add would not)."""
    oh_i = F.one_hot(i, V).to(blocks.dtype)
    oh_j = F.one_hot(j, V).to(blocks.dtype)
    return torch.einsum("ev,ewab->vawb", oh_i, oh_j[:, :, None, None] * blocks[:, None])


def map_sharded_joint_ba(
    mesh: Mesh,
    Tcw: torch.Tensor,  # (K, 4, 4)
    Tow: torch.Tensor,  # (O, 4, 4) object vertices, world -> object
    points: torch.Tensor,  # (N, 3)
    cam_fixed: torch.Tensor,  # (K,) bool
    obj_fixed: torch.Tensor,  # (O,) bool
    slots: SlotEdges,
    obj_edges,  # opt.joint_ba.ObjectPoseEdges, replicated (a few hundred rows)
    intr: Intrinsics,
    baseline_fx: float = 0.0,
    iters: int = 10,
    axis: str = "map",
    pre_padded: bool = False,
):
    """Joint camera-point-object Huber LM with the points sharded over
    `mesh.shape[axis]` ranks -> (Tcw, Tow, points, cost), the same on every
    rank.  The camera-object edges are evaluated replicated on every rank
    and added to the reduced pose system after the fused sum: the same
    values everywhere, no extra collective, no double count."""
    from ..opt.joint_ba import OBJ_EDGE_HUBER2, OBJ_EDGE_INFO, _obj_edge_residual, _obj_edge_system
    from ..opt.schur import solve_dense_pose_system

    K, O, N_orig = Tcw.shape[0], Tow.shape[0], points.shape[0]
    V = K + O
    dt, dev = Tcw.dtype, Tcw.device
    Tcw, Tow, cam_fixed, obj_fixed = broadcast(mesh, (Tcw, Tow, cam_fixed, obj_fixed))
    obj_edges = broadcast(mesh, obj_edges)
    p, s = _shard(mesh, axis, points, slots, pre_padded)
    sh = _Shard(s, K, intr, baseline_fx, dt)
    free_c = 1.0 - cam_fixed.to(dt)
    free_o = 1.0 - obj_fixed.to(dt)
    ci, oi = obj_edges.cam_idx.long(), obj_edges.obj_idx.long()
    M_inv = torch.linalg.inv_ex(obj_edges.T_oc)[0]
    ov = obj_edges.valid
    z6 = torch.zeros(ci.shape[0], 6, dtype=dt, device=dev)
    huber2 = torch.tensor(OBJ_EDGE_HUBER2, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    idx_k = torch.arange(K, device=dev)
    idx_o = K + torch.arange(O, device=dev)
    fixed_v = torch.cat([cam_fixed, obj_fixed])
    oh_c = F.one_hot(ci, V).to(dt)
    oh_o = F.one_hot(K + oi, V).to(dt)

    def obj_cost(T, Tw):
        ro = _obj_edge_residual(z6, z6, T[ci], Tw[oi], M_inv)
        c = robust.huber_rho(torch.sum(ro * ro, dim=-1) * OBJ_EDGE_INFO, huber2)
        return torch.sum(torch.where(ov, c, 0.0))

    def cost_at(T, Tw, p_):
        # The point cost is sharded (summed); the object cost replicated.
        return all_reduce(mesh, sh.local_cost(T, p_, True)) + obj_cost(T, Tw)

    T, Tw = Tcw, Tow
    lmbda = torch.tensor(1e-3, dtype=dt, device=dev)
    cost = cost_at(T, Tw, p)
    for _ in range(iters):
        local, (B, Y, b_p) = sh.reduced_system(T, p, free_c, lmbda, True)
        H_cc, U, rhs_c = all_reduce_flat(mesh, local)

        ro, Jce, Joe = _obj_edge_system(T[ci], Tw[oi], M_inv)
        chio = torch.sum(ro * ro, dim=-1) * OBJ_EDGE_INFO
        wo = robust.huber_weight(chio, huber2) * OBJ_EDGE_INFO * ov.to(dt)
        Jce = Jce * free_c[ci][:, None, None]
        Joe = Joe * free_o[oi][:, None, None]
        JceW, JoeW = Jce * wo[:, None, None], Joe * wo[:, None, None]

        Sv = torch.zeros(V, 6, V, 6, dtype=dt, device=dev)
        Sv[:K, :, :K, :] = -U
        Sv[idx_k, :, idx_k, :] += H_cc + lmbda * H_cc * eye6
        Sv = Sv + _place_blocks(ci, ci, torch.einsum("eri,erj->eij", JceW, Jce), V)
        Sv = Sv + _place_blocks(K + oi, K + oi, torch.einsum("eri,erj->eij", JoeW, Joe), V)
        Sv = Sv + _place_blocks(ci, K + oi, torch.einsum("eri,erj->eij", JceW, Joe), V)
        Sv = Sv + _place_blocks(K + oi, ci, torch.einsum("eri,erj->eij", JoeW, Jce), V)
        Sv[idx_o, :, idx_o, :] += lmbda * Sv[idx_o, :, idx_o, :] * eye6

        rhs_v = torch.zeros(V, 6, dtype=dt, device=dev)
        rhs_v[:K] = rhs_c
        rhs_v = rhs_v - oh_c.T @ torch.einsum("eri,er->ei", JceW, ro) - oh_o.T @ torch.einsum("eri,er->ei", JoeW, ro)
        delta = solve_dense_pose_system(Sv, rhs_v, fixed_v)
        dc, do = delta[:K], delta[K:]

        T_try = lie.exp_se3(dc) @ T
        Tw_try = lie.exp_se3(do) @ Tw
        p_try = p + sh.back_substitute(B, Y, b_p, dc)
        new_cost = cost_at(T_try, Tw_try, p_try)
        accept = new_cost < cost
        T = torch.where(accept, T_try, T)
        Tw = torch.where(accept, Tw_try, Tw)
        p = torch.where(accept, p_try, p)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return T, Tw, all_gather_blocks(mesh, p)[:N_orig], cost


def make_map_mesh(num_devices: int | None = None, axis: str = "map", device=None) -> Mesh:
    return make_mesh(num_devices, axis, device)

"""Dry run of every sharded path over N ranks on tiny shapes (counterpart
of `dryrun_multichip` in the repository's `__graft_entry__.py`).

    python -m qsp_slam_tpu_torch.parallel.dryrun N [--cpu] [--reps R]

Starts N ranks (`spawn_ranks`), each running: the edge-sharded BA, the
map-sharded BA, and `global_ba_sharded` / `global_joint_ba_sharded` on a
system-shaped map; every result must be finite and the same on every
rank, and the point BA must move the map.  Then the scaling line: the
edge-sharded BA at 20 keyframes / 2000 points on rank 0 alone (a size-1
mesh, the other ranks waiting) against all N ranks.  Rank 0's JSON line
is printed and returned.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .multihost import spawn_ranks


def _system_map(prob, K: int, N: int, device):
    """A SyntheticBA packed into a MapState (kmax 8, nmax 128, emax 2048),
    observations added keyframe by keyframe."""
    from ..slam import map as mapmod

    m = mapmod.empty_map(kmax=8, nmax=128, emax=2048, device=device)
    for k in range(K):
        m, _ = mapmod.add_keyframe(m, torch.from_numpy(prob.Tcw_init[k]).to(device))
    m, ids = mapmod.add_points(m, torch.from_numpy(prob.points_init).to(device),
                               torch.zeros(N, 256, dtype=torch.int8, device=device),
                               torch.zeros(N, dtype=torch.int32, device=device),
                               torch.zeros(N, 3, device=device), torch.ones(N, dtype=torch.bool, device=device))
    idmap = ids.cpu().numpy()
    for k in range(K):
        sel = prob.kf_idx == k
        pt_ids = np.full(N, -1, np.int32)
        uv = np.zeros((N, 2), np.float32)
        pt_ids[: sel.sum()] = idmap[prob.pt_idx[sel]]
        uv[: sel.sum()] = prob.uv[sel]
        m = mapmod.add_observations(m, torch.tensor(k, dtype=torch.int32, device=device),
                                    torch.from_numpy(pt_ids).to(device), torch.from_numpy(uv).to(device),
                                    torch.full((N,), -1.0, device=device),
                                    torch.zeros(N, dtype=torch.int32, device=device))
    return m


def _check(ok, what: str) -> None:
    if not bool(ok):
        raise RuntimeError(f"dry run: {what}")


def _same_everywhere(mesh, *xs) -> bool:
    """Whether every rank holds the same bits of `xs` as rank 0."""
    from .mesh import broadcast

    xs = tuple(x.reshape(-1).to(torch.float32) for x in xs)
    return all(torch.equal(a, b) for a, b in zip(xs, broadcast(mesh, xs)))


def rank_main(argv=None) -> dict:
    """One rank of the dry run (`spawn_ranks(..., target=
    "qsp_slam_tpu_torch.parallel.dryrun:rank_main")`)."""
    from ..data.synthetic import ba_edges, make_ba_problem
    from ..slam.distributed_mapping import global_ba_sharded, global_joint_ba_sharded
    from ..slam.objects import empty_objects
    from ..slam.tracking import TrackingConfig
    from .map_sharded_ba import edges_to_slots, make_map_mesh, map_sharded_ba
    from .mesh import make_mesh
    from .sharded_ba import make_edge_mesh, sharded_local_ba

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    mesh = make_edge_mesh(device=dev)
    n = mesh.size
    try:
        make_mesh(n + 1, device=dev)
    except ValueError:
        pass
    else:
        raise RuntimeError("dry run: a mesh larger than the process group was made")
    out = {"ranks": n, "backend": mesh.backend, "device": str(dev)}

    prob = make_ba_problem(num_cams=4, num_points=64, obs_per_point=3, seed=0)
    edges = ba_edges(prob, dev)
    fix = torch.zeros(4, dtype=torch.bool, device=dev)
    fix[0] = True
    T0, p0 = torch.from_numpy(prob.Tcw_init).to(dev), torch.from_numpy(prob.points_init).to(dev)
    T, p, cost = sharded_local_ba(mesh, T0, p0, fix, edges, prob.intr, iters=2)
    _check(torch.isfinite(cost) and torch.isfinite(T).all(), "edge-sharded BA is not finite")
    _check(_same_everywhere(mesh, T, p, cost), "edge-sharded BA differs between ranks")
    out["edge_cost"] = float(cost)

    map_mesh = make_map_mesh(device=dev)
    slots = edges_to_slots(edges, prob.points_init.shape[0], slots=4)
    Tm, pm, cm = map_sharded_ba(map_mesh, T0, p0, fix, slots, prob.intr, iters=2)
    _check(torch.isfinite(cm) and torch.isfinite(pm).all(), "map-sharded BA is not finite")
    _check(_same_everywhere(map_mesh, Tm, pm, cm), "map-sharded BA differs between ranks")
    out["map_cost"] = float(cm)

    cfg = TrackingConfig()  # its intrinsics are the synthetic problem's
    K2, N2 = 6, 96
    prob2 = make_ba_problem(num_cams=K2, num_points=N2, obs_per_point=3, seed=1)
    m = _system_map(prob2, K2, N2, dev)
    m_out = global_ba_sharded(m, cfg, map_mesh, iters=3)
    dT = float((m_out.kf_Tcw[:K2] - m.kf_Tcw[:K2]).abs().max())
    _check(torch.isfinite(m_out.kf_Tcw).all() and dT > 1e-6, "sharded global BA did not move the map")
    _check(_same_everywhere(map_mesh, m_out.kf_Tcw, m_out.pt_xyz), "sharded global BA differs between ranks")
    objs = empty_objects(4, device=dev)
    pm_kf = objs.pm_kf.clone()
    pm_kf[0, :2] = torch.tensor([0, 1], dtype=torch.int32)
    valid = objs.valid.clone()
    valid[0] = True
    objs = objs._replace(valid=valid, pm_kf=pm_kf)
    m_j, o_j = global_joint_ba_sharded(m, objs, cfg, map_mesh, iters=2)
    _check(torch.isfinite(m_j.kf_Tcw).all() and torch.isfinite(o_j.ellipsoid).all(), "joint global BA not finite")
    _check(_same_everywhere(map_mesh, m_j.kf_Tcw, m_j.pt_xyz, o_j.ellipsoid), "joint global BA differs")
    out["global_dT"] = dT

    if n > 1:
        big = make_ba_problem(num_cams=20, num_points=2000, obs_per_point=6, seed=0)
        bedges = ba_edges(big, dev)
        bfix = torch.zeros(20, dtype=torch.bool, device=dev)
        bfix[0] = True
        bT, bp = torch.from_numpy(big.Tcw_init).to(dev), torch.from_numpy(big.points_init).to(dev)

        def timed(msh):
            def run():
                sharded_local_ba(msh, bT, bp, bfix, bedges, big.intr, iters=10)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            run()
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
            return np.asarray(ts) * 1e3

        t1 = timed(make_mesh(1, axis="edges", device=dev)) if mesh.rank == 0 else None
        dist.barrier()
        tn = timed(mesh)
        if mesh.rank == 0:
            K_, N_ = 20, 2000
            out["scaling"] = {
                "ranks": n, "backend": mesh.backend, "problem": "20 KF / 2000 pts / ~12k edges, 10 LM trips",
                "t1_ms": float(np.median(t1)), "t1_iqr_ms": [float(np.percentile(t1, q)) for q in (25, 75)],
                "tn_ms": float(np.median(tn)), "tn_iqr_ms": [float(np.percentile(tn, q)) for q in (25, 75)],
                "collective_bytes_per_trip": 4 * (K_ * 42 + N_ * 12 + N_ * K_ * 18 + 1),
                "collectives_per_trip": 2,
                "note": ("t1: rank 0 alone on a size-1 mesh while the others wait; tn: all ranks.  Ranks on "
                         "one host share its cores (or card), so tn > t1 is the cost of the ranks' "
                         "collectives and boundaries, not a scaling figure"),
            }
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
    dist.barrier()
    return out


def dryrun_multichip(n_devices: int, cpu: bool = False, reps: int = 7, timeout: float = 600.0) -> dict:
    """The dry run over `n_devices` ranks; rank 0's JSON line."""
    res = spawn_ranks(n_devices, ["--reps", str(reps)] + (["--cpu"] if cpu else []),
                      target="qsp_slam_tpu_torch.parallel.dryrun:rank_main", cpu=cpu, timeout=timeout)
    return res[0].json()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("ranks", type=int)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.ranks, cpu=args.cpu, reps=args.reps)
    print(json.dumps(out), flush=True)
    print(f"dryrun_multichip({args.ranks}) ok", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()

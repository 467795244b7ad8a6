"""Run the sharded solvers on problems saved to a file, as one rank of a
process group: the rank side of a parity check against another
implementation, of a world-size comparison, or of a measurement.

    spawn_ranks(N, [PROBLEMS_NPZ, OUT_DIR] (+ ["--cpu"]),
                target="qsp_slam_tpu_torch.parallel.replay:main")

`PROBLEMS_NPZ` holds `cases`, a JSON list of {"name", "kind", "prefix",
...}, and each case's arrays under `<prefix>/<field>`.  Kinds and the
fields they read (besides `intr` (4,) and `bf` ()):

- `edge_ba`: Tcw, points, cam_fixed and the ReprojEdges fields ->
  `sharded_local_ba` (options `iters`, `use_huber`);
- `map_ba`: the same -> `edges_to_slots` (option `slots`, None sizes it
  from the data) and `map_sharded_ba`;
- `map_joint_ba`: also Tow, obj_fixed and the ObjectPoseEdges fields ->
  `map_sharded_joint_ba`;
- `global_ba`, `global_joint_ba`: the MapState fields (and the
  ObjectTable's, `obj/<field>`) -> `global_ba_sharded` /
  `global_joint_ba_sharded` under the default TrackingConfig, or under
  option `camera` ({fx, fy, cx, cy, baseline}) a sequence's;
- `system_global_ba`: the MapState fields -> a `SlamSystem` (objects off,
  option `capacity` = [kmax, nmax, emax]) on the world's mesh, marked
  initialized, and `run_global_ba()`.  Option `diverge`: every rank but 0
  holds an empty, uninitialized map of twice the capacity instead, as
  replicas that parted would.  Option `loop_on_rank0` = k: instead, rank
  0 alone has the global BA of a loop at keyframe k due (as loop closing
  leaves it) and every rank ends a frame.  Each rank's facts give its
  branches, loops closed and its map's SHA-256.

Rank r writes `OUT_DIR/rank<r>.npz` (`<name>/<output>`) and prints one JSON
line: backend, world size, device, and per case the branch taken or, with
option `time`, the ms of the whole call by CUDA events (wall clock on the
CPU) after one warm-up call, the ms per LM trip (the call at `iters` trips less the call at 0,
over `iters`), the starting cost, the bytes one trip's collectives
carry, and the rank's peak device memory.  `problem_arrays` and
`save_problems` write such a file.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import Intrinsics
from ..opt.joint_ba import ObjectPoseEdges
from ..opt.reproj import ReprojEdges
from .map_sharded_ba import edges_to_slots, map_sharded_ba, map_sharded_joint_ba
from .mesh import make_mesh
from .sharded_ba import sharded_local_ba


def problem_arrays(prob, bf: float = 0.0) -> dict:
    """A `data.synthetic.SyntheticBA`'s starting state, camera 0 fixed, and
    its edges, as the arrays of one case (numpy, the fields above)."""
    z = {"Tcw": prob.Tcw_init, "points": prob.points_init, "cam_fixed": np.arange(prob.Tcw_init.shape[0]) == 0,
         "intr": np.array(prob.intr, np.float32), "bf": np.float32(bf)}
    z.update({f: getattr(prob, f) for f in ReprojEdges._fields})
    return z


def save_problems(path, cases: list[dict], arrays: dict) -> None:
    """Write `cases` and `arrays` ({prefix: {field: array}}) to `path`."""
    np.savez(path, cases=np.array(json.dumps(cases)),
             **{f"{pre}/{k}": v for pre, fields in arrays.items() for k, v in fields.items()})


def _timed(fn, device) -> tuple[object, float]:
    if device.type == "cuda":
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize(device)
        return out, e0.elapsed_time(e1)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _trip_bytes(kind: str, K: int, N: int, O: int) -> int:
    """f32 bytes one LM trip's collectives carry into each rank."""
    if kind == "edge_ba":  # the normal blocks and the cost
        return 4 * (K * 42 + N * 12 + N * K * 18 + 1)
    return 4 * (K * 36 + (6 * K) ** 2 + 6 * K + 1)  # (H_cc, U, rhs) and the cost


def run_case(spec: dict, z, device, meshes) -> tuple[dict, dict]:
    """One case -> (outputs, facts)."""
    kind, pre = spec["kind"], spec["prefix"]

    def t(name):
        return torch.from_numpy(np.array(z[f"{pre}/{name}"])).to(device)

    intr = Intrinsics(*(float(x) for x in np.asarray(z[f"{pre}/intr"])))
    bf = float(z[f"{pre}/bf"])
    iters = int(spec.get("iters", 10))
    facts = {}
    if kind in ("edge_ba", "map_ba", "map_joint_ba"):
        Tcw, points, cam_fixed = t("Tcw"), t("points"), t("cam_fixed")
        edges = ReprojEdges(*(t(f) for f in ReprojEdges._fields))
        huber = bool(spec.get("use_huber", True))
        if kind == "edge_ba":
            def call(n):
                return sharded_local_ba(meshes["edges"], Tcw, points, cam_fixed, edges, intr, bf, iters=n,
                                        use_huber=huber)
            names = ("Tcw", "points", "cost")
        else:
            slots = edges_to_slots(edges, points.shape[0], spec.get("slots"))
            if kind == "map_ba":
                def call(n):
                    return map_sharded_ba(meshes["map"], Tcw, points, cam_fixed, slots, intr, bf, iters=n,
                                          use_huber=huber)
                names = ("Tcw", "points", "cost")
            else:
                Tow, obj_fixed = t("Tow"), t("obj_fixed")
                oe = ObjectPoseEdges(*(t(f"obj_{f}") for f in ObjectPoseEdges._fields))

                def call(n):
                    return map_sharded_joint_ba(meshes["map"], Tcw, Tow, points, cam_fixed, obj_fixed, slots, oe,
                                                intr, bf, iters=n)
                names = ("Tcw", "Tow", "points", "cost")
        if spec.get("time"):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            call(iters)  # the first call pays the libraries' set-up and module loads
            out, ms = _timed(lambda: call(iters), device)
            entry, ms0 = _timed(lambda: call(0), device)
            O = Tow.shape[0] if kind == "map_joint_ba" else 0
            facts = {"ms": ms, "ms_entry": ms0, "ms_per_trip": (ms - ms0) / max(iters, 1),
                     "collective_bytes_per_trip": _trip_bytes(kind, Tcw.shape[0], points.shape[0], O),
                     "peak_mb": torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None}
            facts["cost0"] = float(entry[-1])
        else:
            out = call(iters)
        return dict(zip(names, out)), facts

    from ..convert import map_state_from_numpy, object_table_from_numpy
    from ..slam.map import MapState
    from ..slam.objects import ObjectTable
    from ..slam.tracking import TrackingConfig

    m = map_state_from_numpy({f: z[f"{pre}/{f}"] for f in MapState._fields}, device=device)
    cfg = TrackingConfig(**spec.get("camera", {}))
    if kind == "global_ba":
        from ..slam.distributed_mapping import global_ba_sharded

        m2 = global_ba_sharded(m, cfg, meshes["map"], iters=iters)
        return {"kf_Tcw": m2.kf_Tcw, "pt_xyz": m2.pt_xyz}, facts
    if kind == "global_joint_ba":
        from ..slam.distributed_mapping import global_joint_ba_sharded

        objs = object_table_from_numpy({f: z[f"{pre}/obj/{f}"] for f in ObjectTable._fields}, device=device)
        m2, o2 = global_joint_ba_sharded(m, objs, cfg, meshes["map"], iters=iters)
        return {"kf_Tcw": m2.kf_Tcw, "pt_xyz": m2.pt_xyz, "ellipsoid": o2.ellipsoid}, facts
    if kind == "system_global_ba":
        from ..slam.system import SlamSystem

        from ..slam.map import empty_map
        from .mesh import tree_digest

        kmax, nmax, emax = spec["capacity"]
        sysm = SlamSystem(cfg, kmax=kmax, nmax=nmax, emax=emax, enable_objects=False, mesh=meshes["map"],
                          device=device)
        if spec.get("diverge") and meshes["map"].rank != 0:
            sysm.map_state = empty_map(2 * kmax, 2 * nmax, 2 * emax, device)
        else:
            sysm.map_state = m
            sysm.initialized = True
        if "loop_on_rank0" in spec:
            sysm.trajectory.append(np.asarray(sysm.Tcw))
            if meshes["map"].rank == 0:
                sysm._loop_kf = int(spec["loop_on_rank0"])
            sysm._end_frame()
        else:
            sysm.run_global_ba(iters)
        facts = {"global_ba": sysm.stats.get("global_ba", []), "loops_closed": sysm.loops_closed,
                 "map_digest": tree_digest(sysm.map_state)}
        out = {"kf_Tcw": sysm.map_state.kf_Tcw, "pt_xyz": sysm.map_state.pt_xyz,
               "Tcw": torch.from_numpy(np.asarray(sysm.Tcw))}
        if sysm.trajectory:
            out["trajectory_last"] = torch.from_numpy(np.asarray(sysm.trajectory[-1]))
        return out, facts
    raise ValueError(f"unknown case kind {kind!r}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("problems")
    ap.add_argument("out_dir")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    z = np.load(args.problems)
    meshes = {axis: make_mesh(axis=axis, device=device) for axis in ("edges", "map")}
    rank = meshes["map"].rank
    outs, facts = {}, {}
    for spec in json.loads(str(z["cases"])):
        got, facts[spec["name"]] = run_case(spec, z, device, meshes)
        outs.update({f"{spec['name']}/{k}": v.detach().cpu().numpy() for k, v in got.items()})
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(os.path.join(args.out_dir, f"rank{rank}.npz"), **outs)
    line = {"rank": rank, "world": meshes["map"].size, "backend": meshes["map"].backend,
            "device": str(device), "cases": facts}
    print(json.dumps(line), flush=True)
    if dist.is_initialized():
        dist.barrier()
    return line

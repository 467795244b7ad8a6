"""Sharded global BA on the live map: MapState in, corrected map out
(counterpart of `qsp_slam_tpu/slam/distributed_mapping.py`).

The system runs these instead of `local_mapping.global_ba_step` /
`joint_mapping.joint_ba_step` when it has a mesh of more than one rank:
the post-loop whole-map optimization and `SlamSystem.run_global_ba`, with
the map's points (and H_pp, Y and the (n, K, 6, 3) coupling tensor)
sharded over the ranks.  Every rank calls them with its replica of the
map and gets the same corrected map back.  The flat edge store becomes a
per-point slot table once per call; its capacity is rounded up to a power
of two, as in the reference, so padding and results match it.
"""

from __future__ import annotations

import torch

from ..core import lie, quadric
from ..opt.joint_ba import ObjectPoseEdges
from ..opt.reproj import ReprojEdges
from ..parallel.map_sharded_ba import edges_to_slots, map_sharded_ba, map_sharded_joint_ba, required_slots
from ..parallel.mesh import Mesh
from .map import MapState
from .objects import ObjectTable
from .tracking import TrackingConfig


def _global_problem(m: MapState, cfg: TrackingConfig):
    """The whole-map BA problem of the SoA store, keyframe 0 the gauge (as
    `local_mapping.global_ba_step` sets it up)."""
    Kmax = m.kf_Tcw.shape[0]
    kf_ids = torch.arange(Kmax, dtype=torch.int32, device=m.device)
    in_map = kf_ids < m.num_kfs
    cam_fixed = (kf_ids == 0) | ~in_map
    ob_kf, ob_pt = m.ob_kf.long(), m.ob_pt.long()
    valid = m.ob_valid & in_map[ob_kf] & m.pt_valid[ob_pt]
    inv_sigma2 = (1.0 / cfg.orb.pyramid.scale_factor ** 2) ** m.ob_octave.to(torch.float32)
    edges = ReprojEdges(ob_kf, ob_pt, m.ob_uv, m.ob_ur, inv_sigma2, valid)
    return in_map, cam_fixed, edges


def _slots_pow2(edges: ReprojEdges, num_points: int):
    """Slot table whose capacity is the next power of two."""
    need = max(required_slots(edges, num_points), 1)
    return edges_to_slots(edges, num_points, slots=1 << (need - 1).bit_length())


def global_ba_sharded(m: MapState, cfg: TrackingConfig, mesh: Mesh, iters: int = 10) -> MapState:
    """Whole-map point BA, map-sharded over `mesh` (the distributed form of
    `local_mapping.global_ba_step`: one Huber LM of `iters` trips)."""
    in_map, cam_fixed, edges = _global_problem(m, cfg)
    slots = _slots_pow2(edges, m.pt_xyz.shape[0])
    T, p, _ = map_sharded_ba(mesh, m.kf_Tcw, m.pt_xyz, cam_fixed, slots, cfg.intr, baseline_fx=cfg.bf,
                             iters=iters, axis=mesh.axis_names[0])
    return m._replace(kf_Tcw=torch.where(in_map[:, None, None], T, m.kf_Tcw), pt_xyz=p)


def global_joint_ba_sharded(
    m: MapState, objects: ObjectTable, cfg: TrackingConfig, mesh: Mesh, iters: int = 10
) -> tuple[MapState, ObjectTable]:
    """Whole-map joint camera-point-object BA, map-sharded over `mesh`.
    The object vertices and edges are `joint_mapping.joint_ba_step`'s with
    the window widened to the whole map (camera index = keyframe id); an
    object with fewer than two measurements stays fixed."""
    in_map, cam_fixed, edges = _global_problem(m, cfg)
    slots = _slots_pow2(edges, m.pt_xyz.shape[0])
    dev = m.device

    Omax, Mring = objects.pm_kf.shape
    Tow = lie.inv_se3(lie.rt_to_se3(quadric.euler_to_rotmat(objects.ellipsoid[:, 3:6]), objects.ellipsoid[:, 0:3]))
    pm_kf = objects.pm_kf.reshape(-1).long()
    pm_obj = torch.arange(Omax, device=dev).repeat_interleave(Mring)
    pm_ok = (pm_kf >= 0) & (pm_kf < m.num_kfs) & objects.valid[pm_obj] & ~objects.dynamic[pm_obj]
    obj_edges = ObjectPoseEdges(cam_idx=torch.clamp(pm_kf, min=0), obj_idx=pm_obj,
                                T_oc=objects.pm_Toc.reshape(-1, 4, 4), valid=pm_ok)
    n_meas = torch.zeros(Omax, dtype=torch.int32, device=dev).index_add_(0, pm_obj, pm_ok.to(torch.int32))
    obj_fixed = ~objects.valid | (n_meas < 2)

    T, Tow_new, p, _ = map_sharded_joint_ba(mesh, m.kf_Tcw, Tow, m.pt_xyz, cam_fixed, obj_fixed, slots, obj_edges,
                                            cfg.intr, baseline_fx=cfg.bf, iters=iters, axis=mesh.axis_names[0])
    m = m._replace(kf_Tcw=torch.where(in_map[:, None, None], T, m.kf_Tcw), pt_xyz=p)
    T_wo = lie.inv_se3(Tow_new)
    e_new = torch.cat([T_wo[:, :3, 3], quadric.rotmat_to_euler(T_wo[:, :3, :3]), objects.ellipsoid[:, 6:9]], dim=-1)
    moved = objects.valid & ~obj_fixed
    return m, objects._replace(ellipsoid=torch.where(moved[:, None], e_new, objects.ellipsoid))

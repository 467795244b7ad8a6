"""Joint camera-point-object BA in the mapping loop, the stereo sensor's
(counterpart of `qsp_slam_tpu/slam/joint_mapping.py`): object pose
vertices join the newest keyframes, constrained by the camera-object
pose measurements in the object table's rings.
"""

from __future__ import annotations

import torch

from ..core import lie, quadric
from ..opt.joint_ba import ObjectPoseEdges, joint_bundle_adjustment
from ..opt.reproj import ReprojEdges
from .map import MapState
from .objects import ObjectTable
from .tracking import TrackingConfig


def joint_ba_step(
    m: MapState,
    objects: ObjectTable,
    cfg: TrackingConfig,
    window: int = 8,
) -> tuple[MapState, ObjectTable]:
    """Optimize the last `window` keyframes (the two oldest of them fixed),
    all points and the object poses.  An object with fewer than two
    measurements from window keyframes (or dynamic, or dead) stays fixed;
    the moved objects' centres and angles are written back, their
    half-axes kept."""
    dev = m.device
    Kmax = m.kf_Tcw.shape[0]
    start = torch.clamp(m.num_kfs - window, min=0)
    kf_ids = torch.arange(Kmax, dtype=torch.int32, device=dev)
    slot_of = torch.where((kf_ids >= start) & (kf_ids < m.num_kfs), torch.clamp(kf_ids - start, 0, window - 1), -1)
    win = torch.arange(window, dtype=torch.int32, device=dev)
    kf_sel = torch.clamp(start + win, 0, Kmax - 1).long()
    win_valid = (start + win) < m.num_kfs
    cam_fixed = (win < 2) | ~win_valid

    ob_kf, ob_pt = m.ob_kf.long(), m.ob_pt.long()
    edge_slot = slot_of[ob_kf]
    valid = m.ob_valid & (edge_slot >= 0) & m.pt_valid[ob_pt]
    inv_sigma2 = (1.0 / cfg.orb.pyramid.scale_factor ** 2) ** m.ob_octave.to(torch.float32)
    edges = ReprojEdges(torch.clamp(edge_slot, min=0).long(), ob_pt, m.ob_uv, m.ob_ur, inv_sigma2, valid)

    # Object vertices: the rigid world -> object transform of each ellipsoid.
    Omax, Mring = objects.pm_kf.shape
    Tow = lie.inv_se3(lie.rt_to_se3(quadric.euler_to_rotmat(objects.ellipsoid[:, 3:6]), objects.ellipsoid[:, 0:3]))
    # The measurement rings flattened into an edge list.
    pm_kf = objects.pm_kf.reshape(-1).long()
    pm_slot = torch.where(pm_kf >= 0, slot_of[torch.clamp(pm_kf, min=0)], -1)
    pm_obj = torch.arange(Omax, device=dev).repeat_interleave(Mring)
    pm_ok = (pm_slot >= 0) & objects.valid[pm_obj] & ~objects.dynamic[pm_obj]
    obj_edges = ObjectPoseEdges(cam_idx=torch.clamp(pm_slot, min=0), obj_idx=pm_obj,
                                T_oc=objects.pm_Toc.reshape(-1, 4, 4), valid=pm_ok)
    n_meas = torch.zeros(Omax, dtype=torch.int32, device=dev).index_add_(0, pm_obj, pm_ok.to(torch.int32))
    obj_fixed = ~objects.valid | (n_meas < 2)

    res = joint_bundle_adjustment(m.kf_Tcw[kf_sel], Tow, m.pt_xyz, cam_fixed, obj_fixed, edges, obj_edges,
                                  cfg.intr, baseline_fx=cfg.bf)
    kf_Tcw = m.kf_Tcw.clone()
    kf_Tcw[kf_sel] = torch.where(win_valid[:, None, None], res.Tcw, m.kf_Tcw[kf_sel])
    m = m._replace(kf_Tcw=kf_Tcw, pt_xyz=res.points,
                   ob_valid=torch.where(edge_slot >= 0, res.inlier & m.ob_valid, m.ob_valid))
    # The optimized object poses folded back into the ellipsoid table.
    T_wo = lie.inv_se3(res.Tow)
    e_new = torch.cat([T_wo[:, :3, 3], quadric.rotmat_to_euler(T_wo[:, :3, :3]), objects.ellipsoid[:, 6:9]], dim=-1)
    moved = objects.valid & ~obj_fixed
    return m, objects._replace(ellipsoid=torch.where(moved[:, None], e_new, objects.ellipsoid))

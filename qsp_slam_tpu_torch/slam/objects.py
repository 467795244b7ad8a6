"""Object landmarks: the SoA ellipsoid table, IoU association, keyframe
integration, refinement (the depth path's `refine_objects` and the
monocular `refine_objects_mono`), culling and duplicate merging
(counterpart of `qsp_slam_tpu/slam/objects.py`).

The table has the JAX package's fields, dtypes and capacities, so a JAX
checkpoint's `obj.*` arrays load as they are.  Functions return a new
table and leave their argument untouched.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import lie, quadric
from ..opt.quadric_factors import ObjectObservations, refine_object


class ObjectTable(NamedTuple):
    ellipsoid: torch.Tensor  # (Omax, 9) world-frame minimal vectors
    label: torch.Tensor  # (Omax,) int32
    prob: torch.Tensor  # (Omax,) f32 running confidence
    obs_count: torch.Tensor  # (Omax,) int32
    valid: torch.Tensor  # (Omax,) bool
    num_objects: torch.Tensor  # () int32
    # observation ring per object (the box history refinement reads)
    obs_Tcw: torch.Tensor  # (Omax, M, 4, 4)
    obs_bbox: torch.Tensor  # (Omax, M, 4)
    obs_weight: torch.Tensor  # (Omax, M)
    obs_next: torch.Tensor  # (Omax,) int32 ring cursor
    # shape state (codes and normalized frames), written by the shape slice
    code: torch.Tensor  # (Omax, C)
    Tow_shape: torch.Tensor  # (Omax, 4, 4) similarity world -> normalized object
    shape_ok: torch.Tensor  # (Omax,) bool
    # lifecycle
    last_seen_kf: torch.Tensor  # (Omax,) int32
    move_votes: torch.Tensor  # (Omax,) int32 large single-frame displacements
    dynamic: torch.Tensor  # (Omax,) bool
    # motion model of dynamic objects, per keyframe-index unit
    vel_center: torch.Tensor  # (Omax, 3) f32
    vel_yaw: torch.Tensor  # (Omax,) f32
    adv_kf: torch.Tensor  # (Omax,) int32 keyframe the state is advanced to
    # camera-object relative-pose measurements per keyframe
    pm_Toc: torch.Tensor  # (Omax, M, 4, 4)
    pm_kf: torch.Tensor  # (Omax, M) int32 keyframe id (-1 empty)
    pm_next: torch.Tensor  # (Omax,) int32 ring cursor

    @property
    def device(self) -> torch.device:
        return self.ellipsoid.device


def empty_objects(omax: int = 32, obs_per_object: int = 16, code_dim: int = 16, device=None) -> ObjectTable:
    dev = resolve_device(device)
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    eye = torch.eye(4, dtype=f32, device=dev)
    return ObjectTable(
        ellipsoid=z((omax, 9), f32), label=torch.full((omax,), -1, dtype=i32, device=dev),
        prob=z(omax, f32), obs_count=z(omax, i32), valid=z(omax, torch.bool), num_objects=z((), i32),
        obs_Tcw=eye.repeat(omax, obs_per_object, 1, 1), obs_bbox=z((omax, obs_per_object, 4), f32),
        obs_weight=z((omax, obs_per_object), f32), obs_next=z(omax, i32),
        code=z((omax, code_dim), f32), Tow_shape=eye.repeat(omax, 1, 1), shape_ok=z(omax, torch.bool),
        last_seen_kf=z(omax, i32), move_votes=z(omax, i32), dynamic=z(omax, torch.bool),
        vel_center=z((omax, 3), f32), vel_yaw=z(omax, f32), adv_kf=z(omax, i32),
        pm_Toc=eye.repeat(omax, obs_per_object, 1, 1),
        pm_kf=torch.full((omax, obs_per_object), -1, dtype=i32, device=dev), pm_next=z(omax, i32),
    )


class Associations(NamedTuple):
    obj_for_det: torch.Tensor  # (D,) int32 object per detection (-1 = new)
    iou: torch.Tensor  # (D,) f32


def associate_detections(
    table: ObjectTable,
    Tcw: torch.Tensor,
    K: torch.Tensor,
    det_bbox: torch.Tensor,  # (D, 4)
    det_label: torch.Tensor,  # (D,)
    det_valid: torch.Tensor,  # (D,)
    iou_threshold: float = 0.3,
) -> Associations:
    """Each detection takes the live, in-front object of its label (-1
    matches any label) whose projected box overlaps it best, above the IoU
    threshold; an object claimed by several keeps its best claimant."""
    O = table.ellipsoid.shape[0]
    proj = quadric.project_bbox(table.ellipsoid, Tcw[None], K)  # (O, 4)
    front = quadric.check_observability(table.ellipsoid, Tcw[None])
    iou = quadric.bbox_iou(proj[None, :, :], det_bbox[:, None, :])  # (D, O)
    label_ok = (det_label[:, None] == table.label[None, :]) | (det_label[:, None] < 0)
    gate = label_ok & table.valid[None, :] & front[None, :] & det_valid[:, None] & (iou > iou_threshold)
    iou_g = torch.where(gate, iou, -1.0)
    best = torch.argmax(iou_g, dim=1)
    best_iou = torch.gather(iou_g, 1, best[:, None])[:, 0]
    obj = torch.where(best_iou > 0.0, best.to(torch.int32), -1)
    obj_safe = torch.where(obj >= 0, obj, O - 1).long()
    best_for_obj = torch.full((O,), -math.inf, dtype=iou.dtype, device=iou.device).scatter_reduce(
        0, obj_safe, torch.where(obj >= 0, best_iou, -1.0), "amax")
    keep = (obj >= 0) & (best_iou >= best_for_obj[obj_safe])
    return Associations(obj_for_det=torch.where(keep, obj, -1), iou=best_iou)


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def advance_dynamic_objects(table: ObjectTable, kf_id: int) -> ObjectTable:
    """Dynamic objects not observed since an earlier keyframe move on to
    `kf_id` with their velocity (their shape anchor with them); repeated
    calls are idempotent through `adv_kf`."""
    anchor = torch.maximum(table.adv_kf, table.last_seen_kf)
    dk = torch.clamp(kf_id - anchor, min=0).to(table.vel_center.dtype)
    move = table.valid & table.dynamic & (dk > 0)
    delta = table.vel_center * dk[:, None]
    e = table.ellipsoid
    yaw = torch.where(move, _wrap(e[:, 4] + table.vel_yaw * dk), e[:, 4])
    e = torch.cat([torch.where(move[:, None], e[:, 0:3] + delta, e[:, 0:3]), e[:, 3:4], yaw[:, None], e[:, 5:]],
                  dim=-1)
    t_new = table.Tow_shape[:, :3, 3] - torch.einsum("oij,oj->oi", table.Tow_shape[:, :3, :3], delta)
    Tow = table.Tow_shape.clone()
    Tow[:, :3, 3] = torch.where(move[:, None], t_new, table.Tow_shape[:, :3, 3])
    return table._replace(ellipsoid=e, Tow_shape=Tow,
                          adv_kf=torch.where(table.valid & (dk > 0), kf_id, table.adv_kf))


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`mask` (O,) or (O, M) shaped to broadcast against x."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def integrate_keyframe(
    table: ObjectTable,
    Tcw: torch.Tensor,
    det_bbox: torch.Tensor,  # (D, 4)
    det_label: torch.Tensor,
    det_prob: torch.Tensor,
    det_valid: torch.Tensor,
    det_ellipsoid_cam: torch.Tensor,  # (D, 9) single-frame fits, camera frame
    det_fit_ok: torch.Tensor,  # (D,) bool
    assoc: Associations,
    kf_id: int = 0,
    dynamic_dist: float = 0.35,
) -> ObjectTable:
    """Fold one keyframe's detections into the table, in detection order
    (a later detection sees the slot an earlier one took).  An associated
    detection pushes a box observation (and a camera-object pose when its
    fit is good), raises the confidence and votes on motion: two large
    displacements make the object dynamic, which then follows its fits.
    An unassociated detection with a good fit takes the first free slot.
    Each step is a masked row update, so the loop never reads the device."""
    D = det_bbox.shape[0]
    O, M = table.obs_weight.shape
    dev = table.device
    ids = torch.arange(O, device=dev)
    slots = torch.arange(M, device=dev)
    T_wc = lie.inv_se3(Tcw)
    e_w = quadric.transform_ellipsoid(det_ellipsoid_cam, T_wc)  # (D, 9)
    T_oc = lie.inv_se3(lie.rt_to_se3(quadric.euler_to_rotmat(det_ellipsoid_cam[:, 3:6]), det_ellipsoid_cam[:, 0:3]))
    kf = torch.tensor(kf_id, dtype=torch.int32, device=dev)
    tb = table._asdict()

    def put(name, mask, val):
        tb[name] = torch.where(_rows(mask, tb[name]), val, tb[name])

    def at(name, o):
        # The row of object o, a (1,) index (a 0-dim one would be read back).
        return tb[name][o][0]

    for i in range(D):
        oid = assoc.obj_for_det[i]
        is_assoc = (oid >= 0) & det_valid[i]
        fit = det_fit_ok[i]
        o = torch.clamp(oid, min=0).long().reshape(1)
        row = (ids == o) & is_assoc
        # Associated: the observation ring, the pose ring, motion votes.
        cell = row[:, None] & (slots == at("obs_next", o) % M)[None, :]
        put("obs_Tcw", cell, Tcw)
        put("obs_bbox", cell, det_bbox[i])
        put("obs_weight", cell, det_prob[i])
        put("obs_next", row, tb["obs_next"] + 1)
        put("obs_count", row, tb["obs_count"] + 1)
        pm_row = row & fit
        pm_cell = pm_row[:, None] & (slots == at("pm_next", o) % M)[None, :]
        put("pm_Toc", pm_cell, T_oc[i])
        put("pm_kf", pm_cell, kf)
        put("pm_next", pm_row, tb["pm_next"] + 1)
        e_old = at("ellipsoid", o)
        moved = fit & (torch.linalg.vector_norm(e_w[i, 0:3] - e_old[0:3]) > dynamic_dist)
        votes = at("move_votes", o) + moved.to(torch.int32)
        is_dyn = votes >= 2
        dk = torch.clamp(kf - at("last_seen_kf", o), min=1).to(e_old.dtype)
        v_meas = (e_w[i, 0:3] - e_old[0:3]) / dk
        dyaw = _wrap(e_w[i, 4] - e_old[4])
        vel_c = torch.where(fit, 0.6 * at("vel_center", o) + 0.4 * v_meas, at("vel_center", o))
        vel_y = torch.where(fit, 0.6 * at("vel_yaw", o) + 0.4 * dyaw / dk, at("vel_yaw", o))
        snap = is_dyn & fit
        e_new = torch.where(snap, e_w[i], e_old)
        T_old = at("Tow_shape", o)
        t_old = T_old[:3, 3]
        t_shape = torch.where(snap, t_old - T_old[:3, :3] @ (e_new[0:3] - e_old[0:3]), t_old)
        put("prob", row, torch.clamp(at("prob", o) + 0.1 * det_prob[i], max=1.0))
        put("ellipsoid", row, e_new)
        Tow = tb["Tow_shape"].clone()
        Tow[:, :3, 3] = torch.where(row[:, None], t_shape, Tow[:, :3, 3])
        tb["Tow_shape"] = Tow
        put("vel_center", row, vel_c)
        put("vel_yaw", row, vel_y)
        put("adv_kf", row, kf)
        put("last_seen_kf", row, kf)
        put("move_votes", row, votes)
        put("dynamic", row, is_dyn)

        # Not associated: a new object in the first free slot (culled and
        # merged objects return theirs), its history scrubbed.
        free = ~tb["valid"]
        create = ~is_assoc & det_valid[i] & fit & free.any()
        new = (ids == torch.argmax(free.to(torch.uint8))) & create
        cell0 = new[:, None] & (slots == 0)[None, :]
        put("ellipsoid", new, e_w[i])
        put("label", new, det_label[i].to(torch.int32))
        put("prob", new, 0.2 * det_prob[i])
        put("valid", new, True)
        tb["num_objects"] = tb["num_objects"] + create.to(torch.int32)
        for name, val in (("last_seen_kf", kf), ("move_votes", 0), ("dynamic", False), ("vel_center", 0.0),
                          ("vel_yaw", 0.0), ("adv_kf", kf), ("obs_weight", 0.0), ("shape_ok", False),
                          ("code", 0.0), ("obs_next", 1), ("obs_count", 1), ("pm_next", 1)):
            put(name, new, val)
        put("pm_Toc", new, torch.where(_rows(slots == 0, tb["pm_Toc"][0]), T_oc[i], torch.eye(4, device=dev)))
        put("pm_kf", new, torch.where(slots == 0, kf, -1).to(torch.int32))
        put("obs_Tcw", cell0, Tcw)
        put("obs_bbox", cell0, det_bbox[i])
        put("obs_weight", cell0, det_prob[i])
    return ObjectTable(**tb)


def cull_objects(table: ObjectTable, current_kf: int, max_age_kf: int = 8, min_obs: int = 2) -> ObjectTable:
    """Drop objects with fewer than `min_obs` observations not seen for
    more than `max_age_kf` keyframes."""
    drop = table.valid & ((current_kf - table.last_seen_kf) > max_age_kf) & (table.obs_count < min_obs)
    return table._replace(valid=table.valid & ~drop)


def refine_objects(
    table: ObjectTable,
    K: torch.Tensor,
    ground_plane_w: torch.Tensor,
    iters: int = 8,
    support_planes_w: torch.Tensor | None = None,
    img_wh: tuple | None = None,
) -> ObjectTable:
    """Refinement of every live static object with at least two
    observations against its box history, the gravity prior and the
    support prior, all objects in one batched LM.  `support_planes_w`
    (O, 4) gives each object its supporting plane (an object on a table
    rests on the table); it defaults to the ground plane.  Dynamic objects
    keep their last fit."""
    planes = ground_plane_w.expand(table.ellipsoid.shape[0], 4) if support_planes_w is None else support_planes_w
    obs = ObjectObservations(Tcw=table.obs_Tcw, bbox=table.obs_bbox, weight=table.obs_weight)
    e_new, _ = refine_object(table.ellipsoid, obs, K, planes, iters=iters, img_wh=img_wh)
    enough = torch.sum(table.obs_weight > 0, dim=-1) >= 2
    refine = table.valid & ~table.dynamic & enough
    return table._replace(ellipsoid=torch.where(refine[:, None], e_new, table.ellipsoid))


def refine_objects_mono(
    table: ObjectTable,
    K: torch.Tensor,
    ground_plane_w: torch.Tensor,
    aspect_d: torch.Tensor,  # (L,) per-label half-axis ratio priors
    aspect_e: torch.Tensor,  # (L,)
    iters: int = 12,
    img_wh: tuple | None = None,
) -> ObjectTable:
    """Monocular refinement of every live static object with at least two
    observations: box history plus gravity, support and aspect priors, all
    objects in one batched LM.  Dynamic objects keep their last fit."""
    from ..perception.prior_infer import refine_with_priors

    lbl = torch.clamp(table.label, 0, aspect_d.shape[0] - 1).long()
    obs = ObjectObservations(Tcw=table.obs_Tcw, bbox=table.obs_bbox, weight=table.obs_weight)
    e_new, _ = refine_with_priors(table.ellipsoid, obs, K, ground_plane_w, aspect_d[lbl], aspect_e[lbl],
                                  iters=iters, img_wh=img_wh)
    enough = torch.sum(table.obs_weight > 0, dim=-1) >= 2
    refine = table.valid & ~table.dynamic & enough
    return table._replace(ellipsoid=torch.where(refine[:, None], e_new, table.ellipsoid))


def merge_duplicates(table: ObjectTable, dist_threshold: float = 0.5) -> ObjectTable:
    """Same-label live objects with centres closer than the threshold: the
    lower id absorbs the other's confidence, the other is dropped."""
    c = table.ellipsoid[:, 0:3]
    d = torch.linalg.vector_norm(c[:, None, :] - c[None, :, :], dim=-1)
    same = ((table.label[:, None] == table.label[None, :]) & table.valid[:, None] & table.valid[None, :]
            & (d < dist_threshold))
    ids = torch.arange(c.shape[0], device=c.device)
    lower = same & (ids[None, :] < ids[:, None])  # j < i duplicates i
    absorb = lower.to(table.prob.dtype).T @ table.prob
    return table._replace(valid=table.valid & ~lower.any(dim=1),
                          prob=torch.clamp(table.prob + absorb, max=1.0))

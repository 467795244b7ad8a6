"""Local mapping: covisibility-window bundle adjustment, the whole-map BA,
map-point fusion and keyframe culling over the SoA map (counterpart of
`qsp_slam_tpu/slam/local_mapping.py`).

The fusion's descriptor distances come from kernel K2.
"""

from __future__ import annotations

import torch

from ..frontend.fast import topk_stable
from ..frontend.matcher import hamming_matrix, pack_pm
from ..opt.local_ba import local_bundle_adjustment
from ..opt.reproj import ReprojEdges
from .map import MapState, _segment_count
from .tracking import TrackingConfig


def edge_budget_for(num_obs: int, emax: int, floor: int = 4096) -> int:
    """Power-of-2 bucket >= num_obs, from `floor` up to `emax` (the
    whole-store bucketing the system replaced by `window_edge_budget`)."""
    b = floor
    while b < num_obs and b < emax:
        b *= 2
    return min(b, emax)


def window_edge_budget(window: int, cfg: TrackingConfig, emax: int) -> int:
    """Power-of-2 edge capacity for a covisibility window: each keyframe
    adds at most F tracked + F new-point observations, so window * 2F
    bounds the window's edges."""
    need = window * 2 * cfg.orb.num_features
    b = 4096
    while b < need and b < emax:
        b *= 2
    return min(b, emax)


def local_ba_step(
    m: MapState, cfg: TrackingConfig, window: int = 8, edge_budget: int | None = None
) -> MapState:
    """Optimize the newest keyframe's covisibility window (the `window - 1`
    keyframes sharing most points with it, plus itself; the two oldest
    anchored) and all points.  With `edge_budget` below the edge store's
    capacity, the window's edges are first compacted into that many rows."""
    dev = m.device
    Kmax = m.kf_Tcw.shape[0]
    window = min(window, Kmax)
    newest = m.num_kfs - 1
    kf_ids = torch.arange(Kmax, dtype=torch.int32, device=dev)
    in_map = (kf_ids < m.num_kfs) & m.kf_valid
    Nmax = m.pt_xyz.shape[0]
    ob_pt, ob_kf = m.ob_pt.long(), m.ob_kf.long()
    seen_by_new = _segment_count(m.ob_valid & (m.ob_kf == newest), ob_pt, Nmax) > 0
    covis = _segment_count(m.ob_valid & seen_by_new[ob_pt], ob_kf, Kmax)
    covis = torch.where(in_map & (kf_ids != newest), covis, -1)
    scores, top = topk_stable(covis, window - 1)
    sel_raw = torch.cat([
        torch.where(scores > 0, top.to(torch.int32), Kmax),
        newest.reshape(1).to(torch.int32),
    ])
    kf_sorted = torch.sort(sel_raw).values  # invalid selections (= Kmax) last
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), kf_sorted[1:] != kf_sorted[:-1]])
    win_valid = uniq & (kf_sorted < Kmax)
    slot_of = torch.full((Kmax + 1,), -1, dtype=torch.int32, device=dev)
    slot_of[torch.where(win_valid, kf_sorted, Kmax).long()] = torch.where(
        win_valid, torch.arange(window, dtype=torch.int32, device=dev), -1
    )
    slot_of = slot_of[:Kmax]
    kf_sel = torch.clamp(kf_sorted, 0, Kmax - 1).long()
    Tcw_win = m.kf_Tcw[kf_sel]
    # Anchor the two oldest in-window cameras and any padding slot.
    cam_fixed = (torch.arange(window, device=dev) < 2) | ~win_valid

    edge_slot = slot_of[ob_kf]
    valid = m.ob_valid & (edge_slot >= 0) & m.pt_valid[ob_pt]
    # A window camera with no surviving edges must not float free.
    slot_edges = _segment_count(valid, torch.clamp(edge_slot, min=0), window)
    cam_fixed = cam_fixed | (slot_edges == 0)
    inv_sigma2 = (1.0 / cfg.orb.pyramid.scale_factor ** 2) ** m.ob_octave.to(torch.float32)
    kf_idx = torch.clamp(edge_slot, min=0).long()
    take = None
    if edge_budget is not None and edge_budget < m.ob_kf.shape[0]:
        take = torch.argsort((~valid).to(torch.uint8), stable=True)[:edge_budget]
        edges = ReprojEdges(kf_idx[take], ob_pt[take], m.ob_uv[take], m.ob_ur[take],
                            inv_sigma2[take], valid[take])
    else:
        edges = ReprojEdges(kf_idx, ob_pt, m.ob_uv, m.ob_ur, inv_sigma2, valid)
    res = local_bundle_adjustment(
        Tcw_win, m.pt_xyz, cam_fixed, edges, cfg.intr, baseline_fx=cfg.bf
    )
    # Gate-rejected in-window edges are disabled; others keep validity.
    if take is not None:
        ob_valid_new = m.ob_valid.clone()
        ob_valid_new[take] = torch.where(
            valid[take], res.inlier & m.ob_valid[take], m.ob_valid[take]
        )
    else:
        ob_valid_new = torch.where(edge_slot >= 0, res.inlier & m.ob_valid, m.ob_valid)
    # Write back window poses; invalid slots go to a dump row.
    kf_Tcw = torch.cat([m.kf_Tcw, m.kf_Tcw.new_zeros((1, 4, 4))])
    kf_Tcw[torch.where(win_valid, kf_sel, Kmax)] = res.Tcw
    return m._replace(kf_Tcw=kf_Tcw[:Kmax], pt_xyz=res.points, ob_valid=ob_valid_new)


def global_ba_step(m: MapState, cfg: TrackingConfig, iters: int = 10) -> MapState:
    """Whole-map BA: `local_bundle_adjustment` over every keyframe and all
    points, keyframe 0 fixed as the gauge (iters // 2 robust iterations,
    the rest on the gated inliers)."""
    Kmax = m.kf_Tcw.shape[0]
    kf_ids = torch.arange(Kmax, dtype=torch.int32, device=m.device)
    in_map = kf_ids < m.num_kfs
    cam_fixed = (kf_ids == 0) | ~in_map
    ob_kf, ob_pt = m.ob_kf.long(), m.ob_pt.long()
    valid = m.ob_valid & in_map[ob_kf] & m.pt_valid[ob_pt]
    inv_sigma2 = (1.0 / cfg.orb.pyramid.scale_factor ** 2) ** m.ob_octave.to(torch.float32)
    edges = ReprojEdges(ob_kf, ob_pt, m.ob_uv, m.ob_ur, inv_sigma2, valid)
    res = local_bundle_adjustment(
        m.kf_Tcw, m.pt_xyz, cam_fixed, edges, cfg.intr, baseline_fx=cfg.bf,
        iters_robust=iters // 2, iters_final=iters - iters // 2,
    )
    return m._replace(
        kf_Tcw=torch.where(in_map[:, None, None], res.Tcw, m.kf_Tcw),
        pt_xyz=res.points,
        ob_valid=torch.where(in_map[ob_kf], res.inlier & m.ob_valid, m.ob_valid),
    )


def fuse_map_points(
    m: MapState, window_pts: int = 2048, radius: float = 0.02, desc_th: int = 25
) -> MapState:
    """Merge duplicate map points among the `window_pts` most recent: close
    in 3D, close in descriptor, never seen by the same keyframe.  A
    duplicate collapses into its lowest-index partner and its edges are
    re-pointed."""
    dev = m.device
    Nmax = m.pt_xyz.shape[0]
    window_pts = min(window_pts, Nmax)
    start = torch.clamp(m.num_pts - window_pts, 0, Nmax - window_pts)
    ii = torch.arange(window_pts, device=dev)
    idx = start + ii
    xyz = m.pt_xyz[idx]
    valid = m.pt_valid[idx] & (idx < m.num_pts)
    d = xyz[:, None, :] - xyz[None, :, :]
    d2 = torch.sum(d * d, dim=-1)
    bits = pack_pm(m.pt_desc[idx])
    ham = hamming_matrix(bits, bits)
    # Co-observation exclusion: two points seen in one keyframe are two
    # real features.
    Kmax = m.kf_Tcw.shape[0]
    ob_pt = m.ob_pt.long()
    in_win_edge = (ob_pt >= start) & (ob_pt < start + window_pts) & m.ob_valid
    local_pt = torch.clamp(ob_pt - start, 0, window_pts - 1)
    flat = torch.where(in_win_edge, local_pt * Kmax + m.ob_kf.long(), 0)
    obs_mask = torch.zeros(window_pts * Kmax, dtype=torch.float32, device=dev)
    obs_mask = obs_mask.scatter_reduce(0, flat, in_win_edge.to(torch.float32), "amax")
    obs_mask = obs_mask.reshape(window_pts, Kmax)
    co_observed = (obs_mask @ obs_mask.T) > 0.0
    mergeable = (
        (d2 < radius * radius)
        & (ham < desc_th)
        & ~co_observed
        & valid[:, None]
        & valid[None, :]
        & (ii[None, :] < ii[:, None])  # partner must have a lower index
    )
    has_partner = mergeable.any(dim=1)
    partner = torch.argmax(mergeable.to(torch.int32), dim=1)  # first True
    target = torch.where(has_partner, partner, ii)
    target = target[target]  # resolve chains a -> b -> c
    target = target[target]
    in_window = (ob_pt >= start) & (ob_pt < start + window_pts)
    ob_pt_new = torch.where(in_window, (start + target)[local_pt], ob_pt).to(torch.int32)
    pt_valid = m.pt_valid.clone()
    pt_valid[idx] = m.pt_valid[idx] & ~has_partner
    return m._replace(ob_pt=ob_pt_new, pt_valid=pt_valid)


def cull_keyframes(m: MapState, redundancy: float = 0.9) -> MapState:
    """Deactivate at most one redundant keyframe (not the first, not among
    the 4 newest, only once the map has 8): >= 90% of its observations are
    of points seen by >= 3 keyframes."""
    Kmax = m.kf_Tcw.shape[0]
    Nmax = m.pt_xyz.shape[0]
    ob_kf = m.ob_kf.long()
    well_observed = _segment_count(m.ob_valid, m.ob_pt, Nmax) >= 3
    per_kf_total = _segment_count(m.ob_valid, ob_kf, Kmax)
    per_kf_redund = _segment_count(m.ob_valid & well_observed[m.ob_pt.long()], ob_kf, Kmax)
    kf_ids = torch.arange(Kmax, device=m.device)
    frac = per_kf_redund / torch.clamp(per_kf_total, min=1)
    cullable = (
        m.kf_valid
        & (kf_ids > 0)
        & (kf_ids < m.num_kfs - 4)
        & (m.num_kfs >= 8)
        & (per_kf_total > 0)
        & (frac >= redundancy)
    )
    first = torch.argmax(cullable.to(torch.int32)).reshape(1)
    do = cullable[first]
    kf_valid = m.kf_valid.clone()
    kf_valid[first] = torch.where(do, False, m.kf_valid[first])
    ob_valid = torch.where(do & (ob_kf == first), False, m.ob_valid)
    return m._replace(kf_valid=kf_valid, ob_valid=ob_valid)


def cull_points(m: MapState, min_obs: int = 2) -> MapState:
    """Disable points whose surviving observation count fell below
    `min_obs`; the counts become `pt_obs_count`."""
    obs = _segment_count(m.ob_valid, m.ob_pt, m.pt_xyz.shape[0])
    return m._replace(pt_valid=m.pt_valid & (obs >= min_obs), pt_obs_count=obs)

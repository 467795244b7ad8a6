"""Per-frame tracking: feature processing, projection matching, pose
solve, keyframe insertion and policy (counterpart of
`qsp_slam_tpu/slam/tracking.py`, the RGB-D and stereo frames).

The (map points x features) Hamming matrix comes from kernel K2 once per
frame; the 1x and 2x radius searches share it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.camera import Intrinsics, backproject, in_image, project, undistort_points
from ..frontend import matcher
from ..frontend.orb import Features, OrbConfig, extract_features, extract_features_pair
from ..frontend.stereo import depth_from_u_right, match_stereo
from ..opt.pose_opt import PoseOptResult, optimize_pose
from ..opt.reproj import ReprojEdges
from ..utils.tracing import TRACER
from . import map as mapmod
from .map import MapState, scatter_set_last


class TrackingConfig(NamedTuple):
    orb: OrbConfig = OrbConfig()
    fx: float = 520.9
    fy: float = 521.0
    cx: float = 325.1
    cy: float = 249.7
    width: int = 640
    height: int = 480
    baseline: float = 0.08  # RGB-D pseudo-stereo baseline (m)
    depth_min: float = 0.1
    depth_max: float = 8.0
    search_radius: float = 12.0  # px, scaled by octave
    min_track_inliers: int = 20
    # >0: match against a fixed-size local map (frustum-visible, then
    # recently observed points) instead of the whole point table.
    local_map_budget: int = 0
    kf_min_interval: int = 3
    kf_max_interval: int = 30
    kf_tracked_ratio: float = 0.75
    new_points_per_kf: int = 256
    # "Close" depth for the keyframe trigger, in baselines (ThDepth).
    close_depth_factor: float = 40.0
    # Radial-tangential distortion (k1, k2, p1, p2, k3); all zero = off.
    dist_coef: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # Divisor for uint16 depth images (the TUM PNG convention).
    depth_png_scale: float = 5000.0

    @property
    def intr(self) -> Intrinsics:
        return Intrinsics(*(float(np.float32(v)) for v in (self.fx, self.fy, self.cx, self.cy)))

    @property
    def bf(self) -> float:
        return self.baseline * self.fx


class FrameData(NamedTuple):
    feats: Features
    depth: torch.Tensor  # (F,) depth at keypoint (0 = invalid)
    u_right: torch.Tensor  # (F,) pseudo-stereo right coordinate (-1 = none)


class TrackResult(NamedTuple):
    Tcw: torch.Tensor  # (4, 4) optimized pose
    match_pt: torch.Tensor  # (N_map,) int32 — feature matched per map point (-1)
    match_inlier: torch.Tensor  # (N_map,) bool — survived pose optimization
    num_matches: torch.Tensor  # () int
    num_inliers: torch.Tensor  # () int
    pred_dev_t: torch.Tensor  # () |translation(log(T_new T_pred^-1))|
    pred_dev_r: torch.Tensor  # () |rotation(log(T_new T_pred^-1))|
    tracked_close: torch.Tensor  # () inlier-matched features with close depth
    untracked_close: torch.Tensor  # () close-depth features not in the map


def decode_inputs(gray: torch.Tensor, depth_img: torch.Tensor, cfg: TrackingConfig):
    """uint8 gray -> f32; uint16 depth -> meters via cfg.depth_png_scale."""
    if gray.dtype != torch.float32:
        gray = gray.to(torch.float32)
    if depth_img.dtype == torch.uint16:
        depth_img = depth_img.to(torch.float32) / cfg.depth_png_scale
    elif depth_img.dtype != torch.float32:
        depth_img = depth_img.to(torch.float32)
    return gray, depth_img


def process_frame(gray: torch.Tensor, depth_img: torch.Tensor, cfg: TrackingConfig) -> FrameData:
    """ORB features plus per-keypoint depth (the RGB-D frame constructor)."""
    with TRACER.span("track.features"):
        gray, depth_img = decode_inputs(gray, depth_img, cfg)
        feats = extract_features(gray, cfg.orb)
        # Depth is sampled at the raw (distorted) pixel.
        xi = torch.clamp(torch.round(feats.xy[:, 0]).long(), 0, cfg.width - 1)
        yi = torch.clamp(torch.round(feats.xy[:, 1]).long(), 0, cfg.height - 1)
        d = depth_img[yi, xi]
        ok = (d > cfg.depth_min) & (d < cfg.depth_max) & feats.valid
        d = torch.where(ok, d, 0.0)
        if any(c != 0.0 for c in cfg.dist_coef):
            feats = feats._replace(xy=undistort_points(feats.xy, cfg.intr, cfg.dist_coef))
        u_right = torch.where(ok, feats.xy[:, 0] - cfg.bf / torch.where(ok, d, 1.0), -1.0)
        return FrameData(feats=feats, depth=d, u_right=u_right)


def _octave_radius(cfg: TrackingConfig, octave: torch.Tensor) -> torch.Tensor:
    return cfg.search_radius * cfg.orb.pyramid.scale_factor ** octave.to(torch.float32)


def track_frame(m: MapState, Tcw_pred: torch.Tensor, frame: FrameData, cfg: TrackingConfig) -> TrackResult:
    """Projection search against the map + motion-only pose optimization.
    The `track.search` span runs from here to the pose solve."""
    Nmax = m.pt_xyz.shape[0]
    B = cfg.local_map_budget
    search = TRACER.begin("track.search")
    if B and B < Nmax:
        # Local-map view: frustum-visible points first, then points seen by
        # the 12 most recent keyframes; ties keep id order (stable sort).
        pc = lie.transform_points(Tcw_pred, m.pt_xyz)
        uv_all, z_all = project(pc, cfg.intr)
        in_f = m.pt_valid & (z_all > cfg.depth_min) & in_image(uv_all, cfg.width, cfg.height, border=-40)
        recent_edge = m.ob_valid & (m.ob_kf >= m.num_kfs - 12)
        recent = (mapmod._segment_count(recent_edge, m.ob_pt, Nmax) > 0) & m.pt_valid
        prio = in_f.to(torch.float32) * 2.0 + recent.to(torch.float32)
        take = torch.argsort(-prio, stable=True)[:B]
        sub = m._replace(
            pt_xyz=m.pt_xyz[take],
            pt_desc=m.pt_desc[take],
            pt_octave=m.pt_octave[take],
            pt_normal=m.pt_normal[take],
            pt_valid=m.pt_valid[take] & (prio[take] > 0.0),
        )
        r = _track_against(sub, Tcw_pred, frame, cfg, search)
        match_pt = torch.full((Nmax,), -1, dtype=torch.int32, device=m.device)
        match_inlier = torch.zeros(Nmax, dtype=torch.bool, device=m.device)
        match_pt[take] = r.match_pt
        match_inlier[take] = r.match_inlier
        return r._replace(match_pt=match_pt, match_inlier=match_inlier)
    return _track_against(m, Tcw_pred, frame, cfg, search)


def _track_against(m: MapState, Tcw_pred: torch.Tensor, frame: FrameData, cfg: TrackingConfig,
                   search) -> TrackResult:
    """The search and the pose solve; ends the caller's `search` span."""
    intr = cfg.intr
    feats = frame.feats
    # 1. Project all map points with the predicted pose; viewing-angle gate
    # (cos > 0.5 to the mean viewing direction).
    pts_cam = lie.transform_points(Tcw_pred, m.pt_xyz)
    uv, z = project(pts_cam, intr)
    cam_center = lie.inv_se3(Tcw_pred)[:3, 3]
    view = m.pt_xyz - cam_center
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-9)
    cos_view = torch.sum(view * m.pt_normal, dim=-1)
    has_normal = torch.linalg.vector_norm(m.pt_normal, dim=-1) > 0.5
    proj_ok = (
        m.pt_valid
        & (z > cfg.depth_min)
        & in_image(uv, cfg.width, cfg.height, border=-20)
        & (~has_normal | (cos_view > 0.5))
    )
    # 2. Windowed descriptor match; if the narrow window finds fewer than 50
    # matches, the 2x radius search is used (both computed, then selected).
    dist = matcher.hamming_matrix(matcher.pack_pm(m.pt_desc), feats.desc_bits)

    def run_search(scale):
        mres = matcher.search_by_projection(
            proj_uv=uv,
            proj_valid=proj_ok,
            proj_octave=m.pt_octave,
            feat_xy=feats.xy,
            feat_valid=feats.valid,
            feat_octave=feats.octave,
            radius_per_row=_octave_radius(cfg, m.pt_octave) * scale,
            dist=dist,
            max_dist=matcher.TH_HIGH,
            ratio=0.9,
        )
        return matcher.resolve_duplicates(mres, feats.capacity)

    match1 = run_search(1.0)
    match2 = run_search(2.0)
    few = torch.sum(match1.valid) < 50
    match = matcher.MatchResult(*(torch.where(few, b, a) for a, b in zip(match1, match2)))

    # 3. Pose-only optimization on the matched 3D-2D pairs.
    fidx = torch.clamp(match.idx, min=0).long()
    moct = feats.octave[fidx]
    inv_sigma2 = (1.0 / cfg.orb.pyramid.scale_factor ** 2) ** moct.to(torch.float32)
    edges = ReprojEdges(
        kf_idx=torch.zeros_like(match.idx),
        pt_idx=torch.arange(m.pt_xyz.shape[0], dtype=torch.int64, device=m.device),
        uv=feats.xy[fidx],
        u_right=frame.u_right[fidx],
        inv_sigma2=inv_sigma2,
        valid=match.valid,
    )
    TRACER.end(search)
    with TRACER.span("track.pose"):
        res: PoseOptResult = optimize_pose(Tcw_pred, m.pt_xyz, edges, intr, baseline_fx=cfg.bf)
    dev = lie.log_se3(res.Tcw @ lie.inv_se3(Tcw_pred))
    # Close-point census: matches are unique per feature after
    # resolve_duplicates, so inlier rows with a close feature count the
    # tracked close features.
    close = (frame.depth > 0.0) & (frame.depth < cfg.close_depth_factor * cfg.baseline)
    tracked_close = torch.sum(res.inlier & match.valid & close[fidx])
    return TrackResult(
        Tcw=res.Tcw,
        match_pt=match.idx,
        match_inlier=res.inlier,
        num_matches=torch.sum(match.valid),
        num_inliers=res.num_inliers,
        pred_dev_t=torch.linalg.vector_norm(dev[:3]),
        pred_dev_r=torch.linalg.vector_norm(dev[3:]),
        tracked_close=tracked_close,
        untracked_close=torch.sum(close) - tracked_close,
    )


def process_and_track(gray, depth_img, m: MapState, Tcw_pred: torch.Tensor, cfg: TrackingConfig):
    """Per-frame step: feature processing, then tracking."""
    frame = process_frame(gray, depth_img, cfg)
    return frame, track_frame(m, Tcw_pred, frame, cfg)


def process_frame_stereo(gray_left: torch.Tensor, gray_right: torch.Tensor, cfg: TrackingConfig) -> FrameData:
    """The stereo frame constructor: both images' features (one K1 launch
    for the pair), scanline matching with subpixel refinement, and depth
    per keypoint."""
    with TRACER.span("track.features"):
        gl = gray_left.to(torch.float32)
        gr = gray_right.to(torch.float32)
        fl, fr = extract_features_pair(gl, gr, cfg.orb)
        u_r = match_stereo(fl, fr, cfg.bf, min_depth=cfg.depth_min, max_depth=cfg.depth_max,
                           gray_left=gl, gray_right=gr)
        d = depth_from_u_right(fl.xy[:, 0], u_r, cfg.bf)
        ok = (d > cfg.depth_min) & (d < cfg.depth_max) & fl.valid
        return FrameData(feats=fl, depth=torch.where(ok, d, 0.0), u_right=torch.where(ok, u_r, -1.0))


def process_and_track_stereo(gray_left, gray_right, m: MapState, Tcw_pred: torch.Tensor, cfg: TrackingConfig):
    """Stereo per-frame step: the stereo frame, then tracking."""
    frame = process_frame_stereo(gray_left, gray_right, cfg)
    return frame, track_frame(m, Tcw_pred, frame, cfg)


def keyframe_insertion(
    m: MapState, Tcw: torch.Tensor, frame: FrameData, track: TrackResult, cfg: TrackingConfig
) -> MapState:
    """Insert a keyframe: observations of tracked inlier points, a majority
    vote on their descriptors, and new points from unmatched features with
    depth, closest first.

    Two writes reproduce the reference's duplicate-index behaviour (the
    last row in index order wins, `map.scatter_set_last`): every map row
    that is not an inlier writes point 0's old vote back over it, and every
    unmatched map row marks feature 0 unmatched.
    """
    m, kf_id = mapmod.add_keyframe(m, Tcw)
    F = frame.feats.capacity
    N = m.pt_xyz.shape[0]
    feats = frame.feats

    pt_ids = torch.where(
        track.match_inlier, torch.arange(N, dtype=torch.int32, device=m.device), -1
    )
    fidx = torch.clamp(track.match_pt, min=0).long()
    m = mapmod.add_observations(
        m, kf_id, pt_ids=pt_ids, uv=feats.xy[fidx],
        u_right=frame.u_right[fidx], octave=feats.octave[fidx],
    )
    # Descriptor maintenance: saturating majority vote over the ±1 history.
    pids = torch.clamp(pt_ids, min=0).long()
    acc_old = m.pt_desc_acc[pids]
    acc_new = torch.clamp(
        acc_old.to(torch.int16) + feats.desc_pm[fidx].to(torch.int16), -16, 16
    ).to(torch.int8)
    acc_new = torch.where(track.match_inlier[:, None], acc_new, acc_old)
    desc_new = torch.where(
        acc_new > 0, 1, torch.where(acc_new < 0, -1, m.pt_desc[pids])
    ).to(torch.int8)
    m = m._replace(
        pt_desc_acc=scatter_set_last(m.pt_desc_acc, pids, acc_new),
        pt_desc=scatter_set_last(m.pt_desc, pids, desc_new),
    )

    # New points from unmatched features with depth, closest first.
    matched_feat = scatter_set_last(
        torch.zeros(F, dtype=torch.bool, device=m.device), fidx, track.match_inlier
    )
    cand = feats.valid & (frame.depth > 0.0) & ~matched_feat
    order = torch.argsort(torch.where(cand, frame.depth, torch.inf), stable=True)
    take = order[: cfg.new_points_per_kf]
    T_wc = lie.inv_se3(Tcw)
    p_cam = backproject(feats.xy[take], frame.depth[take], cfg.intr)
    p_w = lie.transform_points(T_wc, p_cam)
    view = p_w - T_wc[:3, 3]
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-9)
    m, new_ids = mapmod.add_points(
        m, xyz=p_w, desc=feats.desc_pm[take], octave=feats.octave[take],
        normal=view, valid=cand[take],
    )
    return mapmod.add_observations(
        m, kf_id, pt_ids=new_ids, uv=feats.xy[take],
        u_right=frame.u_right[take], octave=feats.octave[take],
    )


def need_keyframe(
    frames_since_kf: int,
    num_inliers: int,
    inliers_at_last_kf: int,
    cfg: TrackingConfig,
    tracked_close: int = 0,
    untracked_close: int = 0,
) -> bool:
    """Host-side keyframe policy: max interval, tracked-ratio decay, and the
    RGB-D close-point census (few close points tracked while many close
    features are unmapped)."""
    if frames_since_kf < cfg.kf_min_interval:
        return False
    if frames_since_kf >= cfg.kf_max_interval:
        return True
    if tracked_close < 100 and untracked_close > 70:
        return True
    return num_inliers < cfg.kf_tracked_ratio * max(inliers_at_last_kf, 1)

"""Loop closing (counterpart of `qsp_slam_tpu/slam/loop_closing.py`,
point-only): keyframe snapshots, the consistency gate, geometric Sim3
verification and the pose-graph correction.

- Every keyframe stores a fixed-size snapshot of its features and a place
  signature, slot k for keyframe k (relocalization reads them too).
- `ConsistencyGate`: a candidate goes to verification only after its
  keyframe-id neighbourhood has been proposed in 3 consecutive rounds.
- `verify_loop` / `detect_loop`: one kernel-K2 call at (features,
  snapshot rows) per verification.  The word-gated first match and the
  projection-gated growth match share that distance matrix; RANSAC Sim3
  with the two-sided image gate, growth, re-solve, image-space polish.
- `correct_loop`: the essential graph (covisibility-weighted odometry
  chain, the strongest covisibility edges, the loop edge), LM over it, and
  every map point moved with its anchor keyframe's correction, every
  object with the correction of the keyframe that last observed it.
  Scale drift (the monocular sensor) is corrected over Sim(3).
- `feature_points_from_matches`: the monocular snapshot's 3D, the tracked
  map points scattered onto the frame's features.

The RANSAC draws come from a `torch.Generator`; `draw` lets a caller
supply them (see `opt.sim3_solver`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import lie, quadric
from ..core.camera import Intrinsics, project
from ..frontend import matcher
from ..frontend.fast import topk_stable
from ..frontend.orb import DESC_BITS
from ..opt.pose_graph import PoseGraphEdges, optimize_pose_graph, relative_measurement
from ..opt.sim3_solver import (
    Draw,
    Sim3RansacResult,
    ransac_sim3_reproj,
    refine_sim3_reproj,
    sim3_image_inliers,
    sim3_sample,
)
from .map import MapState, scatter_set_last
from .objects import ObjectTable, merge_duplicates
from .place_recognition import (
    PlaceDatabase,
    add_signature,
    bow_signature,
    empty_database,
    query,
    quantize_words,
)


class LoopState(NamedTuple):
    db: PlaceDatabase
    kf_desc: torch.Tensor  # (Kmax, S, 256) int8 snapshot of each KF's features
    kf_pts_cam: torch.Tensor  # (Kmax, S, 3) camera-frame 3D points per feature
    kf_pts_ok: torch.Tensor  # (Kmax, S) bool
    kf_xy: torch.Tensor  # (Kmax, S, 2) pixel positions
    kf_feat_ok: torch.Tensor  # (Kmax, S) bool — feature validity
    kf_octave: torch.Tensor  # (Kmax, S) int8 pyramid level


def empty_loop_state(kmax: int = 64, snap: int = 384, device=None) -> LoopState:
    dev = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return LoopState(
        db=empty_database(kmax, dev),
        kf_desc=z((kmax, snap, DESC_BITS), torch.int8),
        kf_pts_cam=z((kmax, snap, 3), torch.float32),
        kf_pts_ok=z((kmax, snap), torch.bool),
        kf_xy=z((kmax, snap, 2), torch.float32),
        kf_feat_ok=z((kmax, snap), torch.bool),
        kf_octave=z((kmax, snap), torch.int8),
    )


def snapshot_keyframe(
    ls: LoopState,
    desc_pm: torch.Tensor,  # (F, 256)
    feat_valid: torch.Tensor,  # (F,)
    pts_cam: torch.Tensor,  # (F, 3) camera-frame backprojections
    pts_ok: torch.Tensor,  # (F,)
    xy: torch.Tensor,  # (F, 2)
    octave: torch.Tensor | None = None,  # (F,)
) -> LoopState:
    """Store the first S features (strongest-first order) and the frame's
    signature in the next slot; at capacity the snapshot is dropped whole
    so slot k stays keyframe k."""
    S = ls.kf_desc.shape[1]
    Kmax = ls.kf_desc.shape[0]
    if octave is None:
        octave = torch.zeros(desc_pm.shape[0], dtype=torch.int8, device=desc_pm.device)
    fits = ls.db.count < Kmax
    kid = torch.clamp(ls.db.count, 0, Kmax - 1).long().reshape(1)

    def fit_rows(x, fill):
        """First S rows, padded with `fill` when the table is smaller."""
        if x.shape[0] >= S:
            return x[:S]
        pad = torch.full((S - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    def put(store, rows):
        out = store.clone()
        out[kid] = torch.where(fits, rows.to(store.dtype), store[kid])
        return out

    return LoopState(
        db=add_signature(ls.db, bow_signature(desc_pm, feat_valid)),
        kf_desc=put(ls.kf_desc, fit_rows(desc_pm, 0)),
        kf_pts_cam=put(ls.kf_pts_cam, fit_rows(pts_cam, 0.0)),
        kf_pts_ok=put(ls.kf_pts_ok, fit_rows(pts_ok & feat_valid, False)),
        kf_xy=put(ls.kf_xy, fit_rows(xy, 0.0)),
        kf_feat_ok=put(ls.kf_feat_ok, fit_rows(feat_valid, False)),
        kf_octave=put(ls.kf_octave, fit_rows(octave.to(torch.int8), 0)),
    )


def feature_points_from_matches(
    pt_xyz: torch.Tensor,  # (N, 3) world map points
    match_pt: torch.Tensor,  # (N,) feature matched per map point
    match_inlier: torch.Tensor,  # (N,) bool
    Tcw: torch.Tensor,  # (4, 4)
    num_feats: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame 3D per feature from this frame's inlier map-point
    matches -> (points (F, 3), ok (F,)): a monocular keyframe has no
    depth, but its tracked map points are 3D, which relocalization and
    loop verification read from the snapshot.  Indices scatter as the
    reference's `.at[].set(mode="drop")` into F + 1 rows: a negative one
    counts from the end, one out of range is dropped."""
    pc = lie.transform_points(Tcw, pt_xyz)
    tgt = torch.where(match_inlier, match_pt.long(), num_feats)
    tgt = torch.where(tgt < 0, tgt + num_feats + 1, tgt)
    tgt = torch.where((tgt >= 0) & (tgt <= num_feats), tgt, num_feats)
    pts = scatter_set_last(torch.zeros(num_feats + 1, 3, device=pt_xyz.device), tgt, pc)[:num_feats]
    ok = scatter_set_last(torch.zeros(num_feats + 1, dtype=torch.bool, device=pt_xyz.device), tgt,
                          match_inlier)[:num_feats]
    return pts, ok


def grow_loop_state(ls: LoopState, kmax: int) -> LoopState:
    """Grow the snapshot store with the map (slot k <-> keyframe k)."""
    k0, snap = ls.kf_desc.shape[:2]
    if kmax <= k0:
        return ls
    tgt = empty_loop_state(kmax, snap, ls.kf_desc.device)
    rep = {}
    for name in LoopState._fields:
        if name == "db":
            continue
        out = getattr(tgt, name).clone()
        out[:k0] = getattr(ls, name)
        rep[name] = out
    signatures = tgt.db.signatures.clone()
    signatures[:k0] = ls.db.signatures
    rep["db"] = PlaceDatabase(signatures=signatures, df=ls.db.df, count=ls.db.count)
    return LoopState(**rep)


class LoopDetection(NamedTuple):
    found: torch.Tensor  # () bool
    match_kf: torch.Tensor  # () int32
    T_cur_match: torch.Tensor  # (4, 4) current-camera <- match-camera transform
    num_inliers: torch.Tensor  # () int
    score: torch.Tensor  # () f32 appearance score


class ConsistencyGate:
    """A candidate proceeds to geometric verification only after its
    neighbourhood (keyframe ids within `neighborhood`) appeared in
    `required` consecutive detection rounds.  Host-side state."""

    def __init__(self, required: int = 3, neighborhood: int = 8):
        self.required = required
        self.neighborhood = neighborhood
        self.history: list[list[int]] = []

    def update(self, cands, scores) -> int:
        """Feed this round's candidates (-1 = none); returns the best-scored
        consistent candidate, or -1."""
        cands = [int(c) for c in np.asarray(cands)]
        scores = [float(s) for s in np.asarray(scores)]
        best_id, best_score = -1, -np.inf
        have = len(self.history) >= self.required - 1
        for c, s in zip(cands, scores):
            if c < 0:
                continue
            if have and all(
                any(abs(c - c2) <= self.neighborhood for c2 in h)
                for h in self.history[-(self.required - 1):]
            ):
                if s > best_score:
                    best_id, best_score = c, s
        self.history.append([c for c in cands if c >= 0])
        if len(self.history) > self.required:
            self.history = self.history[-self.required:]
        return best_id

    def reset(self):
        self.history = []


def verify_loop(
    ls: LoopState,
    cand: int,  # candidate keyframe id (-1: none)
    desc_pm: torch.Tensor,  # (F, 256) current keyframe features
    feat_valid: torch.Tensor,
    pts_cam: torch.Tensor,  # (F, 3)
    pts_ok: torch.Tensor,
    gen: torch.Generator | None,
    intr: Intrinsics,
    xy: torch.Tensor,  # (F, 2) current keypoint pixels
    octave: torch.Tensor | None = None,  # (F,)
    min_inliers: int = 20,
    fix_scale: bool = True,
    scale_factor: float = 1.2,
    draw: Draw = sim3_sample,
) -> LoopDetection:
    """Geometric verification of one candidate: matching, image-space
    RANSAC Sim3, correspondence growth and polish."""
    if octave is None:
        octave = torch.zeros(desc_pm.shape[0], dtype=torch.int32, device=desc_pm.device)
    res = _match_and_solve_sim3(ls, max(int(cand), 0), desc_pm, feat_valid, pts_cam, pts_ok, xy,
                                octave, gen, fix_scale, intr, scale_factor, draw=draw)
    dev = desc_pm.device
    return LoopDetection(
        found=(cand >= 0) & res.ok & (res.num_inliers >= min_inliers),
        match_kf=torch.tensor(int(cand), dtype=torch.int32, device=dev),
        T_cur_match=res.T_ds,
        num_inliers=res.num_inliers,
        score=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _match_and_solve_sim3(
    ls, cand_c, desc_pm, feat_valid, pts_cam, pts_ok, xy, octave, gen,
    fix_scale, intr, scale_factor: float = 1.2, grow_px: float = 7.5, draw: Draw = sim3_sample,
) -> Sim3RansacResult:
    """The verification core.
    1. Word-gated mutual match (bag-of-words buckets as a mask).
    2. RANSAC Sim3 on the matched pairs, inliers by octave-scaled
       reprojection chi2 in both images.
    3. Growth: the candidate's points projected into the current image
       with the solution, re-matched inside an octave-scaled window, then
       re-solved; the better of the two solutions is kept.
    4. Polish against the two-sided image residuals, kept when it
       explains at least as many matches.
    Both matches read one K2 distance matrix; `draw` is called once per
    RANSAC (twice)."""
    cand_desc = ls.kf_desc[cand_c]
    cand_ok = ls.kf_pts_ok[cand_c]
    cand_pts = ls.kf_pts_cam[cand_c]
    cand_xy = ls.kf_xy[cand_c]
    sf = float(np.float32(scale_factor))
    sig2_cur = sf ** (2.0 * octave.to(torch.float32))
    sig2_cand = sf ** (2.0 * ls.kf_octave[cand_c].to(torch.float32))
    a_ok = feat_valid & pts_ok

    dist = matcher.hamming_matrix(matcher.pack_pm(desc_pm), matcher.pack_pm(cand_desc))  # (F, S)
    wm = matcher.word_mask(quantize_words(desc_pm), quantize_words(cand_desc))
    m = matcher.mutual_match(dist, a_ok, cand_ok, max_dist=matcher.TH_LOW, ratio=0.9, pair_mask=wm)
    j = torch.clamp(m.idx, min=0).long()

    def solve(match_idx, match_valid):
        ji = torch.clamp(match_idx, min=0).long()
        return ransac_sim3_reproj(
            pts_src=cand_pts[ji], pts_dst=pts_cam, uv_src=cand_xy[ji], uv_dst=xy,
            sigma2_src=sig2_cand[ji], sigma2_dst=sig2_cur, valid=match_valid, gen=gen,
            intr=intr, with_scale=not fix_scale, draw=draw,
        )

    res = solve(m.idx, m.valid)

    # Growth window: the candidate snapshot projected into the current image.
    uv_proj, z_proj = project(lie.transform_points(res.T_ds, cand_pts), intr)
    r = grow_px * sf ** octave.to(torch.float32)
    d2 = (xy[:, None, 0] - uv_proj[None, :, 0]) ** 2 + (xy[:, None, 1] - uv_proj[None, :, 1]) ** 2
    near = (d2 < (r ** 2)[:, None]) & (z_proj > 0)[None, :]
    m2 = matcher.mutual_match(dist, a_ok, cand_ok, max_dist=matcher.TH_HIGH, ratio=0.95, pair_mask=near)
    idx2 = torch.where(m2.valid, m2.idx, m.idx)
    valid2 = (m2.valid | m.valid) & res.ok  # growth only off a real seed
    res2 = solve(idx2, valid2)
    better = res2.ok & (res2.num_inliers > res.num_inliers)
    res = Sim3RansacResult(
        T_ds=torch.where(better, res2.T_ds, res.T_ds),
        inliers=torch.where(better, res2.inliers, res.inliers),
        num_inliers=torch.where(better, res2.num_inliers, res.num_inliers),
        ok=res.ok | (better & res2.ok),
    )

    jw = torch.clamp(torch.where(better, idx2, j.to(idx2.dtype)), min=0).long()
    valid_w = torch.where(better, valid2, m.valid)
    T_pol = refine_sim3_reproj(
        res.T_ds, cand_pts[jw], pts_cam, cand_xy[jw], xy, sig2_cand[jw], sig2_cur,
        res.inliers.to(torch.float32), intr, with_scale=not fix_scale,
    )
    inl_pol = sim3_image_inliers(T_pol, cand_pts[jw], pts_cam, cand_xy[jw], xy, sig2_cand[jw],
                                 sig2_cur, valid_w, intr, with_scale=not fix_scale)
    n_pol = torch.sum(inl_pol)
    keep = res.ok & (n_pol >= res.num_inliers)
    return Sim3RansacResult(
        T_ds=torch.where(keep, T_pol, res.T_ds),
        inliers=torch.where(keep, inl_pol, res.inliers),
        num_inliers=torch.where(keep, n_pol, res.num_inliers),
        ok=res.ok,
    )


def detect_loop(
    ls: LoopState,
    desc_pm: torch.Tensor,
    feat_valid: torch.Tensor,
    pts_cam: torch.Tensor,
    pts_ok: torch.Tensor,
    gen: torch.Generator | None,
    intr: Intrinsics,
    xy: torch.Tensor,
    octave: torch.Tensor | None = None,
    score_min: float = 0.18,
    exclude_recent: int = 10,
    min_inliers: int = 20,
    fix_scale: bool = True,
    scale_factor: float = 1.2,
    draw: Draw = sim3_sample,
) -> LoopDetection:
    """Top-1 appearance query plus geometric verification."""
    if octave is None:
        octave = torch.zeros(desc_pm.shape[0], dtype=torch.int32, device=desc_pm.device)
    cand, score = query(ls.db, bow_signature(desc_pm, feat_valid), exclude_recent)
    res = _match_and_solve_sim3(ls, torch.clamp(cand, min=0).long(), desc_pm, feat_valid, pts_cam,
                                pts_ok, xy, octave, gen, fix_scale, intr, scale_factor, draw=draw)
    return LoopDetection(
        found=(score > score_min) & res.ok & (res.num_inliers >= min_inliers),
        match_kf=cand, T_cur_match=res.T_ds, num_inliers=res.num_inliers, score=score,
    )


def correct_loop(
    m: MapState,
    objects: ObjectTable,
    cur_kf: int,
    det: LoopDetection,
    fix_scale: bool = True,
    iters: int = 15,
) -> tuple[MapState, ObjectTable]:
    """Pose-graph correction of the keyframe chain and re-anchoring of the
    map points and objects; `fix_scale=False` optimizes over Sim(3).

    Edges: the odometry chain (i, i+1), weighted by the pair's shared
    observations (full trust at 100; a handoff with no common structure is
    a sheet jump and nearly free), the 4 Kmax strongest covisibility
    pairs (>= 20 shared points, not adjacent), and the loop edge (weight 5
    when found).  Keyframe 0 and unused slots are fixed.  Each point then
    moves with the correction of its anchor, the first keyframe that
    observes it; each object with the correction of the keyframe whose
    pose its newest observation stored (none when no keyframe pose
    matches within 1e-4), and then duplicates are merged."""
    dev = m.device
    Kmax, Nmax = m.kf_Tcw.shape[0], m.pt_xyz.shape[0]
    K = m.num_kfs
    poses = m.kf_Tcw
    ids = torch.arange(Kmax, dtype=torch.int64, device=dev)
    # Covisibility counts: the 0/1 point incidence of each keyframe times
    # its transpose, in f32 (exact below 2^24).
    ob_kf, ob_pt = m.ob_kf.long(), m.ob_pt.long()
    flat = torch.where(m.ob_valid, ob_kf * Nmax + ob_pt, 0)
    seen = torch.zeros(Kmax * Nmax, dtype=torch.float32, device=dev)
    seen = seen.scatter_reduce(0, flat, m.ob_valid.to(torch.float32), "amax").reshape(Kmax, Nmax)
    covis = (seen @ seen.T).to(torch.int32)  # (Kmax, Kmax) shared points

    odo_i = ids
    odo_j = torch.clamp(ids + 1, 0, Kmax - 1)
    odo_w = ((odo_j < K) & (odo_i < odo_j)).to(torch.float32) * torch.clamp(
        covis[odo_i, odo_j] / 100.0, 1e-4, 1.0)
    pair_ok = (
        (ids[None, :] > ids[:, None] + 1)
        & (ids[None, :] < K)
        & m.kf_valid[:, None]
        & m.kf_valid[None, :]
        & (covis >= 20)
    )
    top_c, top_idx = topk_stable(torch.where(pair_ok, covis, 0).reshape(-1), 4 * Kmax)
    cov_i, cov_j = top_idx // Kmax, top_idx % Kmax
    cov_w = torch.where(top_c > 0, torch.clamp(top_c / 100.0, 0.2, 1.0), 0.0)

    sim3 = not fix_scale
    cur = torch.full((1,), int(cur_kf), dtype=torch.int64, device=dev)
    all_i = torch.cat([odo_i, cov_i, cur])
    all_j = torch.cat([odo_j, cov_j, det.match_kf.reshape(1).long()])
    meas_T = relative_measurement(poses[all_i[:-1]], poses[all_j[:-1]], sim3)
    edges = PoseGraphEdges(
        i=all_i, j=all_j,
        T_ij=torch.cat([meas_T, det.T_cur_match[None]]),
        weight=torch.cat([odo_w, cov_w, torch.where(det.found, 5.0, 0.0).reshape(1)]),
    )
    new_poses, _ = optimize_pose_graph(poses, (ids == 0) | (ids >= K), edges, sim3=sim3, iters=iters)

    # Correction per keyframe: T_corr(k) = T_wk_new @ T_kw_old.
    inv = lie.inv_se3 if fix_scale else lie.inv_sim3
    T_corr = inv(new_poses) @ poses
    anchor = torch.full((Nmax,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    anchor = anchor.scatter_reduce(0, ob_pt, torch.where(m.ob_valid, ob_kf, Kmax - 1), "amin")
    Ta = T_corr[torch.clamp(anchor, 0, Kmax - 1)]
    pts_new = torch.einsum("nij,nj->ni", Ta[:, :3, :3], m.pt_xyz) + Ta[:, :3, 3]
    m = m._replace(kf_Tcw=new_poses, pt_xyz=torch.where(m.pt_valid[:, None], pts_new, m.pt_xyz))

    O, M_ring = objects.obs_weight.shape
    last_slot = torch.remainder(objects.obs_next - 1, M_ring).long()
    T_obs = objects.obs_Tcw[torch.arange(O, device=dev), last_slot]  # (O, 4, 4)
    diff = torch.sum(torch.abs(poses[None] - T_obs[:, None]), dim=(2, 3))  # (O, Kmax)
    k = torch.argmin(diff, dim=1)
    good = (torch.gather(diff, 1, k[:, None])[:, 0] < 1e-4) & objects.valid & (objects.obs_count > 0)
    e_new = quadric.transform_ellipsoid(objects.ellipsoid, T_corr[torch.where(good, k, 0)])
    objects = objects._replace(ellipsoid=torch.where(good[:, None], e_new, objects.ellipsoid))
    return m, merge_duplicates(objects, dist_threshold=0.5)

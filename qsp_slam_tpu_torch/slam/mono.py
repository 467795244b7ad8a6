"""Monocular pipeline pieces: the two-view bootstrap and keyframe
triangulation (counterpart of `qsp_slam_tpu/slam/mono.py`).

Each function makes one kernel-K2 call: `mono_initialize` at (F, F)
between the two frames (the mutual match reads the matrix and its
transpose), `triangulate_new_points` at (S, F) between the previous
keyframe's snapshot and the current frame, gated by the epipolar mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import pixel_rays, project
from ..frontend import matcher
from ..frontend.initializer import Draw, _triangulate, two_view_init, two_view_sample
from . import map as mapmod
from .map import MapState
from .tracking import FrameData, TrackingConfig


class MonoInitResult(NamedTuple):
    ok: torch.Tensor
    T_cw2: torch.Tensor  # (4, 4)
    # match-aligned (capacity = the features of frame 1)
    pts_w: torch.Tensor  # (F, 3)
    pt_ok: torch.Tensor  # (F,)
    uv1: torch.Tensor  # (F, 2) pixel in frame 1
    uv2: torch.Tensor  # (F, 2) pixel in frame 2
    octave2: torch.Tensor  # (F,)


def mono_initialize(
    frame1: FrameData, frame2: FrameData, cfg: TrackingConfig, gen: torch.Generator | None,
    draw: Draw = two_view_sample,
) -> MonoInitResult:
    """Mutual match of the two frames, rotation-histogram filter, two-view
    initialization; the structure is returned per frame-1 feature."""
    f1, f2 = frame1.feats, frame2.feats
    dist = matcher.hamming_matrix(f1.desc_bits, f2.desc_bits)
    m = matcher.mutual_match(dist, f1.valid, f2.valid, max_dist=matcher.TH_LOW, ratio=0.9)
    j = torch.clamp(m.idx, min=0).long()
    keep = matcher.rotation_consistency(f1.angle, f2.angle[j], m.valid)
    uv2 = f2.xy[j]
    init = two_view_init(f1.xy, uv2, keep, cfg.intr, gen, draw=draw)
    return MonoInitResult(
        ok=init.ok, T_cw2=init.T_cw2, pts_w=init.points, pt_ok=init.pt_ok & keep,
        uv1=f1.xy, uv2=uv2, octave2=f2.octave[j],
    )


def triangulate_new_points(
    m: MapState,
    prev_desc: torch.Tensor,  # (S, 256) previous keyframe's snapshot
    prev_xy: torch.Tensor,  # (S, 2)
    prev_valid: torch.Tensor,  # (S,)
    prev_kf: int,
    cur_kf: torch.Tensor,  # () int32
    frame: FrameData,
    matched_feat: torch.Tensor,  # (F,) features already bound to map points
    cfg: TrackingConfig,
    max_new: int = 128,
    min_parallax_deg: float = 1.0,
    max_reproj_px: float = 2.0,
) -> MapState:
    """New points from the unmatched features, triangulated against the
    previous keyframe: an epipolar-gated mutual match (sigma 2 px, since
    the gate runs on estimated poses), then positive depth, parallax and
    reprojection gates in both views; at most `max_new`, in feature order."""
    intr = cfg.intr
    feats = frame.feats
    T1, T2 = m.kf_Tcw[prev_kf], m.kf_Tcw[cur_kf.long()]
    T_21 = T2 @ lie.inv_se3(T1)  # camera 1 -> camera 2
    epi = matcher.epipolar_mask(prev_xy, feats.xy, T_21, intr, octave_b=feats.octave,
                                scale_factor=cfg.orb.pyramid.scale_factor, sigma_px=2.0)
    dist = matcher.hamming_matrix(matcher.pack_pm(prev_desc), feats.desc_bits)
    mm = matcher.mutual_match(dist, prev_valid, feats.valid & ~matched_feat,
                              max_dist=matcher.TH_LOW, ratio=0.85, pair_mask=epi)
    f2 = torch.clamp(mm.idx, min=0).long()
    uv1, uv2 = prev_xy, feats.xy[f2]
    pts_c1, _, _ = _triangulate(pixel_rays(uv1, intr), pixel_rays(uv2, intr), T_21)
    T_w1 = lie.inv_se3(T1)
    pts_w = lie.transform_points(T_w1, pts_c1)

    c1_w, c2_w = T_w1[:3, 3], lie.inv_se3(T2)[:3, 3]
    v1, v2 = pts_w - c1_w, pts_w - c2_w
    cosang = torch.sum(v1 * v2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1), min=1e-12)
    par_ok = cosang < math.cos(math.radians(min_parallax_deg))
    uv1_hat, z1 = project(lie.transform_points(T1, pts_w), intr)
    uv2_hat, z2 = project(lie.transform_points(T2, pts_w), intr)
    rep_ok = (torch.linalg.vector_norm(uv1_hat - uv1, dim=-1) < max_reproj_px) & (
        torch.linalg.vector_norm(uv2_hat - uv2, dim=-1) < max_reproj_px)
    good = mm.valid & par_ok & rep_ok & (z1 > 0.05) & (z2 > 0.05)

    take = torch.argsort((~good).to(torch.uint8), stable=True)[:max_new]
    view = pts_w[take] - c2_w
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-9)
    f_take = f2[take]
    m, new_ids = mapmod.add_points(m, xyz=pts_w[take], desc=feats.desc_pm[f_take],
                                   octave=feats.octave[f_take], normal=view, valid=good[take])
    no_right = torch.full((take.shape[0],), -1.0, device=m.device)
    prev = torch.tensor(prev_kf, dtype=torch.int32, device=m.device)
    m = mapmod.add_observations(m, prev, new_ids, uv1[take], no_right, feats.octave[f_take])
    return mapmod.add_observations(m, cur_kf, new_ids, uv2[take], no_right, feats.octave[f_take])

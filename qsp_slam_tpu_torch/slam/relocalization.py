"""The two recovery tiers of a lost frame (counterpart of
`qsp_slam_tpu/slam/relocalization.py`): descriptor matching against
keyframe snapshots, then PnP-RANSAC.

- `track_reference_keyframe`: mutual word-gated match against the newest
  keyframe's snapshot (one K2 call at (features, snapshot rows)), PnP with
  the last camera centre as the hint.
- `relocalize`: the top-k place candidates solved together.  Their
  snapshots are stacked into one K2 call at (k * snapshot rows, features),
  the k mutual matches run on that matrix viewed as (k, rows, features),
  one batched PnP scores the k * 256 hypotheses, and the candidate with the
  most inliers wins.

The reference seeds its RANSAC from `jax.random` keys, which torch cannot
replay; here the draws come from a CPU `torch.Generator` seeded from the
same integers (`seed_of`), so a run on the card draws what a CPU run
draws, and `draw` lets a caller supply the indices instead.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..frontend.matcher import TH_LOW, hamming_matrix, mutual_match, pack_pm, word_mask
from ..frontend.pnp import Draw, PnPResult, pnp_ransac, pnp_sample
from .loop_closing import LoopState
from .place_recognition import bow_signature, quantize_words, query_topk
from .tracking import FrameData, TrackingConfig


def seed_of(key: int, data: int = 0) -> int:
    """Generator seed for the reference's `fold_in(PRNGKey(key), data)`."""
    return (key << 16) + data


def track_reference_keyframe(
    ls: LoopState,
    kf_Tcw: torch.Tensor,  # (Kmax, 4, 4)
    ref_kf: int,  # the reference (newest) keyframe id
    frame: FrameData,
    Tcw_last: torch.Tensor,  # (4, 4) last frame's pose; its centre is the hint
    cfg: TrackingConfig,
    draw: Draw = pnp_sample,
) -> PnPResult:
    """Middle recovery tier: the motion model was wrong, the map is not.
    Callers accept the result on its inlier count."""
    r = max(ref_kf, 0)
    desc_kf, ok_kf = ls.kf_desc[r], ls.kf_pts_ok[r]
    wm = word_mask(quantize_words(frame.feats.desc_pm), quantize_words(desc_kf))
    dist = hamming_matrix(frame.feats.desc_bits, pack_pm(desc_kf))  # (F, S)
    m = mutual_match(dist, frame.feats.valid, ok_kf, max_dist=TH_LOW, ratio=0.85, pair_mask=wm)
    pts_w = lie.transform_points(lie.inv_se3(kf_Tcw[r]), ls.kf_pts_cam[r])
    gen = torch.Generator().manual_seed(seed_of(41, ref_kf))
    return pnp_ransac(
        pts_w[torch.clamp(m.idx, min=0).long()], frame.feats.xy, m.valid, cfg.intr, gen,
        center_hint=lie.inv_se3(Tcw_last)[:3, 3], max_center_dist=8.0, draw=draw,
    )


def relocalize(
    ls: LoopState,
    kf_Tcw: torch.Tensor,  # (Kmax, 4, 4) current keyframe pose estimates
    frame: FrameData,
    cfg: TrackingConfig,
    gen: torch.Generator | None,
    score_min: float = 0.0,
    k: int = 4,
    draw: Draw = pnp_sample,
) -> PnPResult:
    """The lost camera's pose against the top-k scoring keyframes; the
    candidate with the most PnP inliers wins.  Acceptance is PnP's (inlier
    count and centre gate); `score_min` adds an appearance floor."""
    sig = bow_signature(frame.feats.desc_pm, frame.feats.valid)
    cands, scores = query_topk(ls.db, sig, k=k, exclude_recent=0)
    c = torch.clamp(cands, min=0).long()
    S = ls.kf_desc.shape[1]
    F = frame.feats.capacity
    ok_kf = ls.kf_pts_ok[c]  # (k, S)
    # One K2 call for all candidates: the stacked snapshot rows are packed
    # into a fresh contiguous (k * S, 8) table, so every row starts 16-byte
    # aligned as the kernel requires.
    dist = hamming_matrix(pack_pm(ls.kf_desc[c].reshape(k * S, -1)), frame.feats.desc_bits)
    m = mutual_match(dist.reshape(k, S, F), ok_kf, frame.feats.valid.expand(k, F),
                     max_dist=TH_LOW, ratio=0.85)
    T_wc = lie.inv_se3(kf_Tcw[c])  # (k, 4, 4)
    pts_w = lie.transform_points(T_wc, ls.kf_pts_cam[c])  # (k, S, 3)
    uv = frame.feats.xy[torch.clamp(m.idx, min=0).long()]  # (k, S, 2)
    res = pnp_ransac(pts_w, uv, m.valid & ok_kf, cfg.intr, gen,
                     center_hint=T_wc[:, :3, 3], max_center_dist=3.0, draw=draw)
    ok = res.ok & (scores >= score_min) & (cands >= 0)
    best = torch.argmax(torch.where(ok, res.num_inliers, -1))
    return PnPResult(Tcw=res.Tcw[best], inliers=res.inliers[best],
                     num_inliers=res.num_inliers[best], ok=ok[best])

"""Descriptor matching (counterpart of `qsp_slam_tpu/frontend/matcher.py`).

Distances come from kernel K2 on packed descriptors (`hamming_matrix`).
For ±1 rows, Hamming on the packed bits equals the JAX package's
(256 - <a, b>) // 2 exactly; the two differ only on all-zero (never
written) map rows, which every caller's validity mask already removes.
The projection search takes the distance matrix as an argument so tracking
computes it once per frame and shares it between the 1x and 2x radius
searches, whose masks are all that differ; the mutual match takes it too,
so relocalization makes one K2 call for all its candidate keyframes.
The rotation histogram and the epipolar gate serve the monocular
bootstrap and keyframe triangulation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.camera import Intrinsics, intrinsic_matrix
from ..ops.hamming import hamming_packed
from .fast import topk_stable
from .orb import pack_bits

TH_LOW = 50  # reference ORBmatcher::TH_LOW
TH_HIGH = 100  # reference ORBmatcher::TH_HIGH
HISTO_BINS = 30

_BIG = 1 << 20
_INT_MAX = 2**31 - 1


def pack_pm(pm: torch.Tensor) -> torch.Tensor:
    """(N, 256) ±1 int8 descriptors -> (N, 8) int32 words (bit = pm > 0)."""
    return pack_bits(pm > 0)


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances (kernel K2). (A, 8), (B, 8) -> (A, B) int32."""
    return hamming_packed(bits_a, bits_b)


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (A,) int32 — best column per row (-1 if none)
    dist: torch.Tensor  # (A,) int32 — its Hamming distance
    valid: torch.Tensor  # (A,) bool


def masked_best_match(
    dist: torch.Tensor,
    mask: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
) -> MatchResult:
    """Best match per row with an optional Lowe ratio test against the
    second best.  dist (..., A, B) int32; mask (..., A, B) bool candidate
    gate; leading dimensions are independent problems."""
    d = torch.where(mask, dist, _BIG)
    best = torch.argmin(d, dim=-1)  # first minimum, as jnp.argmin
    dbest = torch.gather(d, -1, best[..., None])[..., 0]
    d2 = d.scatter(-1, best[..., None], _BIG)
    dsecond = torch.min(d2, dim=-1).values
    ok = (dbest <= max_dist) & (dbest.to(torch.float32) <= ratio * dsecond.to(torch.float32))
    return MatchResult(
        idx=torch.where(ok, best.to(torch.int32), -1),
        dist=dbest,
        valid=ok,
    )


def projection_mask(
    proj_uv: torch.Tensor,
    proj_valid: torch.Tensor,
    proj_octave: torch.Tensor,
    feat_xy: torch.Tensor,
    feat_valid: torch.Tensor,
    feat_octave: torch.Tensor,
    radius_per_row: torch.Tensor,
    octave_window: int = 1,
) -> torch.Tensor:
    """(A, B) candidate gate of the projection search: inside the row's
    pixel radius and octave window, both sides valid."""
    dx = proj_uv[:, None, 0] - feat_xy[None, :, 0]
    dy = proj_uv[:, None, 1] - feat_xy[None, :, 1]
    window = (dx * dx + dy * dy) <= (radius_per_row[:, None] ** 2)
    oct_ok = torch.abs(proj_octave[:, None] - feat_octave[None, :]) <= octave_window
    return window & oct_ok & proj_valid[:, None] & feat_valid[None, :]


def search_by_projection(
    proj_uv: torch.Tensor,
    proj_valid: torch.Tensor,
    proj_octave: torch.Tensor,
    feat_xy: torch.Tensor,
    feat_valid: torch.Tensor,
    feat_octave: torch.Tensor,
    radius_per_row: torch.Tensor,
    dist: torch.Tensor,
    max_dist: int = TH_HIGH,
    octave_window: int = 1,
    ratio: float = 0.9,
) -> MatchResult:
    """Windowed projection search: each projected map point matches the
    keypoints inside its pixel radius and octave window.  `dist` is the
    (points, features) Hamming matrix from `hamming_matrix`."""
    mask = projection_mask(
        proj_uv, proj_valid, proj_octave, feat_xy, feat_valid, feat_octave,
        radius_per_row, octave_window,
    )
    return masked_best_match(dist, mask, max_dist=max_dist, ratio=ratio)


def mutual_match(
    dist: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    pair_mask: torch.Tensor | None = None,
) -> MatchResult:
    """Mutual-best matching on a (..., A, B) distance matrix from
    `hamming_matrix`: a row's best column must pick that row back.  The
    backward pass runs on the transpose of the same matrix.  `pair_mask`
    (..., A, B) restricts the candidates (e.g. `word_mask`)."""
    mask = valid_a[..., :, None] & valid_b[..., None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    fwd = masked_best_match(dist, mask, max_dist=max_dist, ratio=ratio)
    bwd = masked_best_match(dist.transpose(-1, -2), mask.transpose(-1, -2), max_dist=max_dist, ratio=ratio)
    a_idx = torch.arange(dist.shape[-2], dtype=torch.int32, device=dist.device)
    back = torch.gather(bwd.idx, -1, torch.clamp(fwd.idx, min=0).long())
    mutual = fwd.valid & (back == a_idx)
    return MatchResult(idx=torch.where(mutual, fwd.idx, -1), dist=fwd.dist, valid=mutual)


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Keep the matches whose angle difference falls in one of the 3 most
    populated of 30 bins (the rotation histogram of the reference
    matcher); count ties go to the lower bin."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b, two_pi)
    bins = torch.clamp((rot * (HISTO_BINS / two_pi)).to(torch.int32), 0, HISTO_BINS - 1)
    counts = torch.bincount(torch.where(valid, bins, HISTO_BINS).long(), minlength=HISTO_BINS + 1)
    top3 = topk_stable(counts[:HISTO_BINS], 3)[1]
    return valid & (bins[:, None] == top3[None, :]).any(dim=1)


def epipolar_mask(
    uv_a: torch.Tensor,  # (A, 2) pixels in camera 1
    uv_b: torch.Tensor,  # (B, 2) pixels in camera 2
    T_21: torch.Tensor,  # (4, 4) camera 1 -> camera 2
    intr: Intrinsics,
    octave_b: torch.Tensor | None = None,
    scale_factor: float = 1.2,
    chi2: float = 3.84,
    sigma_px: float = 1.0,
) -> torch.Tensor:
    """(A, B) gate of triangulation matching: a candidate in image 2 lies
    within chi2 * sigma(octave)^2 (squared pixels) of the epipolar line of
    the image-1 feature, F21 = K^-T [t]x R K^-1."""
    R, t = T_21[:3, :3], T_21[:3, 3]
    z = torch.zeros((), dtype=uv_a.dtype, device=uv_a.device)
    tx = torch.stack([
        torch.stack([z, -t[2], t[1]]), torch.stack([t[2], z, -t[0]]), torch.stack([-t[1], t[0], z])
    ]).to(uv_a.dtype)
    Kinv = torch.linalg.inv(intrinsic_matrix(intr, uv_a.device))
    F21 = Kinv.T @ tx @ R @ Kinv
    xa = torch.cat([uv_a, torch.ones_like(uv_a[:, :1])], dim=-1)
    lines = xa @ F21.T  # (A, 3) epipolar lines in image 2
    xb = torch.cat([uv_b, torch.ones_like(uv_b[:, :1])], dim=-1)
    num = torch.abs(lines @ xb.T)
    den = torch.sqrt(torch.clamp(lines[:, 0] ** 2 + lines[:, 1] ** 2, min=1e-12))[:, None]
    d = num / den
    sigma2 = sigma_px ** 2
    if octave_b is not None:
        sigma2 = (sigma2 * (scale_factor ** octave_b.to(uv_a.dtype)) ** 2)[None, :]
    return (d * d) < (chi2 * sigma2)


def word_mask(word_a: torch.Tensor, word_b: torch.Tensor) -> torch.Tensor:
    """(A, B) gate of features quantized to the same vocabulary word (the
    bag-of-words bucket of the reference matcher)."""
    return word_a[:, None] == word_b[None, :]


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = torch.full((num_segments,), _INT_MAX, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg.long(), vals, "amin")


def resolve_duplicates(match: MatchResult, num_targets: int) -> MatchResult:
    """Each target column keeps at most one row: the lowest distance, ties
    to the lowest row index."""
    tgt = torch.where(match.valid, match.idx, num_targets)
    best_per_tgt = _segment_min(match.dist, tgt, num_targets + 1)
    keep = match.valid & (match.dist <= best_per_tgt[tgt.long()])
    rows = torch.arange(match.idx.shape[0], dtype=torch.int32, device=match.idx.device)
    first_row = _segment_min(torch.where(keep, rows, 1 << 30), tgt, num_targets + 1)
    keep = keep & (rows == first_row[tgt.long()])
    return MatchResult(idx=torch.where(keep, match.idx, -1), dist=match.dist, valid=keep)

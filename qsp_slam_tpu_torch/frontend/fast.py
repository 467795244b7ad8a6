"""FAST-9/16 corners and spatially-distributed top-K selection
(counterpart of `qsp_slam_tpu/frontend/fast.py`).

The NMS'd score maps come from the hand-written CUDA kernel
(`ops.fast_nms`: `extract_features` asks for a whole pyramid at both
thresholds at once, `detect_keypoints` for one image); `fast_score` +
`nms3x3` below are that kernel's plain PyTorch version, and
`select_keypoints` turns a score map into a keypoint table.  Top-k
selections use a stable descending sort, so ties resolve to the lower
index exactly as `jax.lax.top_k` does (FAST scores of a uint8 image tie
often).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (dy, dx), the standard FAST-16 ring.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint table for one pyramid level."""

    xy: torch.Tensor  # (K, 2) f32 — (x, y) in this level's pixel coords
    score: torch.Tensor  # (K,) f32
    valid: torch.Tensor  # (K,) bool


def _rot16(m: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate 16-bit ring masks held in int32."""
    return ((m >> r) | (m << (16 - r))) & 0xFFFF


def _arc9(m: torch.Tensor) -> torch.Tensor:
    """Contiguous cyclic run of >= 9 set bits in a 16-bit ring mask:
    AND with rotations 1, 2, 4 leaves runs >= 8; the original rotated by 8
    appends the ninth bit."""
    r = m & _rot16(m, 1)
    r = r & _rot16(r, 2)
    r = r & _rot16(r, 4)
    r = r & _rot16(m, 8)
    return r != 0


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9/16 corner score (0 where not a corner).

    Score = max(sum over bright ring pixels of |d| - t, same over dark),
    summed in ring order; zero within 3 px of the border.
    """
    H, W = img.shape
    pad = F.pad(img, (3, 3, 3, 3))
    c = img
    hi, lo = c + threshold, c - threshold
    bmask = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    dmask = torch.zeros_like(bmask)
    score_b = torch.zeros_like(img)
    score_d = torch.zeros_like(img)
    for k, (dy, dx) in enumerate(_CIRCLE):
        ring = pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
        bright = ring > hi
        dark = ring < lo
        bmask = bmask | (bright.to(torch.int32) << k)
        dmask = dmask | (dark.to(torch.int32) << k)
        diff = torch.abs(ring - c) - threshold
        score_b = score_b + torch.where(bright, diff, 0.0)
        score_d = score_d + torch.where(dark, diff, 0.0)
    is_corner = _arc9(bmask) | _arc9(dmask)
    score = torch.where(is_corner, torch.maximum(score_b, score_d), 0.0)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    border = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return torch.where(border, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima (ties survive) in a 3x3 neighbourhood."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values, ties in
    ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cell_candidates(score: torch.Tensor, cell: int, cell_cap: int):
    """Per-cell top-`cell_cap` NMS candidates -> (scores (C*cap,), x, y)."""
    H, W = score.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    sp = F.pad(score, (0, Wp - W, 0, Hp - H))
    cells = sp.reshape(Hp // cell, cell, Wp // cell, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(-1, cell * cell)  # (C, cell*cell)
    top_s, top_i = topk_stable(cells, cell_cap)
    cid = torch.arange(cells.shape[0], device=score.device)[:, None]
    py = (cid // (Wp // cell)) * cell + top_i // cell
    px = (cid % (Wp // cell)) * cell + top_i % cell
    return top_s.reshape(-1), px.reshape(-1), py.reshape(-1)


def _select_budget(flat_s, flat_x, flat_y, max_keypoints: int, dtype) -> Keypoints:
    """Global top-K by score over the pooled cell candidates, padded with
    invalid rows when a small level has fewer candidates than its budget."""
    k = min(max_keypoints, flat_s.shape[0])
    k_s, k_i = topk_stable(flat_s, k)
    if k < max_keypoints:
        pad = max_keypoints - k
        k_s = torch.cat([k_s, k_s.new_zeros(pad)])
        k_i = torch.cat([k_i, k_i.new_zeros(pad)])
    xy = torch.stack([flat_x[k_i].to(dtype), flat_y[k_i].to(dtype)], dim=-1)
    return Keypoints(xy=xy, score=k_s, valid=k_s > 0.0)


def select_keypoints(
    score: torch.Tensor,
    max_keypoints: int,
    cell: int = 32,
    cell_cap: int = 8,
) -> Keypoints:
    """Per-cell cap + global top-K of an NMS'd score map -> fixed table."""
    flat_s, flat_x, flat_y = _cell_candidates(score, cell, cell_cap)
    return _select_budget(flat_s, flat_x, flat_y, max_keypoints, score.dtype)


def detect_keypoints(
    img: torch.Tensor,
    threshold: float,
    max_keypoints: int,
    cell: int = 32,
    cell_cap: int = 8,
) -> Keypoints:
    """FAST + NMS (kernel K1) + per-cell cap + global top-K -> fixed table."""
    from ..ops.fast_nms import fast_score_nms

    return select_keypoints(fast_score_nms(img, threshold), max_keypoints, cell, cell_cap)

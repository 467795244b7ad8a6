"""Stereo left-right matching -> per-keypoint disparity and depth
(counterpart of `qsp_slam_tpu/frontend/stereo.py`).

For each left keypoint: the Hamming-best right keypoint inside the
scanline band, octave window and disparity range (one kernel-K2 call at
(left features, right features)), then, given the images, a SAD scan of
the 11x11 left patch along the right scanline (+-5 px) with a parabola
fit for the subpixel position, and the reference's median-SAD prune.

The SAD scan is one batched gather: index arithmetic on the flattened
images gives (F, 11, 11) patches and (F, 11, 21) strips, and one
reduction gives the (F, 11) SADs.  On integer images the SADs are exact in
f32, so the refined `u_right` matches the reference bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .matcher import TH_HIGH, hamming_matrix
from .orb import Features

_W = 5  # SAD half-window (11 x 11 patch)
_R = 5  # subpixel scan range (+- px)


def _subpixel_refine(gray_l: torch.Tensor, gray_r: torch.Tensor, xy_l: torch.Tensor, u_r0: torch.Tensor):
    """SAD scan of the right image around each coarse match ->
    (u_r refined, valid, SAD at the minimum).  Invalid where the minimum
    sits on the scan boundary or the patch leaves the image; there u_r
    stays the coarse value."""
    H, W = gray_l.shape
    n, s = 2 * _W + 1, 2 * _R + 1
    dev = gray_l.device
    xi = torch.round(xy_l[:, 0]).to(torch.int64)
    yi = torch.round(xy_l[:, 1]).to(torch.int64)
    ri = torch.round(u_r0).to(torch.int64)
    in_img = ((yi >= _W) & (yi < H - _W) & (xi >= _W) & (xi < W - _W)
              & (ri >= _W + _R) & (ri < W - _W - _R))
    yc = torch.clamp(yi - _W, 0, H - n)
    xc = torch.clamp(xi - _W, 0, W - n)
    rc = torch.clamp(ri - _W - _R, 0, W - (n + s - 1))
    rows = (yc[:, None] + torch.arange(n, device=dev)) * W  # (F, 11) row offsets
    patch = gray_l.reshape(-1)[rows[:, :, None] + (xc[:, None] + torch.arange(n, device=dev))[:, None, :]]
    strip = gray_r.reshape(-1)[rows[:, :, None] + (rc[:, None] + torch.arange(n + s - 1, device=dev))[:, None, :]]
    # (F, 11 rows, 11 shifts, 11 cols): SAD at each shift in [-R, R].
    sads = torch.sum(torch.abs(patch[:, :, None, :] - strip.unfold(2, n, 1)), dim=(1, 3))
    b = torch.argmin(sads, dim=-1)
    interior = (b > 0) & (b < 2 * _R)
    bi = torch.clamp(b, 1, 2 * _R - 1)
    s_m, s_0, s_p = (torch.gather(sads, 1, (bi + k)[:, None])[:, 0] for k in (-1, 0, 1))
    denom = s_m - 2.0 * s_0 + s_p
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / denom, 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    u_ref = ri.to(torch.float32) + (bi.to(torch.float32) - _R) + delta
    ok = in_img & interior
    return torch.where(ok, u_ref, u_r0), ok, s_0


def nanmedian_mean(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN values with `jnp.nanmedian`'s convention: the
    mean of the two middle values for an even count (`torch.nanmedian`
    takes the lower one); NaN when there are none.  No host read."""
    ok = ~torch.isnan(x)
    vals = torch.sort(torch.where(ok, x, torch.inf)).values
    cnt = torch.sum(ok)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    med = vals[lo] * 0.5 + vals[cnt // 2] * 0.5
    return torch.where(cnt > 0, med, torch.nan)


def match_stereo(
    left: Features,
    right: Features,
    baseline_fx: float,
    min_depth: float = 0.3,
    max_depth: float = 80.0,
    row_tol: float = 2.0,
    max_dist: int = TH_HIGH,
    gray_left: torch.Tensor | None = None,
    gray_right: torch.Tensor | None = None,
) -> torch.Tensor:
    """u_right (F,) for the left features, -1 where unmatched.

    The scanline tolerance grows with the left keypoint's octave (by the
    literal 1.2, as the reference has it).  With the images, each coarse
    match is refined to subpixel and dropped where that fails, then pruned
    by SAD against 1.5 * 1.4 * the median SAD and re-gated on disparity."""
    # The reference takes these scalars as float32 arrays.
    bf = np.float32(baseline_fx)
    min_disp = float(bf / np.float32(max_depth))
    max_disp = float(bf / np.float32(min_depth))
    dist = hamming_matrix(left.desc_bits, right.desc_bits)  # (L, R), kernel K2
    dv = torch.abs(left.xy[:, None, 1] - right.xy[None, :, 1])
    tol = float(np.float32(row_tol)) * 1.2 ** left.octave.to(torch.float32)
    disp = left.xy[:, None, 0] - right.xy[None, :, 0]
    gate = (
        (dv <= tol[:, None])
        & (disp > min_disp)
        & (disp < max_disp)
        & left.valid[:, None]
        & right.valid[None, :]
        & (torch.abs(left.octave[:, None] - right.octave[None, :]) <= 1)
    )
    d = torch.where(gate, dist, 1 << 20)
    best = torch.argmin(d, dim=1)  # first minimum, as jnp.argmin
    ok = torch.gather(d, 1, best[:, None])[:, 0] <= max_dist
    u_r = right.xy[best, 0]
    if gray_left is not None and gray_right is not None:
        u_r, refined, sad = _subpixel_refine(gray_left.to(torch.float32), gray_right.to(torch.float32),
                                             left.xy, u_r)
        ok = ok & refined
        # A wrong coarse match lands at a spuriously large disparity: prune
        # SADs far above the median.
        med = nanmedian_mean(torch.where(ok, sad, torch.nan))
        ok = ok & (sad < (1.5 * 1.4) * torch.where(torch.isnan(med), torch.inf, med))
        # The parabola can step across the disparity bounds.
        disp_r = left.xy[:, 0] - u_r
        ok = ok & (disp_r > min_disp) & (disp_r < max_disp)
    return torch.where(ok, u_r, -1.0)


def depth_from_u_right(u: torch.Tensor, u_right: torch.Tensor, baseline_fx: float) -> torch.Tensor:
    """Depth = bf / disparity; 0 where unmatched."""
    disp = u - u_right
    ok = (u_right >= 0) & (disp > 1e-3)
    return torch.where(ok, baseline_fx / torch.where(ok, disp, 1.0), 0.0)

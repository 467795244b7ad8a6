"""Oriented BRIEF descriptors and the multi-level ORB extractor
(counterpart of `qsp_slam_tpu/frontend/orb.py`).

pyramid -> FAST + NMS on every level at two thresholds (kernel K1, one
launch per frame, or per stereo pair with `extract_features_pair`) ->
per-level keypoint selection -> intensity-centroid orientation ->
steered BRIEF-256 on the blurred level, emitted as
a fixed-capacity feature table.  The sampling pattern is the reference's
seeded table (same generator, same seed).  Descriptors come both packed
((F, 8) int32 words, bit j of word w = bit 32w + j, the matcher's form for
kernel K2) and as ±1 int8 (the map's storage form).  Bilinear samples are
plain gathers from per-keypoint windows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.fast_nms import MAX_LEVELS, fast_score_nms_pyramid
from .fast import Keypoints, select_keypoints
from .pyramid import PyramidConfig, build_pyramid, gaussian_blur

PATCH_R = 15  # orientation patch radius (31x31), as in ORB
DESC_BITS = 256


def _make_pattern(seed: int = 7, n: int = DESC_BITS, sigma: float = PATCH_R / 5.0):
    rng = np.random.default_rng(seed)
    p = np.clip(rng.normal(0.0, sigma, size=(n, 2, 2)), -PATCH_R, PATCH_R)
    return p.astype(np.float32)  # (256, 2 points, (dx, dy))


_PATTERN = _make_pattern()

# Circular mask weights for the intensity centroid (radius 15).
_D = np.arange(-PATCH_R, PATCH_R + 1)
_DX, _DY = np.meshgrid(_D, _D)
_CIRC = (_DX**2 + _DY**2 <= PATCH_R**2).astype(np.float32)

# Descriptor window radius: steered offsets reach 15*sqrt(2) ~ 21.3 px.
_DESC_R = 21
_DESC_S = 2 * _DESC_R + 1


class Features(NamedTuple):
    """Fixed-capacity multi-level feature table."""

    xy: torch.Tensor  # (F, 2) f32 — level-0 pixel coords
    response: torch.Tensor  # (F,) f32
    angle: torch.Tensor  # (F,) f32 radians
    octave: torch.Tensor  # (F,) int32 pyramid level
    desc_bits: torch.Tensor  # (F, 8) int32 packed descriptor (u32 bits)
    desc_pm: torch.Tensor  # (F, 256) int8 ±1 descriptor
    valid: torch.Tensor  # (F,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _consts(device: torch.device):
    return (
        torch.from_numpy(_PATTERN).to(device),
        torch.from_numpy(_CIRC * _DX.astype(np.float32)).to(device),
        torch.from_numpy(_CIRC * _DY.astype(np.float32)).to(device),
    )


def extract_windows(img: torch.Tensor, xy: torch.Tensor, radius: int):
    """Per-keypoint (2r+1)^2 windows -> (patches (K, S, S), x0 (K,), y0 (K,))
    with patch[k, py, px] = img[y0[k] + py, x0[k] + px].

    Windows whose keypoint lies within `radius` of the border are shifted
    inside the image (the reference's clamp-inside semantics)."""
    H, W = img.shape
    size = 2 * radius + 1
    xc = torch.round(xy[:, 0]).to(torch.int64)
    yc = torch.round(xy[:, 1]).to(torch.int64)
    x0 = torch.clamp(xc - radius, 0, W - size)
    y0 = torch.clamp(yc - radius, 0, H - size)
    off = torch.arange(size, device=img.device)
    patches = img[(y0[:, None] + off)[:, :, None], (x0[:, None] + off)[:, None, :]]
    return patches, x0, y0


def compute_orientation(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per keypoint (moments about the window
    centre over the radius-15 disc)."""
    _, wx, wy = _consts(img.device)
    patch, _, _ = extract_windows(img, xy, PATCH_R)  # (K, 31, 31)
    m10 = torch.einsum("kyx,yx->k", patch, wx)
    m01 = torch.einsum("kyx,yx->k", patch, wy)
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words, bit j of word w = bit 32w + j."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64) << shifts, dim=-1)
    # Two's-complement wrap of the u32 values into int32 storage.
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def compute_descriptors(
    img_blur: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steered BRIEF-256 on a blurred image -> (bits (K, 8) int32, pm (K, 256) int8)."""
    pat, _, _ = _consts(img_blur.device)
    ca, sa = torch.cos(angle), torch.sin(angle)  # (K,)
    px_, py_ = pat[None, ..., 0], pat[None, ..., 1]  # (1, 256, 2)
    offx = ca[:, None, None] * px_ - sa[:, None, None] * py_
    offy = sa[:, None, None] * px_ + ca[:, None, None] * py_
    posx = xy[:, 0, None, None] + offx  # (K, 256, 2) absolute sample positions
    posy = xy[:, 1, None, None] + offy

    patch, x0, y0 = extract_windows(img_blur, xy, _DESC_R)  # (K, 43, 43)
    S = _DESC_S
    px = torch.clamp(posx - x0[:, None, None].to(posx.dtype), 0.0, S - 1.001)
    py = torch.clamp(posy - y0[:, None, None].to(posy.dtype), 0.0, S - 1.001)
    x0i = torch.floor(px).to(torch.int64)
    y0i = torch.floor(py).to(torch.int64)
    fx = px - x0i
    fy = py - y0i
    K = patch.shape[0]
    flat = patch.reshape(K, S * S)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * S + xi).reshape(K, -1)).reshape(yi.shape)

    top = (1.0 - fx) * at(y0i, x0i) + fx * at(y0i, x0i + 1)
    bot = (1.0 - fx) * at(y0i + 1, x0i) + fx * at(y0i + 1, x0i + 1)
    vals = (1.0 - fy) * top + fy * bot  # (K, 256, 2)
    bits = vals[..., 0] < vals[..., 1]  # (K, 256)
    pm = torch.where(bits, 1, -1).to(torch.int8)
    return pack_bits(bits), pm


class OrbConfig(NamedTuple):
    num_features: int = 1000
    pyramid: PyramidConfig = PyramidConfig()
    fast_threshold: float = 20.0
    fast_threshold_min: float = 7.0  # low-texture fallback threshold
    cell: int = 32
    cell_cap: int = 8


def _per_level_budget(cfg: OrbConfig) -> list[int]:
    """Geometric feature budget per level; level 0 absorbs the rounding."""
    inv = 1.0 / cfg.pyramid.scale_factor
    n0 = cfg.num_features * (1 - inv) / (1 - inv**cfg.pyramid.num_levels)
    budgets = []
    acc = 0
    for lv in range(cfg.pyramid.num_levels):
        b = int(round(n0 * inv**lv))
        budgets.append(b)
        acc += b
    budgets[0] += cfg.num_features - acc
    return budgets


def _as_image(img, device) -> torch.Tensor:
    if not isinstance(img, torch.Tensor):
        img = torch.as_tensor(np.asarray(img), device=resolve_device(device))
    elif device is not None:
        img = img.to(device)
    return img.to(torch.float32).contiguous()


def extract_features(img, cfg: OrbConfig, device=None) -> Features:
    """Full ORB pipeline for one grayscale image -> Features table of static
    capacity `cfg.num_features` with a validity mask.

    `img` is an (H, W) tensor (used on its own device) or an array, which
    goes to `device` (CUDA unless named).  uint8 input is cast here.
    """
    pyr = build_pyramid(_as_image(img, device), cfg.pyramid)
    # Kernel K1, one launch: every level at both thresholds.
    scores = fast_score_nms_pyramid(pyr, (cfg.fast_threshold, cfg.fast_threshold_min))
    return _features_from_scores(pyr, scores, cfg)


def extract_features_pair(img_l, img_r, cfg: OrbConfig, device=None) -> tuple[Features, Features]:
    """`extract_features` of a stereo pair, the same two tables, with one
    K1 launch for both pyramids when their levels fit one launch
    (2 x 8 levels is exactly `MAX_LEVELS`), else one launch per image."""
    pyrs = [build_pyramid(_as_image(im, device), cfg.pyramid) for im in (img_l, img_r)]
    ths = (cfg.fast_threshold, cfg.fast_threshold_min)
    n = len(pyrs[0])
    if 2 * n <= MAX_LEVELS:
        scores = fast_score_nms_pyramid(pyrs[0] + pyrs[1], ths)
        per_image = (scores[:n], scores[n:])
    else:
        per_image = tuple(fast_score_nms_pyramid(p, ths) for p in pyrs)
    return tuple(_features_from_scores(p, sc, cfg) for p, sc in zip(pyrs, per_image))


def _features_from_scores(pyr: list[torch.Tensor], scores, cfg: OrbConfig) -> Features:
    """Keypoint selection, orientation and descriptors of every level,
    given its NMS'd score maps at both thresholds."""
    budgets = _per_level_budget(cfg)
    scales = cfg.pyramid.scales
    dev = pyr[0].device

    xs, resp, ang, oct_, bits, pm, valid = [], [], [], [], [], [], []
    for lv, (im, budget) in enumerate(zip(pyr, budgets)):
        if budget <= 0:
            continue
        score, score_min = scores[lv]
        kp = select_keypoints(score, budget, cfg.cell, cfg.cell_cap)
        # Low-texture fallback: where the strict threshold finds fewer than
        # half the budget, take the minimum-threshold detection instead.
        kp_min = select_keypoints(score_min, budget, cfg.cell, cfg.cell_cap)
        use_min = torch.sum(kp.valid) < (budget // 2)
        kp = Keypoints(
            xy=torch.where(use_min, kp_min.xy, kp.xy),
            score=torch.where(use_min, kp_min.score, kp.score),
            valid=torch.where(use_min, kp_min.valid, kp.valid),
        )
        a = compute_orientation(im, kp.xy)
        d_bits, d_pm = compute_descriptors(gaussian_blur(im), kp.xy, a)
        xs.append(kp.xy * scales[lv])  # level-0 coords
        resp.append(kp.score)
        ang.append(a)
        oct_.append(torch.full((budget,), lv, dtype=torch.int32, device=dev))
        bits.append(d_bits)
        pm.append(d_pm)
        valid.append(kp.valid)

    return Features(
        xy=torch.cat(xs),
        response=torch.cat(resp),
        angle=torch.cat(ang),
        octave=torch.cat(oct_),
        desc_bits=torch.cat(bits),
        desc_pm=torch.cat(pm),
        valid=torch.cat(valid),
    )

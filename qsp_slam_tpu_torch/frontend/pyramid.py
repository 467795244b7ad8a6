"""Image pyramid: 8 levels at scale factor 1.2 (counterpart of
`qsp_slam_tpu/frontend/pyramid.py`).

Each level is resized from the previous one with the antialiased triangle
kernel of `jax.image.resize(..., "linear", antialias=True)`.  Its weight
matrices are rebuilt here in float32 exactly as JAX builds them and applied
as two small matrix products, so levels agree with the reference to f32
summation order and FAST's threshold comparisons on the smaller levels see
the same pixels.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class PyramidConfig(NamedTuple):
    num_levels: int = 8
    scale_factor: float = 1.2
    height: int = 480
    width: int = 640

    @property
    def scales(self) -> list[float]:
        return [self.scale_factor**i for i in range(self.num_levels)]

    def level_shape(self, level: int) -> tuple[int, int]:
        s = self.scale_factor**level
        return (int(round(self.height / s)), int(round(self.width / s)))


@lru_cache(maxsize=None)
def _blur_taps(sigma: float, radius: int) -> tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with zero padding. img (H, W) f32.

    Shift-and-accumulate in the reference's tap order, so the sums round
    exactly as the JAX version does.
    """
    k = _blur_taps(sigma, radius)
    H, W = img.shape
    pad = F.pad(img, (radius, radius))
    out = k[0] * pad[:, 0:W]
    for i in range(1, 2 * radius + 1):
        out = out + k[i] * pad[:, i:i + W]
    pad = F.pad(out, (0, 0, radius, radius))
    out = k[0] * pad[0:H, :]
    for i in range(1, 2 * radius + 1):
        out = out + k[i] * pad[i:i + H, :]
    return out


@lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of JAX's antialiased linear resize along one
    axis (`jax._src.image.scale.compute_weight_mat`, triangle kernel, no
    translation) as the compiled reference evaluates them: the sample
    position (i + 0.5) * inv_scale - 0.5 is one fused multiply-add (exact
    in float64, then rounded once), and divisions by the kernel scale and
    the column sums are products with their float32 reciprocals.  Without
    the FMA the weights differ by up to 2e-5, enough to move FAST's
    threshold comparisons on the smaller levels."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    pos = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (pos.astype(np.float64) * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w * (f32(1.0) / np.where(total != 0, total, f32(1.0))),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@lru_cache(maxsize=None)
def _weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Antialiased linear resize of an (H, W) f32 image to `shape`."""
    H, W = img.shape
    h, w = shape
    wy = _weights_on(H, h, img.device)
    wx = _weights_on(W, w, img.device)
    return wy.T @ (img @ wx)


def build_pyramid(img: torch.Tensor, cfg: PyramidConfig) -> list[torch.Tensor]:
    """Grayscale f32 image -> list of `num_levels` downscaled images, each
    resized from the previous level."""
    levels = [img]
    for lv in range(1, cfg.num_levels):
        levels.append(resize(levels[-1], cfg.level_shape(lv)))
    return levels

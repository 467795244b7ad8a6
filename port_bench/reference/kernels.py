"""Plain PyTorch references of the frontend's two hand-written kernels and
of the image pyramid that feeds the first (frozen copies, rewritten, of
the port's plain versions; they import nothing of the program).

- FAST-9/16 corner score with 3x3 non-maximum suppression (kernel K1):
  score = max(sum over bright ring pixels of |d| - t, the same over dark
  ones) where a cyclic run of >= 9 ring pixels is brighter or darker than
  the centre by t, 0 elsewhere and within 3 px of the border; then a
  pixel keeps its score only when no neighbour's is higher.
- Hamming distances of packed 256-bit descriptors (kernel K2): the
  popcount of the XOR of their eight 32-bit words.
- The pyramid: each level resized from the previous one by an
  antialiased triangle (linear) kernel, as `jax.image.resize(...,
  "linear", antialias=True)` builds it, as two matrix products.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def _arc9(bits: torch.Tensor) -> torch.Tensor:
    """A cyclic run of >= 9 set bits among 16 (bool (16, H, W))."""
    run = torch.ones_like(bits[0])
    found = torch.zeros_like(bits[0])
    ring = torch.cat([bits, bits[:8]])
    for s in range(16):
        run = torch.ones_like(bits[0])
        for k in range(9):
            run = run & ring[s + k]
        found = found | run
    return found


def fast_nms(img: torch.Tensor, t: float) -> torch.Tensor:
    """NMS'd FAST score map of an (H, W) f32 image at threshold t."""
    H, W = img.shape
    pad = F.pad(img, (3, 3, 3, 3))
    rings = torch.stack([pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dy, dx in CIRCLE])
    bright, dark = rings > img + t, rings < img - t
    diff = torch.abs(rings - img) - t
    sb, sd = torch.zeros_like(img), torch.zeros_like(img)
    for k in range(16):  # in ring order, so the sums round as the kernel's
        sb = sb + torch.where(bright[k], diff[k], 0.0)
        sd = sd + torch.where(dark[k], diff[k], 0.0)
    score = torch.where(_arc9(bright) | _arc9(dark), torch.maximum(sb, sd), 0.0)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    score = torch.where((yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3), score, 0.0)
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def hamming(a: torch.Tensor, b: torch.Tensor, rows: int = 1024) -> torch.Tensor:
    """(A, 8), (B, 8) int32 words -> (A, B) int64 distances."""
    table = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64, device=a.device)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int64, device=a.device)
    bb = b.to(torch.int64) & 0xFFFFFFFF
    for s in range(0, a.shape[0], rows):
        x = (a[s:s + rows, None, :].to(torch.int64) & 0xFFFFFFFF) ^ bb[None]
        n = sum(table[(x >> (8 * k)) & 0xFF] for k in range(4))
        out[s:s + rows] = n.sum(-1)
    return out


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of the antialiased linear resize along one
    axis: sample position (i + 0.5) / scale - 0.5 (one rounding), triangle
    kernel widened by the downscale, columns normalised."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    pos = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (pos.astype(np.float64) * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w * (f32(1.0) / np.where(total != 0, total, f32(1.0))), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def level_shapes(height: int, width: int, levels: int, scale: float) -> list[tuple[int, int]]:
    return [(int(round(height / scale**i)), int(round(width / scale**i))) for i in range(levels)]


def pyramid(img: torch.Tensor, shapes: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Level 0 is the image; level i the resize of level i - 1."""
    out = [img]
    for h, w in shapes[1:]:
        H, W = out[-1].shape
        wy = torch.from_numpy(resize_weights(H, h)).to(img.device)
        wx = torch.from_numpy(resize_weights(W, w)).to(img.device)
        out.append(wy.T @ (out[-1] @ wx))
    return out

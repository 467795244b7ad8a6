"""Synthetic RGB-D frames: a textured box room, ray-cast per pixel
(counterpart of `qsp_slam_tpu/data/render.py`: `make_room`,
`orbit_trajectory`, `render_frame`).  The textures come from the same
seeded numpy generator, so both packages render the same room.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..core.camera import Intrinsics


class BoxRoom(NamedTuple):
    """6 axis-aligned planes enclosing [-hx,hx] x [-hy,hy] x [-hz,hz]."""

    normals: torch.Tensor  # (6, 3) inward normals
    offsets: torch.Tensor  # (6,)   n . p + d = 0
    axes_u: torch.Tensor  # (6, 3) plane-local u axis
    axes_v: torch.Tensor  # (6, 3) plane-local v axis
    textures: torch.Tensor  # (6, T, T) f32 grayscale
    tex_period: float = 10.0  # meters per texture wrap


def make_room(
    half_extent=(4.0, 2.2, 4.0), tex_size: int = 512, seed: int = 0,
    tex_period: float = 10.0, device=None,
) -> BoxRoom:
    dev = resolve_device(device)
    hx, hy, hz = half_extent
    rng = np.random.default_rng(seed)

    def band_noise():
        # Two-band noise: large-scale structure plus corner-dense detail.
        n = rng.normal(size=(tex_size, tex_size)).astype(np.float32)
        F = np.fft.rfft2(n)
        fy = np.fft.fftfreq(tex_size)[:, None]
        fx = np.fft.rfftfreq(tex_size)[None, :]
        r = np.sqrt(fx * fx + fy * fy)
        lo = F * np.exp(-((r - 0.08) ** 2) / (2 * 0.05**2))
        hi = F * np.exp(-((r - 0.22) ** 2) / (2 * 0.08**2))

        def norm(Fm):
            out = np.fft.irfft2(Fm, s=(tex_size, tex_size))
            return (out - out.min()) / (out.max() - out.min())

        return (40.0 + 180.0 * (0.65 * norm(lo) + 0.35 * norm(hi))).astype(np.float32)

    normals = np.array(
        [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]], np.float32
    )
    offsets = np.array([hx, hx, hy, hy, hz, hz], np.float32)
    axes_u = np.array(
        [[0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]], np.float32
    )
    axes_v = np.array(
        [[0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 1, 0]], np.float32
    )
    tex = np.stack([band_noise() for _ in range(6)])

    def t(a):
        return torch.from_numpy(a).to(dev)

    return BoxRoom(t(normals), t(offsets), t(axes_u), t(axes_v), t(tex), float(np.float32(tex_period)))


def render_frame(
    room: BoxRoom, T_cw, intr: Intrinsics, height: int = 480, width: int = 640
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render (gray (H, W) f32, depth (H, W) f32 meters) at pose T_cw."""
    dev = room.textures.device
    if not isinstance(T_cw, torch.Tensor):
        T_cw = torch.from_numpy(np.asarray(T_cw, np.float32))
    T_cw = T_cw.to(dev, torch.float32)
    T_wc = lie.inv_se3(T_cw)
    R_wc = T_wc[:3, :3]
    c_w = T_wc[:3, 3]
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    rays_c = torch.stack(
        [(xx - intr.cx) / intr.fx, (yy - intr.cy) / intr.fy, torch.ones_like(xx)], dim=-1
    )  # z = 1, so the hit parameter is the camera depth
    rays_w = rays_c @ R_wc.T

    denom = rays_w @ room.normals.T  # (H, W, 6)
    numer = -(room.normals @ c_w + room.offsets)  # (6,)
    t = numer / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t = torch.where((t > 0.05) & (denom < 0.0), t, torch.inf)  # facing, in front
    depth, best = torch.min(t, dim=-1)
    depth = torch.where(torch.isfinite(depth), depth, 0.0)

    hit_w = c_w + rays_w * depth[..., None]
    T = room.textures.shape[-1]
    scale = T / room.tex_period
    u = torch.sum(hit_w * room.axes_u[best], dim=-1) * scale
    v = torch.sum(hit_w * room.axes_v[best], dim=-1) * scale
    u = torch.remainder(u, T - 1.0)
    v = torch.remainder(v, T - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    fu, fv = u - u0, v - v0

    def samp(vi, ui):
        # Indices clamp into the texture, as JAX's gather does: the wrap
        # above can round up to exactly T - 1, putting the +1 tap at T.
        return room.textures[best, vi.clamp(0, T - 1), ui.clamp(0, T - 1)]

    g = (
        samp(v0, u0) * (1 - fu) * (1 - fv)
        + samp(v0, u0 + 1) * fu * (1 - fv)
        + samp(v0 + 1, u0) * (1 - fu) * fv
        + samp(v0 + 1, u0 + 1) * fu * fv
    )
    return g, depth


def orbit_trajectory(num_frames: int, step: float = 0.02, pitch: float = 0.0) -> np.ndarray:
    """Smooth camera arc inside the room with constant per-frame motion
    (~10 px image motion at 4 m); returns T_cw (F, 4, 4) float32."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_pitch = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]], np.float32)
    poses = []
    for i in range(num_frames):
        th = i * step
        cpos = np.array([2.2 * np.sin(th), 0.25 * np.sin(2 * th), 1.1 * (np.cos(th) - 1.0)])
        yaw = 0.54 * np.sin(th)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = R_wc @ R_pitch
        T_wc[:3, 3] = cpos
        poses.append(np.linalg.inv(T_wc))
    return np.stack(poses).astype(np.float32)

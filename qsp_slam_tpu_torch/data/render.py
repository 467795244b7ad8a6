"""Synthetic frames: a textured box room with ellipsoid objects, ray-cast
per pixel (counterpart of `qsp_slam_tpu/data/render.py`: `make_room`,
`make_scene`, `orbit_trajectory`, `render_frame`, `render_scene`,
`gt_detections`).  The textures, table slabs and object placements come
from the same seeded numpy generators, so both packages render the same
scene.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import lie, quadric
from ..core.camera import Intrinsics, intrinsic_matrix


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


class Scene(NamedTuple):
    """Room + ellipsoid objects (world-frame minimal vectors: centre, XYZ
    Euler angles, half-axes) + horizontal table slabs (Manhattan structure
    for the relation typing)."""

    room: BoxRoom
    ellipsoids: torch.Tensor  # (O, 9)
    labels: torch.Tensor  # (O,) int32 semantic labels
    albedo: torch.Tensor  # (O,) f32 base gray value
    slabs: torch.Tensor | None = None  # (S, 5) cx, y_top, cz, half x, half z
    slab_albedo: torch.Tensor | None = None  # (S,)


def make_scene(
    num_objects: int = 4,
    seed: int = 1,
    half_extent=(4.0, 2.2, 4.0),
    num_tables: int = 0,
    table_height: float = 0.75,
    half_range=((0.12, 0.10, 0.12), (0.35, 0.30, 0.35)),
    z_range=None,
    tex_period: float = 10.0,
    device=None,
) -> Scene:
    """Room with ellipsoid objects resting on the floor (y = +hy, y down).
    With `num_tables` > 0, table slabs `table_height` above the floor are
    placed first, and the first `num_tables` objects rest on them.
    `half_range` bounds the per-axis half-extents; `z_range` overrides the
    forward placement band."""
    dev = resolve_device(device)
    room = make_room(half_extent=half_extent, seed=seed, tex_period=tex_period, device=dev)
    rng = np.random.default_rng(seed + 100)
    hx, hy, hz = half_extent
    if z_range is None:
        z_range = (0.8, hz * 0.9)
    slabs, slab_albedo = [], []
    for _ in range(num_tables):
        cx = rng.uniform(-hx * 0.4, hx * 0.4)
        cz = rng.uniform(1.6, hz * 0.8)
        slabs.append([cx, hy - table_height, cz, rng.uniform(0.7, 1.0), rng.uniform(0.5, 0.8)])
        slab_albedo.append(rng.uniform(90.0, 150.0))
    els, labels, albedo = [], [], []
    for i in range(num_objects):
        half = rng.uniform(half_range[0], half_range[1])
        yaw = rng.uniform(0, np.pi)
        if i < num_tables:  # on table i, inside its footprint
            s = slabs[i]
            x = s[0] + rng.uniform(-0.4, 0.4) * s[3]
            z = s[2] + rng.uniform(-0.4, 0.4) * s[4]
            y = s[1] - half[1]
        else:
            x = rng.uniform(-hx * 0.6, hx * 0.6)
            z = rng.uniform(*z_range)
            y = hy - half[1]  # resting on the floor
        els.append([x, y, z, 0.0, yaw, 0.0, half[0], half[1], half[2]])
        label = i % 3  # tied to an albedo band, a visual correlate
        labels.append(label)
        albedo.append(115.0 + 55.0 * label + rng.uniform(-18.0, 18.0))
    return Scene(
        room=room,
        ellipsoids=torch.from_numpy(np.array(els, np.float32).reshape(-1, 9)).to(dev),
        labels=torch.from_numpy(np.array(labels, np.int32)).to(dev),
        albedo=torch.from_numpy(np.array(albedo, np.float32)).to(dev),
        slabs=torch.from_numpy(np.array(slabs, np.float32).reshape(-1, 5)).to(dev),
        slab_albedo=torch.from_numpy(np.array(slab_albedo, np.float32)).to(dev),
    )


def _ray_ellipsoid(e: torch.Tensor, origin: torch.Tensor, rays: torch.Tensor):
    """Rays (..., 3) from `origin` against ellipsoid e (9,) -> hit distance
    (...,) (inf on a miss) and unit world normals (..., 3)."""
    R = quadric.euler_to_rotmat(e[3:6])
    inv_scale = 1.0 / e[6:9]
    # world -> unit-sphere coordinates: x' = S^-1 R^T (x - c)
    o_l = (R.T @ (origin - e[0:3])) * inv_scale
    d_l = (rays @ R) * inv_scale
    a = torch.sum(d_l * d_l, dim=-1)
    b = 2.0 * (d_l @ o_l)
    c = torch.sum(o_l * o_l) - 1.0
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2 * a)
    t = torch.where((disc > 0.0) & (t0 > 0.05), t0, torch.inf)
    p_l = o_l + d_l * t[..., None]
    n_w = (p_l * inv_scale) @ R.T
    n_w = n_w / torch.clamp(torch.linalg.vector_norm(n_w, dim=-1, keepdim=True), min=1e-9)
    return t, n_w


def render_scene(
    scene: Scene, T_cw, intr: Intrinsics, height: int = 480, width: int = 640
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render (gray, depth, instance id) with the objects composited over
    the room; instance id is -1 on the background."""
    dev = scene.room.textures.device
    if not isinstance(T_cw, torch.Tensor):
        T_cw = torch.from_numpy(np.asarray(T_cw, np.float32))
    T_cw = T_cw.to(dev, torch.float32)
    gray_bg, depth_bg = render_frame(scene.room, T_cw, intr, height, width)
    T_wc = lie.inv_se3(T_cw)
    c_w = T_wc[:3, 3]
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    rays_c = torch.stack(
        [(xx - intr.cx) / intr.fx, (yy - intr.cy) / intr.fy, torch.ones_like(xx)], dim=-1
    )
    rays_w = rays_c @ T_wc[:3, :3].T
    if scene.slabs is not None and scene.slabs.shape[0] > 0:
        # Table tops: the ray meets the plane y = y_top inside the slab.
        ts, gs = [], []
        for (cx, y_top, cz, shx, shz), alb in zip(scene.slabs, scene.slab_albedo):
            dy = rays_w[..., 1]
            t = (y_top - c_w[1]) / torch.where(torch.abs(dy) < 1e-9, 1e-9, dy)
            p = c_w + rays_w * t[..., None]
            inside = (torch.abs(p[..., 0] - cx) < shx) & (torch.abs(p[..., 2] - cz) < shz)
            ts.append(torch.where((t > 0.05) & inside, t, torch.inf))
            gs.append(alb * (0.8 + 0.4 * (0.5 + 0.5 * torch.sin(17.0 * p[..., 0]) * torch.sin(13.0 * p[..., 2]))))
        t_slab, s_best = torch.min(torch.stack(ts), dim=0)
        hit = torch.isfinite(t_slab) & ((t_slab < depth_bg) | (depth_bg <= 0.0))
        gray_bg = torch.where(hit, torch.gather(torch.stack(gs), 0, s_best[None])[0], gray_bg)
        depth_bg = torch.where(hit, t_slab, depth_bg)
    if scene.ellipsoids.shape[0] == 0:
        return gray_bg, depth_bg, torch.full(gray_bg.shape, -1, dtype=torch.int32, device=dev)
    light = torch.tensor([0.4, -0.8, 0.45], dtype=torch.float32, device=dev)
    light = light / torch.linalg.vector_norm(light)
    ts, gs = [], []
    for e, alb, label in zip(scene.ellipsoids, scene.albedo, scene.labels):
        t, n = _ray_ellipsoid(e, c_w, rays_w)
        # Lambert shading and a class-dependent surface ripple (texture on
        # the object, a visual correlate of its label).
        lam = torch.clamp(n @ light, 0.15, 1.0)
        p_w = c_w + rays_w * t[..., None]
        f = 18.0 + 13.0 * label.to(torch.float32)
        ripple = 0.5 + 0.5 * torch.sin(f * p_w[..., 0]) * torch.sin(0.83 * f * p_w[..., 1]) * torch.sin(
            1.26 * f * p_w[..., 2])
        ts.append(t)
        gs.append(alb * lam * (0.75 + 0.45 * ripple))
    t_best, o_best = torch.min(torch.stack(ts), dim=0)
    g_obj = torch.gather(torch.stack(gs), 0, o_best[None])[0]
    hit = torch.isfinite(t_best) & ((t_best < depth_bg) | (depth_bg <= 0.0))
    return (torch.where(hit, g_obj, gray_bg), torch.where(hit, t_best, depth_bg),
            torch.where(hit, o_best.to(torch.int32), -1))


def gt_detections(scene: Scene, T_cw, intr: Intrinsics, width: int = 640, height: int = 480,
                  min_pixels: int = 400, instance=None) -> dict:
    """A detector from the ground truth: each object's projected box,
    clipped to the image, with its label; valid when the object is in
    front and its clipped box exceeds `min_pixels` (prob 0.99, else 0).
    With the `instance` image of `render_scene`, also "mask" (O, H, W)."""
    dev = scene.ellipsoids.device
    if not isinstance(T_cw, torch.Tensor):
        T_cw = torch.from_numpy(np.asarray(T_cw, np.float32))
    T_cw = T_cw.to(dev, torch.float32)
    e = scene.ellipsoids
    bbox = quadric.project_bbox(e, T_cw, intrinsic_matrix(intr, dev))
    lim = (width - 1, height - 1, width - 1, height - 1)
    b = torch.stack([torch.clamp(bbox[:, i], 0, lim[i]) for i in range(4)], dim=-1)
    area = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(b[:, 3] - b[:, 1], min=0)
    valid = quadric.check_observability(e, T_cw) & (area > min_pixels)
    out = {"bbox": b, "label": scene.labels, "prob": torch.where(valid, 0.99, 0.0), "valid": valid}
    if instance is not None:
        ids = torch.arange(e.shape[0], dtype=torch.int32, device=dev)
        out["mask"] = instance.to(dev)[None] == ids[:, None, None]
    return out


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

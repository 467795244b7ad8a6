"""The benchmark's one traffic generator: renders a cell's frames and
detections from a traffic file's parameters.

A frozen copy, rewritten, of the port's synthetic renderer
(`data/render.py`: the textured box room, ray-cast ellipsoid objects,
`gt_detections` with instance masks).  It imports nothing of the
program, so a later change to the program's generators leaves the
benchmark's frames as they are.

The traffic file's "scene" names a module under `scenes/` that places the
room, the objects and the camera's poses (`scenes/room_objects.py`).  The
configuration's sensor (`harness/sensors/`) says what each frame renders:
gray and depth images for RGB-D, a left and a right gray image for
stereo.  Each frame also carries boxes with labels and, with `masks`,
instance masks, from the frame's (left) camera.

The traffic file fixes the whole scene, since the keyframe cadence, and
with it the work of a shape period, follows the texture and the
objects' places: every seed gets the same frames, and the seed moves the
decoder's weights and the sampled frames of a run (`harness/cell.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..reference import geometry as geo
from . import scenes


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    baseline: float = 0.0


class Room(NamedTuple):
    normals: torch.Tensor  # (6, 3) inward
    offsets: torch.Tensor  # (6,) n . p + d = 0
    axes_u: torch.Tensor
    axes_v: torch.Tensor
    textures: torch.Tensor  # (6, T, T)
    tex_period: float


class Scene(NamedTuple):
    room: Room
    ellipsoids: torch.Tensor  # (O, 9) world frame
    labels: torch.Tensor  # (O,) int32
    albedo: torch.Tensor  # (O,)


class Traffic(NamedTuple):
    """What a run feeds the system: `frames[i]` is (a, b, det), numpy on
    the host, as the sensor takes them ((gray, depth, det) for RGB-D);
    `T_cw` (N, 4, 4) float64 the true poses; `ellipsoids` (O, 9) the true
    objects in the world; `depth[i]` the frame's true depth (metres),
    for the comparison only."""

    frames: list
    T_cw: np.ndarray
    ellipsoids: np.ndarray
    labels: np.ndarray
    depth: list


def seeds(seed: int, n: int) -> list[int]:
    """`n` independent 63-bit seeds from one whole number of any size."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n, dtype=np.uint64) >> 1]


def make_room(half_extent, tex_size: int, tex_period: float, rng: np.random.Generator, device) -> Room:
    hx, hy, hz = half_extent

    def band_noise():
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

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Room(
        normals=t([[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]]),
        offsets=t([hx, hx, hy, hy, hz, hz]),
        axes_u=t([[0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]]),
        axes_v=t([[0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 1, 0]]),
        textures=t(np.stack([band_noise() for _ in range(6)])),
        tex_period=float(tex_period),
    )


def _rays(cam: Camera, T_cw: torch.Tensor):
    dev = T_cw.device
    yy = torch.arange(cam.height, dtype=torch.float32, device=dev)[:, None].expand(cam.height, cam.width)
    xx = torch.arange(cam.width, dtype=torch.float32, device=dev)[None, :].expand(cam.height, cam.width)
    rays_c = torch.stack([(xx - cam.cx) / cam.fx, (yy - cam.cy) / cam.fy, torch.ones_like(xx)], dim=-1)
    T_wc = geo.inv_se3(T_cw)
    return T_wc[:3, 3], rays_c @ T_wc[:3, :3].T  # z = 1 rays: the hit parameter is the depth


def _render_room(room: Room, c_w, rays_w):
    denom = rays_w @ room.normals.T
    numer = -(room.normals @ c_w + room.offsets)
    t = numer / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t = torch.where((t > 0.05) & (denom < 0.0), t, torch.inf)
    depth, best = torch.min(t, dim=-1)
    depth = torch.where(torch.isfinite(depth), depth, 0.0)
    hit = c_w + rays_w * depth[..., None]
    T = room.textures.shape[-1]
    scale = T / room.tex_period
    u = torch.remainder(torch.sum(hit * room.axes_u[best], dim=-1) * scale, T - 1.0)
    v = torch.remainder(torch.sum(hit * room.axes_v[best], dim=-1) * scale, T - 1.0)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    fu, fv = u - u0, v - v0

    def samp(vi, ui):
        return room.textures[best, vi.clamp(0, T - 1), ui.clamp(0, T - 1)]

    gray = (samp(v0, u0) * (1 - fu) * (1 - fv) + samp(v0, u0 + 1) * fu * (1 - fv)
            + samp(v0 + 1, u0) * (1 - fu) * fv + samp(v0 + 1, u0 + 1) * fu * fv)
    return gray, depth


def _ray_ellipsoid(e: torch.Tensor, origin, rays):
    R = geo.euler_to_rotmat(e[3:6])
    inv_scale = 1.0 / e[6:9]
    o_l = (R.T @ (origin - e[0:3])) * inv_scale
    d_l = (rays @ R) * inv_scale
    a = torch.sum(d_l * d_l, dim=-1)
    b = 2.0 * (d_l @ o_l)
    c = torch.sum(o_l * o_l) - 1.0
    disc = b * b - 4 * a * c
    t0 = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
    t = torch.where((disc > 0.0) & (t0 > 0.05), t0, torch.inf)
    n_w = ((o_l + d_l * t[..., None]) * inv_scale) @ R.T
    return t, n_w / torch.clamp(torch.linalg.vector_norm(n_w, dim=-1, keepdim=True), min=1e-9)


def render(scene: Scene, T_cw: torch.Tensor, cam: Camera):
    """(gray f32, depth f32 metres, instance id int32 with -1 off objects)."""
    c_w, rays_w = _rays(cam, T_cw)
    gray, depth = _render_room(scene.room, c_w, rays_w)
    light = torch.tensor([0.4, -0.8, 0.45], dtype=torch.float32, device=T_cw.device)
    light = light / torch.linalg.vector_norm(light)
    ts, gs = [], []
    for e, alb, label in zip(scene.ellipsoids, scene.albedo, scene.labels):
        t, n = _ray_ellipsoid(e, c_w, rays_w)
        lam = torch.clamp(n @ light, 0.15, 1.0)
        p_w = c_w + rays_w * torch.where(torch.isfinite(t), t, 0.0)[..., None]
        f = 18.0 + 13.0 * label.to(torch.float32)
        ripple = 0.5 + 0.5 * torch.sin(f * p_w[..., 0]) * torch.sin(0.83 * f * p_w[..., 1]) * torch.sin(
            1.26 * f * p_w[..., 2])
        ts.append(t)
        gs.append(alb * lam * (0.75 + 0.45 * ripple))
    t_best, o_best = torch.min(torch.stack(ts), dim=0)
    g_obj = torch.gather(torch.stack(gs), 0, o_best[None])[0]
    hit = torch.isfinite(t_best) & ((t_best < depth) | (depth <= 0.0))
    return (torch.where(hit, g_obj, gray), torch.where(hit, t_best, depth),
            torch.where(hit, o_best.to(torch.int32), -1))


def detections(scene: Scene, T_cw: torch.Tensor, cam: Camera, min_pixels: float, instance=None) -> dict:
    """A perfect detector: each object's projected box clipped to the
    image with its label, valid when its centre is ahead and the clipped
    box covers more than `min_pixels`; with `instance`, the instance masks
    ("mask" (O, H, W))."""
    e = scene.ellipsoids
    K = geo.intrinsic_matrix(cam.fx, cam.fy, cam.cx, cam.cy, device=e.device)
    box = geo.project_bbox(e, T_cw, K)
    lim = (cam.width - 1, cam.height - 1, cam.width - 1, cam.height - 1)
    b = torch.stack([torch.clamp(box[:, i], 0, lim[i]) for i in range(4)], dim=-1)
    area = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(b[:, 3] - b[:, 1], min=0)
    valid = geo.in_front(e, T_cw) & (area > min_pixels)
    out = {"bbox": b, "label": scene.labels, "prob": torch.where(valid, 0.99, 0.0), "valid": valid}
    if instance is not None:
        out["mask"] = instance[None] == torch.arange(e.shape[0], dtype=torch.int32, device=e.device)[:, None, None]
    return out


def generate(p: dict, cam: Camera, device, sensor) -> Traffic:
    """Render every frame of the traffic file `p` for the camera `cam` as
    the sensor module `sensor` (`harness/sensors/`) takes it."""
    scene, T_cw = scenes.load(p["scene"]).make(p, cam, device)

    def view(T):
        gray, depth, inst = render(scene, T, cam)
        return torch.clamp(gray, 0, 255).to(torch.uint8).cpu().numpy(), depth.cpu().numpy(), inst

    frames, depths = [], []
    for T in T_cw:
        T32 = T.to(device, torch.float32)
        a, b, depth, inst = sensor.render(view, T32, cam)
        det = detections(scene, T32, cam, p["min_box_pixels"], instance=inst if p["masks"] else None)
        frames.append((a, b, {k: v.cpu().numpy() for k, v in det.items()}))
        depths.append(depth)
    return Traffic(frames, T_cw.numpy(), scene.ellipsoids.cpu().numpy().astype(np.float64),
                   scene.labels.cpu().numpy(), depths)

"""Offscreen object renderer: shaded ellipsoids and DeepSDF shapes as a
PNG (counterpart of `qsp_slam_tpu/viz/object_render.py`).

Ellipsoid landmarks are ray-traced in closed form: each pixel ray is
mapped into the unit-sphere frame and intersected there, one quadratic
per pixel and object.  Reconstructed shapes are sphere-traced through the
decoder over a crop around the object's projected box (24 fixed steps),
with normals from central differences of the SDF.  Both give linear depth
and Lambert-shaded colour and composite by the nearest depth.  The PNG is
written by the package's standard-library encoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lie, quadric
from ..core.camera import Intrinsics, intrinsic_matrix
from ..data.make_tum import png_encode
from ..models.deepsdf import decode_sdf, weights

# Label palette (the JAX package's, as its frame drawer uses).
_PALETTE = np.array(
    [(66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88), (171, 71, 188), (0, 172, 193)], np.float32,
) / 255.0
_LIGHT_DIR = np.array([0.4, -0.7, -0.6], np.float32)  # camera frame, toward the scene
_AMBIENT = 0.35


def _unit(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _shade(normal_cam: torch.Tensor, base_rgb: torch.Tensor) -> torch.Tensor:
    """Lambert + ambient in the camera frame. normal (..., 3), rgb (..., 3)."""
    light = torch.from_numpy(_LIGHT_DIR).to(normal_cam.device)
    light = light / torch.linalg.vector_norm(light)
    lam = torch.clamp(-torch.sum(normal_cam * light, dim=-1), 0.0, 1.0)
    return base_rgb * (_AMBIENT + (1.0 - _AMBIENT) * lam)[..., None]


def _palette(label: torch.Tensor) -> torch.Tensor:
    pal = torch.from_numpy(_PALETTE).to(label.device)
    return pal[torch.remainder(label.long(), pal.shape[0])]


def _pixel_ray_grid(H: int, W: int, intr: Intrinsics, device) -> torch.Tensor:
    """Unit camera-frame ray directions through every pixel centre. (H, W, 3)."""
    x = (torch.arange(W, dtype=torch.float32, device=device) + 0.5 - intr.cx) / intr.fx
    y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5 - intr.cy) / intr.fy
    d = torch.stack([x[None, :].expand(H, W), y[:, None].expand(H, W), torch.ones((H, W), device=device)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def render_ellipsoids(ellipsoids, valid, label, Tcw, intr: Intrinsics, H: int, W: int):
    """Ray-trace every ellipsoid (O, 9) -> (depth (H, W), +inf where no
    hit; rgb (H, W, 3)).  In the unit-sphere frame the ray o + t d hits
    where |o + t d| = 1, and the hit point is the normal there."""
    dev = ellipsoids.device
    rays = _pixel_ray_grid(H, W, intr, dev)
    T_wc = lie.inv_se3(Tcw)
    cam_w = T_wc[:3, 3]
    R = quadric.euler_to_rotmat(ellipsoids[:, 3:6])  # (O, 3, 3)
    inv_s = 1.0 / torch.clamp(ellipsoids[:, 6:9], min=1e-6)  # (O, 3)
    o_s = inv_s * torch.einsum("oji,oj->oi", R, cam_w - ellipsoids[:, 0:3])  # (O, 3)
    d_w = rays @ T_wc[:3, :3].T  # (H, W, 3)
    d_s = torch.einsum("hwj,oji->ohwi", d_w, R) * inv_s[:, None, None, :]  # (O, H, W, 3)
    a = torch.sum(d_s * d_s, dim=-1)
    b = 2.0 * torch.sum(d_s * o_s[:, None, None, :], dim=-1)
    c = torch.sum(o_s * o_s, dim=-1)[:, None, None] - 1.0
    disc = b * b - 4.0 * a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(2.0 * a, min=1e-12)
    hit = valid[:, None, None] & (disc > 0.0) & (t > 1e-3)
    p_s = o_s[:, None, None, :] + t[..., None] * d_s
    n_w = _unit(torch.einsum("ohwj,oij->ohwi", p_s * inv_s[:, None, None, :], R))
    n_c = n_w @ Tcw[:3, :3].T
    p_w = cam_w + t[..., None] * d_w
    z = (p_w @ Tcw[:3, :3].T + Tcw[:3, 3])[..., 2]
    depths = torch.where(hit & (z > 0.0), z, torch.inf)
    rgbs = _shade(n_c, _palette(label)[:, None, None, :])
    depth, best = torch.min(depths, dim=0)
    rgb = torch.gather(rgbs, 0, best[None, ..., None].expand(1, H, W, 3))[0]
    return depth, torch.where(torch.isfinite(depth)[..., None], rgb, 0.0)


def render_shape_crop(params, cfg, code, Tow_shape, Tcw, intr: Intrinsics, bbox, label, res: int = 96,
                      steps: int = 24):
    """Sphere-trace the decoder over a res x res crop [x0, y0, x1, y1] of
    the image -> (uv (res, res, 2) pixel coordinates, depth (res, res)
    camera z or +inf, rgb (res, res, 3)).  The march runs in the
    normalized object frame; Tow_shape's scale turns object lengths back
    into metres."""
    dev = code.device
    wb = weights(params, cfg)
    steps_f = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    us = bbox[0] + (bbox[2] - bbox[0]) * steps_f
    vs = bbox[1] + (bbox[3] - bbox[1]) * steps_f
    uv = torch.stack(torch.meshgrid(us, vs, indexing="xy"), dim=-1)
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)

    T_wc = lie.inv_se3(Tcw)
    sR = Tow_shape[:3, :3]
    s = torch.linalg.vector_norm(sR[:, 0])
    o_obj = sR @ T_wc[:3, 3] + Tow_shape[:3, 3]
    d_obj = _unit((d_cam @ T_wc[:3, :3].T) @ sR.T)
    # Enter each ray at the |x|_inf <= 1.1 cube, where the decoder was trained.
    d_safe = torch.where(torch.abs(d_obj) < 1e-9, 1e-9, d_obj)
    t_lo, t_hi = (-1.1 - o_obj) / d_safe, (1.1 - o_obj) / d_safe
    t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    inside = t_far > torch.clamp(t_near, min=0.0)
    t = torch.clamp(t_near, min=0.0)
    for _ in range(steps):
        # Capped steps: tanh compresses large distances.
        sdf = decode_sdf(params, cfg, code, o_obj + t[..., None] * d_obj, wb)
        t = t + torch.clamp(sdf, -0.05, 0.25)
    hit = inside & (torch.abs(sdf) < 0.01) & (t < t_far + 0.05)

    p_obj = o_obj + t[..., None] * d_obj
    offs = torch.eye(3, dtype=torch.float32, device=dev) * 0.01
    n_obj = _unit(torch.stack([decode_sdf(params, cfg, code, p_obj + offs[i], wb)
                               - decode_sdf(params, cfg, code, p_obj - offs[i], wb) for i in range(3)], dim=-1))
    n_c = _unit(n_obj @ sR) @ Tcw[:3, :3].T
    z = (t / torch.clamp(s, min=1e-9)) * d_cam[..., 2]
    depth = torch.where(hit & (z > 0.0), z, torch.inf)
    return uv, depth, _shade(n_c, _palette(label)[None, None, :])


def render_objects_png(path: str | None, objects, Tcw, intr: Intrinsics, H: int, W: int, gray=None,
                       shape_prior: tuple | None = None) -> np.ndarray:
    """Render the object map from camera Tcw; write the PNG to `path`
    (when given) and return the RGB uint8 image.  Every live ellipsoid
    renders; objects with a reconstructed shape are also sphere-traced
    through the decoder, the nearer depth winning each pixel."""
    dev = objects.device
    Tcw = torch.as_tensor(np.asarray(Tcw, np.float32)).to(dev)
    depth, rgb = render_ellipsoids(objects.ellipsoid, objects.valid, objects.label, Tcw, intr, H, W)
    depth, rgb = depth.cpu().numpy(), rgb.cpu().numpy()
    if shape_prior is not None:
        params, cfg = shape_prior[:2]
        K = intrinsic_matrix(intr, dev)
        for o in torch.nonzero((objects.valid & objects.shape_ok).cpu())[:, 0].tolist():
            bb = quadric.project_bbox(objects.ellipsoid[o], Tcw, K).cpu().numpy()
            bb = np.array([max(bb[0] - 5, 0), max(bb[1] - 5, 0), min(bb[2] + 5, W), min(bb[3] + 5, H)], np.float32)
            if bb[2] <= bb[0] or bb[3] <= bb[1]:
                continue
            uv, d_c, rgb_c = (x.cpu().numpy() for x in render_shape_crop(
                params, cfg, objects.code[o], objects.Tow_shape[o], Tcw, intr, torch.from_numpy(bb).to(dev),
                objects.label[o]))
            xi = np.clip(np.round(uv[..., 0]).astype(int), 0, W - 1)
            yi = np.clip(np.round(uv[..., 1]).astype(int), 0, H - 1)
            m = np.isfinite(d_c) & (d_c < depth[yi, xi])
            # Crop samples sharing a pixel: write farthest first, so the
            # nearest lands last (fancy assignment keeps the last write).
            ys, xs, ds, cs = yi[m], xi[m], d_c[m], rgb_c[m]
            order = np.argsort(-ds)
            depth[ys[order], xs[order]] = ds[order]
            rgb[ys[order], xs[order]] = cs[order]
    if gray is not None:
        bg = np.clip(np.asarray(gray, np.float32) / 255.0, 0, 1)[..., None]
        bg = np.broadcast_to(bg, bg.shape[:2] + (3,)).copy()
    else:
        bg = np.full((H, W, 3), 1.0, np.float32)
    out = np.where(np.isfinite(depth)[..., None], 0.25 * bg + 0.75 * rgb, bg)
    img = (np.clip(out, 0, 1) * 255).astype(np.uint8)
    if path:
        with open(path, "wb") as f:
            f.write(png_encode(img))
    return img

"""Depth + box -> ellipsoid extraction, the single-keyframe object estimate
(counterpart of `qsp_slam_tpu/perception/ellipsoid_fit.py`).

Every function is batched over detections: points (D, S, 3), masks
(D, S), boxes (D, 4), planes (4,) or (D, 4).  The pixel draw is split
from the rest: `bbox_sample` gives unit uniforms (D, S, 2) from a
generator, and the deterministic rest scales them into each box as
`jax.random.uniform` does (u * (max - min) + min in one rounding, then at
least min), so a test can feed the reference's draws through `draw`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import quadric
from ..core.camera import Intrinsics, backproject, intrinsic_matrix
from ..utils.tracing import HOST_READS, count


class EllipsoidFitResult(NamedTuple):
    ellipsoid_cam: torch.Tensor  # (D, 9) minimal vectors, camera frame
    prob: torch.Tensor  # (D,) IoU of the projected box against the detection
    ok: torch.Tensor  # (D,) bool, enough supporting points
    num_points: torch.Tensor  # (D,) int


Draw = Callable[["torch.Generator | None", int, int], torch.Tensor]


def bbox_sample(gen: torch.Generator | None, num_det: int, num_samples: int = 1024) -> torch.Tensor:
    """Unit uniforms (D, S, 2) for the (u, v) pixel draw of each detection,
    on the generator's device."""
    dev = gen.device if gen is not None else None
    return torch.rand((num_det, num_samples, 2), generator=gen, device=dev)


def jax_linspace(start: float, stop: float, num: int, endpoint: bool = True) -> torch.Tensor:
    """f32 grid equal bit for bit to the reference's compiled
    `jnp.linspace`: XLA folds start * (1 - s) + stop * s, s = i / div, into
    start * (1 - i * r) + (stop * r) * i with r = f32(1 / div)."""
    div = num - 1 if endpoint else num
    f32 = np.float32
    i = np.arange(div, dtype=f32)
    r = f32(1.0 / div)
    a, b = f32(start), f32(stop)
    out = a * (f32(1.0) - i * r) + (b * r) * i
    if endpoint:
        out = np.concatenate([out, [b]])
    return torch.from_numpy(out.astype(f32))


def _scaled(unit: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """unit * (hi - lo) + lo rounded once (the reference's fused multiply-
    add; the f64 product of two f32 is exact), then at least lo."""
    x = unit.double() * (hi - lo).double() + lo.double()
    return torch.maximum(x.to(unit.dtype), lo)


def sample_bbox_depth_points(
    depth: torch.Tensor,  # (H, W)
    bbox: torch.Tensor,  # (D, 4)
    intr: Intrinsics,
    gen: torch.Generator | None,
    num_samples: int = 1024,
    depth_min: float = 0.1,
    depth_max: float = 8.0,
    draw: Draw = bbox_sample,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Back-project a uniform pixel sample inside each box -> (pts (D, S, 3),
    valid (D, S))."""
    H, W = depth.shape
    count(HOST_READS)  # the draw's copy from host memory waits for the card
    unit = draw(gen, bbox.shape[0], num_samples).to(depth.device)
    u = _scaled(unit[..., 0], bbox[:, 0:1], bbox[:, 2:3])
    v = _scaled(unit[..., 1], bbox[:, 1:2], bbox[:, 3:4])
    ui = torch.clamp(torch.round(u).to(torch.int32), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int32), 0, H - 1)
    z = depth[vi.long(), ui.long()]
    pts = backproject(torch.stack([ui, vi], dim=-1).to(depth.dtype), z, intr)
    return pts, (z > depth_min) & (z < depth_max)


def _take(srt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """srt (..., S) at per-row index idx (...) -> (...)."""
    return torch.gather(srt, -1, idx.long()[..., None])[..., 0]


def core_mask(
    pts: torch.Tensor,  # (..., S, 3)
    valid: torch.Tensor,  # (..., S)
    ground_plane_cam: torch.Tensor,  # (..., 4)
    ground_margin: float = 0.03,
) -> torch.Tensor:
    """Object core: off the supporting plane, within median +- max(3 MAD,
    0.05) per axis (the masked medians index a sort with +inf padding)."""
    g = ground_plane_cam[..., None, :]
    gdist = torch.sum(pts * g[..., :3], dim=-1) + g[..., 3]
    valid = valid & (gdist > ground_margin)
    S = pts.shape[-2]
    mid = torch.clamp((torch.sum(valid, dim=-1) - 1) // 2, 0, S - 1)

    def masked_median(x):
        return _take(torch.sort(torch.where(valid, x, torch.inf), dim=-1).values, mid)

    med = torch.stack([masked_median(pts[..., i]) for i in range(3)], dim=-1)
    mad = torch.stack([masked_median(torch.abs(pts[..., i] - med[..., i:i + 1])) for i in range(3)], dim=-1)
    band = torch.clamp(3.0 * mad, min=0.05)
    return valid & torch.all(torch.abs(pts - med[..., None, :]) < band[..., None, :], dim=-1)


def fit_ellipsoid_depth(
    depth: torch.Tensor,  # (H, W)
    bbox: torch.Tensor,  # (D, 4)
    ground_plane_cam: torch.Tensor,  # (4,) or (D, 4)
    intr: Intrinsics,
    gen: torch.Generator | None,
    num_samples: int = 1024,
    num_yaw: int = 36,
    depth_min: float = 0.1,
    depth_max: float = 8.0,
    ground_margin: float = 0.03,
    min_points: int = 50,
    draw: Draw = bbox_sample,
) -> EllipsoidFitResult:
    """Ellipsoid fit of each detection from a dense depth image."""
    pts, valid = sample_bbox_depth_points(depth, bbox, intr, gen, num_samples, depth_min, depth_max, draw=draw)
    return fit_ellipsoid_points(pts, valid, bbox, ground_plane_cam, intr, num_yaw=num_yaw,
                                ground_margin=ground_margin, min_points=min_points)


def fit_ellipsoid_points(
    pts: torch.Tensor,  # (D, S, 3) camera-frame candidate points
    valid: torch.Tensor,  # (D, S)
    bbox: torch.Tensor,  # (D, 4) detection boxes (for the IoU score)
    ground_plane_cam: torch.Tensor,  # (4,) or (D, 4)
    intr: Intrinsics,
    num_yaw: int = 36,
    ground_margin: float = 0.03,
    min_points: int = 50,
) -> EllipsoidFitResult:
    """Core fit from explicit point sets (dense samples, stereo keypoints):
    the core cluster, a gravity-aligned frame whose yaw minimizes the
    footprint box (the first of `num_yaw` yaws in [0, pi/2]), 5-95th
    percentile extents, and the vertical extent completed down to the
    supporting plane."""
    D, S = valid.shape
    dt, dev = pts.dtype, pts.device
    g = ground_plane_cam.expand(D, 4)
    gdist = torch.sum(pts * g[:, None, :3], dim=-1) + g[:, 3:4]
    core = core_mask(pts, valid, g, ground_margin)
    n_core = torch.sum(core, dim=-1)

    up = g[:, :3] / torch.linalg.vector_norm(g[:, :3], dim=-1, keepdim=True)
    count(HOST_READS, 3)  # ex, ey and the yaws below are copies from host memory: each waits for the card
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
    a = torch.where(torch.abs(up[:, 0:1]) < 0.9, ex, ey)
    x0 = a - up * torch.sum(a * up, dim=-1, keepdim=True)
    x0 = x0 / torch.linalg.vector_norm(x0, dim=-1, keepdim=True)
    y0 = torch.linalg.cross(up, x0, dim=-1)

    w = core.to(dt)
    ctr = torch.sum(pts * w[..., None], dim=1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)[:, None]
    rel = pts - ctr[:, None, :]
    px = torch.sum(rel * x0[:, None], dim=-1)
    py = torch.sum(rel * y0[:, None], dim=-1)
    pz = torch.sum(rel * up[:, None], dim=-1)

    yaws = jax_linspace(0.0, np.pi / 2, num_yaw).to(dev)
    c, s = torch.cos(yaws)[None, :, None], torch.sin(yaws)[None, :, None]  # (1, Y, 1)
    qx = c * px[:, None] + s * py[:, None]  # (D, Y, S)
    qy = -s * px[:, None] + c * py[:, None]
    m = core[:, None]

    def ext(q):
        return torch.amax(torch.where(m, q, -torch.inf), dim=-1) - torch.amin(torch.where(m, q, torch.inf), dim=-1)

    areas = ext(qx) * ext(qy)  # (D, Y)
    best_yaw = yaws[torch.argmin(areas, dim=-1)]
    c, s = torch.cos(best_yaw)[:, None], torch.sin(best_yaw)[:, None]
    ax = c * x0 + s * y0
    ay = -s * x0 + c * y0
    R_co = torch.stack([ax, ay, up], dim=-1)  # object axes (columns) in the camera frame

    q = torch.stack([torch.sum(rel * ax[:, None], dim=-1), torch.sum(rel * ay[:, None], dim=-1), pz], dim=-1)
    cnt = torch.clamp(n_core, min=1)
    srt = torch.sort(torch.where(core[..., None], q, torch.inf), dim=1).values  # (D, S, 3)
    lo_i = torch.clamp(cnt * 5 // 100, 0, S - 1)
    hi_i = torch.clamp(cnt * 95 // 100, 0, S - 1)
    los = torch.gather(srt, 1, lo_i.long()[:, None, None].expand(D, 1, 3))[:, 0]
    his = torch.gather(srt, 1, hi_i.long()[:, None, None].expand(D, 1, 3))[:, 0]
    half = torch.clamp((his - los) * 0.5, min=0.02)
    center = ctr + torch.einsum("dij,dj->di", R_co, (his + los) * 0.5)

    # The vertical extent from the supporting plane up to the 95th-
    # percentile height (depth sees only the upper and front surface).
    gh = torch.sort(torch.where(core, gdist, -torch.inf), dim=-1).values
    h_top = _take(gh, torch.clamp(S - cnt + cnt * 95 // 100, 0, S - 1))
    half_up = torch.clamp(h_top * 0.5, min=0.02)
    g_center = torch.sum(center * g[:, :3], dim=-1) + g[:, 3]
    center = center + up * (half_up - g_center)[:, None]
    half = torch.cat([half[:, :2], half_up[:, None]], dim=-1)
    e_cam = torch.cat([center, quadric.rotmat_to_euler(R_co), half], dim=-1)

    proj = quadric.project_bbox(e_cam, torch.eye(4, dtype=dt, device=dev), intrinsic_matrix(intr, dev))
    prob = quadric.bbox_iou(proj, bbox)
    ok = (n_core >= min_points) & torch.isfinite(prob)
    return EllipsoidFitResult(ellipsoid_cam=e_cam, prob=torch.where(ok, prob, 0.0), ok=ok, num_points=n_core)

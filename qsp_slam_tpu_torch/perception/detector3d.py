"""Learned 3D object detector, PointPillars-class (counterpart of
`qsp_slam_tpu/perception/detector3d.py`).

- Pillar encoder: a per-point MLP (two dense products) and a per-pillar
  max-pool as one scatter-max (`scatter_reduce(..., "amax")`) into a dense
  bird's-eye-view canvas with a dump row for invalid points.  Features
  are ReLU outputs, so an empty pillar's identity is the zero vector.
- BEV backbone: a stride-2 stem and a dilated residual trunk (cuDNN
  convolutions, XLA's "SAME" padding as in `detector2d.same_conv`).
- CenterPoint-style head: class heatmap, sub-cell offset, height, log
  size and yaw as (sin 2t, cos 2t); decoding is the 2D detector's peak NMS
  and tie-ordered top-k.

Everything is in the camera frame (x right, y down, z forward); the BEV
grid spans (x, z).  Training scans are procedural (`synth_scan`): cars on
the ground, ground returns and non-car clutter.  As every sampler of the
port, `synth_scan` is a draw (`scan_sample`: every uniform and normal it
takes, from a CPU generator, so the card draws what the CPU draws) and a
deterministic rest; tests feed the JAX package's draws through `draw=`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import quadric
from .detector2d import adam, focal_loss, he_init, params_from_numpy, params_to_numpy, peak_topk, same_conv, \
    scatter_max_cells

HEADS = ("hm", "off", "ycen", "sz", "yaw")


class Detector3DConfig(NamedTuple):
    grid: int = 128           # BEV cells per side (z forward, x lateral)
    cell: float = 0.325       # meters per BEV cell
    x_min: float = -20.8      # lateral extent: [x_min, x_min + grid*cell]
    z_min: float = 0.0        # forward extent: [z_min, z_min + grid*cell]
    y_range: tuple = (-3.0, 2.2)  # vertical gate (camera y, down-positive)
    ground_y: float = 1.65    # ground height below the camera (training scenes)
    channels: int = 32        # pillar feature width
    widths: tuple = (32, 48)  # backbone widths after the stride-2 stem
    num_classes: int = 1      # car
    max_det: int = 8
    score_thr: float = 0.3


class Boxes3D(NamedTuple):
    """Decoded 7-DoF boxes in the camera frame."""

    center: torch.Tensor  # (D, 3)
    size: torch.Tensor    # (D, 3) full extents along local (x, y, z) at yaw 0
    yaw: torch.Tensor     # (D,) rotation about camera y (mod pi)
    label: torch.Tensor   # (D,) int32
    prob: torch.Tensor    # (D,)
    valid: torch.Tensor   # (D,) bool


def param_shapes(cfg: Detector3DConfig) -> dict:
    """Weight shapes in the JAX package's layout (dense (in, out), conv
    HWIO), in its order."""
    C = cfg.channels
    w0, w1 = cfg.widths
    return {
        "p1": (6, C),          # point MLP (dense)
        "p2": (C, C),
        "c1": (3, 3, C, w0),   # stride-2 stem
        "c2": (3, 3, w0, w1),
        "c3": (3, 3, w1, w1),  # dilation 2
        "c4": (3, 3, w1, w1),  # dilation 4
        "hm": (1, 1, w1, cfg.num_classes),
        "off": (1, 1, w1, 2),  # sub-cell (dx, dz) of the centre
        "ycen": (1, 1, w1, 1),
        "sz": (1, 1, w1, 3),   # log full extents
        "yaw": (1, 1, w1, 2),  # (sin 2t, cos 2t)
    }


def init_detector3d(gen: torch.Generator, cfg: Detector3DConfig, device=None) -> dict:
    return he_init(gen, param_shapes(cfg), cfg.num_classes, device)


# ---------------------------------------------------------------------------
# Pillar encoder and network
# ---------------------------------------------------------------------------

def pillar_canvas(params: dict, cfg: Detector3DConfig, pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Points (N, 3) + valid (N,) -> BEV canvas (grid, grid, C): per point
    the offsets to its pillar's centre, its height above the ground and
    its normalised position through the MLP, max-pooled per pillar.
    Invalid and out-of-range points go to a dump row that is dropped."""
    G, cell = cfg.grid, cfg.cell
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    fx = (x - cfg.x_min) / cell
    fz = (z - cfg.z_min) / cell
    ix = torch.floor(fx).to(torch.int32)
    iz = torch.floor(fz).to(torch.int32)
    ok = valid & (ix >= 0) & (ix < G) & (iz >= 0) & (iz < G) & (y > cfg.y_range[0]) & (y < cfg.y_range[1])
    span = G * cell
    feats_in = torch.stack([
        fx - ix.to(torch.float32) - 0.5,
        fz - iz.to(torch.float32) - 0.5,
        (cfg.ground_y - y) / 2.0,
        (x - cfg.x_min) / span - 0.5,
        (z - cfg.z_min) / span - 0.5,
        torch.ones_like(x),
    ], dim=-1)
    h = F.relu(feats_in @ params["p1_w"] + params["p1_b"])
    h = F.relu(h @ params["p2_w"] + params["p2_b"])
    flat = torch.where(ok, iz.to(torch.int64) * G + ix, G * G)
    canvas = torch.zeros((G * G + 1, cfg.channels), dtype=h.dtype, device=h.device)
    canvas = canvas.scatter_reduce(0, flat[:, None].expand(-1, cfg.channels), h, "amax", include_self=True)
    return canvas[: G * G].reshape(G, G, cfg.channels)


def forward(params: dict, cfg: Detector3DConfig, pts, valid):
    """Scan -> (hm, off, ycen, sz, yaw) on the stride-2 BEV grid, channels
    last (ycen (Gs, Gs))."""
    p = params
    x = pillar_canvas(p, cfg, pts, valid).permute(2, 0, 1)[None]
    x = F.relu(same_conv(x, p["c1_w"], p["c1_b"], stride=2))
    x = F.relu(same_conv(x, p["c2_w"], p["c2_b"]))
    x = F.relu(same_conv(x, p["c3_w"], p["c3_b"], dilation=2) + x)
    x = F.relu(same_conv(x, p["c4_w"], p["c4_b"], dilation=4) + x)
    hm, off, ycen, sz, yaw = (same_conv(x, p[h + "_w"], p[h + "_b"])[0].permute(1, 2, 0) for h in HEADS)
    return hm, off, ycen[..., 0], sz, yaw


def detect_objects_3d(params: dict, cfg: Detector3DConfig, pts, valid) -> Boxes3D:
    """One scan -> a fixed budget of 7-DoF boxes (peak NMS + top-k)."""
    hm, off, ycen, sz, yaw = forward(params, cfg, pts, valid)
    scores, cls, iz, ix = peak_topk(hm, cfg.max_det)
    s = 2 * cfg.cell  # head stride in meters
    o = off[iz, ix]
    cx = cfg.x_min + (ix.to(torch.float32) + 0.5 + o[:, 0]) * s
    cz = cfg.z_min + (iz.to(torch.float32) + 0.5 + o[:, 1]) * s
    cy = cfg.ground_y - ycen[iz, ix] * 2.0
    yv = yaw[iz, ix]
    return Boxes3D(center=torch.stack([cx, cy, cz], -1), size=torch.exp(sz[iz, ix]),
                   yaw=0.5 * torch.atan2(yv[:, 0], yv[:, 1]), label=cls, prob=scores, valid=scores > cfg.score_thr)


def boxes_to_ellipsoids(boxes: Boxes3D) -> torch.Tensor:
    """7-DoF boxes -> camera-frame minimal 9-vectors in a z-up object frame
    (the object priors take the landmark's local z as the vertical):
    R = [x_yaw, z x x_yaw, (0, -1, 0)], half-axes (length, width, height)/2."""
    ct, st = torch.cos(boxes.yaw), torch.sin(boxes.yaw)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    x_col = torch.stack([ct, zero, -st], -1)       # long axis, horizontal
    z_col = torch.stack([zero, -one, zero], -1)    # up (camera y is down)
    y_col = torch.linalg.cross(z_col, x_col, dim=-1)
    R = torch.stack([x_col, y_col, z_col], -1)     # columns
    half = torch.stack([boxes.size[:, 0], boxes.size[:, 2], boxes.size[:, 1]], -1) * 0.5
    return torch.cat([boxes.center, quadric.rotmat_to_euler(R), half], dim=-1)


# ---------------------------------------------------------------------------
# Training targets and loss
# ---------------------------------------------------------------------------

def _targets(cfg: Detector3DConfig, center, size, yaw, bvalid):
    """Gaussian BEV heatmap (a full 1 at each centre cell) and the
    regression targets at the centre cells."""
    G2 = cfg.grid // 2
    s = 2 * cfg.cell
    dev = center.device
    zs = torch.arange(G2, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(G2, dtype=torch.float32, device=dev)[None, :]
    fx = (center[:, 0] - cfg.x_min) / s - 0.5
    fz = (center[:, 2] - cfg.z_min) / s - 0.5
    bev_w = torch.clamp(torch.minimum(size[:, 0], size[:, 2]) / s, min=1e-3)
    sigma = torch.clamp(bev_w / 6.0, min=0.8)
    g = torch.exp(-((xs - fx[:, None, None]) ** 2 + (zs - fz[:, None, None]) ** 2) / (2 * sigma[:, None, None] ** 2))
    hm_t = torch.amax(torch.where(bvalid[:, None, None], g, 0.0), dim=0)[..., None]
    ix = torch.clamp(torch.round(fx).to(torch.int32), 0, G2 - 1)
    iz = torch.clamp(torch.round(fz).to(torch.int32), 0, G2 - 1)
    hm_t = scatter_max_cells(hm_t, (iz, ix, torch.zeros_like(ix)), bvalid.to(torch.float32))
    off_t = torch.stack([fx - ix, fz - iz], -1)
    ycen_t = (cfg.ground_y - center[:, 1]) / 2.0
    sz_t = torch.log(torch.clamp(size, min=1e-3))
    yaw_t = torch.stack([torch.sin(2 * yaw), torch.cos(2 * yaw)], -1)
    return hm_t, (iz, ix, off_t, ycen_t, sz_t, yaw_t)


def detector3d_loss(params, cfg: Detector3DConfig, pts, pvalid, center, size, yaw, bvalid) -> torch.Tensor:
    hm, off, ycen, sz, yw = forward(params, cfg, pts, pvalid)
    hm_t, (iz, ix, off_t, ycen_t, sz_t, yaw_t) = _targets(cfg, center, size, yaw, bvalid)
    iz, ix = iz.long(), ix.long()
    w = bvalid.to(torch.float32)
    nw = torch.clamp(w.sum(), min=1.0)
    l_off = torch.sum(torch.abs(off[iz, ix] - off_t).sum(-1) * w) / nw
    l_y = torch.sum(torch.abs(ycen[iz, ix] - ycen_t) * w) / nw
    l_sz = torch.sum(torch.abs(sz[iz, ix] - sz_t).sum(-1) * w) / nw
    l_yaw = torch.sum(torch.abs(yw[iz, ix] - yaw_t).sum(-1) * w) / nw
    return focal_loss(hm, hm_t) + l_off + l_y + l_sz + l_yaw


# ---------------------------------------------------------------------------
# Procedural training scans: a draw and a deterministic rest
# ---------------------------------------------------------------------------

CLUTTER = 4  # clutter structures per scan (poles and wall slabs)


def scan_sample(gen: torch.Generator | None, max_boxes: int = 4, pts_per_box: int = 384, ground_pts: int = 4096,
                clutter_pts: int = 1024) -> dict:
    """Every number `synth_scan` draws, from `gen` on the CPU: unit
    uniforms in [0, 1) and standard normals, named by what they become."""
    B, W, cp = max_boxes, CLUTTER, clutter_pts // CLUTTER
    n = B * pts_per_box + ground_pts + W * cp

    def u(*shape):
        return torch.rand(shape, generator=gen)

    out = {k: u(B) for k in ("cx", "cz", "length", "width", "height", "theta", "bvalid")}
    out["cube"] = u(B, pts_per_box, 3)
    out["gx"], out["gz"] = u(ground_pts), u(ground_pts)
    out["gy"] = torch.randn(ground_pts, generator=gen)
    out.update({k: u(W) for k in ("wx", "wz", "is_wall", "sx", "sy")})
    out["off"] = u(W, cp, 3)
    out["noise"] = torch.randn((n, 3), generator=gen)
    return out


def _between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jax.random.uniform(..., minval=lo, maxval=hi)` of the unit draw u."""
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo_t.to(u.device), u * (hi_t - lo_t).to(u.device) + lo_t.to(u.device))


def synth_scan(gen: torch.Generator | None, cfg: Detector3DConfig, max_boxes: int = 4, pts_per_box: int = 384,
               ground_pts: int = 4096, clutter_pts: int = 1024, device=None, draw=scan_sample):
    """One LiDAR-like scan: cars on the ground (box surface points), ground
    returns and clutter (thin poles and wall slabs).
    -> (pts (N, 3), valid (N,), gt {center, size, yaw, valid}) on `device`."""
    dev = resolve_device(device)
    d = {k: v.to(dev) for k, v in draw(gen, max_boxes, pts_per_box, ground_pts, clutter_pts).items()}
    B = max_boxes
    x_hi, z_hi = cfg.x_min + cfg.grid * cfg.cell, cfg.z_min + cfg.grid * cfg.cell
    cx = _between(d["cx"], cfg.x_min + 4.0, x_hi - 4.0)
    cz = _between(d["cz"], cfg.z_min + 4.0, z_hi - 4.0)
    length = _between(d["length"], 3.2, 4.8)
    width = _between(d["width"], 1.6, 2.0)
    height = _between(d["height"], 1.4, 1.8)
    theta = _between(d["theta"], 0.0, np.pi)
    bvalid = d["bvalid"] < 0.8
    center = torch.stack([cx, cfg.ground_y - height / 2.0, cz], -1)
    size = torch.stack([length, height, width], -1)  # local x = long axis

    # Box surface points: a cube sample pushed out to its dominant face.
    u = _between(d["cube"], -1.0, 1.0)
    dom = torch.argmax(torch.abs(u), dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(u, -1, dom))
    on_face = torch.arange(3, device=dev) == dom
    local = torch.where(on_face, sign * torch.ones_like(u), u) * (size[:, None, :] * 0.5)
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    px = ct * local[:, :, 0] + st * local[:, :, 2]
    pz = -st * local[:, :, 0] + ct * local[:, :, 2]
    box_pts = (torch.stack([px, local[:, :, 1], pz], -1) + center[:, None, :]).reshape(-1, 3)
    box_ok = torch.repeat_interleave(bvalid, pts_per_box)

    gnd = torch.stack([_between(d["gx"], cfg.x_min, x_hi), cfg.ground_y + 0.03 * d["gy"],
                       _between(d["gz"], cfg.z_min, z_hi)], -1)

    wx = _between(d["wx"], cfg.x_min + 2.0, x_hi - 2.0)
    wz = _between(d["wz"], cfg.z_min + 2.0, z_hi - 2.0)
    is_wall = d["is_wall"] < 0.5
    sx = torch.where(is_wall, _between(d["sx"], 6.0, 10.0), 0.3)[:, None]
    szc = torch.where(is_wall, 0.25, 0.3)[:, None]
    sy = _between(d["sy"], 2.2, 3.5)[:, None]
    off = _between(d["off"], -0.5, 0.5)
    cl = torch.stack([wx[:, None] + off[:, :, 0] * sx, cfg.ground_y - off[:, :, 1] * sy - sy * 0.25,
                      wz[:, None] + off[:, :, 2] * szc], -1).reshape(-1, 3)

    pts = torch.cat([box_pts, gnd, cl], 0)
    valid = torch.cat([box_ok, torch.ones(ground_pts + cl.shape[0], dtype=torch.bool, device=dev)])
    gt = {"center": center, "size": size, "yaw": theta, "valid": bvalid}
    return pts + 0.02 * d["noise"], valid, gt


def train_detector3d(seed: int, cfg: Detector3DConfig = Detector3DConfig(), steps: int = 800, lr: float = 1e-3,
                     device=None, params: dict | None = None, draw=scan_sample):
    """Adam under the cosine schedule on one fresh procedural scan per
    update.  `seed` seeds the init and the scans' CPU generator; `params`
    replaces the init and `draw` the scans' draws (tests feed the JAX
    package's).  -> (params, losses (list of floats))."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = init_detector3d(gen, cfg, dev)
    params = {k: v.detach().clone().to(dev) for k, v in params.items()}
    opt, sched = adam(params, lr, steps)
    losses = []
    for _ in range(steps):
        pts, pvalid, gt = synth_scan(gen, cfg, device=dev, draw=draw)
        loss = detector3d_loss(params, cfg, pts, pvalid, gt["center"], gt["size"], gt["yaw"], gt["valid"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
    return {k: v.detach() for k, v in params.items()}, torch.stack(losses).cpu().tolist() if losses else []


# ---------------------------------------------------------------------------
# The detection dict of a scan, and weights on disk
# ---------------------------------------------------------------------------

BOX_CORNERS = [[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)]


def lidar_detections_learned(params: dict, cfg: Detector3DConfig, pts_cam, intr, width: int, height: int,
                             budget: int = 32768) -> dict:
    """Scan (N, 3) in the camera frame -> the detection dict (numpy) with
    learned 3D boxes, on the params' device.  Beyond the 2D keys it holds
    `ellipsoid_cam` (D, 9) and `fit_ok` (D,), which seed the objects from
    the boxes instead of a fit.  Scans are padded or truncated to
    `budget` points; a detection is valid when its box is confident, its
    centre lies ahead (z > 1 m) and inside the image, and its projection
    spans more than 8 x 6 pixels."""
    dev = params["p1_w"].device
    pts_np = np.zeros((budget, 3), np.float32)
    n = min(len(pts_cam), budget)
    pts_np[:n] = np.asarray(pts_cam, np.float32)[:n]
    pts = torch.from_numpy(pts_np).to(dev)
    boxes = detect_objects_3d(params, cfg, pts, torch.arange(budget, device=dev) < n)
    e_cam = boxes_to_ellipsoids(boxes)

    corners = torch.tensor(BOX_CORNERS, dtype=torch.float32, device=dev)
    ct, st = torch.cos(boxes.yaw)[:, None], torch.sin(boxes.yaw)[:, None]
    local = corners[None] * boxes.size[:, None, :]
    px = ct * local[:, :, 0] + st * local[:, :, 2]
    pz = -st * local[:, :, 0] + ct * local[:, :, 2]
    cam = torch.stack([px, local[:, :, 1], pz], -1) + boxes.center[:, None, :]
    z = torch.clamp(cam[:, :, 2], min=0.2)
    u = intr.fx * cam[:, :, 0] / z + intr.cx
    v = intr.fy * cam[:, :, 1] / z + intr.cy
    bbox = torch.stack([
        torch.clamp(u.amin(1), 0, width - 1.0),
        torch.clamp(v.amin(1), 0, height - 1.0),
        torch.clamp(u.amax(1), 0, width - 1.0),
        torch.clamp(v.amax(1), 0, height - 1.0),
    ], -1)
    zc = torch.clamp(boxes.center[:, 2], min=0.2)
    uc = intr.fx * boxes.center[:, 0] / zc + intr.cx
    vc = intr.fy * boxes.center[:, 1] / zc + intr.cy
    in_view = ((boxes.center[:, 2] > 1.0) & (uc >= 0) & (uc < width) & (vc >= 0) & (vc < height)
               & (bbox[:, 2] - bbox[:, 0] > 8.0) & (bbox[:, 3] - bbox[:, 1] > 6.0))
    valid = boxes.valid & in_view
    return {
        "bbox": bbox.cpu().numpy(),
        "label": boxes.label.cpu().numpy().astype(np.int32),
        "prob": torch.where(valid, boxes.prob, 0.0).cpu().numpy(),
        "valid": valid.cpu().numpy(),
        "ellipsoid_cam": e_cam.cpu().numpy(),
        "fit_ok": valid.cpu().numpy(),
    }


def save_detector3d(path: str, params: dict, cfg: Detector3DConfig) -> None:
    np.savez(
        path,
        __cfg__=np.asarray([cfg.grid, cfg.cell, cfg.x_min, cfg.z_min, *cfg.y_range, cfg.ground_y, cfg.channels,
                            *cfg.widths, cfg.num_classes, cfg.max_det, cfg.score_thr], np.float64),
        **params_to_numpy(params),
    )


def load_detector3d(path: str, device=None):
    """-> (params on `device`, Detector3DConfig)."""
    with np.load(path) as z:
        c = z["__cfg__"]
        cfg = Detector3DConfig(
            grid=int(c[0]), cell=float(c[1]), x_min=float(c[2]), z_min=float(c[3]), y_range=(float(c[4]), float(c[5])),
            ground_y=float(c[6]), channels=int(c[7]), widths=(int(c[8]), int(c[9])), num_classes=int(c[10]),
            max_det=int(c[11]), score_thr=float(c[12]),
        )
        params = params_from_numpy({k: z[k] for k in z.files if k != "__cfg__"}, device)
    return params, cfg

"""Fabricate a TUM-RGB-D-format sequence from the synthetic renderer
(counterpart of `qsp_slam_tpu/data/make_tum.py`): `rgb/` 8-bit and
`depth/` 16-bit gray PNGs at the TUM depth scale, `rgb.txt`, `depth.txt`
and `groundtruth.txt`, which `run_tum`, `run_mono` and `TumSequence`
read.  The scene is `make_scene(num_objects, seed)`, the JAX package's;
with `--detections`, `detections/<frame>.npz` holds each frame's
ground-truth detections with instance masks (the replay seam `run_mono
--detections` reads).  PNGs are written by a small standard-library
encoder (zlib, filter 0), so no imaging package is needed.

    python -m qsp_slam_tpu_torch.data.make_tum OUT_DIR [--frames 640] [--objects N]
        [--step 0.01] [--pitch 0.35] [--seed 1] [--detections]
        [--distort K1,K2,P1,P2,K3] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..core.camera import undistort_points
from ..slam.tracking import TrackingConfig
from .io import save_detection_cache
from .render import gt_detections, make_scene, orbit_trajectory, render_scene
from .tum import DEPTH_SCALE


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def png_encode(img: np.ndarray) -> bytes:
    """A PNG with filter 0 rows: gray (H, W) uint8 -> 8-bit, uint16 ->
    16-bit; RGB (H, W, 3) uint8 -> 8-bit truecolor."""
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[img.dtype]
    h, w = img.shape[:2]
    color = {2: 0, 3: 2}[img.ndim]  # PNG color types: gray, truecolor
    rows = np.ascontiguousarray(img).astype(img.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _distortion_warp(cfg: TrackingConfig, distort, device):
    """I_d(p) = I_ideal(undistort(p)): gray bilinear, depth nearest (depth
    must not blend across edges); outside the ideal image both are 0."""
    H, W = cfg.height, cfg.width
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    src = undistort_points(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1), cfg.intr, distort)
    sx, sy = src[:, 0], src[:, 1]
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    x0 = torch.clamp(torch.floor(sx).long(), 0, W - 2)
    y0 = torch.clamp(torch.floor(sy).long(), 0, H - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    xn = torch.clamp(torch.round(sx).long(), 0, W - 1)
    yn = torch.clamp(torch.round(sy).long(), 0, H - 1)

    def warp(gray, depth):
        g = (gray[y0, x0] * (1 - fx) * (1 - fy) + gray[y0, x0 + 1] * fx * (1 - fy)
             + gray[y0 + 1, x0] * (1 - fx) * fy + gray[y0 + 1, x0 + 1] * fx * fy)
        g = torch.where(inside, g, 0.0).reshape(H, W)
        d = torch.where(inside, depth[yn, xn], 0.0).reshape(H, W)
        return g, d

    return warp


def make_sequence(out_dir: str, num_frames: int = 640, num_objects: int = 0, step: float = 0.01,
                  pitch: float = 0.35, seed: int = 1, with_detections: bool = False,
                  fps: float = 30.0, distort: tuple | None = None, device=None) -> None:
    dev = resolve_device(device)
    cfg = TrackingConfig()
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    warp = None
    if distort is not None and any(c != 0.0 for c in distort):
        warp = _distortion_warp(cfg, distort, dev)
        k1, k2, p1, p2, k3 = (float(c) for c in distort)
        with open(os.path.join(out_dir, "calib.yaml"), "w") as f:
            f.write("# fabricated sequence calibration (with lens distortion)\n"
                    f"Camera.fx: {cfg.fx}\nCamera.fy: {cfg.fy}\n"
                    f"Camera.cx: {cfg.cx}\nCamera.cy: {cfg.cy}\n"
                    f"Camera.width: {cfg.width}\nCamera.height: {cfg.height}\n"
                    f"Camera.k1: {k1}\nCamera.k2: {k2}\n"
                    f"Camera.p1: {p1}\nCamera.p2: {p2}\nCamera.k3: {k3}\n")
    scene = make_scene(num_objects=max(num_objects, 1), seed=seed, device=dev)
    if num_objects == 0:
        scene = scene._replace(ellipsoids=scene.ellipsoids[:0], labels=scene.labels[:0], albedo=scene.albedo[:0])
    det_dir = os.path.join(out_dir, "detections")
    if with_detections:
        os.makedirs(det_dir, exist_ok=True)
    traj = orbit_trajectory(num_frames, step=step, pitch=pitch)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(num_frames):
        t = i / fps
        gray, depth, inst = render_scene(scene, traj[i], cfg.intr, cfg.height, cfg.width)
        if warp is not None:
            gray, depth = warp(gray, depth)
        g8 = torch.clamp(gray, 0, 255).to(torch.uint8).cpu().numpy()
        d16 = torch.clamp(depth * DEPTH_SCALE, 0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
        rgb_rel, depth_rel = f"rgb/{t:.6f}.png", f"depth/{t:.6f}.png"
        with open(os.path.join(out_dir, rgb_rel), "wb") as f:
            f.write(png_encode(g8))
        with open(os.path.join(out_dir, depth_rel), "wb") as f:
            f.write(png_encode(d16))
        rgb_lines.append(f"{t:.6f} {rgb_rel}")
        depth_lines.append(f"{t:.6f} {depth_rel}")
        T_wc = np.linalg.inv(traj[i])
        q = lie.rotmat_to_quat(torch.from_numpy(T_wc[:3, :3].astype(np.float64))).numpy()
        tx, ty, tz = T_wc[:3, 3]
        gt_lines.append(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
        if with_detections:
            det = gt_detections(scene, traj[i], cfg.intr, instance=inst)
            save_detection_cache(os.path.join(det_dir, f"{i}.npz"), {k: v.cpu().numpy() for k, v in det.items()})
    hdr = "# fabricated TUM-format sequence (qsp_slam_tpu_torch synthetic renderer)\n"
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines), ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(hdr + "\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=640)
    ap.add_argument("--objects", type=int, default=0)
    ap.add_argument("--step", type=float, default=0.01)
    ap.add_argument("--pitch", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--detections", action="store_true")
    ap.add_argument("--distort", default=None, metavar="K1,K2,P1,P2,K3",
                    help="simulate lens distortion (Brown-Conrady coefficients); "
                         "writes a matching calib.yaml for run_tum --config")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU instead of CUDA")
    args = ap.parse_args(argv)
    dist = None
    if args.distort:
        dist = tuple(float(x) for x in args.distort.split(","))
        if len(dist) != 5:
            ap.error("--distort needs 5 coefficients")
    make_sequence(args.out_dir, args.frames, args.objects, args.step, args.pitch, args.seed,
                  args.detections, distort=dist, device="cpu" if args.cpu else None)
    print(f"wrote {args.frames} frames to {args.out_dir}")


if __name__ == "__main__":
    main()

"""Fabricate a KITTI-odometry-format sequence from the synthetic renderer
(counterpart of `qsp_slam_tpu/data/make_kitti.py`): car-sized ellipsoids
on a road plane and a level stereo rig 1.65 m above it, driving forward
with a gentle sway, or (`--loop`) round a rounded-square circuit that
returns to its start.  Writes `calib.txt` (P0..P3 and Tr), `times.txt`,
`image_0/` and `image_1/` 8-bit PNGs (the standard-library encoder of
`make_tum`), `velodyne/*.bin` scans backprojected from the left depth,
and a KITTI-format poses file.  Renders on CUDA unless `--cpu` is given.

Gray values are converted to 8 bits as the reference converts them
(truncation, wrapping above 255 on the brightest car pixels).

    python -m qsp_slam_tpu_torch.data.make_kitti OUT_DIR [--frames 60] [--cars 6]
        [--height 192 --width 624] [--seed 2] [--poses-out FILE]
        [--loop [--loop-overlap 80]] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Intrinsics, backproject
from .make_tum import png_encode
from .render import make_scene, render_scene

# velodyne frame (x fwd, y left, z up) -> cam0 frame (z fwd, x right, y down)
TR_VELO_TO_CAM = np.array(
    [[0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, -1.0, -0.08],
     [1.0, 0.0, 0.0, 0.27]],
    np.float32,
)

CAM_HEIGHT = 1.65  # camera above the road, as the KITTI rig
CORNER_R = 10.0  # corner radius of a `--loop` circuit


def _circuit_pose(s: float, straight: float, r: float):
    """Arc length -> ((x, z), yaw) on a rounded-square circuit: four
    straights of length `straight` joined by quarter circles of radius
    `r`, centred at the origin, returning exactly to its start."""
    quad = straight + 0.5 * np.pi * r
    q = int(s // quad) % 4
    u = s - (s // quad) * quad
    h = straight / 2.0 + r
    if u < straight:
        pos = np.array([-h, u - straight / 2.0])
        heading = 0.0
    else:
        a = (u - straight) / r
        c = np.array([-h + r, straight / 2.0])
        pos = c + r * np.array([-np.cos(a), np.sin(a)])
        heading = a
    th = -q * np.pi / 2.0
    ct, st = np.cos(th), np.sin(th)
    x, z = pos
    pos = np.array([x * ct - z * st, x * st + z * ct])
    return pos, heading + q * np.pi / 2.0


def _to_u8(gray: torch.Tensor) -> np.ndarray:
    """f32 gray -> uint8 as numpy's `astype(np.uint8)` does it on the
    reference's renders: truncation toward zero, low 8 bits kept."""
    return (gray.to(torch.int32) & 0xFF).to(torch.uint8).cpu().numpy()


def drive_scene(num_frames: int = 60, num_cars: int = 6, step: float = 0.35, seed: int = 2, loop: bool = False,
                loop_overlap: int = 80, device=None):
    """The scene of a drive: the room and the cars (world frame) that
    `make_kitti_sequence` renders for these arguments, with the room's
    half extents, the drive's start (z) and the circuit's straight length
    (loops)."""
    dev = resolve_device(device)
    car_half = ((1.7, 0.65, 0.8), (2.3, 0.85, 1.0))
    straight = z_start = 0.0
    if loop:
        # The last `loop_overlap` frames re-drive the first stretch.
        perimeter = max(num_frames - loop_overlap, num_frames // 2) * step
        straight = max((perimeter - 2.0 * np.pi * CORNER_R) / 4.0, 10.0)
        half_span = straight / 2.0 + CORNER_R
        room_half = (half_span + 30.0, 4.0, half_span + 30.0)
        # One texture period across the whole world, so no two places look
        # alike.
        scene = make_scene(num_objects=num_cars, seed=seed, half_extent=room_half,
                           half_range=car_half, tex_period=2.0 * (half_span + 30.0), device=dev)
        # Cars along the circuit: random arc position, 5-9 m off the
        # centreline on either side, resting on the floor.
        rng0 = np.random.default_rng(seed + 7)
        e = scene.ellipsoids.cpu().numpy().copy()
        for i in range(len(e)):
            s = rng0.uniform(0.0, perimeter)
            pos, heading = _circuit_pose(s, straight, CORNER_R)
            fwd = np.array([np.sin(heading), np.cos(heading)])
            left = np.array([fwd[1], -fwd[0]])
            off = rng0.uniform(5.0, 9.0) * rng0.choice([-1.0, 1.0])
            e[i, 0] = pos[0] + left[0] * off
            e[i, 2] = pos[1] + left[1] * off
            e[i, 1] = room_half[1] - e[i, 7]
            e[i, 4] = heading + rng0.uniform(-0.3, 0.3)
        scene = scene._replace(ellipsoids=torch.from_numpy(e.astype(np.float32)).to(dev))
    else:
        # A wide, long room whose floor is CAM_HEIGHT below the drive, with
        # the cars along the drive.
        room_half = (16.0, 4.0, 0.6 * num_frames * step + 30.0)
        z_start = -room_half[2] + 6.0
        scene = make_scene(num_objects=num_cars, seed=seed, half_extent=room_half, half_range=car_half,
                           z_range=(z_start + 10.0, z_start + 14.0 + num_frames * step + 18.0),
                           tex_period=80.0, device=dev)
        # Keep the ego lane clear: shove any car straddling |x| < 3 m aside.
        e = scene.ellipsoids.cpu().numpy().copy()
        lane = np.abs(e[:, 0]) < 3.0
        e[lane, 0] = np.sign(e[lane, 0] + 1e-3) * (3.2 + np.abs(e[lane, 0]))
        scene = scene._replace(ellipsoids=torch.from_numpy(e).to(dev))
    return scene, room_half, z_start, straight


def make_kitti_sequence(
    out_dir: str,
    num_frames: int = 60,
    num_cars: int = 6,
    height: int = 192,
    width: int = 624,
    baseline: float = 0.54,
    step: float = 0.35,
    seed: int = 2,
    poses_out: str | None = None,
    velo_stride: int = 2,
    loop: bool = False,
    loop_overlap: int = 80,
    device=None,
) -> None:
    dev = resolve_device(device)
    fx = 0.58 * width
    intr = Intrinsics(*(float(np.float32(v)) for v in (fx, fx, width / 2.0, height / 2.0)))
    scene, room_half, z_start, straight = drive_scene(num_frames, num_cars, step, seed, loop, loop_overlap, dev)

    for sub in ("image_0", "image_1", "velodyne"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    P0 = np.array([[fx, 0, width / 2, 0], [0, fx, height / 2, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * baseline
    with open(os.path.join(out_dir, "calib.txt"), "w") as f:
        for name, P in [("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1)]:
            f.write(name + ": " + " ".join(f"{v:.6e}" for v in P.ravel()) + "\n")
        f.write("Tr: " + " ".join(f"{v:.6e}" for v in TR_VELO_TO_CAM.ravel()) + "\n")
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        for i in range(num_frames):
            f.write(f"{0.1 * i:.6e}\n")

    cam_y = float(room_half[1]) - CAM_HEIGHT
    z0 = 0.0 if loop else z_start
    Tr44 = np.eye(4, dtype=np.float32)
    Tr44[:3] = TR_VELO_TO_CAM
    Tr_inv = np.linalg.inv(Tr44)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -baseline

    poses_wc = []
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height:velo_stride, 0:width:velo_stride]
    uv = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32))
    for i in range(num_frames):
        if loop:
            pos, yaw = _circuit_pose(step * i, straight, CORNER_R)
            tx, tz = float(pos[0]), float(pos[1])
        else:
            yaw = 0.04 * np.sin(0.05 * i)
            tx, tz = 0.8 * np.sin(0.08 * i), z0 + step * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        T_wc[:3, 3] = [tx, cam_y, tz]
        poses_wc.append(T_wc)
        T_cw = np.linalg.inv(T_wc).astype(np.float32)

        gl, depth, _ = render_scene(scene, T_cw, intr, height=height, width=width)
        gr, _, _ = render_scene(scene, shift @ T_cw, intr, height=height, width=width)
        g8 = _to_u8(gl)
        for sub, img in (("image_0", g8), ("image_1", _to_u8(gr))):
            with open(os.path.join(out_dir, sub, f"{i:06d}.png"), "wb") as f:
                f.write(png_encode(img))

        # Velodyne scan: the strided left depth backprojected to cam0 and
        # mapped into the velodyne frame (a forward sector of a spin);
        # reflectance carries the image gray.
        d = depth.cpu().numpy()[::velo_stride, ::velo_stride]
        g = gl.cpu().numpy()[::velo_stride, ::velo_stride]
        z = d.ravel().astype(np.float32)
        ok = (z > 0.5) & (z < 80.0)
        pts_cam = backproject(uv[torch.from_numpy(ok)], torch.from_numpy(z[ok]), intr).numpy()
        pts_cam += rng.normal(0, 0.02, pts_cam.shape).astype(np.float32)
        hom = np.concatenate([pts_cam, np.ones((len(pts_cam), 1), np.float32)], -1)
        scan = np.concatenate([(hom @ Tr_inv.T)[:, :3], g.ravel()[ok, None] / 255.0], -1).astype(np.float32)
        scan.tofile(os.path.join(out_dir, "velodyne", f"{i:06d}.bin"))

    if poses_out:
        os.makedirs(os.path.dirname(poses_out) or ".", exist_ok=True)
        with open(poses_out, "w") as f:
            for T in poses_wc:
                f.write(" ".join(f"{v:.6e}" for v in T[:3].ravel()) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--cars", type=int, default=6)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=624)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--poses-out", default=None)
    ap.add_argument("--loop", action="store_true",
                    help="rounded-square circuit that returns to its start; the last "
                         "--loop-overlap frames re-drive the first stretch")
    ap.add_argument("--loop-overlap", type=int, default=80)
    ap.add_argument("--cpu", action="store_true", help="render on the CPU instead of CUDA")
    args = ap.parse_args(argv)
    make_kitti_sequence(
        args.out_dir, num_frames=args.frames, num_cars=args.cars, height=args.height,
        width=args.width, seed=args.seed, poses_out=args.poses_out, loop=args.loop,
        loop_overlap=args.loop_overlap, device="cpu" if args.cpu else None,
    )
    print(f"wrote {args.frames} frames to {args.out_dir}")


if __name__ == "__main__":
    main()

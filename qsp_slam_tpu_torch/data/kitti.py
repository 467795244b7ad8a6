"""KITTI odometry dataset reader, stereo and LiDAR (counterpart of
`qsp_slam_tpu/data/kitti.py`).  Host code: `calib.txt` (P0..P3 and the
velodyne-to-camera `Tr`), `times.txt`, the `image_0/` and `image_1/`
PNG pairs decoded by the native loader (PIL only for a file it
declines), `velodyne/*.bin` scans and a KITTI poses file.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import native_loader


def load_calib(path: str) -> dict:
    """Parse calib.txt: P0..P3 (3x4) and Tr (velodyne -> cam0)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = np.array([float(x) for x in v.split()], np.float32).reshape(3, 4)
    return out


@dataclass
class KittiSequence:
    """Stereo + velodyne frame server for one odometry sequence."""

    root: str  # .../sequences/NN
    poses_file: str | None = None  # .../poses/NN.txt
    calib: dict = field(init=False)
    times: np.ndarray = field(init=False)
    poses: np.ndarray | None = field(init=False)  # (F, 4, 4) T_wc of cam0

    def __post_init__(self):
        self.calib = load_calib(os.path.join(self.root, "calib.txt"))
        self.times = np.loadtxt(os.path.join(self.root, "times.txt"), np.float64)
        self.poses = None
        if self.poses_file and os.path.exists(self.poses_file):
            P = np.loadtxt(self.poses_file, np.float32).reshape(-1, 3, 4)
            bottom = np.tile(np.array([[[0, 0, 0, 1]]], np.float32), (len(P), 1, 1))
            self.poses = np.concatenate([P, bottom], axis=1)

    @property
    def intrinsics(self) -> dict:
        P0 = self.calib["P0"]
        return dict(fx=P0[0, 0], fy=P0[1, 1], cx=P0[0, 2], cy=P0[1, 2])

    @property
    def baseline(self) -> float:
        """Stereo baseline in meters: -P1[0, 3] / fx."""
        return float(-self.calib["P1"][0, 3] / self.calib["P1"][0, 0])

    def __len__(self) -> int:
        return len(self.times)

    def _pair_paths(self, idx: int) -> tuple[str, str]:
        return (os.path.join(self.root, "image_0", f"{idx:06d}.png"),
                os.path.join(self.root, "image_1", f"{idx:06d}.png"))

    def load_gray_pair(self, idx: int):
        """(left, right) f32 gray images of frame `idx`."""
        lp, rp = self._pair_paths(idx)
        gl, gr = native_loader.load_png(lp), native_loader.load_png(rp)
        if gl is None or gr is None:
            from PIL import Image

            gl = np.asarray(Image.open(lp).convert("L"), np.float32)
            gr = np.asarray(Image.open(rp).convert("L"), np.float32)
        return gl, gr

    def prefetch_pairs(self, indices, threads: int = 2, lookahead: int = 4):
        """Yield (gray_left, gray_right) for `indices`, decoded ahead on the
        native worker pool (PIL for a pair the decoder declines)."""
        indices = list(indices)
        pf = native_loader.FramePrefetcher([self._pair_paths(i) for i in indices], 1.0, threads, lookahead)
        try:
            for pos, i in enumerate(indices):
                got = pf.get(pos)
                yield got if got is not None else self.load_gray_pair(i)
        finally:
            pf.close()

    def load_velodyne(self, idx: int, max_points: int | None = None) -> np.ndarray:
        """Velodyne scan (N, 4) [x, y, z, reflectance], subsampled (seeded
        by `idx`) to `max_points`."""
        path = os.path.join(self.root, "velodyne", f"{idx:06d}.bin")
        pts = np.fromfile(path, np.float32).reshape(-1, 4)
        if max_points is not None and len(pts) > max_points:
            sel = np.random.default_rng(idx).choice(len(pts), max_points, replace=False)
            pts = pts[sel]
        return pts

    def transform_velo_to_cam(self, pts: np.ndarray) -> np.ndarray:
        """(N, 4) velodyne points -> (N, 3) cam0-frame points."""
        Tr = self.calib["Tr"]
        return pts[:, :3] @ Tr[:3, :3].T + Tr[:3, 3]

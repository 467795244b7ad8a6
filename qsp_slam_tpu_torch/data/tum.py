"""TUM RGB-D dataset reader (counterpart of `qsp_slam_tpu/data/tum.py`):
the index files, the ground-truth trajectory, greedy timestamp
association, and frames decoded by the native loader (`native_loader`),
with PIL only for a file that decoder declines.  Host code; the tracker
takes the f32 gray and f32 depth in metres as they come.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from ..core import lie
from . import native_loader

DEPTH_SCALE = 5000.0  # TUM convention: depth_png / 5000 = meters


def _rows(path: str) -> Iterator[list[str]]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def parse_file_list(path: str) -> list[tuple[float, str]]:
    """A TUM index file: lines of `timestamp path` (# comments)."""
    return [(float(p[0]), p[1]) for p in _rows(path)]


def parse_trajectory(path: str) -> list[tuple[float, np.ndarray]]:
    """groundtruth.txt: `t tx ty tz qx qy qz qw` -> list of (t, T_wc f32)."""
    out = []
    for p in _rows(path):
        v = [float(x) for x in p]
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = lie.quat_to_rotmat(torch.tensor(v[4:8], dtype=torch.float32)).numpy()
        T_wc[:3, 3] = v[1:4]
        out.append((v[0], T_wc))
    return out


def associate(a: list[tuple[float, object]], b: list[tuple[float, object]],
              max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association: each entry of `a` takes its
    nearest `b` within `max_dt`; a `b` entry is used once, first come."""
    used, out = set(), []
    for i, (ta, _) in enumerate(a):
        best_j, best_dt = -1, max_dt
        for j, (tb, _) in enumerate(b):
            if abs(ta - tb) < best_dt:
                best_j, best_dt = j, abs(ta - tb)
        if best_j >= 0 and best_j not in used:
            used.add(best_j)
            out.append((i, best_j))
    return out


@dataclass
class TumSequence:
    """Associated (gray, depth, timestamp, T_cw ground truth) frames.
    `decoded_by` records, per frame index read so far, which decoder read
    it: "native" or "pil"."""

    root: str
    rgb_list: list = field(init=False)
    depth_list: list = field(init=False)
    gt: list = field(init=False)
    frames: list = field(init=False)  # (t, rgb_path, depth_path, T_wc or None)
    decoded_by: dict = field(init=False, default_factory=dict)

    def __post_init__(self):
        self.rgb_list = parse_file_list(os.path.join(self.root, "rgb.txt"))
        self.depth_list = parse_file_list(os.path.join(self.root, "depth.txt"))
        gt_path = os.path.join(self.root, "groundtruth.txt")
        self.gt = parse_trajectory(gt_path) if os.path.exists(gt_path) else []
        self.frames = []
        for i, j in associate(self.rgb_list, self.depth_list):
            t = self.rgb_list[i][0]
            T = None
            if self.gt:
                k = int(np.argmin([abs(t - tg) for tg, _ in self.gt]))
                if abs(self.gt[k][0] - t) < 0.05:
                    T = self.gt[k][1]
            self.frames.append((t, self.rgb_list[i][1], self.depth_list[j][1], T))

    def __len__(self) -> int:
        return len(self.frames)

    def _load_pil(self, rgb_rel: str, depth_rel: str):
        from PIL import Image

        rgb = np.asarray(Image.open(os.path.join(self.root, rgb_rel)).convert("L"), np.float32)
        depth = np.asarray(Image.open(os.path.join(self.root, depth_rel)), np.float32) / DEPTH_SCALE
        return rgb, depth

    def _frame(self, idx: int, decoded):
        """(gray, depth, t, T_cw | None) from a native decode or, where it
        declined, from PIL."""
        t, rgb_rel, depth_rel, T_wc = self.frames[idx]
        if decoded is None:
            decoded = self._load_pil(rgb_rel, depth_rel)
            self.decoded_by[idx] = "pil"
        else:
            self.decoded_by[idx] = "native"
        T_cw = None if T_wc is None else np.linalg.inv(T_wc).astype(np.float32)
        return (*decoded, t, T_cw)

    def load(self, idx: int):
        """(gray f32 (H, W), depth f32 meters (H, W), t, T_cw | None)."""
        _, rgb_rel, depth_rel, _ = self.frames[idx]
        rgb = native_loader.load_png(os.path.join(self.root, rgb_rel), 1.0)
        depth = native_loader.load_png(os.path.join(self.root, depth_rel), 1.0 / DEPTH_SCALE)
        return self._frame(idx, None if rgb is None or depth is None else (rgb, depth))

    def prefetch_iter(self, indices: list[int], threads: int = 2, lookahead: int = 4) -> Iterator:
        """(gray, depth, t, T_cw | None, frame index) for `indices`, decoded
        ahead on the native worker pool."""
        pairs = [(os.path.join(self.root, self.frames[i][1]), os.path.join(self.root, self.frames[i][2]))
                 for i in indices]
        pf = native_loader.FramePrefetcher(pairs, 1.0 / DEPTH_SCALE, threads, lookahead)
        try:
            for pos, i in enumerate(indices):
                yield (*self._frame(i, pf.get(pos)), i)
        finally:
            pf.close()

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self.load(i)

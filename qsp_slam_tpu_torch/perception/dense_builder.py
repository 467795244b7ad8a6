"""Dense RGB-D map builder: per-frame clouds merged into a voxel-filtered
global map (counterpart of `qsp_slam_tpu/perception/dense_builder.py`), an
export product outside the estimation path.

The unprojection and the camera-to-world transform run on the builder's
device; the voxel hash stays on the host in numpy, as in the reference:
key `(kx << 42) ^ (ky << 21) ^ kz` of the int64 voxel indices, the first
point into a voxel wins, at most `max_points` voxels.  The merge is
vectorised (`np.unique` first occurrences, in frame order), which keeps
the reference's cloud and its order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..core.camera import Intrinsics
from ..data.io import _np
from .groundplane import depth_to_cloud


@dataclass
class DenseBuilder:
    intr: Intrinsics
    voxel: float = 0.05
    stride: int = 4
    max_points: int = 2_000_000
    device: Optional[str] = None
    _keys: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    _pts: list = field(default_factory=list)
    _gray: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def process_frame(self, gray, depth, T_cw) -> None:
        """Unproject one frame (gray (H, W), depth (H, W) in meters, T_cw
        (4, 4)) and merge its points into the voxel map."""
        dev = self.device
        depth = torch.tensor(_np(depth), dtype=torch.float32, device=dev)
        pts_c, valid = depth_to_cloud(depth, self.intr, self.stride)
        T_wc = lie.inv_se3(torch.tensor(_np(T_cw), dtype=torch.float32, device=dev))
        pts_w = lie.transform_points(T_wc, pts_c)
        pts_w, ok = _np(pts_w), _np(valid)
        g = _np(gray)[:: self.stride, :: self.stride].reshape(-1)
        pts_w, g = pts_w[ok], g[ok]
        keys = np.floor(pts_w / self.voxel).astype(np.int64)
        flat = (keys[:, 0] << 42) ^ (keys[:, 1] << 21) ^ keys[:, 2]
        uniq, first = np.unique(flat, return_index=True)
        fresh = np.sort(first[~np.isin(uniq, self._keys)])[: self.max_points - len(self._keys)]
        if len(fresh):
            self._keys = np.concatenate([self._keys, flat[fresh]])
            self._pts.append(pts_w[fresh])
            self._gray.append(g[fresh])

    @property
    def num_points(self) -> int:
        return len(self._keys)

    def cloud(self):
        """(N, 3) f32 points and (N,) f32 gray values, in insertion order."""
        if not self._pts:
            return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
        return np.concatenate(self._pts).astype(np.float32), np.concatenate(self._gray).astype(np.float32)

    def save_ply(self, path: str) -> None:
        from ..viz.export import save_ply_points

        pts, g = self.cloud()
        colors = np.stack([g, g, g], axis=-1).clip(0, 255).astype(np.uint8)
        save_ply_points(path, pts, colors)

"""System facade: the single-controller SLAM loop (counterpart of
`qsp_slam_tpu/slam/system.py`, point-only RGB-D and stereo tracking).

Per frame: features + tracking, a host-side consistency gate and keyframe
policy; on a keyframe: insertion, covisibility local BA, point fusion,
periodic keyframe culling, the keyframe snapshot and, from keyframe 12
on, loop closing (top-8 place query, consistency gate, Sim3
verification, pose-graph correction and global BA).  A lost frame goes
through the recovery tiers (reference-keyframe tracking, top-k
relocalization, then the early-map reset or a coast on the prediction).
Localization-only mode tracks against a frozen map.  Capabilities of
later port slices raise `NotImplementedError` naming the slice (see
ROADMAP.md queue A).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import backproject
from . import map as mapmod
from .local_mapping import (
    cull_keyframes,
    fuse_map_points,
    global_ba_step,
    local_ba_step,
    window_edge_budget,
)
from .loop_closing import (
    ConsistencyGate,
    LoopState,
    correct_loop,
    empty_loop_state,
    grow_loop_state,
    snapshot_keyframe,
    verify_loop,
)
from .map import MapState
from .place_recognition import bow_signature, query_topk_with_ref
from .relocalization import relocalize, track_reference_keyframe
from .tracking import (
    FrameData,
    TrackingConfig,
    TrackResult,
    keyframe_insertion,
    need_keyframe,
    process_and_track,
    process_and_track_stereo,
    process_frame,
    process_frame_stereo,
)

_LATER = {
    "enable_objects": "slice 6 (quadric objects)",
    "detector": "slice 8 (learned detectors)",
    "shape_prior": "slice 7 (DeepSDF shapes)",
    "mesh": "slice 9 (distribution)",
}


def _to_device(x, device: torch.device) -> torch.Tensor:
    """Camera input (array or tensor) -> tensor on `device`; uint16 depth
    crosses as its int16 bit pattern and is widened on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        t = torch.from_numpy(x.view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    return torch.from_numpy(x).to(device)


@dataclass
class SlamSystem:
    cfg: TrackingConfig
    kmax: int = 64
    nmax: int = 8192
    emax: int = 65536
    ba_window: int = 8
    enable_objects: bool = False
    enable_loop_closing: bool = True
    # Relocalization against the keyframe snapshots (always maintained).
    enable_relocalization: bool = True
    # Track and relocalize against the frozen map: no keyframes, no BA, no
    # database growth, no automatic reset.
    localization_only: bool = False
    detector: Optional[tuple] = None
    shape_prior: Optional[tuple] = None
    mesh: Optional[object] = None
    device: Optional[str] = None
    map_state: MapState = field(init=False)
    loop_state: LoopState = field(init=False)
    Tcw: np.ndarray = field(init=False)
    velocity: np.ndarray = field(init=False)
    loops_closed: int = 0
    initialized: bool = False
    frames_since_kf: int = 0
    inliers_at_last_kf: int = 0
    trajectory: list = field(default_factory=list)
    stats: dict = field(default_factory=lambda: {"frames": 0, "keyframes": 0,
                                                 "track_ms": [], "ba_ms": []})

    def __post_init__(self):
        self._refuse_later()
        self.device = resolve_device(self.device)
        self.map_state = mapmod.empty_map(self.kmax, self.nmax, self.emax, self.device)
        self.loop_state = empty_loop_state(self.kmax, device=self.device)
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self._kf_fresh = False
        self._lost_streak = 0
        self._sensor = "rgbd"
        self._loop_gate = ConsistencyGate()

    def _refuse_later(self):
        for name, where in _LATER.items():
            if getattr(self, name):
                raise NotImplementedError(f"{name} arrives with ROADMAP {where}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def set_localization_mode(self, on: bool = True) -> None:
        """Switch localization-only tracking against the frozen map on or
        off.  Entering it drops the motion model, which is commonly stale."""
        self.localization_only = bool(on)
        if on:
            self.velocity = np.eye(4, dtype=np.float32)

    def reset(self) -> None:
        """Drop the map and the snapshot store (rebuilt empty at their
        current capacities, so snapshot slot k is again keyframe k) and
        return to the uninitialized state; the next frame re-bootstraps."""
        self.map_state = mapmod.empty_map(self.kmax, self.nmax, self.emax, self.device)
        self.loop_state = empty_loop_state(self.kmax, device=self.device)
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.initialized = False
        self.frames_since_kf = 0
        self.inliers_at_last_kf = 0
        self._lost_streak = 0
        self._kf_fresh = False
        self._loop_gate.reset()
        self.stats["kf_frames"] = []
        self.stats["resets"] = self.stats.get("resets", 0) + 1

    # ------------------------------------------------------------------
    def track_rgbd(self, gray, depth, detections=None) -> np.ndarray:
        """Process one RGB-D frame (gray (H, W) uint8/f32, depth (H, W)
        uint16 PNG units or f32 meters); returns the estimated T_cw."""
        if detections is not None:
            raise NotImplementedError("detections arrive with ROADMAP " + _LATER["enable_objects"])
        self._sensor = "rgbd"
        self._ensure_capacity()
        gray = _to_device(gray, self.device)
        depth = _to_device(depth, self.device)
        if depth.dtype == torch.int32:  # widened uint16
            depth = depth.to(torch.float32) / self.cfg.depth_png_scale
        if not self.initialized:
            self._initialize(process_frame(gray, depth, self.cfg))
            self.trajectory.append(self.Tcw.copy())
            return self.Tcw
        t0 = time.perf_counter()
        Tcw_pred = self.velocity @ self.Tcw
        frame, res = process_and_track(
            gray, depth, self.map_state, torch.from_numpy(Tcw_pred).to(self.device), self.cfg
        )
        return self._post_track(frame, res, Tcw_pred, t0)

    def track_stereo(self, gray_left, gray_right, detections=None) -> np.ndarray:
        """Process one rectified stereo pair (gray (H, W) uint8/f32 each):
        features of both images, scanline matching, depth per keypoint,
        then the same tracking, recovery and keyframe policy as RGB-D;
        returns the estimated T_cw of the left camera."""
        if detections is not None:
            raise NotImplementedError("detections arrive with ROADMAP " + _LATER["enable_objects"])
        self._sensor = "stereo"
        self._ensure_capacity()
        gl = _to_device(gray_left, self.device)
        gr = _to_device(gray_right, self.device)
        if not self.initialized:
            self._initialize(process_frame_stereo(gl, gr, self.cfg))
            self.trajectory.append(self.Tcw.copy())
            return self.Tcw
        t0 = time.perf_counter()
        Tcw_pred = self.velocity @ self.Tcw
        frame, res = process_and_track_stereo(
            gl, gr, self.map_state, torch.from_numpy(Tcw_pred).to(self.device), self.cfg
        )
        return self._post_track(frame, res, Tcw_pred, t0)

    def _post_track(self, frame: FrameData, res: TrackResult, Tcw_pred, t0) -> np.ndarray:
        """Host policy after tracking: one device->host transfer, the
        consistency gate, velocity update and keyframe trigger, or the
        recovery tiers of a lost frame (which make reads of their own)."""
        cfg = self.cfg
        got = torch.cat([
            res.Tcw.reshape(16).to(torch.float64),
            torch.stack([res.num_inliers, res.pred_dev_t, res.pred_dev_r,
                         res.tracked_close, res.untracked_close]).to(torch.float64),
        ]).cpu().numpy()
        Tcw_new = got[:16].reshape(4, 4).astype(np.float32)
        num_inliers, dev_t, dev_r, n_close_trk, n_close_new = got[16:]
        num_inliers = int(num_inliers)
        self.stats["track_ms"].append((time.perf_counter() - t0) * 1e3)
        # A solution far from the prediction is a repetitive-texture
        # mismatch, not tracking.
        tracked = bool(num_inliers >= cfg.min_track_inliers and dev_t < 0.5 and dev_r < 0.5)
        self.stats.setdefault("inliers", []).append(num_inliers)
        self.stats.setdefault("track_ok", []).append(tracked)
        if tracked:
            self._lost_streak = 0
            self.velocity = (Tcw_new @ np.linalg.inv(self.Tcw)).astype(np.float32)
            self.Tcw = Tcw_new
            self.frames_since_kf += 1
            if self._kf_fresh:
                # First track against the replenished map sets the reference
                # count for the ratio trigger.
                self.inliers_at_last_kf = max(self.inliers_at_last_kf, num_inliers)
                self._kf_fresh = False
            if not self.localization_only and need_keyframe(
                self.frames_since_kf, num_inliers, self.inliers_at_last_kf, cfg,
                tracked_close=int(n_close_trk), untracked_close=int(n_close_new),
            ):
                self._insert_keyframe(frame, res)
        elif not self._recover(frame):
            if (not self.localization_only and self._lost_streak >= 2
                    and int(self.map_state.num_kfs) <= 5):
                # Lost soon after initialization with nothing to recover
                # against: the bootstrap is poisoned, so re-seed the map
                # from this frame rather than coast.
                self.reset()
                self._initialize(frame)
            else:
                self.Tcw = np.asarray(Tcw_pred, dtype=np.float32)
        self.stats["frames"] += 1
        self.trajectory.append(self.Tcw.copy())
        return self.Tcw

    def _recover(self, frame: FrameData) -> bool:
        """Recovery tiers of a lost frame, in order: reference-keyframe
        tracking seeded from the last pose (the motion model, not the map,
        was wrong), then top-k relocalization.  True when one succeeded."""
        cfg = self.cfg
        self._lost_streak += 1
        if int(self.loop_state.db.count) == 0:
            return False
        dev = self.device
        r = track_reference_keyframe(
            self.loop_state, self.map_state.kf_Tcw, int(self.map_state.num_kfs) - 1, frame,
            torch.from_numpy(self.Tcw).to(dev), cfg,
        )
        if int(r.num_inliers) >= cfg.min_track_inliers:
            Tr = r.Tcw.cpu().numpy()
            self.velocity = (Tr @ np.linalg.inv(self.Tcw)).astype(np.float32)
            self.Tcw = Tr
            self._lost_streak = 0
            self.frames_since_kf += 1
            self.stats["ref_kf_recoveries"] = self.stats.get("ref_kf_recoveries", 0) + 1
            return True
        if not self.enable_relocalization:
            return False
        gen = torch.Generator().manual_seed(900 + self.stats["frames"])
        r = relocalize(self.loop_state, self.map_state.kf_Tcw, frame, cfg, gen)
        if not bool(r.ok):
            return False
        self.Tcw = r.Tcw.cpu().numpy()
        self.velocity = np.eye(4, dtype=np.float32)
        self._lost_streak = 0
        self.stats["relocalizations"] = self.stats.get("relocalizations", 0) + 1
        return True

    # ------------------------------------------------------------------
    def _ensure_capacity(self, reserve_kfs: int = 1):
        """Grow or compact the stores at frame start (ids must stay stable
        between a frame's tracking and its keyframe insertion): a keyframe
        adds at most 1 keyframe, F points and 2F edges."""
        m = self.map_state
        num_kfs, num_pts, num_obs = (
            int(v) for v in torch.stack([m.num_kfs, m.num_pts, m.num_obs]).cpu()
        )
        F = self.cfg.orb.num_features
        ev = self.stats.setdefault("capacity_events", [])
        if num_kfs + reserve_kfs > self.kmax:
            self.kmax *= 2
            self.map_state = m = mapmod.grow_map(m, kmax=self.kmax)
            self.loop_state = grow_loop_state(self.loop_state, self.kmax)
            ev.append(("grow_kfs", self.kmax))
        if num_pts + reserve_kfs * F > self.nmax:
            dead = num_pts - int(torch.sum(m.pt_valid))
            if dead >= F:
                self.map_state = m = mapmod.compact_points(m)
                ev.append(("compact_points", dead))
            else:
                self.nmax *= 2
                self.map_state = m = mapmod.grow_map(m, nmax=self.nmax)
                ev.append(("grow_points", self.nmax))
        if num_obs + reserve_kfs * 2 * F > self.emax:
            dead = num_obs - int(torch.sum(m.ob_valid))
            if dead >= 2 * F:
                self.map_state = mapmod.compact_edges(m)
                ev.append(("compact_edges", dead))
            else:
                self.emax *= 2
                self.map_state = mapmod.grow_map(m, emax=self.emax)
                ev.append(("grow_edges", self.emax))

    # ------------------------------------------------------------------
    def _initialize(self, frame: FrameData):
        """The first frame becomes keyframe 0 at the origin, with a map
        point for every valid-depth feature (up to the per-keyframe cap)."""
        dev = self.device
        dummy = TrackResult(
            Tcw=torch.from_numpy(self.Tcw).to(dev),
            match_pt=torch.full((self.nmax,), -1, dtype=torch.int32, device=dev),
            match_inlier=torch.zeros(self.nmax, dtype=torch.bool, device=dev),
            **{k: torch.zeros((), device=dev) for k in TrackResult._fields[3:]},
        )
        self.map_state = keyframe_insertion(
            self.map_state, torch.from_numpy(self.Tcw).to(dev), frame, dummy, self.cfg
        )
        self.initialized = True
        self.inliers_at_last_kf = int(torch.sum(frame.depth > 0))
        self.frames_since_kf = 0
        self.stats["keyframes"] += 1
        self.stats.setdefault("kf_frames", []).append(len(self.trajectory))
        self._loop_closing(frame, 0)

    def _insert_keyframe(self, frame: FrameData, res: TrackResult):
        self.map_state = keyframe_insertion(
            self.map_state, torch.from_numpy(self.Tcw).to(self.device), frame, res, self.cfg
        )
        t0 = time.perf_counter()
        budget = window_edge_budget(self.ba_window, self.cfg, self.emax)
        self.map_state = local_ba_step(self.map_state, self.cfg, self.ba_window, budget)
        self.map_state = fuse_map_points(self.map_state)
        if self.stats["keyframes"] % 4 == 0:
            self.map_state = cull_keyframes(self.map_state)
        self._sync()
        self.stats["ba_ms"].append((time.perf_counter() - t0) * 1e3)
        # Adopt the refined pose of the newest keyframe.
        kf_id = int(self.map_state.num_kfs) - 1
        self.Tcw = self.map_state.kf_Tcw[kf_id].cpu().numpy()
        self.frames_since_kf = 0
        # Provisional reference count (measured before this keyframe's new
        # points existed); the first track after insertion refreshes it.
        self.inliers_at_last_kf = int(res.num_inliers)
        self._kf_fresh = True
        self.stats["keyframes"] += 1
        self.stats.setdefault("kf_frames", []).append(len(self.trajectory))
        self._loop_closing(frame, kf_id)

    def _loop_closing(self, frame: FrameData, kf_id: int):
        """Snapshot the keyframe (always: relocalization reads the store),
        then, from keyframe 12 on, loop closing in three stages: the top-8
        place query above the adaptive floor (the worst score among the
        recent covisible keyframes, at least 0.02); the consistency gate;
        and, for a consistent candidate, Sim3 verification, which must
        find >= 40 inliers.  A verified loop is corrected by the pose
        graph and a global BA."""
        cfg = self.cfg
        pts_cam = backproject(frame.feats.xy, frame.depth, cfg.intr)
        pts_ok = frame.depth > 0.0
        self.loop_state = snapshot_keyframe(
            self.loop_state, frame.feats.desc_pm, frame.feats.valid,
            pts_cam, pts_ok, frame.feats.xy, frame.feats.octave,
        )
        if not self.enable_loop_closing or kf_id < 12:
            return
        cands, scores, ref_min = query_topk_with_ref(
            self.loop_state.db, bow_signature(frame.feats.desc_pm, frame.feats.valid), k=8
        )
        got = torch.cat([cands.to(torch.float64), scores.to(torch.float64), ref_min.reshape(1).to(torch.float64)])
        got = got.cpu().numpy()
        k = cands.shape[0]
        cands_np, scores_np, ref_min = got[:k].astype(np.int64), got[k:2 * k].astype(np.float32), float(got[-1])
        score_min = max(ref_min, 0.02)
        chosen = self._loop_gate.update(np.where(scores_np > score_min, cands_np, -1), scores_np)
        scan_row = [int(kf_id), tuple(int(c) for c in cands_np), float(scores_np[0]), ref_min, int(chosen), -1]
        self.stats.setdefault("loop_scan", []).append(scan_row)
        if chosen < 0:
            return
        # Stereo and RGB-D fix the scale (the monocular sensor waits for
        # its slice).
        gen = torch.Generator().manual_seed(77 + kf_id)
        det = verify_loop(
            self.loop_state, chosen, frame.feats.desc_pm, frame.feats.valid, pts_cam, pts_ok, gen,
            intr=cfg.intr, xy=frame.feats.xy, octave=frame.feats.octave,
            scale_factor=cfg.orb.pyramid.scale_factor, min_inliers=40,
        )
        found, n_inl = (int(v) for v in torch.stack([det.found.to(torch.int64), det.num_inliers.to(torch.int64)]).cpu())
        scan_row[5] = n_inl
        if not found:
            return
        ev = (int(kf_id), int(chosen), n_inl)
        self.stats.setdefault("loop_events", []).append(ev)
        print(f"[loop] kf={ev[0]} match={ev[1]} inliers={ev[2]}", file=sys.stderr)
        self._loop_gate.reset()
        self.map_state = correct_loop(self.map_state, kf_id, det)
        self._dispatch_global_ba()
        self.Tcw = self.map_state.kf_Tcw[kf_id].cpu().numpy()
        self.velocity = np.eye(4, dtype=np.float32)
        self.loops_closed += 1

    def _dispatch_global_ba(self, iters: int = 10) -> None:
        """Whole-map point-only BA on this device (the joint and sharded
        variants raise through `_LATER`)."""
        self._refuse_later()
        self.map_state = global_ba_step(self.map_state, self.cfg, iters=iters)
        self._sync()

    # ------------------------------------------------------------------
    def run_global_ba(self, iters: int = 10) -> None:
        """Full-map point-only optimization outside loop closure (all
        keyframes, keyframe 0 fixed, and all points), e.g. before saving a
        map.  The joint and sharded variants belong to later slices."""
        if int(self.map_state.num_kfs) < 2:
            return
        self._dispatch_global_ba(iters)
        self.Tcw = self.map_state.kf_Tcw[int(self.map_state.num_kfs) - 1].cpu().numpy()
        self.velocity = np.eye(4, dtype=np.float32)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        tm = self.stats["track_ms"]
        bm = self.stats["ba_ms"]
        return {
            "frames": self.stats["frames"],
            "keyframes": self.stats["keyframes"],
            "track_fps": round(1000.0 / float(np.median(tm)), 2) if tm else None,
            "num_points": int(self.map_state.num_pts),
            "num_obs": int(self.map_state.num_obs),
            "num_objects": 0,
            "loops_closed": self.loops_closed,
            "track_ms_median": float(np.median(tm)) if tm else None,
            "ba_ms_median": float(np.median(bm)) if bm else None,
        }

"""System facade: the single-controller SLAM loop (counterpart of
`qsp_slam_tpu/slam/system.py`: RGB-D, stereo and monocular tracking with
their object landmarks).

Per frame: features + tracking, a host-side consistency gate and keyframe
policy; on a keyframe: insertion, covisibility local BA, point fusion,
periodic keyframe culling, the keyframe snapshot and, from keyframe 12
on, loop closing (top-8 place query, consistency gate, Sim3
verification, pose-graph correction and global BA).  A lost frame goes
through the recovery tiers (reference-keyframe tracking, top-k
relocalization, then the early-map reset or a coast on the prediction).
Localization-only mode tracks against a frozen map.  The monocular
sensor bootstraps from two views, triangulates new points against the
previous keyframe, closes loops over Sim(3), and spawns object landmarks
from detection boxes, the ground plane of its sparse map and aspect
priors.  With detections, an RGB-D or stereo keyframe fuses the ground
plane, fits one ellipsoid per detection (from sampled depth, completed
down to its supporting plane, or from the stereo keypoints in its box),
associates and integrates them, and refines the objects against their
box histories; RGB-D keyframes also track the Manhattan planes and type
object-plane relations, which route each object's supporting plane into
the refinement, and stereo keyframes run the joint camera-point-object
BA, which the global BA joins once objects carry pose measurements.
With a DeepSDF `shape_prior`, the RGB-D and stereo object step ends with
the shape step: each due object gathers surface points and rays from the
keyframe's depth (stereo: a scatter image of the keypoint depths; with
instance masks, the surface points are the object's own pixels) and runs
the joint pose + code LM over its flip hypotheses.  With a learned 2D
`detector`, an RGB-D or stereo frame given no detections keeps its gray
image (the left one of a pair) on the device, and a keyframe detects in
it (`perception/detector2d.detect_objects`) before its object step: the
reference's detect-online mode.  With a `mesh` of several ranks, each
rank runs its replica of the system on the same frames and the whole-map
BA runs map-sharded over them, every decision and shape of its
collectives taken from rank 0's state (`_end_frame`, `_adopt_rank0`).
"""

from __future__ import annotations

import functools
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..core import plane as plane_mod
from ..core.camera import backproject, intrinsic_matrix
from ..models.shape_opt import ShapeOptConfig
from ..perception.detector2d import detect_objects
from ..perception.ellipsoid_fit import core_mask, fit_ellipsoid_depth, fit_ellipsoid_points, sample_bbox_depth_points
from ..perception.groundplane import adaptive_inlier_th, estimate_ground_plane, estimate_ground_plane_points
from ..perception.manhattan import empty_plane_set, extract_manhattan_planes, update_plane_set
from ..perception.prior_infer import default_priors, generate_init_guess
from ..perception.relations import extract_relations, select_support_plane, support_planes_for_objects
from ..perception.symmetry import estimate_symmetry
from ..utils.tracing import HOST_READS, TRACER, count, fetch
from ..parallel.mesh import Mesh, broadcast, broadcast_object
from . import map as mapmod
from .distributed_mapping import global_ba_sharded, global_joint_ba_sharded
from .joint_mapping import joint_ba_step
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
    feature_points_from_matches,
    grow_loop_state,
    snapshot_keyframe,
    verify_loop,
)
from .map import MapState, scatter_set_last
from .mono import mono_initialize, triangulate_new_points
from .objects import (
    ObjectTable,
    advance_dynamic_objects,
    associate_detections,
    cull_objects,
    empty_objects,
    integrate_keyframe,
    merge_duplicates,
    refine_objects,
    refine_objects_mono,
)
from .place_recognition import bow_signature, query_topk_with_ref
from .relocalization import relocalize, track_reference_keyframe
from .shape_mapping import gather_shape_inputs, keypoint_depth_image, reconstruct_due_objects
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


def _to_device(x, device: torch.device) -> torch.Tensor:
    """Camera input (array or tensor) -> tensor on `device`; uint16 depth
    crosses as its int16 bit pattern and is widened on the device.  A copy
    from host memory waits for the device and counts as a host read."""
    if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
        count(HOST_READS)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        t = torch.from_numpy(x.view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    return torch.from_numpy(x).to(device)


# What a rank is given rather than what it tracked: kept when a rank takes
# rank 0's state (`SlamSystem._adopt_rank0`).
_GIVEN = frozenset({
    "cfg", "ba_window", "omax", "enable_objects", "enable_loop_closing", "enable_relocalization",
    "localization_only", "enable_structures", "enable_symmetry", "aspect_priors", "detector", "shape_prior",
    "mesh", "device", "keep_frame_info", "_pending_detections", "_pending_depth", "_pending_gray",
})


def _frame(track):
    """A `track_*` method that ends with `_end_frame`, which every rank of
    a mesh reaches once per frame whatever its own tracking decided."""

    @functools.wraps(track)
    def run(self, *args, **kwargs):
        TRACER.new_frame()
        track(self, *args, **kwargs)
        self._end_frame()
        return self.Tcw

    return run


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array (a pose, a plane) on `device`: the copy waits for the
    device, so it counts as a host read."""
    count(HOST_READS)
    return torch.from_numpy(x).to(device)


def _det_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A detection field (numpy array or tensor) as a tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.device.type == "cpu":  # host memory: the copy waits for the device
        count(HOST_READS)
    return x.to(device, dtype)


@dataclass
class SlamSystem:
    cfg: TrackingConfig
    kmax: int = 64
    nmax: int = 8192
    emax: int = 65536
    ba_window: int = 8
    omax: int = 32
    # Object landmarks from the detections passed to track_* (every sensor).
    enable_objects: bool = True
    enable_loop_closing: bool = True
    # Relocalization against the keyframe snapshots (always maintained).
    enable_relocalization: bool = True
    # Track and relocalize against the frozen map: no keyframes, no BA, no
    # database growth, no automatic reset.
    localization_only: bool = False
    # RGB-D structure: Manhattan planes, object-plane relations and the
    # supporting-plane selection in extraction and refinement.
    enable_structures: bool = True
    # Reflection-symmetry completion of each object cloud before its fit.
    enable_symmetry: bool = False
    # Per-label aspect priors of the monocular objects (`AspectPriors`);
    # None is the neutral 1:1.
    aspect_priors: Optional[object] = None
    # Learned 2D detector (params, DetectorConfig): detections at keyframes
    # of RGB-D and stereo frames tracked without any (detect-online).
    detector: Optional[tuple] = None
    # DeepSDF prior (params, DeepSDFConfig[, ShapeOptConfig]): per-object
    # shape reconstruction at keyframes of the RGB-D and stereo object step.
    shape_prior: Optional[tuple] = None
    # Rank mesh of the sharded global BA (`parallel.mesh.make_mesh`): with
    # more than one rank the post-loop and `run_global_ba` whole-map BA run
    # map-sharded over it (`slam/distributed_mapping.py`); every rank runs
    # its replica of the system and makes the same calls on the same
    # frames.  A global BA starts with every rank taking rank 0's state, so
    # whether it runs, its branch and its shapes are rank 0's.  None or a
    # size-1 mesh use the single-device programs.
    mesh: Optional[Mesh] = None
    device: Optional[str] = None
    # Keep each tracked frame's keypoints and tracked mask on the host in
    # `last_frame_info` (the frame drawer's input, `run_tum --save-frames`);
    # they ride the frame's one device->host copy.
    keep_frame_info: bool = False
    last_frame_info: Optional[dict] = field(init=False, default=None)
    map_state: MapState = field(init=False)
    loop_state: LoopState = field(init=False)
    objects: ObjectTable = field(init=False)
    ground_plane: Optional[np.ndarray] = field(init=False, default=None)  # world frame (4,)
    plane_set: object = field(init=False)  # Manhattan planes (`PlaneSet`), world frame
    relations: object = field(init=False, default=None)  # object-plane `Relations`, or None
    Tcw: np.ndarray = field(init=False)
    velocity: np.ndarray = field(init=False)
    loops_closed: int = 0
    initialized: bool = False
    frames_since_kf: int = 0
    inliers_at_last_kf: int = 0
    trajectory: list = field(default_factory=list)
    stats: dict = field(default_factory=lambda: {"frames": 0, "keyframes": 0,
                                                 "track_ms": [], "ba_ms": [], "obj_ms": []})

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(self.mesh).__name__}")
        if self.device is None and self.mesh is not None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        if self.detector is not None:
            params, dcfg = self.detector
            self.detector = ({k: v.to(self.device) for k, v in params.items()}, dcfg)
        self._sensor = "rgbd"
        self._pending_detections = self._pending_depth = self._pending_gray = None
        self._loop_gate = ConsistencyGate()
        self._clear_state()

    def _sync(self):
        fetch(device=self.device)

    # ------------------------------------------------------------------
    def set_localization_mode(self, on: bool = True) -> None:
        """Switch localization-only tracking against the frozen map on or
        off.  Entering it drops the motion model, which is commonly stale."""
        self.localization_only = bool(on)
        if on:
            self.velocity = np.eye(4, dtype=np.float32)

    def reset(self) -> None:
        """Drop the map, the snapshot store (rebuilt empty at their current
        capacities, so snapshot slot k is again keyframe k), the objects,
        the ground plane, the Manhattan planes and relations and the
        monocular reference, and return to the uninitialized state; the
        next frame re-bootstraps."""
        self._clear_state()
        self.stats["kf_frames"] = []
        self.stats["resets"] = self.stats.get("resets", 0) + 1

    def _clear_state(self) -> None:
        self.map_state = mapmod.empty_map(self.kmax, self.nmax, self.emax, self.device)
        self.loop_state = empty_loop_state(self.kmax, device=self.device)
        code_dim = self.shape_prior[1].code_dim if self.shape_prior else 16
        self.objects = empty_objects(self.omax, code_dim=code_dim, device=self.device)
        self.plane_set = empty_plane_set(8, device=self.device)
        self.relations = None
        self.ground_plane = None
        self._gp_count = 0  # keyframes fused into the RGB-D / stereo ground plane
        self._gp_inliers = 0  # support of the monocular ground plane
        self._mono_ref = None
        self._mono_ref_age = 0
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.initialized = False
        self.frames_since_kf = 0
        self.inliers_at_last_kf = 0
        self._lost_streak = 0
        self._kf_fresh = False
        self._loop_kf = -1  # keyframe of a loop whose global BA is due
        self._loop_gate.reset()

    # ------------------------------------------------------------------
    @_frame
    def track_rgbd(self, gray, depth, detections=None) -> np.ndarray:
        """Process one RGB-D frame (gray (H, W) uint8/f32, depth (H, W)
        uint16 PNG units or f32 meters); returns the estimated T_cw.
        `detections` (dict of "bbox" (D, 4), "label", "prob", "valid",
        optionally "ellipsoid_cam" and "fit_ok" for measured ellipsoids, or
        a callable giving one) feed the objects at keyframes when
        `enable_objects` is on.  The object step reads the depth image as
        given, as the reference does: a uint16 image stays in PNG units
        there (ROADMAP queue C)."""
        self._sensor = "rgbd"
        self._pending_detections = detections
        self._ensure_capacity()
        gray = _to_device(gray, self.device)
        depth = _to_device(depth, self.device)
        self._pending_gray = gray if detections is None and self.detector is not None else None
        self._pending_depth = depth.to(torch.float32)
        if depth.dtype == torch.int32:  # widened uint16
            depth = depth.to(torch.float32) / self.cfg.depth_png_scale
        if not self.initialized:
            self._initialize(process_frame(gray, depth, self.cfg))
            self.trajectory.append(self.Tcw.copy())
            return self.Tcw
        span = TRACER.begin("track")
        Tcw_pred = self.velocity @ self.Tcw
        frame, res = process_and_track(
            gray, depth, self.map_state, _upload(Tcw_pred, self.device), self.cfg
        )
        return self._post_track(frame, res, Tcw_pred, span)

    @_frame
    def track_stereo(self, gray_left, gray_right, detections=None) -> np.ndarray:
        """Process one rectified stereo pair (gray (H, W) uint8/f32 each):
        features of both images, scanline matching, depth per keypoint,
        then the same tracking, recovery and keyframe policy as RGB-D;
        returns the estimated T_cw of the left camera.  `detections` as for
        `track_rgbd`; the objects fit from the keypoints in each box."""
        self._sensor = "stereo"
        self._pending_detections = detections
        self._pending_depth = None
        self._ensure_capacity()
        gl = _to_device(gray_left, self.device)
        gr = _to_device(gray_right, self.device)
        self._pending_gray = gl if detections is None and self.detector is not None else None
        if not self.initialized:
            self._initialize(process_frame_stereo(gl, gr, self.cfg))
            self.trajectory.append(self.Tcw.copy())
            return self.Tcw
        span = TRACER.begin("track")
        Tcw_pred = self.velocity @ self.Tcw
        frame, res = process_and_track_stereo(
            gl, gr, self.map_state, _upload(Tcw_pred, self.device), self.cfg
        )
        return self._post_track(frame, res, Tcw_pred, span)

    @_frame
    def track_mono(self, gray, detections=None) -> np.ndarray:
        """Process one monocular frame (gray (H, W) uint8/f32); returns the
        estimated T_cw.  Until the two-view bootstrap succeeds the pose
        stays at the identity; then the frame goes through the RGB-D
        frame code at zero depth and the same tracking, recovery and
        keyframe policy.  `detections` (dict of "bbox" (D, 4), "label",
        "prob", "valid", or a callable giving one) feed the object
        landmarks at keyframes when `enable_objects` is on."""
        self._sensor = "mono"
        self._pending_detections = detections
        self._ensure_capacity()
        cfg = self.cfg
        gray = _to_device(gray, self.device)
        zero_depth = torch.zeros((cfg.height, cfg.width), dtype=torch.float32, device=self.device)
        if not self.initialized:
            if not self.localization_only:  # a frozen map needs a map
                self._mono_bootstrap(process_frame(gray, zero_depth, cfg))
            self.trajectory.append(self.Tcw.copy())
            return self.Tcw
        span = TRACER.begin("track")
        Tcw_pred = self.velocity @ self.Tcw
        frame, res = process_and_track(
            gray, zero_depth, self.map_state, _upload(Tcw_pred, self.device), cfg
        )
        return self._post_track(frame, res, Tcw_pred, span)

    def _post_track(self, frame: FrameData, res: TrackResult, Tcw_pred, span) -> np.ndarray:
        """Host policy after tracking: one device->host transfer, which
        ends the `track` span begun by the caller, the consistency gate,
        velocity update and keyframe trigger, or the recovery tiers of a
        lost frame (which make reads of their own).  With
        `keep_frame_info` the keypoints, the matched features and their
        inlier flags ride the same transfer (f64 holds the indices
        exactly)."""
        cfg = self.cfg
        parts = [
            res.Tcw.reshape(16).to(torch.float64),
            torch.stack([res.num_inliers, res.pred_dev_t, res.pred_dev_r,
                         res.tracked_close, res.untracked_close]).to(torch.float64),
        ]
        if self.keep_frame_info:
            parts += [frame.feats.xy.reshape(-1).to(torch.float64), res.match_inlier.to(torch.float64),
                      res.match_pt.to(torch.float64)]
        got = fetch(torch.cat(parts)).numpy()
        Tcw_new = got[:16].reshape(4, 4).astype(np.float32)
        num_inliers, dev_t, dev_r, n_close_trk, n_close_new = got[16:21]
        num_inliers = int(num_inliers)
        TRACER.end(span)
        self.stats["track_ms"].append(span.host_ms)
        if self.keep_frame_info:
            F, N = frame.feats.xy.shape[0], res.match_pt.shape[0]
            xy, mi, mp = np.split(got[21:], [2 * F, 2 * F + N])
            mi, mp = mi != 0, mp.astype(np.int64)
            kp_tracked = np.zeros(F, bool)
            kp_tracked[mp[mi & (mp >= 0)]] = True
            self.last_frame_info = {"kp_xy": xy.reshape(F, 2).astype(np.float32), "kp_tracked": kp_tracked}
        # A solution far from the prediction is a repetitive-texture
        # mismatch, not tracking.
        tracked = bool(num_inliers >= cfg.min_track_inliers and dev_t < 0.5 and dev_r < 0.5)
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
                if self._sensor == "mono":
                    self._insert_mono_keyframe(frame, res)
                else:
                    self._insert_keyframe(frame, res)
        elif not self._recover(frame):
            if (not self.localization_only and self._lost_streak >= 2
                    and int(fetch(self.map_state.num_kfs)) <= 5):
                # Lost soon after initialization with nothing to recover
                # against: the bootstrap is poisoned, so re-seed the map
                # from this frame rather than coast.
                self.reset()
                if self._sensor == "mono":  # back to the two-view bootstrap
                    self._mono_ref = frame
                else:
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
        if int(fetch(self.loop_state.db.count)) == 0:
            return False
        r = track_reference_keyframe(
            self.loop_state, self.map_state.kf_Tcw, int(fetch(self.map_state.num_kfs)) - 1, frame,
            _upload(self.Tcw, self.device), cfg,
        )
        if int(fetch(r.num_inliers)) >= cfg.min_track_inliers:
            Tr = fetch(r.Tcw).numpy()
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
        if not bool(fetch(r.ok)):
            return False
        self.Tcw = fetch(r.Tcw).numpy()
        self.velocity = np.eye(4, dtype=np.float32)
        self._lost_streak = 0
        self.stats["relocalizations"] = self.stats.get("relocalizations", 0) + 1
        return True

    # ------------------------------------------------------------------
    def _ensure_capacity(self, reserve_kfs: int = 1):
        """Grow or compact the stores at frame start (ids must stay stable
        between a frame's tracking and its keyframe insertion): a keyframe
        adds at most 1 keyframe, F points and 2F edges."""
        with TRACER.span("capacity"):
            m = self.map_state
            num_kfs, num_pts, num_obs = (int(v) for v in fetch(torch.stack([m.num_kfs, m.num_pts, m.num_obs])))
            F = self.cfg.orb.num_features
            ev = self.stats.setdefault("capacity_events", [])
            if num_kfs + reserve_kfs > self.kmax:
                self.kmax *= 2
                self.map_state = m = mapmod.grow_map(m, kmax=self.kmax)
                self.loop_state = grow_loop_state(self.loop_state, self.kmax)
                ev.append(("grow_kfs", self.kmax))
            if num_pts + reserve_kfs * F > self.nmax:
                dead = num_pts - int(fetch(torch.sum(m.pt_valid)))
                if dead >= F:
                    self.map_state = m = mapmod.compact_points(m)
                    ev.append(("compact_points", dead))
                else:
                    self.nmax *= 2
                    self.map_state = m = mapmod.grow_map(m, nmax=self.nmax)
                    ev.append(("grow_points", self.nmax))
            if num_obs + reserve_kfs * 2 * F > self.emax:
                dead = num_obs - int(fetch(torch.sum(m.ob_valid)))
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
            Tcw=_upload(self.Tcw, dev),
            match_pt=torch.full((self.nmax,), -1, dtype=torch.int32, device=dev),
            match_inlier=torch.zeros(self.nmax, dtype=torch.bool, device=dev),
            **{k: torch.zeros((), device=dev) for k in TrackResult._fields[3:]},
        )
        self.map_state = keyframe_insertion(self.map_state, _upload(self.Tcw, dev), frame, dummy, self.cfg)
        self.initialized = True
        self.inliers_at_last_kf = int(fetch(torch.sum(frame.depth > 0)))
        self.frames_since_kf = 0
        self.stats["keyframes"] += 1
        self.stats.setdefault("kf_frames", []).append(len(self.trajectory))
        if self.enable_objects and (self._pending_detections is not None or self._pending_gray is not None):
            with TRACER.span("objects"):
                self._process_objects(self._pending_detections, self._pending_depth, frame)
        self._loop_closing(frame, 0)

    def _insert_keyframe(self, frame: FrameData, res: TrackResult):
        with TRACER.span("map.insert"):
            self.map_state = keyframe_insertion(self.map_state, _upload(self.Tcw, self.device), frame, res,
                                                self.cfg)
        with TRACER.span("map.local_ba") as ba:
            budget = window_edge_budget(self.ba_window, self.cfg, self.emax)
            self.map_state = local_ba_step(self.map_state, self.cfg, self.ba_window, budget)
            self.map_state = fuse_map_points(self.map_state)
            if self.stats["keyframes"] % 4 == 0:
                self.map_state = cull_keyframes(self.map_state)
            self._sync()
        self.stats["ba_ms"].append(ba.host_ms)
        # Adopt the refined pose of the newest keyframe.
        kf_id = int(fetch(self.map_state.num_kfs)) - 1
        self.Tcw = fetch(self.map_state.kf_Tcw[kf_id]).numpy()
        self.frames_since_kf = 0
        # Provisional reference count (measured before this keyframe's new
        # points existed); the first track after insertion refreshes it.
        self.inliers_at_last_kf = int(fetch(res.num_inliers))
        self._kf_fresh = True
        self.stats["keyframes"] += 1
        self.stats.setdefault("kf_frames", []).append(len(self.trajectory))
        if self.enable_objects and (self._pending_detections is not None or self._pending_gray is not None):
            with TRACER.span("objects") as obj:
                self._process_objects(self._pending_detections, self._pending_depth, frame)
            self.stats["obj_ms"].append(obj.host_ms)
            # Stereo: the joint camera-point-object BA over the newest keyframes.
            if self._sensor == "stereo" and int(fetch(torch.sum(self.objects.valid))) > 0:
                self.map_state, self.objects = joint_ba_step(self.map_state, self.objects, self.cfg, self.ba_window)
                self._sync()
                self.Tcw = fetch(self.map_state.kf_Tcw[kf_id]).numpy()
        self._loop_closing(frame, kf_id)

    # ------------------------------------------------------------------
    def _mono_bootstrap(self, frame: FrameData):
        """Two-view initialization against the reference frame (the first
        frame, renewed when it is more than 10 attempts old).  Success
        makes keyframes 0 (identity) and 1 with the triangulated points,
        snapshots both, and starts tracking.  The draws come from a CPU
        generator seeded 31, as the reference seeds every attempt."""
        if self._mono_ref is None:
            self._mono_ref, self._mono_ref_age = frame, 0
            return
        self._mono_ref_age += 1
        init = mono_initialize(self._mono_ref, frame, self.cfg, torch.Generator().manual_seed(31))
        if not bool(fetch(init.ok)):
            if self._mono_ref_age > 10:
                self._mono_ref, self._mono_ref_age = frame, 0
            return
        dev = self.device
        m, kf0 = mapmod.add_keyframe(self.map_state, torch.eye(4, device=dev))
        m, kf1 = mapmod.add_keyframe(m, init.T_cw2)
        F = init.pts_w.shape[0]
        view = init.pts_w / torch.clamp(torch.linalg.vector_norm(init.pts_w, dim=-1, keepdim=True), min=1e-9)
        # The points are frame-1 aligned but take frame 2's descriptors in
        # frame-1 order, as the reference does (ROADMAP queue C).
        m, ids = mapmod.add_points(m, init.pts_w, frame.feats.desc_pm, init.octave2, view, init.pt_ok)
        no_right = torch.full((F,), -1.0, device=dev)
        m = mapmod.add_observations(m, kf0, ids, init.uv1, no_right, init.octave2)
        self.map_state = mapmod.add_observations(m, kf1, ids, init.uv2, no_right, init.octave2)
        self.Tcw = fetch(init.T_cw2).numpy()
        self.initialized = True
        self.inliers_at_last_kf = int(fetch(torch.sum(init.pt_ok)))
        self.frames_since_kf = 0
        self.stats["keyframes"] += 2
        kf_fr = self.stats.setdefault("kf_frames", [])
        kf_fr += [max(len(self.trajectory) - self._mono_ref_age, 0), len(self.trajectory)]
        # Snapshot both keyframes: snapshot slot k is keyframe k.
        self._loop_closing(self._mono_ref, 0)
        self._loop_closing(frame, 1)

    def _insert_mono_keyframe(self, frame: FrameData, res: TrackResult):
        """A monocular keyframe: observations of the tracked inliers, new
        points triangulated against the previous keyframe's snapshot, local
        BA, the objects, and a snapshot whose 3D are the tracked map points."""
        cfg = self.cfg
        dev = self.device
        with TRACER.span("map.insert"):
            m, kf_id = mapmod.add_keyframe(self.map_state, _upload(self.Tcw, dev))
            N = m.pt_xyz.shape[0]
            F = frame.feats.capacity
            pt_ids = torch.where(res.match_inlier, torch.arange(N, dtype=torch.int32, device=dev), -1)
            fidx = torch.clamp(res.match_pt, min=0).long()
            m = mapmod.add_observations(m, kf_id, pt_ids, frame.feats.xy[fidx], torch.full((N,), -1.0, device=dev),
                                        frame.feats.octave[fidx])
            prev = int(fetch(m.num_kfs)) - 2
            # Every unmatched map row marks feature 0 unmatched too, as in the
            # reference (ROADMAP queue C).
            matched_feat = scatter_set_last(torch.zeros(F, dtype=torch.bool, device=dev), fidx, res.match_inlier)
            ls = self.loop_state
            self.map_state = triangulate_new_points(m, ls.kf_desc[prev], ls.kf_xy[prev], ls.kf_feat_ok[prev], prev,
                                                    kf_id, frame, matched_feat, cfg)
        with TRACER.span("map.local_ba") as ba:
            budget = window_edge_budget(self.ba_window, cfg, self.emax)
            self.map_state = local_ba_step(self.map_state, cfg, self.ba_window, budget)
            self._sync()
        self.stats["ba_ms"].append(ba.host_ms)
        kf = int(fetch(self.map_state.num_kfs)) - 1
        self.Tcw = fetch(self.map_state.kf_Tcw[kf]).numpy()
        self.frames_since_kf = 0
        self.inliers_at_last_kf = int(fetch(res.num_inliers))  # provisional, as in _insert_keyframe
        self._kf_fresh = True
        self.stats["keyframes"] += 1
        self.stats.setdefault("kf_frames", []).append(len(self.trajectory))
        if self.enable_objects and self._pending_detections is not None:
            with TRACER.span("objects") as obj:
                self._process_objects_mono(self._pending_detections)
            self.stats["obj_ms"].append(obj.host_ms)
        pts_cam, pts_ok = feature_points_from_matches(self.map_state.pt_xyz, res.match_pt, res.match_inlier,
                                                      _upload(self.Tcw, dev), F)
        self._loop_closing(frame, kf, pts_cam=pts_cam, pts_ok=pts_ok)

    def _process_objects_mono(self, detections):
        """The monocular object step of a keyframe: the ground plane of the
        sparse map (re-estimated every keyframe, the best-supported fit
        kept; objects wait for one), box-only ellipsoids from the ground
        and the aspect priors, association, integration, the prior-aided
        refinement, duplicate merging and culling.  The plane's draws come
        from a CPU generator seeded 400 + keyframe id."""
        if callable(detections):
            detections = detections()
        cfg, dev = self.cfg, self.device
        m = self.map_state
        kf_id = int(fetch(m.num_kfs)) - 1
        gp = estimate_ground_plane_points(
            m.pt_xyz, m.pt_valid, torch.Generator().manual_seed(400 + kf_id), min_inlier_frac=0.04,
            inlier_th=adaptive_inlier_th(m.pt_xyz, m.pt_valid),
        )
        ok, n_inl = (int(v) for v in fetch(torch.stack([gp.ok.to(torch.int64), gp.num_inliers.to(torch.int64)])))
        if ok and n_inl > self._gp_inliers:
            self.ground_plane = fetch(gp.plane).numpy()  # world frame already
            self._gp_inliers = n_inl
        if self.ground_plane is None:
            return
        Tcw = _upload(self.Tcw, dev)
        K = intrinsic_matrix(cfg.intr, dev)
        pi_w = _upload(self.ground_plane, dev)
        pi_cam = plane_mod.transform(pi_w, Tcw)
        count(HOST_READS, 4)
        bbox, label, prob, dvalid = (torch.as_tensor(np.asarray(detections[k]), dtype=dt).to(dev) for k, dt in (
            ("bbox", torch.float32), ("label", torch.int32), ("prob", torch.float32), ("valid", torch.bool)))
        priors = self.aspect_priors or default_priors(device=dev)
        lbl = torch.clamp(label, 0, priors.d.shape[0] - 1).long()
        e_cam = generate_init_guess(bbox, pi_cam, cfg.intr, priors.d[lbl], priors.e[lbl])
        # A box whose ground ray leaves near the clip bound has no footprint.
        fit_ok = dvalid & (e_cam[:, 2] > 0.3) & (e_cam[:, 2] < 30.0)
        objs = advance_dynamic_objects(self.objects, kf_id)
        assoc = associate_detections(objs, Tcw, K, bbox, label, dvalid)
        objs = integrate_keyframe(objs, Tcw, bbox, label, prob, dvalid, e_cam, fit_ok, assoc, kf_id=kf_id)
        objs = refine_objects_mono(objs, K, pi_w, priors.d, priors.e, img_wh=(cfg.width, cfg.height))
        self.objects = cull_objects(merge_duplicates(objs), kf_id)
        self._sync()

    def _process_objects(self, detections, depth, frame: FrameData):
        """The RGB-D and stereo object step of a keyframe: the fused ground
        plane, the Manhattan planes (RGB-D), one ellipsoid fit per
        detection, association, integration, relation typing and the
        support-aware refinement, duplicate merging and culling.  A
        callable `detections` is evaluated here (its time goes to
        `stats["det_ms"]`).  The draws come from CPU generators seeded as
        the reference seeds its keys: keyframe id (ground plane), 300 +
        keyframe id (Manhattan rounds), 1000 + keyframe id (pixel samples).
        The host reads the ground plane once per keyframe.  Without
        detections, the learned detector runs on the keyframe's gray image
        (its boxes and masks stay on the device)."""
        if callable(detections):
            t_det = time.perf_counter()
            detections = detections()
            self.stats.setdefault("det_ms", []).append((time.perf_counter() - t_det) * 1e3)
        if detections is None:
            detections = detect_objects(*self.detector, self._pending_gray)
            self._pending_gray = None
        cfg, dev = self.cfg, self.device
        Tcw = _upload(self.Tcw, dev)
        sparse = self._sensor == "stereo"
        kf_id = int(fetch(self.map_state.num_kfs)) - 1
        if sparse:
            kp_pts = backproject(frame.feats.xy, frame.depth, cfg.intr)
            kp_ok = frame.depth > 0.0
        with TRACER.span("objects.planes"):
            if self.ground_plane is None or self._gp_count < 10:
                # One keyframe's RANSAC is a noisy estimate: the first keyframes
                # re-estimate and fuse consistent fits (15 deg, 0.4 m) by a
                # count-weighted mean.
                gen = torch.Generator().manual_seed(kf_id)
                gp = (estimate_ground_plane_points(kp_pts, kp_ok, gen) if sparse
                      else estimate_ground_plane(depth, cfg.intr, gen))
                got = fetch(torch.cat([plane_mod.transform(gp.plane, lie.inv_se3(Tcw)),
                                       gp.ok.to(torch.float32)[None]]))
                if bool(got[4]):
                    pi_w_new = got[:4].numpy()
                    pi_w_new = pi_w_new / np.linalg.norm(pi_w_new[:3])
                    if self.ground_plane is None:
                        self.ground_plane, self._gp_count = pi_w_new, 1
                    elif (float(np.dot(self.ground_plane[:3], pi_w_new[:3])) > 0.966
                          and abs(float(self.ground_plane[3] - pi_w_new[3])) < 0.4):
                        k = self._gp_count
                        fused = (k * self.ground_plane + pi_w_new) / (k + 1)
                        self.ground_plane, self._gp_count = fused / np.linalg.norm(fused[:3]), k + 1
                elif self.ground_plane is None:
                    return  # objects wait for a gravity reference
            pi_w = _upload(self.ground_plane, dev)
            pi_cam = plane_mod.transform(pi_w, Tcw)
            if self.enable_structures and not sparse:
                self._update_structures(depth, pi_cam, Tcw, kf_id)
        with TRACER.span("objects.fit"):
            bbox, label, prob, dvalid = (_det_tensor(detections[k], dt, dev) for k, dt in (
                ("bbox", torch.float32), ("label", torch.int32), ("prob", torch.float32), ("valid", torch.bool)))
            gen = torch.Generator().manual_seed(1000 + kf_id)
            if "ellipsoid_cam" in detections:  # measured ellipsoids (a 3D detector's boxes)
                fit_e = _det_tensor(detections["ellipsoid_cam"], torch.float32, dev)
                fit_ok = _det_tensor(detections["fit_ok"], torch.bool, dev)
            else:
                if sparse:
                    xy = frame.feats.xy[None]
                    in_box = ((xy[..., 0] >= bbox[:, 0:1]) & (xy[..., 0] <= bbox[:, 2:3])
                              & (xy[..., 1] >= bbox[:, 1:2]) & (xy[..., 1] <= bbox[:, 3:4]))
                    fits = fit_ellipsoid_points(kp_pts.expand(bbox.shape[0], -1, 3), kp_ok & in_box, bbox, pi_cam,
                                                cfg.intr, min_points=8)
                elif self.enable_structures or self.enable_symmetry:
                    fits = self._fit_detections_structured(depth, bbox, gen, pi_cam, Tcw)
                else:
                    fits = fit_ellipsoid_depth(depth, bbox, pi_cam, cfg.intr, gen)
                fit_e, fit_ok = fits.ellipsoid_cam, fits.ok
        with TRACER.span("objects.refine"):
            K = intrinsic_matrix(cfg.intr, dev)
            objs = advance_dynamic_objects(self.objects, kf_id)
            assoc = associate_detections(objs, Tcw, K, bbox, label, dvalid)
            objs = integrate_keyframe(objs, Tcw, bbox, label, prob, dvalid, fit_e, fit_ok & dvalid, assoc,
                                      kf_id=kf_id)
            support_w = None
            if self.enable_structures:
                # One vote suffices: SUPPORT already needs bottom contact.
                pvalid = self.plane_set.valid & (self.plane_set.votes >= 1)
                self.relations = extract_relations(objs.ellipsoid, objs.valid, self.plane_set.planes, pvalid,
                                                   pi_w[:3] / torch.linalg.vector_norm(pi_w[:3]))
                support_w = support_planes_for_objects(self.relations, self.plane_set.planes, pvalid, pi_w)
            objs = refine_objects(objs, K, pi_w, support_planes_w=support_w, img_wh=(cfg.width, cfg.height))
            self.objects = cull_objects(merge_duplicates(objs), kf_id)
        if self.shape_prior is not None:
            self._reconstruct_shapes(detections, depth, frame, pi_cam, Tcw, assoc.obj_for_det, kf_id)
        self._sync()

    def _reconstruct_shapes(self, detections, depth, frame: FrameData, pi_cam, Tcw, obj_for_det, kf_id: int):
        """The shape step: surface points and rays of the due objects (draws
        from a CPU generator seeded 5000 + keyframe id), instance masks
        when the detections carry "mask", then the LM over the due objects'
        flip hypotheses."""
        cfg = self.cfg
        params, dec_cfg = self.shape_prior[:2]
        opt_cfg = self.shape_prior[2] if len(self.shape_prior) > 2 else ShapeOptConfig()
        if depth is None:  # stereo keeps depth per keypoint
            depth = keypoint_depth_image(frame.feats.xy, frame.depth, cfg.height, cfg.width)
        with TRACER.span("shapes"):
            with TRACER.span("shapes.gather"):
                masks = {}
                if "mask" in detections:
                    masks = dict(det_masks=_det_tensor(detections["mask"], torch.bool, self.device),
                                 det_assoc=obj_for_det)
                inputs = gather_shape_inputs(self.objects, Tcw, depth, pi_cam, cfg.intr,
                                             torch.Generator().manual_seed(5000 + kf_id), **masks)
            self.objects = reconstruct_due_objects(self.objects, inputs, params, dec_cfg, Tcw, opt_cfg)

    def _update_structures(self, depth, pi_cam, Tcw, kf_id: int):
        """Manhattan planes of this keyframe's depth (a stride-8 cloud, four
        RANSAC rounds) vote-merged into the world-frame set."""
        cfg = self.cfg
        H, W = depth.shape
        gy, gx = torch.meshgrid(torch.arange(0, H, 8, dtype=torch.float32, device=depth.device),
                                torch.arange(0, W, 8, dtype=torch.float32, device=depth.device), indexing="ij")
        z = depth[gy.long(), gx.long()].reshape(-1)
        pts = backproject(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1), z, cfg.intr)
        planes_c, found = extract_manhattan_planes(pts, (z > 0.1) & (z < 12.0), pi_cam,
                                                   torch.Generator().manual_seed(300 + kf_id), rounds=4,
                                                   min_inliers=40)
        self.plane_set = update_plane_set(self.plane_set, plane_mod.transform(planes_c, lie.inv_se3(Tcw)), found)

    def _fit_detections_structured(self, depth, bbox, gen, pi_cam, Tcw):
        """Per-detection fits completed down to each point set's supporting
        plane (one vote suffices here: the just-below gate filters false
        planes), with optional symmetry completion."""
        cfg = self.cfg
        planes_cam = plane_mod.transform(self.plane_set.planes, Tcw)
        pvalid = self.plane_set.valid & (self.plane_set.votes >= 1)
        pts, zok = sample_bbox_depth_points(depth, bbox, cfg.intr, gen)
        core0 = core_mask(pts, zok, pi_cam)
        sp = (select_support_plane(pts, core0, planes_cam, pvalid, pi_cam) if self.enable_structures
              else pi_cam.expand(bbox.shape[0], 4))
        if self.enable_symmetry:
            S = 256  # the pairwise-chamfer budget
            sym = estimate_symmetry(pts[:, :S], core0[:, :S], pi_cam[:3] / torch.linalg.vector_norm(pi_cam[:3]))
            n = sym.plane[:, None, :3]
            mirrored = pts - 2.0 * (torch.sum(pts * n, dim=-1, keepdim=True) + sym.plane[:, None, 3:4]) * n
            pts, zok = torch.cat([pts, mirrored], dim=1), torch.cat([zok, core0 & sym.ok[:, None]], dim=1)
        return fit_ellipsoid_points(pts, zok, bbox, sp, cfg.intr)

    def _loop_closing(self, frame: FrameData, kf_id: int, pts_cam=None, pts_ok=None):
        """Snapshot the keyframe (always: relocalization and monocular
        triangulation read the store), then, from keyframe 12 on, loop
        closing in three stages: the top-8 place query above the adaptive
        floor (the worst score among the recent covisible keyframes, at
        least 0.02); the consistency gate; and, for a consistent
        candidate, Sim3 verification, which must find >= 40 inliers.  A
        verified loop is corrected by the pose graph and a global BA; the
        monocular sensor corrects scale too.  `pts_cam`/`pts_ok` replace
        the depth back-projection (a monocular keyframe passes its tracked
        map points)."""
        with TRACER.span("loop"):
            cfg = self.cfg
            if pts_cam is None:
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
            got = fetch(torch.cat([cands.to(torch.float64), scores.to(torch.float64),
                                   ref_min.reshape(1).to(torch.float64)])).numpy()
            k = cands.shape[0]
            cands_np, scores_np, ref_min = got[:k].astype(np.int64), got[k:2 * k].astype(np.float32), float(got[-1])
            score_min = max(ref_min, 0.02)
            chosen = self._loop_gate.update(np.where(scores_np > score_min, cands_np, -1), scores_np)
            scan_row = [int(kf_id), tuple(int(c) for c in cands_np), float(scores_np[0]), ref_min, int(chosen), -1]
            self.stats.setdefault("loop_scan", []).append(scan_row)
            if chosen < 0:
                return
            fix_scale = self._sensor != "mono"
            gen = torch.Generator().manual_seed(77 + kf_id)
            det = verify_loop(
                self.loop_state, chosen, frame.feats.desc_pm, frame.feats.valid, pts_cam, pts_ok, gen,
                intr=cfg.intr, xy=frame.feats.xy, octave=frame.feats.octave, fix_scale=fix_scale,
                scale_factor=cfg.orb.pyramid.scale_factor, min_inliers=40,
            )
            found, n_inl = (int(v) for v in fetch(torch.stack([det.found.to(torch.int64),
                                                                det.num_inliers.to(torch.int64)])))
            scan_row[5] = n_inl
            if not found:
                return
            ev = (int(kf_id), int(chosen), n_inl)
            self.stats.setdefault("loop_events", []).append(ev)
            print(f"[loop] kf={ev[0]} match={ev[1]} inliers={ev[2]}", file=sys.stderr)
            self._loop_gate.reset()
            self.map_state, self.objects = correct_loop(self.map_state, self.objects, kf_id, det,
                                                        fix_scale=fix_scale)
            self._loop_kf = kf_id
            if not self._multi_device():  # on a mesh, at the frame's end
                self._global_ba_after_loop()

    def _global_ba_after_loop(self) -> None:
        """The corrected map's global BA; the loop keyframe's pose is then
        the current one."""
        kf_id, self._loop_kf = self._loop_kf, -1
        self._dispatch_global_ba()
        self.Tcw = fetch(self.map_state.kf_Tcw[kf_id]).numpy()
        self.velocity = np.eye(4, dtype=np.float32)
        self.loops_closed += 1

    def _multi_device(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _end_frame(self) -> None:
        """On a mesh of several ranks, the post-loop global BA of this frame
        (loop closing is a keyframe's last step, so nothing reads the map
        between it and here): rank 0 says whether it closed a loop, and if
        it did every rank takes rank 0's state and runs the sharded BA.  A
        rank's own loop is dropped: the replicas can part (the card's
        scatter-adds are not bitwise repeatable), and collectives entered
        on each rank's own decision would not match."""
        if not self._multi_device():
            return
        flag = torch.tensor([self._loop_kf], dtype=torch.int64, device=self.device)
        if int(fetch(broadcast(self.mesh, (flag,))[0])) < 0:
            self._loop_kf = -1
            return
        self._adopt_rank0()
        self._global_ba_after_loop()
        self.trajectory[-1] = self.Tcw.copy()

    def _adopt_rank0(self) -> None:
        """Every rank takes rank 0's tracked state (everything but what it
        was given, `_GIVEN`): the map, snapshots, objects, planes, pose,
        counters, capacities, trajectory and stats."""
        state = {k: v for k, v in vars(self).items() if k not in _GIVEN}
        for k, v in broadcast_object(self.mesh, state, self.device).items():
            setattr(self, k, v)

    def _dispatch_global_ba(self, iters: int = 10) -> None:
        """Whole-map BA: joint (cameras, points and objects) when the stereo
        sensor's objects hold at least two camera-object pose measurements,
        point-only otherwise; map-sharded over the mesh when it has more
        than one rank (`iters` Huber trips), else on this device
        (`joint_ba_step` over every keyframe slot, or `global_ba_step`).
        `stats["global_ba"]` records each call's branch."""
        joint = (self._sensor == "stereo" and self.enable_objects
                 and int(fetch(torch.sum(self.objects.pm_kf >= 0))) >= 2)
        sharded = self._multi_device()
        if joint and sharded:
            self.map_state, self.objects = global_joint_ba_sharded(self.map_state, self.objects, self.cfg,
                                                                   self.mesh, iters=iters)
        elif joint:
            self.map_state, self.objects = joint_ba_step(self.map_state, self.objects, self.cfg, window=self.kmax)
        elif sharded:
            self.map_state = global_ba_sharded(self.map_state, self.cfg, self.mesh, iters=iters)
        else:
            self.map_state = global_ba_step(self.map_state, self.cfg, iters=iters)
        self.stats.setdefault("global_ba", []).append(("joint" if joint else "point")
                                                      + ("-sharded" if sharded else ""))
        self._sync()

    # ------------------------------------------------------------------
    def run_global_ba(self, iters: int = 10) -> None:
        """Full-map optimization outside loop closure (all keyframes,
        keyframe 0 fixed, and all points; the objects too when the stereo
        sensor has their pose measurements), e.g. before saving a map;
        map-sharded when the system's mesh has more than one rank, which
        every rank calls and which starts from rank 0's state."""
        if self._multi_device():
            self._adopt_rank0()
        if int(fetch(self.map_state.num_kfs)) < 2:
            return
        self._dispatch_global_ba(iters)
        self.Tcw = fetch(self.map_state.kf_Tcw[int(fetch(self.map_state.num_kfs)) - 1]).numpy()
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
            "num_objects": int(torch.sum(self.objects.valid)),
            "loops_closed": self.loops_closed,
            "track_ms_median": float(np.median(tm)) if tm else None,
            "ba_ms_median": float(np.median(bm)) if bm else None,
        }

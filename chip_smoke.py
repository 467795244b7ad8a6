#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--shape-dump FILE]

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi); build every kernel from
     qsp_slam_tpu_torch/csrc with nvcc, one process per source in parallel;
  2. K1 (FAST score + NMS) against its plain PyTorch version on the card,
     bitwise: one `fast_score_nms_pyramid` call per frame's 8-level pyramid
     at t = 20 and 7 (two frames), one call over the odd shapes 8x8, 7x300,
     37x53 and 250x33 mixed with a level, and the single-image entry on
     every one of those images at both thresholds;
  3. K2 (packed Hamming) against its plain version at (8192, 4000),
     (2048, 2048), (70, 130), (1, 1), (513, 127), (129, 4001) and
     (4000, 3), with rows planted at distance 0 and 256: exactly equal;
  4. the main path: `SlamSystem.track_rgbd` on 60 rendered frames
     (uint8 gray, uint16 depth at scale 5000) with 4000 features at
     640x480, default capacities, objects off and loop closing at its
     default (on: from keyframe 12 on, each keyframe runs the place query
     and the consistency gate).  Launch
     counters are zeroed just before and read just after; K1 must launch
     once per frame and K2 at least once; ATE < 0.05 m and >= 2 keyframes;
  5. the same path on 10 frames at 500 features on the card and, as the
     reference, on the CPU (plain kernel versions): camera centres agree
     within 1 cm and the keyframes are the same;
  6. per-kernel times (CUDA events) beside the plain version, the library
     yardsticks where they exist and the bound: K1 as one call per frame,
     K2 at (8192, 4000) and (2048, 2048);
  7. the TUM command line: the port's `make_tum` writes a 60-frame
     object-free sequence to a temporary directory and `run_tum.main` runs
     it on the card at 4000 features with `--save-dir`: which decoder read
     the frames, ms/frame, ATE < 0.05 m, RPE, keyframes, K1 once per frame,
     and `CameraTrajectory.txt` read back through `load_trajectory_tum`;
  8. recovery at 4000 features: a 2 m kick to the motion model after 12
     frames, which the reference-keyframe tier must recover (no
     relocalization, error < 0.08 m), and on the phase-4 system a teleport
     back to frame 2 under a half-turn prediction, which the reference-
     keyframe tier must fail and relocalization recover (error < 0.1 m).
     CUDA events time each whole lost frame; K2's launches and shapes per
     tier are counted; K2 at the recovery shapes (4000, 384) and
     (1536, 4000) is held exactly to its plain version (planted rows at
     distance 0 and 256, and the stacked snapshot table of the teleport's
     relocalization) and timed alone;
  9. the KITTI stereo path: the port's `make_kitti` writes a 60-frame
     forward drive at 1241x376 (seed 2, baseline 0.54 m, fx = 0.58 * 1241)
     and `run_kitti.main` runs it at its defaults (2000 features, 8 levels,
     kmax 128, nmax 16384, emax 131072, local map 8192, depth_max 60) with
     `--poses` and `--save-dir`: ms/frame, ATE < 0.6 m, RPE < 0.25 m per
     frame, >= 4 keyframes, K1 once per stereo frame, K2 launches per
     shape.  Then 10 frames of a 192x624 drive at 500 features on the card
     and on the CPU: camera centres within 1 cm, the same keyframes;
 10. loop closing on the miniature circuit of `tests/test_loop_drive.py`
     (240 frames at 128x416, 6 levels, 1000 features, step 0.6 m, seed 5,
     loop overlap 90, kmax 64): `SlamSystem.track_stereo` on the port's
     `make_kitti --loop` output must close a loop with >= 40 inliers, and
     the corrected keyframe ATE must beat min(2.0 m, the frozen per-frame
     ATE).  CUDA events time every verification and every correction
     (pose graph, then global BA).
  K1 and K2 at the stereo shapes: K1 bitwise over one 16-level launch on a
  1241x376 stereo pair; K2 exactly equal to plain with planted rows at
  (2000, 2000) left-right, (8192, 2000) tracking, (2000, 384) and
  (1000, 384) loop verification; each timed beside its plain version, its
  bound and the library yardsticks.
 11. the monocular command line with objects: the port's `make_tum` writes
     60 frames of the scene and orbit of `tests/test_mono_objects.py`
     (`--objects 3 --detections --step 0.025 --pitch 0.4 --seed 2`) and
     `run_mono.main` runs them on the card at its defaults (1000 features,
     8 levels, 640x480, nmax 8192) with `--detections`: it must initialize,
     make >= 3 keyframes, keep the Sim(3)-aligned ATE below 0.1 (mono gauge
     units, `tests/test_mono_e2e.py`'s bound) and hold >= 2 objects with
     the scene's labels; K1 once per frame; ms per frame (host clock around
     each `track_mono`, synchronised), bootstrap attempts, local-BA and
     object ms per keyframe, K2 launches per shape;
 12. 12 of those frames at 500 features with their detections on the card
     and on the CPU (the RANSAC draws come from CPU generators, so both
     draw the same): the same bootstrap frame and keyframes, camera centres
     within 0.005 gauge units (the unit is the median depth of the
     bootstrap, about 2 m here, so this is phase 5's 1 cm), the same
     objects.  Both runs dump the bootstrap's pose and points, the
     keyframe poses after each local BA and the objects after each
     refinement; the per-step card-vs-CPU gaps are printed, and the
     bootstrap's pose and points and the keyframes are held to
     MONO_STEP_GAPS;
 13. the RGB-D object path: `run_tum.main --detections` on phase 11's
     sequence at 4000 features: ATE < 0.05 m, >= 2 objects of the scene's
     labels, one within 0.4 m of the truth with its label, recall (IoU >=
     0.1, Hungarian, `eval/objects.py`) >= TUM_OBJ_RECALL, >= 2 Manhattan
     planes with two votes; K1 once per frame; ms per frame (median per
     tracked frame, end to end), BA and object ms per keyframe, K2
     launches per shape, precision, recall, mean IoU;
 14. the stereo object path: `run_kitti.main --lidar-detections
     --global-ba` on phase 9's drive at its defaults: ATE < 0.6 m, RPE <
     0.25 m, >= 4 keyframes, >= 1 object, >= 1 local joint BA and a
     global BA that went joint (CUDA events around every `joint_ba_step`);
     ms per frame, object and LiDAR-provider ms per keyframe, K1 once per
     frame, K2 launches per shape;
 15. the object paths on the card against the CPU: 10 RGB-D frames of
     phase 13's scene at 500 features with the renderer's detections, and
     10 frames of phase 9's small drive with a perfect 3D detector's
     detections: the same keyframes, object slots and labels (and
     Manhattan plane slots), object centres within 1 cm; every object
     step traced on both devices (`ObjectStepDumps`, queue C): each step
     before the refinement within OBJECT_STEP_GAP, the refined and final
     objects within OBJECT_GAPS (centres, half-axes, orientation).
  K2 at the monocular shapes: exactly equal to plain with planted rows at
  (1000, 1000) bootstrap, (384, 1000) keyframe triangulation and
  (8192, 1000) tracking, each timed.
 16. the DeepSDF shape path at the reference's width (code 64, hidden 512,
     8 layers): the toy decoder trained on the card (600 Adam steps, mean
     |SDF error| < 0.03 over its 12 ellipsoids), then
     `SlamSystem(shape_prior=...)` through 20 frames of
     `tests/test_shape_mapping.py`'s scene (three objects seen 25 degrees
     down, 4 cm per frame) at 640x480 and 4000 features with the
     renderer's detections and instance masks, omax 32: ATE < 0.05 m, >= 1
     reconstructed object, every reconstructed object's true surface within
     SHAPE_SDF of its decoded zero set (median |SDF| through Tow_shape), K1
     once per frame.  Each shape step is timed by the host clock around a
     synchronise (gather and LM) with its due objects, hypotheses, FLOP
     counted from the shapes and the share of the f32 bound, and its LM's
     peak memory held under the chunking's estimate; the peak device
     memory; then 64^3 meshes of the reconstructed codes (empty: at this
     width the LM reaches a shape with no inside, as the reference does
     on the same inputs, ROADMAP queue C) and of a family code (>= 100
     faces), `render_objects_png` of the map, and tests/test_shape.py's
     one object from a zero code (logged) and from its family code (an
     inside, >= 100 faces, surface within SHAPE_SDF);
 17. the shape scene's first 10 frames at 500 features with a toy-width
     decoder (16/96/6) on the card and on the CPU: the same keyframes and
     reconstructed slots, each run's shapes with an inside and within
     SHAPE_SDF of their true surface; each shape step's input and result
     gaps are printed, its starting frames must agree within
     SHAPE_INIT_GAP, and one LM trip on the CPU run's inputs card vs CPU
     within SHAPE_GAP (eight trips carry the start's gap into the codes:
     PERF.md section 6); the object steps traced and bounded as in 15;
 18. `run_synthetic.main(["30", "--objects"])` at its defaults: ATE <
     0.05 m, >= 1 reconstructed shape, K1 once per frame.
 19. the learned 2D detector at the reference's width (widths 16/32/48,
     480x640): `train_detector` on the card with `run_synthetic
     --detector`'s recipe (3000 steps, 8 scenes, lr 2e-3, seed 7; ms per
     step, the mean of the last 20 losses below the first 20's);
     tests/test_detector2d.py's bars at full resolution on its 8 SLAM
     views (recall >= 0.4 at IoU > 0.4, <= 2 false positives); card vs
     CPU on the same params and views (the same valid rows and labels,
     their boxes within 0.5 px, masks equal on >= 99.9% of the pixels) and
     one training step from the same start (loss and params within 1e-4
     relative); `detect_objects` and a training step timed by CUDA events
     and as device time (cuDNN's share of it) beside the f32 FLOP bound;
     then detect-online drives: `run_tum --detector` (the trained weights
     saved with `save_detector2d`) on phase 13's sequence at 4000
     features and `run_synthetic.main(["30", "--objects", "--detector"])`
     (its training call handed the detector just trained, its recipe):
     ATE < 0.05 m and >= 1 object of the scene's labels with >= 2
     observations, K1 once per frame, the detector once per keyframe
     (CUDA events around each call);
 20. the learned 3D detector at the reference's width (grid 128, 32
     pillar channels, widths 32/48): `train_detector3d` on the card (800
     steps); tests/test_detector3d.py's bars on 12 fresh scans (recall >
     0.85, < 0.75 false positives per scan, centre and size errors < 0.6
     m, yaw error < 20 degrees) and no detection on a ground-only scan;
     card vs CPU on one scan (the same valid rows, centres within 1e-3 m);
     `detect_objects_3d` on a 32768-point scan and a training step timed
     as in 19; then `run_kitti --detector3d` on phase 9's drive: ATE <
     0.6 m, RPE < 0.25 m, >= 4 keyframes, >= 1 object, K1 once per frame.
 21. distribution at run_kitti's whole-map capacity: `make_ba_problem(128
     cameras, 16384 points, 8 observations each)` with 32 measured objects
     through `map_sharded_ba` and `map_sharded_joint_ba` (10 LM trips) as
     one rank (NCCL) and as two ranks sharing the card (gloo), each rank a
     process of `spawn_ranks`: the world sizes agree (`DIST_GAPS`: cost,
     poses, the points' 99.9th percentile and the most a point with 4 or
     more inlier observations moves), both
     ranks return the same bits and the cost falls; ms per LM trip by
     CUDA events, collective bytes per trip, backend and peak memory per
     rank.  Then `run_tum --global-ba --mesh 2` on phase 7's sequence and
     `run_kitti --detections --global-ba --mesh 2` on phase 9's drive with
     phase 14's perfect 3D detector's detections (saved as caches), each
     against the one-device command: phases 7's and 9's ATE gates (the
     KITTI one on the keyframes too), the same keyframe count, for the TUM
     map (the point branch) keyframe ATE within max(0.02 m, half) and
     keyframe translations within 0.05 m (the reference's test bars), the
     joint branch sharded, K1 once per frame on each rank, both ranks'
     final maps bitwise equal (their SHA-256).  The one-device drive's map
     before its global BA goes through the sharded joint BA on one rank
     and on two, which agree within `DIST_GAPS` with ranks bitwise equal
     (the reference's sharded joint BA parts from its single-device one on
     this drive, so the two commands' keyframes are compared only there);
     then the dry run over two ranks on the card.
 22. the tools, each step a span of the port's `Tracer` that ends in a
     synchronise (its report printed): (a) `run_tum --detections
     --save-dir --save-frames --frame-every 10` on phase 13's sequence and
     caches: phase 13's gates, K1 once per frame, `map_points.ply` with as
     many vertices as `map.npz` has valid points, `trajectory.ply` the 60
     camera centres of `CameraTrajectory.txt` within 1e-5 m,
     `object_wireframes.ply` 72 vertices per valid object, 6 annotated
     PNGs that `native_loader.load_png` decodes at 640x480 to the frame
     drawn (its luminance), the tracked frames with >= 100 pixels of
     tracked-keypoint marks; `track_ms_median` beside phase 13's; (b)
     `visualize_map` on that map at 640x480: two renders, its JSON's
     counts the map's, ms per render by CUDA events; (c) run_synthetic's
     object scene (30 frames) with a toy-width decoder in the reference
     checkpoint's layout (16/96/8, latent in at 4) trained on the card,
     its map saved: `extract_objects --resolution 64 --checkpoint` (that
     decoder) writes exactly the meshes `extract_mesh_from_code` gives
     non-empty for the `shape_ok` objects, with their vertex and face
     counts, and `visualize_map` renders the shapes; (d) `DenseBuilder`
     over the 60 frames and the tracked poses on the card and on the
     CPU: >= 99.9% of the voxel keys shared, ms per frame, points, peak
     memory; (e) `label_tool det add / list / remove` on a copy of the
     caches and `gt from-map` (as many objects as the map's valid ones);
     (f) one tracked frame under `utils.tracing.device_trace`, whose trace
     must name K1's kernel.
Paths 4, 7, 8, 9, 10, 11, 13, 14, 16, 18, 19, 20, 21 and 22 each zero the launch counters just
before and read them just after (phase 21's ranks count in their own processes and
report at their end).  With `--profile DIR`: torch.profiler tables in DIR
of main-path frames 12-19, of KITTI-drive frames 12-19 (phase 9's
configuration) and of monocular frames 12-19 (phase 11's), the device's busy share of each window, each kernel's
device time per launch there, and each kernel's device time per call alone
at the phase-6, recovery, stereo and monocular shapes, `profile_objects.txt`: the object step of one
warm RGB-D keyframe and one local joint BA call, and `profile_shape.txt`: one full-width shape step of
phase 16.  Then a `{"kernels": [...]}` line, the
card line again, and as the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from qsp_slam_tpu_torch import extract_objects, label_tool, visualize_map  # noqa: E402
from qsp_slam_tpu_torch import run_kitti, run_mono, run_synthetic, run_tum  # noqa: E402
from qsp_slam_tpu_torch.core import lie, quadric  # noqa: E402
from qsp_slam_tpu_torch.data import make_kitti, make_tum, native_loader  # noqa: E402
from qsp_slam_tpu_torch.data.make_kitti import drive_scene  # noqa: E402
from qsp_slam_tpu_torch.data.kitti import KittiSequence  # noqa: E402
from qsp_slam_tpu_torch.data.io import (  # noqa: E402
    load_detection_cache,
    load_map,
    load_trajectory_tum,
    save_detection_cache,
    save_map,
)
from qsp_slam_tpu_torch.data.synthetic import make_ba_problem  # noqa: E402
from qsp_slam_tpu_torch.data.render import (  # noqa: E402
    gt_detections,
    make_room,
    make_scene,
    orbit_trajectory,
    render_frame,
    render_scene,
)
from qsp_slam_tpu_torch.data.tum import TumSequence  # noqa: E402
from qsp_slam_tpu_torch.eval.ate import ate_rmse, positions_from_Tcw, rpe  # noqa: E402
from qsp_slam_tpu_torch.eval.objects import evaluate_objects  # noqa: E402
from qsp_slam_tpu_torch.frontend.matcher import pack_pm  # noqa: E402
from qsp_slam_tpu_torch.frontend.orb import OrbConfig  # noqa: E402
from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig, build_pyramid  # noqa: E402
from qsp_slam_tpu_torch.models.deepsdf import (  # noqa: E402
    DeepSDFConfig,
    DeepSDFDecoder,
    decode_sdf,
    _layer_dims,
    ellipsoid_sdf,
    train_toy_decoder,
)
from qsp_slam_tpu_torch.models.mesh import extract_mesh_from_code  # noqa: E402
from qsp_slam_tpu_torch.models.shape_opt import reconstruct_object  # noqa: E402
from qsp_slam_tpu_torch.ops import build  # noqa: E402
from qsp_slam_tpu_torch.ops.fast_nms import (  # noqa: E402
    fast_score_nms,
    fast_score_nms_plain,
    fast_score_nms_pyramid,
    fast_score_nms_pyramid_plain,
)
from qsp_slam_tpu_torch.ops.hamming import hamming_packed, hamming_packed_plain  # noqa: E402
from qsp_slam_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from qsp_slam_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402
from qsp_slam_tpu_torch.parallel.replay import problem_arrays, save_problems  # noqa: E402
from qsp_slam_tpu_torch.perception import detector2d as det2d  # noqa: E402
from qsp_slam_tpu_torch.perception import detector3d as det3d  # noqa: E402
from qsp_slam_tpu_torch.perception.dense_builder import DenseBuilder  # noqa: E402
from qsp_slam_tpu_torch.slam import system as system_mod  # noqa: E402
from qsp_slam_tpu_torch.slam.system import SlamSystem  # noqa: E402
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig, process_frame  # noqa: E402
from qsp_slam_tpu_torch.slam.shape_mapping import (  # noqa: E402
    ShapeInputs,
    chunk_size,
    reverse_hypothesis_bytes,
)
from qsp_slam_tpu_torch.utils.tracing import Tracer, device_trace  # noqa: E402
from qsp_slam_tpu_torch.viz import frame_draw, object_render  # noqa: E402
from qsp_slam_tpu_torch.viz.object_render import render_objects_png  # noqa: E402
from port_bench.metrics.flop import shape_step_flop  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores
K1_OPS_PER_PX = 140  # per (pixel, threshold): 16 ring taps x ~7 ops + arc test + 3x3 max
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
K2_SHAPES = ((8192, 4000), (2048, 2048), (70, 130), (1, 1), (513, 127), (129, 4001), (4000, 3))
FRAMES = 60  # main-path frames; the first 10 are warm-up
SNAP, RELOC_K = 384, 4  # keyframe snapshot rows, relocalization candidates
KITTI_FRAMES, KITTI_H, KITTI_W, KITTI_F = 60, 376, 1241, 2000  # phase 9 at run_kitti's defaults
STEREO_K2 = ((KITTI_F, KITTI_F), (8192, KITTI_F), (KITTI_F, SNAP), (1000, SNAP))
MONO_FRAMES, MONO_F, MONO_SMALL = 60, 1000, 12  # phase 11 at run_mono's defaults; phase 12
MONO_K2 = ((MONO_F, MONO_F), (SNAP, MONO_F), (8192, MONO_F))
KITTI_LIDAR_OBJECTS = 0  # phase 14's LiDAR run: the reference's object count on that drive
TUM_OBJ_F = 4000  # phase 13 at the reference's TUM budget (phase 7's)
TUM_OBJ_RECALL = 0.66  # phase 13 object recall gate (`evaluate_objects`, IoU >= 0.1); the JAX run: 1.0
MONO_GAP = 0.005  # phase 12 centre gate, mono gauge units
# Phase 12 per-step gates (gauge units), from the steps' card-vs-CPU gaps
# on the H100: the bootstrap pose 5.2e-6; its points 1.2e-3 (midpoint
# triangulation at 1-2 degrees of parallax multiplies a pose gap by
# depth^2 / baseline on the far points); the keyframes after each local BA
# 4.1e-5.  The objects after each refinement are held to their slots only:
# the monocular LM's turn about the vertical is weakly determined and
# carries 2e-4 into 1e-2.
MONO_STEP_GAPS = {"bootstrap T_cw2": 1e-4, "bootstrap pts_w": 1e-2, "keyframes after local BA": 1e-3}
# Queue C: the RGB-D object step card vs CPU, per step (phases 15 and 17).
# Every step before the refinement agreed within 6.9e-6 on the H100 (the
# association exactly); the refinement's 8 LM trips on objects with two
# boxes solve systems of condition 1e6-1e8 in f32 and take or refuse
# trips on cost changes of 1e-3, so they carry those gaps to 8.0e-3 rad,
# 2.4e-4 m and 4.1e-4 m.  One-ulp changes of the start move the JAX
# package's refined objects as far (7.9e-3 rad, 2.0e-4 m, 3.4e-4 m;
# tools/refine_rounding.py).  Bounds: 1e-4 before the refinement; after
# it, and for the final objects, centres and half-axes 1e-3 m and
# orientations 0.02 rad (about twice the reference's one-ulp spread).
OBJECT_STEP_GAP = 1e-4
OBJECT_STEPS_EXACT = ("estimate_ground_plane", "estimate_ground_plane_points", "extract_manhattan_planes",
                      "sample_bbox_depth_points", "select_support_plane", "fit_ellipsoid_points",
                      "associate_detections")
OBJECT_GAPS = {"centre": 1e-3, "rotation": 0.02, "half_axes": 1e-3}
KERNEL_NAMES = ("fast_score_nms_pyramid_kernel", "hamming_mma_kernel")  # as the profiler names them
SHAPE_FRAMES, SHAPE_F, SHAPE_SMALL = 20, 4000, 10  # phase 16 (tests/test_shape_mapping.py's scene); phase 17
SHAPE_SDF = 0.12  # phase 16: median |SDF| of a reconstructed object's true surface (tests/test_shape_mapping.py)
SHAPE_GAP = 1e-3  # phase 17: codes and Tow_shape after one LM trip on the same inputs, card vs CPU
# Phase 17: the shape step's starting frames card vs CPU.  They come from
# the ellipsoids, whose Euler angles part by up to 7.7e-3 rad after two
# observations (centres 2.4e-4 m), which moved T_oc_init by 0.0267 on the
# H100; the gate is about twice that.
SHAPE_INIT_GAP = 0.05
TOY_DEC = DeepSDFConfig(code_dim=16, hidden=96, num_layers=6, latent_in=(3,))  # the JAX tests' toy width
DET2D_RECIPE = dict(steps=3000, scenes=8, lr=2e-3)  # run_synthetic --detector's, seed 7
DET2D_SEED = 7
DET2D_RECALL, DET2D_FP = 0.4, 2  # tests/test_detector2d.py's bars (recall at IoU > 0.4, false positives)
DET2D_BOX_GAP, DET2D_MASK_AGREE = 0.5, 0.999  # phase 19 card vs CPU: box px, mask pixel share
DET3D_STEPS = 800  # train_detector3d's default
DET3D_BARS = {"recall": 0.85, "fp_per_scan": 0.75, "centre_m": 0.6, "size_m": 0.6, "yaw_deg": 20.0}
DET_STEP_GAP = 1e-4  # one training step card vs CPU, relative
# Phase 21: the sharded BA at run_kitti's whole-map capacity (kmax 128, nmax
# 16384, emax 131072) with stereo edges, as a KITTI map has (monocular
# edges leave the scale free, and world sizes then part along it), 5%
# outliers, 32 objects (omax) with 16-slot measurement rings, 10 LM
# trips.  World sizes 1 and 2 sum in another order, and after 10 trips
# this problem is determined to about 1e-3 m in f32: on the CPU
# (`tools/dist_world_gap.py`) the costs agree to 1.3e-7, the poses to
# 1.0e-3 m, the points to 1.5e-3 m (median) and 4.2e-3 m (99.9th
# percentile), one point seen three times by outliers 7.5 m apart; the
# points with 4 or more observations 6.2e-3 m at most.  Gates: cost
# (relative), poses and object poses (m), the points' 99.9th percentile
# (m), and the most any point with 4 or more inlier observations moves
# (m; on the drive's map, whose outliers carry no label, 4 or more
# observations), so that a fault in a few well-constrained points cannot
# pass.
DIST_PROBLEM = dict(num_cams=128, num_points=16384, obs_per_point=8, stereo=True, seed=0)
DIST_BF = 0.08 * 520.9  # the problem's baseline (m) times fx (px)
DIST_OBJECTS, DIST_RING, DIST_ITERS = 32, 16, 10
DIST_GAPS = {"cost": 1e-5, "poses": 5e-3, "points_p999": 1e-2, "points_max_4_seen": 1e-2}
REPLAY = "qsp_slam_tpu_torch.parallel.replay:main"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of `fn()` over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def zero_counts():
    fast_score_nms_pyramid.launches = 0
    hamming_packed.launches = 0
    hamming_packed.shapes.clear()


def read_counts() -> dict:
    return {"fast_nms": fast_score_nms_pyramid.launches, "hamming": hamming_packed.launches,
            "hamming_shapes": {f"{a}x{b}": n for (a, b), n in sorted(hamming_packed.shapes.items())}}


def planted_words(A: int, B: int, gen):
    """Random packed descriptors; rows 0, 2, ... of the first half of A copy
    a B row (distance 0), rows 1, 3, ... its complement (distance 256)."""
    def words(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    a, b = words(A), words(B)
    rows = torch.arange((A + 1) // 2, device="cuda")
    even = rows % 2 == 0
    a[rows] = torch.where(even[:, None], b[rows % B], ~b[rows % B])
    return a, b, rows, even


def check_k2(a, b, what: str, rows=None, even=None) -> None:
    got, ref = hamming_packed(a, b), hamming_packed_plain(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"K2 differs from plain: {what}")
    if rows is not None and not torch.equal(got[rows, rows % b.shape[0]], torch.where(even, 0, 256).to(torch.int32)):
        raise AssertionError(f"K2 misses the planted distances 0 and 256: {what}")


def k2_bound(A, B):
    """K2's least time: the (A, B) int32 write and the packed inputs, against
    the +-1 int8 product on the tensor cores."""
    return {"bytes": ((A + B) * 32 + A * B * 4) / HBM_BYTES_PER_S,
            "operations": 2 * A * B * 256 / INT8_OPS_PER_S}


def k2_times(a, b, gen, reps: int) -> dict:
    """K2 on the packed rows (a, b) by CUDA events, beside its plain version
    and bound, and the yardsticks: the same product as one f32 matmul and as
    one int8 matmul (the JAX matcher's formulation) of random ±1 rows of
    the same shapes, neither called by the port."""
    A, B = a.shape[0], b.shape[0]
    pm_a, pm_b = (torch.where(torch.rand(n, 256, generator=gen, device="cuda") < 0.5, 1, -1).to(torch.int8)
                  for n in (A, B))
    bound = k2_bound(A, B)
    return {
        "ms": cuda_ms(lambda: hamming_packed(a, b), reps),
        "plain_ms": cuda_ms(lambda: hamming_packed_plain(a, b), 5),
        "bound_ms": max(bound.values()) * 1e3,
        "bound_by": max(bound, key=bound.get),
        "library_ms": cuda_ms(lambda: (256 - pm_a.float() @ pm_b.float().T) // 2, 20),
        "library_int8_ms": cuda_ms(lambda: (256 - torch._int_mm(pm_a, pm_b.T)) // 2, 50),
    }


def lost_frame(sysm, g8, d16, what: str, profile: Path | None = None) -> dict:
    """Track one frame that the motion model loses, timed with CUDA events
    around the whole frame; the launch counters cover this frame only.
    With `profile` (a file), the frame runs under torch.profiler instead:
    the device's busy time in it is logged and the operator table written
    there (the profiler slows the host, so the frame's time is not kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = {k: sysm.stats.get(k, 0) for k in ("ref_kf_recoveries", "relocalizations")}
    torch.cuda.synchronize()
    zero_counts()
    if profile:
        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            T = sysm.track_rgbd(g8, d16)
            torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in pr.events() if e.device_type == DeviceType.CUDA)
        profile.write_text(pr.key_averages().table(sort_by="cuda_time_total", row_limit=40))
        log(f"  {what}: device busy {busy / 1e3:.3f} ms in the profiled lost frame (table in {profile})")
        return {"T": T, "device_busy_ms": busy / 1e3}
    e0.record()
    T = sysm.track_rgbd(g8, d16)
    e1.record()
    torch.cuda.synchronize()
    counts = read_counts()
    tiers = {k: sysm.stats.get(k, 0) - v for k, v in before.items()}
    log(f"  {what}: lost frame {e0.elapsed_time(e1):.3f} ms, tiers {tiers}, launches {counts}")
    return {"T": T, "ms": e0.elapsed_time(e1), "tiers": tiers, "launches": counts}


def tum_path(cfg) -> dict:
    """Phase 7: fabricate a sequence, run the TUM command line on it."""
    native_loader.library()  # the decoder's build is not part of the run
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir, out_dir = os.path.join(tmp, "seq"), os.path.join(tmp, "out")
        make_tum.main([seq_dir, "--frames", str(FRAMES)])
        conf = os.path.join(tmp, "seq.yaml")
        Path(conf).write_text(f"ORBextractor.nFeatures: {cfg.orb.num_features}\n")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = run_tum.main([seq_dir, "--config", conf, "--save-dir", out_dir])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        ts, Tcw = load_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
        gt = np.stack([np.linalg.inv(f[3]) for f in TumSequence(seq_dir).frames])
        reread_ate = ate_rmse(Tcw, gt)
    log(f"phase 7 TUM command line: {len(ts)} frames decoded by {out['decoded_by']}, "
        f"{wall_ms / FRAMES:.3f} ms/frame end to end (decode, tracking, saves; track median "
        f"{out['track_ms_median']:.3f}), {out['keyframes']} keyframes, ATE {out['ate_rmse_m']:.5f} m, "
        f"RPE {out['rpe_trans_rmse']:.5f} m / {out['rpe_rot_rmse_deg']:.4f} deg per frame, "
        f"keyframe ATE {out.get('kf_ate_rmse_m')}, launches {counts}; CameraTrajectory.txt re-read: "
        f"{len(ts)} poses, ATE {reread_ate:.5f} m")
    if not (out["ate_rmse_m"] < 0.05 and len(ts) == FRAMES and abs(reread_ate - out["ate_rmse_m"]) < 1e-4):
        raise AssertionError(f"TUM path failed: {out}, re-read ATE {reread_ate}, {len(ts)} poses")
    if counts["fast_nms"] != FRAMES or counts["hamming"] < 1 or sum(out["decoded_by"].values()) != FRAMES:
        raise AssertionError(f"TUM path: launches {counts}, decoders {out['decoded_by']}")
    return {"ms_per_frame": wall_ms / FRAMES, "launches": counts, "out": out}


def svd_ms(candidates: int) -> float:
    """Time of the batched SVDs that one PnP pass over `candidates`
    candidates makes (128 hypotheses per pool and candidate): 12x12 and
    3x3 for the DLT pool, 4x3, 8x9 and 3x3 for the planar pool."""
    g = torch.Generator(device="cuda").manual_seed(2)
    mats = [torch.randn(candidates * 128, r, c, generator=g, device="cuda")
            for r, c in ((12, 12), (3, 3), (4, 3), (8, 9), (3, 3))]
    return cuda_ms(lambda: [torch.linalg.svd(m) for m in mats], 10)


def recovery_path(cfg, frames, Tcw_gt, sysm_main, profile: Path | None) -> dict:
    """Phase 8: the kick (reference-keyframe tier) and the teleport
    (relocalization), each a lost frame of its own."""
    kick_sys = SlamSystem(cfg, device="cuda")
    for g8, d16 in frames[:12]:
        kick_sys.track_rgbd(g8, d16)
    kick = np.eye(4, dtype=np.float32)
    kick[0, 3] = 2.0
    kick_sys.velocity = kick
    k = lost_frame(kick_sys, *frames[12], "kick (2 m) after 12 frames")
    err = float(np.linalg.norm(k["T"][:3, 3] - Tcw_gt[12][:3, 3]))
    for i in range(13, 16):
        T = kick_sys.track_rgbd(*frames[i])
    err_after = float(np.linalg.norm(T[:3, 3] - Tcw_gt[15][:3, 3]))
    log(f"  kick: error {err:.5f} m at the lost frame, {err_after:.5f} m three frames on")
    if k["tiers"] != {"ref_kf_recoveries": 1, "relocalizations": 0} or err >= 0.08 or err_after >= 0.08:
        raise AssertionError(f"the reference-keyframe tier did not recover the kick: {k['tiers']}, {err}")
    # The first lost frame of the process also pays cuSOLVER's start-up;
    # a second kick times the tier warm.
    kick_sys.velocity = kick
    k2 = lost_frame(kick_sys, *frames[16], "kick again at frame 16 (warm)")
    if k2["tiers"] != k["tiers"] or np.linalg.norm(k2["T"][:3, 3] - Tcw_gt[16][:3, 3]) >= 0.08:
        raise AssertionError(f"the second kick was not recovered: {k2['tiers']}")
    if profile:
        kick_sys.velocity = kick
        lost_frame(kick_sys, *frames[17], "kick at frame 17, profiled", profile=profile / "lost_kick.txt")

    # The motion model predicts a half turn, so no map point is in view: a
    # milder wrong prediction can still pass the consistency gate on this
    # repetitive texture at 4000 features.
    sysm_main.velocity = lie.exp_se3(torch.tensor([0, 0, 0, 0, 3.1, 0])).numpy()
    t = lost_frame(sysm_main, *frames[2], f"teleport from frame {FRAMES - 1} back to frame 2")
    err_t = float(np.linalg.norm(t["T"][:3, 3] - Tcw_gt[2][:3, 3]))
    log(f"  teleport: error {err_t:.5f} m")
    if t["tiers"] != {"ref_kf_recoveries": 0, "relocalizations": 1} or err_t >= 0.1:
        raise AssertionError(f"relocalization did not recover the teleport: {t['tiers']}, {err_t}")
    sysm_main.velocity = lie.exp_se3(torch.tensor([0, 0, 0, 0, 3.1, 0])).numpy()
    t2 = lost_frame(sysm_main, *frames[2], "the same teleport again (warm)")
    if t2["tiers"] != t["tiers"] or np.linalg.norm(t2["T"][:3, 3] - Tcw_gt[2][:3, 3]) >= 0.1:
        raise AssertionError(f"the second teleport was not recovered: {t2['tiers']}")
    if profile:
        sysm_main.velocity = lie.exp_se3(torch.tensor([0, 0, 0, 0, 3.1, 0])).numpy()
        lost_frame(sysm_main, *frames[2], "the same teleport, profiled", profile=profile / "lost_teleport.txt")
    svd = {"reference_keyframe": svd_ms(1), "relocalization": svd_ms(RELOC_K)}
    log(f"  batched SVDs of one PnP pass, ms by events: {svd}")

    # K2 at the recovery shapes against plain: planted rows, then the
    # teleport frame's features against its relocalization's stacked
    # snapshot table (each row must start 16-byte aligned).
    F = cfg.orb.num_features
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = ((F, SNAP), (RELOC_K * SNAP, F))
    k2_in = {}
    for A, B in shapes:
        a, b, rows, even = planted_words(A, B, gen)
        check_k2(a, b, f"recovery shape ({A}, {B})", rows, even)
        k2_in[(A, B)] = (a, b)
    frame = process_frame(torch.from_numpy(frames[2][0]).cuda(),
                          torch.from_numpy(frames[2][1].astype(np.int32)).cuda().float() / cfg.depth_png_scale, cfg)
    ls = sysm_main.loop_state
    table = pack_pm(ls.kf_desc[: min(RELOC_K, int(ls.db.count))].reshape(-1, 256))
    if table.data_ptr() % 16 or table.stride(0) * 4 % 16:
        raise AssertionError("the stacked snapshot table is not 16-byte aligned per row")
    check_k2(table, frame.feats.desc_bits, f"stacked snapshot table {tuple(table.shape)} x features")
    check_k2(frame.feats.desc_bits, pack_pm(ls.kf_desc[int(sysm_main.map_state.num_kfs) - 1]),
             "features x newest snapshot")
    log(f"phase 8 recovery: K2 at {shapes} exactly equal to plain (planted rows at distance 0 and 256), "
        f"and on the teleport frame's features against real snapshot tables")

    times = {}
    for A, B in shapes:
        times[f"{A}x{B}"] = k2_times(*k2_in[(A, B)], gen, 200)
        log(f"  K2 at ({A}, {B}): {times[f'{A}x{B}']}")
    return {"kick": k, "kick_warm": k2, "teleport": t, "teleport_warm": t2, "svd_ms": svd,
            "k2": times, "k2_inputs": k2_in}


def stereo_cfg(seq: KittiSequence, num_features: int, levels: int = 8) -> TrackingConfig:
    """`run_kitti`'s configuration for a sequence."""
    intr = seq.intrinsics
    H, W = seq.load_gray_pair(0)[0].shape
    return TrackingConfig(
        orb=OrbConfig(num_features=num_features, pyramid=PyramidConfig(num_levels=levels, height=H, width=W)),
        fx=float(intr["fx"]), fy=float(intr["fy"]), cx=float(intr["cx"]), cy=float(intr["cy"]),
        width=W, height=H, baseline=seq.baseline, depth_max=60.0, local_map_budget=8192)


def kitti_path(tmp: str, keep: int) -> dict:
    """Phase 9: fabricate a forward drive at KITTI's size, run the KITTI
    command line on it; then the card against the CPU on a small drive.
    Returns the numbers, the first stereo pair (for the K1 check), and the
    drive's configuration and first `keep` pairs (for the profile)."""
    seq_dir, out_dir, poses = (os.path.join(tmp, n) for n in ("kitti", "kitti_out", "kitti_poses.txt"))
    t0 = time.perf_counter()
    make_kitti.main([seq_dir, "--frames", str(KITTI_FRAMES), "--height", str(KITTI_H), "--width", str(KITTI_W),
                     "--seed", "2", "--poses-out", poses])
    make_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = run_kitti.main([seq_dir, "--poses", poses, "--save-dir", out_dir])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    report = json.loads(Path(out_dir, "report.json").read_text())
    log(f"phase 9 KITTI command line: {KITTI_FRAMES} frames at {KITTI_W}x{KITTI_H}, {KITTI_F} features "
        f"(make_kitti {make_s:.1f} s): {wall_ms / KITTI_FRAMES:.3f} ms/frame end to end (decode, tracking, saves; "
        f"track median {out['track_ms_median']:.3f}, BA median {out['ba_ms_median']}), {out['keyframes']} keyframes, "
        f"ATE {out['ate_rmse_m']:.5f} m, RPE {out['rpe_trans_rmse']:.5f} m / {out['rpe_rot_rmse_deg']:.4f} deg per "
        f"frame, keyframe ATE {out.get('kf_ate_rmse_m')}, loops {out['loops_closed']}, loop scan rows "
        f"{len(report['loop_scan'])}, resets {report['resets']}, relocalizations {report['relocalizations']}, "
        f"peak RSS {report['peak_rss_mb']} MB; launches {counts}")
    if not (out["ate_rmse_m"] < 0.6 and out["rpe_trans_rmse"] < 0.25 and out["keyframes"] >= 4):
        raise AssertionError(f"KITTI path failed: {out}")
    if counts["fast_nms"] != KITTI_FRAMES or counts["hamming"] < 1:
        raise AssertionError(f"KITTI path: K1 must launch once per stereo frame: {counts}")
    drive = KittiSequence(seq_dir)
    first_pair = [torch.from_numpy(g).cuda() for g in drive.load_gray_pair(0)]
    kept = {"cfg": stereo_cfg(drive, KITTI_F), "pairs": [drive.load_gray_pair(i) for i in range(keep)]}

    # The card against the CPU on a small drive.
    small_dir = os.path.join(tmp, "kitti_small")
    make_kitti.main([small_dir, "--frames", "10", "--seed", "2", "--poses-out", os.path.join(tmp, "kitti_small_poses.txt")])
    seq = KittiSequence(small_dir)
    cfg = stereo_cfg(seq, 500)
    pairs = list(seq.prefetch_pairs(range(10)))
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = SlamSystem(cfg, kmax=16, nmax=4096, emax=32768, device=dev)
        for gl, gr in pairs:
            runs[dev].track_stereo(gl, gr)
    p = {dev: positions_from_Tcw(np.stack(r.trajectory).astype(np.float64)) for dev, r in runs.items()}
    gap = float(np.linalg.norm(p["cuda"] - p["cpu"], axis=1).max())
    log(f"  stereo card vs CPU reference, 10 frames at 500 features, 624x192: max centre gap {gap:.2e} m, "
        f"keyframes {runs['cuda'].stats['kf_frames']} vs {runs['cpu'].stats['kf_frames']}")
    if gap > 0.01 or runs["cuda"].stats["kf_frames"] != runs["cpu"].stats["kf_frames"]:
        raise AssertionError("stereo card and CPU runs disagree")
    return {"ms_per_frame": wall_ms / KITTI_FRAMES, "launches": counts, "out": out, "pair": first_pair,
            "cpu_gap_m": gap, "kept": kept}


class EventTimes:
    """CUDA-event times of the loop closer's stages: every verification,
    and every correction from the pose graph to the end of the global BA.
    Installed over the system module's names, so the facade's own calls
    are timed."""

    def __init__(self):
        self.verify, self.correct = [], []
        self._saved = {n: getattr(system_mod, n) for n in ("verify_loop", "correct_loop", "global_ba_step")}
        self._start = None

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __enter__(self):
        verify, correct, gba = (self._saved[n] for n in ("verify_loop", "correct_loop", "global_ba_step"))

        def timed_verify(*a, **k):
            e0 = self._event()
            out = verify(*a, **k)
            e1 = self._event()
            torch.cuda.synchronize()
            self.verify.append(e0.elapsed_time(e1))
            return out

        def timed_correct(*a, **k):
            self._start = self._event()
            return correct(*a, **k)

        def timed_gba(*a, **k):
            out = gba(*a, **k)
            e1 = self._event()
            torch.cuda.synchronize()
            self.correct.append(self._start.elapsed_time(e1))
            return out

        system_mod.verify_loop, system_mod.correct_loop, system_mod.global_ba_step = (
            timed_verify, timed_correct, timed_gba)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(system_mod, n, fn)


def loop_path(tmp: str) -> dict:
    """Phase 10: the miniature circuit through `SlamSystem.track_stereo`."""
    root = os.path.join(tmp, "circuit")
    n = 240
    make_kitti.make_kitti_sequence(root, num_frames=n, num_cars=6, height=128, width=416, step=0.6, seed=5,
                                   loop=True, loop_overlap=90, poses_out=os.path.join(root, "poses.txt"))
    seq = KittiSequence(root, os.path.join(root, "poses.txt"))
    # 6 levels: at 128 px the 8-level top is smaller than the descriptor window.
    cfg = stereo_cfg(seq, 1000, levels=6)
    pairs = list(seq.prefetch_pairs(range(n)))
    sysm = SlamSystem(cfg, kmax=64, nmax=16384, emax=131072)
    torch.cuda.synchronize()
    zero_counts()
    with EventTimes() as ev:
        t0 = time.perf_counter()
        for gl, gr in pairs:
            sysm.track_stereo(gl, gr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(n)])
    kf_frames = np.asarray(sysm.stats["kf_frames"])
    n_kf = int(sysm.map_state.num_kfs)
    live = sysm.map_state.kf_valid[:n_kf].cpu().numpy()
    kf_ate = ate_rmse(sysm.map_state.kf_Tcw[:n_kf].cpu().numpy()[live], gt[kf_frames[live]])
    frozen_ate = ate_rmse(np.stack(sysm.trajectory), gt)
    events = sysm.stats.get("loop_events", [])
    log(f"phase 10 loop closing, {n}-frame circuit at 416x128: {wall_ms / n:.3f} ms/frame, "
        f"{sysm.stats['keyframes']} keyframes, loops {sysm.loops_closed} {events}, corrected keyframe ATE "
        f"{kf_ate:.4f} m vs frozen per-frame ATE {frozen_ate:.4f} m, resets {sysm.stats.get('resets', 0)}, "
        f"relocalizations {sysm.stats.get('relocalizations', 0)}, verifications {len(ev.verify)}; launches {counts}")
    log(f"  verification ms by events: {[round(t, 3) for t in ev.verify]}; correction (pose graph + global BA) "
        f"ms by events: {[round(t, 3) for t in ev.correct]}")
    if sysm.loops_closed < 1 or events[0][2] < 40 or not kf_ate < min(2.0, frozen_ate):
        raise AssertionError(f"loop closing failed: loops {sysm.loops_closed}, events {events}, "
                             f"kf ATE {kf_ate}, frozen {frozen_ate}, scan tail {sysm.stats.get('loop_scan', [])[-12:]}")
    if counts["fast_nms"] != n or counts["hamming_shapes"].get(f"1000x{SNAP}", 0) < len(ev.verify):
        raise AssertionError(f"loop path launches: {counts}")
    return {"ms_per_frame": wall_ms / n, "launches": counts, "loops": sysm.loops_closed, "events": events,
            "kf_ate_m": kf_ate, "frozen_ate_m": frozen_ate, "verify_ms": ev.verify, "correct_ms": ev.correct}


class FrameTimes:
    """Host-clock ms of every call of a `SlamSystem` tracking method
    (synchronised), whether the system was initialized before it, and the
    system itself: installed over the class, so a command line's own
    system is timed."""

    def __init__(self, method: str = "track_mono"):
        self.ms, self.was_init, self.system = [], [], None
        self.method = method
        self._saved = getattr(SlamSystem, method)

    def __enter__(self):
        saved = self._saved

        def timed(sysm, *a, **k):
            self.system = sysm
            self.was_init.append(sysm.initialized)
            t0 = time.perf_counter()
            out = saved(sysm, *a, **k)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(SlamSystem, self.method, timed)
        return self

    def __exit__(self, *exc):
        setattr(SlamSystem, self.method, self._saved)


class StepDumps:
    """The monocular path's intermediate results, in call order: the
    bootstrap's second pose and points (`mono_initialize`), every keyframe
    pose after each local BA (`local_ba_step`) and every object after each
    refinement (`refine_objects_mono`).  Installed over the system
    module's names, as `EventTimes` is."""

    NAMES = ("mono_initialize", "local_ba_step", "refine_objects_mono")

    def __init__(self):
        self.steps = []
        self._saved = {n: getattr(system_mod, n) for n in self.NAMES}

    def __enter__(self):
        boot, ba, refine = (self._saved[n] for n in self.NAMES)

        def dump_boot(*a, **k):
            out = boot(*a, **k)
            if bool(out.ok):
                ok = out.pt_ok.cpu().numpy()
                self.steps.append(("bootstrap T_cw2", out.T_cw2.cpu().numpy()))
                self.steps.append(("bootstrap pts_w", np.where(ok[:, None], out.pts_w.cpu().numpy(), 0.0)))
            return out

        def dump_ba(*a, **k):
            m = ba(*a, **k)
            self.steps.append((f"keyframes after local BA (kf {int(m.num_kfs) - 1})",
                               m.kf_Tcw[: int(m.num_kfs)].cpu().numpy()))
            return m

        def dump_refine(*a, **k):
            t = refine(*a, **k)
            self.steps.append(("objects after refine_objects_mono",
                               np.where(t.valid.cpu().numpy()[:, None], t.ellipsoid.cpu().numpy(), 0.0)))
            return t

        system_mod.mono_initialize, system_mod.local_ba_step, system_mod.refine_objects_mono = (
            dump_boot, dump_ba, dump_refine)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(system_mod, n, fn)


class ObjectStepDumps:
    """The RGB-D and stereo object step's intermediate results, in call
    order (queue C's trace): the ground plane of each keyframe
    (`estimate_ground_plane`, `_points`), the Manhattan planes, the depth
    samples and support planes of the structured fit, every fit
    (`fit_ellipsoid_points`), the association, the integrated table, the
    refined table (`refine_objects`) and the merged one.  Installed over
    the system module's names, as `StepDumps` is."""

    NAMES = ("estimate_ground_plane", "estimate_ground_plane_points", "extract_manhattan_planes",
             "sample_bbox_depth_points", "select_support_plane", "fit_ellipsoid_points", "associate_detections",
             "integrate_keyframe", "refine_objects", "merge_duplicates")

    def __init__(self):
        self.steps = []
        self._saved = {n: getattr(system_mod, n) for n in self.NAMES}

    @staticmethod
    def _table(t):
        v = t.valid.cpu().numpy()
        return np.where(v[:, None], t.ellipsoid.cpu().numpy(), 0.0)

    def __enter__(self):
        show = {
            "estimate_ground_plane": lambda r: np.concatenate([r.plane.cpu().numpy(), [float(r.ok)]]),
            "estimate_ground_plane_points": lambda r: np.concatenate([r.plane.cpu().numpy(), [float(r.ok)]]),
            "extract_manhattan_planes": lambda r: np.concatenate([r[0].cpu().numpy().reshape(-1),
                                                                  r[1].cpu().numpy().reshape(-1)]),
            "sample_bbox_depth_points": lambda r: np.where(r[1].cpu().numpy()[..., None], r[0].cpu().numpy(), 0.0),
            "select_support_plane": lambda r: r.cpu().numpy(),
            "fit_ellipsoid_points": lambda r: np.where(r.ok.cpu().numpy()[:, None], r.ellipsoid_cam.cpu().numpy(),
                                                       0.0),
            "associate_detections": lambda r: r.obj_for_det.cpu().numpy().astype(np.float64),
            "integrate_keyframe": self._table, "refine_objects": self._table, "merge_duplicates": self._table,
        }

        def wrap(name, fn):
            def dumped(*a, **k):
                out = fn(*a, **k)
                self.steps.append((name, show[name](out)))
                return out
            return dumped

        for n, fn in self._saved.items():
            setattr(system_mod, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(system_mod, n, fn)


def ellipsoid_gaps(a: np.ndarray, b: np.ndarray) -> dict:
    """Max card-vs-CPU gap of (N, 9) ellipsoid rows by part: centres and
    half-axes (m), Euler angles modulo 2 pi and the angle between the two
    rotations (rad)."""
    d = np.abs(a - b)
    eul = np.abs((a[:, 3:6] - b[:, 3:6] + np.pi) % (2 * np.pi) - np.pi)
    Ra, Rb = (quadric.euler_to_rotmat(torch.from_numpy(np.asarray(x[:, 3:6], np.float64))).numpy() for x in (a, b))
    cos = (np.einsum("nij,nij->n", Ra, Rb) - 1.0) / 2.0
    return {"centre": float(d[:, :3].max(initial=0.0)), "euler": float(eul.max(initial=0.0)),
            "rotation": float(np.arccos(np.clip(cos, -1.0, 1.0)).max(initial=0.0)),
            "half_axes": float(d[:, 6:9].max(initial=0.0))}


def object_gaps_ok(g: dict) -> bool:
    return all(g[k] <= bound for k, bound in OBJECT_GAPS.items())


def object_step_trace(a: list, b: list) -> dict:
    """Queue C's trace of two runs' `ObjectStepDumps`: each step's max gap
    in call order, the first step past 1e-5 and, for the ellipsoid steps,
    the gap by part."""
    gaps = step_gaps(a, b)
    first = next(((i, name) for i, (name, g) in enumerate(gaps) if g > 1e-5), None)
    parts = {}
    for (na, xa), (nb, xb) in zip(a, b):
        if na == nb and na in ("fit_ellipsoid_points", "integrate_keyframe", "refine_objects", "merge_duplicates") \
                and xa.shape == xb.shape:
            g = ellipsoid_gaps(xa, xb)
            parts[na] = {k: max(v, parts.get(na, {}).get(k, 0.0)) for k, v in g.items()}
    ok = (len(a) == len(b) == len(gaps) and all(g <= OBJECT_STEP_GAP for n, g in gaps if n in OBJECT_STEPS_EXACT)
          and all(object_gaps_ok(g) for g in parts.values()))
    return {"steps": len(gaps), "same_steps": len(a) == len(b) == len(gaps), "first_past_1e-5": first,
            "max_by_step": {n: max(g for m, g in gaps if m == n) for n, _ in gaps}, "ellipsoid_parts": parts,
            "sequence": [(n, float(f"{g:.2e}")) for n, g in gaps], "within_bounds": ok}


def step_gaps(a: list, b: list) -> list:
    """(step, max abs gap) for the steps the two runs share, in order."""
    return [(na, float(np.abs(xa - xb).max(initial=0.0)) if xa.shape == xb.shape else float("inf"))
            for (na, xa), (nb, xb) in zip(a, b) if na == nb]


def mono_path(tmp: str, keep: int) -> dict:
    """Phases 11-12: the monocular command line with objects at full width,
    then the card against the CPU on its first frames.  The first `keep`
    frames and their detections are returned (for the profile)."""
    seq_dir = os.path.join(tmp, "mono")
    t0 = time.perf_counter()
    make_tum.main([seq_dir, "--frames", str(MONO_FRAMES), "--objects", "3", "--detections", "--step", "0.025",
                   "--pitch", "0.4", "--seed", "2"])
    make_s = time.perf_counter() - t0
    det_dir = os.path.join(seq_dir, "detections")
    torch.cuda.synchronize()
    zero_counts()
    with FrameTimes("track_mono") as mf:
        t0 = time.perf_counter()
        out = run_mono.main([seq_dir, "--detections", det_dir])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    sysm = mf.system
    kf_frames = sysm.stats.get("kf_frames", [])
    valid = sysm.objects.valid.cpu().numpy()
    labels = sorted(int(x) for x in sysm.objects.label.cpu().numpy()[valid])
    tracked = [ms for ms, init in zip(mf.ms, mf.was_init) if init]
    attempts = mf.was_init.index(True) - 1 if True in mf.was_init else len(mf.ms)
    res = {"ms_per_frame_end_to_end": wall_ms / MONO_FRAMES, "ms_per_frame_median_tracked": float(np.median(tracked)),
           "bootstrap_attempts": attempts, "kf_frames": kf_frames, "ba_ms": sysm.stats["ba_ms"],
           "obj_ms": sysm.stats["obj_ms"], "labels": labels, "launches": counts, "out": out}
    log(f"phase 11 mono command line: {MONO_FRAMES} frames at 640x480, {MONO_F} features, objects from "
        f"detections (make_tum {make_s:.1f} s): {wall_ms / MONO_FRAMES:.3f} ms/frame end to end, median "
        f"{res['ms_per_frame_median_tracked']:.3f} ms per tracked frame (host clock around track_mono), "
        f"bootstrap after {attempts} attempts, keyframes at frames {kf_frames}, ATE (Sim3) "
        f"{out.get('ate_rmse_m_sim3')}, {out['num_points']} points, objects {out['num_objects']} labels {labels}, "
        f"local BA ms per keyframe {[round(x, 1) for x in sysm.stats['ba_ms']]}, object ms per keyframe "
        f"{[round(x, 1) for x in sysm.stats['obj_ms']]}, resets {sysm.stats.get('resets', 0)}, "
        f"relocalizations {sysm.stats.get('relocalizations', 0)}; launches {counts}")
    scene_labels = {0, 1, 2}  # make_scene labels object i as i % 3
    if not (sysm.initialized and out["keyframes"] >= 3 and out.get("ate_rmse_m_sim3", np.inf) < 0.1
            and out["num_objects"] >= 2 and set(labels) <= scene_labels):
        raise AssertionError(f"mono path failed: {out}, labels {labels}")
    if counts["fast_nms"] != MONO_FRAMES or any(counts["hamming_shapes"].get(f"{a}x{b}", 0) < 1 for a, b in MONO_K2):
        raise AssertionError(f"mono path launches: {counts}")

    # 12. the card against the CPU on the first frames, with detections.
    seq = TumSequence(seq_dir)
    grays = [seq.load(i)[0] for i in range(max(MONO_SMALL, keep))]
    dets = [load_detection_cache(os.path.join(det_dir, f"{i}.npz")) for i in range(max(MONO_SMALL, keep))]
    res["kept"] = list(zip(grays, dets))[:keep]
    small = TrackingConfig(orb=OrbConfig(num_features=500))
    runs, dumps = {}, {}
    for dev in ("cuda", "cpu"):
        runs[dev] = SlamSystem(small, enable_objects=True, device=dev)
        with StepDumps() as sd:
            for g, d in zip(grays[:MONO_SMALL], dets[:MONO_SMALL]):
                runs[dev].track_mono(g, d)
        dumps[dev] = sd.steps
    p = {dev: positions_from_Tcw(np.stack(r.trajectory).astype(np.float64)) for dev, r in runs.items()}
    gap = float(np.linalg.norm(p["cuda"] - p["cpu"], axis=1).max())
    objs = {dev: (r.objects.valid.cpu().numpy(), r.objects.label.cpu().numpy()) for dev, r in runs.items()}
    same_objs = all((objs["cuda"][i] == objs["cpu"][i]).all() for i in range(2))
    ell_gap = float(np.abs(runs["cuda"].objects.ellipsoid.cpu().numpy() - runs["cpu"].objects.ellipsoid.numpy())
                    [objs["cpu"][0]].max(initial=0.0))
    log(f"phase 12 mono card vs CPU, {MONO_SMALL} frames at 500 features: max centre gap {gap:.2e} (gauge units), "
        f"keyframes {runs['cuda'].stats['kf_frames']} vs {runs['cpu'].stats['kf_frames']}, objects "
        f"{int(objs['cuda'][0].sum())} vs {int(objs['cpu'][0].sum())} (same slots and labels: {same_objs}), "
        f"max ellipsoid gap {ell_gap:.2e}")
    gaps = step_gaps(dumps["cuda"], dumps["cpu"])
    first = next((name for name, g in gaps if g > 1e-4), None)
    log(f"  per-step card-vs-CPU gaps: {[(name, float(f'{g:.2e}')) for name, g in gaps]}; first step past 1e-4: "
        f"{first}")
    if (gap > MONO_GAP or runs["cuda"].stats["kf_frames"] != runs["cpu"].stats["kf_frames"]
            or not runs["cuda"].initialized or not same_objs or len(gaps) != len(dumps["cpu"])
            or any(g > bound for name, g in gaps for step, bound in MONO_STEP_GAPS.items()
                   if name.startswith(step))):
        raise AssertionError("mono card and CPU runs disagree")
    res.update(cpu_gap=gap, ell_gap=ell_gap, step_gaps=gaps)
    return res


class CallTimes:
    """CUDA-event ms of every call of a module's function, installed over
    its name (the facade's `joint_ba_step`, `detect_objects`): `calls`
    holds (key(*args), ms) for each call, `ms` the times alone."""

    def __init__(self, module, name: str, key=lambda *a, **k: None):
        self.module, self.name, self.key, self.calls = module, name, key, []
        self._saved = getattr(module, name)

    @property
    def ms(self) -> list:
        return [ms for _, ms in self.calls]

    def __enter__(self):
        saved = self._saved

        def timed(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = saved(*a, **k)
            e1.record()
            torch.cuda.synchronize()
            self.calls.append((self.key(*a, **k), e0.elapsed_time(e1)))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._saved)


def joint_times() -> CallTimes:
    """Every `joint_ba_step` the facade calls, keyed by its window (window
    `ba_window`: the local joint BA; window kmax: the global one)."""
    return CallTimes(system_mod, "joint_ba_step", key=lambda m, objects, cfg, window=8: window)


def scene_truth(step: float, pitch: float):
    """Phase 11's scene (`make_tum --objects 3 --seed 2`) in the frame of its
    first camera, the SLAM world: ellipsoids and labels."""
    scene = make_scene(num_objects=3, seed=2, device="cpu")
    first = torch.from_numpy(orbit_trajectory(1, step=step, pitch=pitch)[0])
    return quadric.transform_ellipsoid(scene.ellipsoids, first).numpy(), scene.labels.numpy()


def rgbd_objects_gates(sysm, out: dict, what: str) -> dict:
    """Phase 13's object gates on a `run_tum --detections` run of phase 11's
    sequence (ATE, objects of the scene's labels, one within 0.4 m with its
    label, recall, Manhattan planes with two votes)."""
    valid = sysm.objects.valid.cpu().numpy()
    est, labels = sysm.objects.ellipsoid.cpu().numpy()[valid], sysm.objects.label.cpu().numpy()[valid]
    gt, gt_labels = scene_truth(0.025, 0.4)
    ev = evaluate_objects(est, labels, gt, gt_labels)
    near = [np.linalg.norm(gt[:, :3] - e[:3], axis=1) for e in est]
    matched = sum(d.min() < 0.4 and gt_labels[d.argmin()] == lab for d, lab in zip(near, labels))
    votes = sysm.plane_set.votes.cpu().numpy()
    planes2 = int((sysm.plane_set.valid.cpu().numpy() & (votes >= 2)).sum())
    res = {"labels": sorted(int(x) for x in labels), "matched": int(matched), "planes_2_votes": planes2,
           "votes": votes.tolist(), "ev": ev}
    if not (out["ate_rmse_m"] < 0.05 and out["num_objects"] >= 2 and set(res["labels"]) <= {0, 1, 2}
            and matched >= 1 and planes2 >= 2 and ev.recall >= TUM_OBJ_RECALL):
        raise AssertionError(f"{what} failed: {res}, {out}")
    return res


def rgbd_objects_path(tmp: str) -> dict:
    """Phase 13: `run_tum --detections` on phase 11's sequence at 4000
    features, the objects held to the scene's ground truth."""
    seq_dir = os.path.join(tmp, "mono")
    conf = os.path.join(tmp, "tum4000.yaml")
    Path(conf).write_text(f"ORBextractor.nFeatures: {TUM_OBJ_F}\n")
    torch.cuda.synchronize()
    zero_counts()
    with FrameTimes("track_rgbd") as ft:
        t0 = time.perf_counter()
        out = run_tum.main([seq_dir, "--detections", os.path.join(seq_dir, "detections"), "--config", conf,
                            "--save-dir", os.path.join(tmp, "tum_obj_out")])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    sysm = ft.system
    g = rgbd_objects_gates(sysm, out, "RGB-D object path")
    ev = g.pop("ev")
    tracked = [ms for ms, init in zip(ft.ms, ft.was_init) if init]
    res = {"ms_per_frame_end_to_end": wall_ms / MONO_FRAMES, "ms_per_frame_median": float(np.median(tracked)),
           "kf_frames": sysm.stats["kf_frames"], "ba_ms": sysm.stats["ba_ms"], "obj_ms": sysm.stats["obj_ms"],
           **g, "precision": ev.precision, "recall": ev.recall, "mean_iou": ev.mean_iou, "launches": counts,
           "out": out}
    log(f"phase 13 RGB-D objects, run_tum --detections: {MONO_FRAMES} frames at 640x480, {TUM_OBJ_F} features: "
        f"{res['ms_per_frame_end_to_end']:.3f} ms/frame end to end, median {res['ms_per_frame_median']:.3f} ms per "
        f"tracked frame (host clock around track_rgbd), keyframes at {sysm.stats['kf_frames']}, ATE "
        f"{out['ate_rmse_m']:.5f} m, RPE {out['rpe_trans_rmse']:.5f} m, objects {out['num_objects']} labels "
        f"{res['labels']}, {res['matched']} within 0.4 m of the truth with its label, Manhattan planes with >= 2 "
        f"votes {res['planes_2_votes']} (votes {res['votes']}), precision {ev.precision:.3f} recall "
        f"{ev.recall:.3f} mean IoU {ev.mean_iou:.3f} centre error {ev.mean_center_err:.4f} m; BA ms per keyframe "
        f"{[round(x, 1) for x in sysm.stats['ba_ms']]}, object ms per keyframe "
        f"{[round(x, 1) for x in sysm.stats['obj_ms']]}; launches {counts}")
    if counts["fast_nms"] != MONO_FRAMES or counts["hamming"] < 1:
        raise AssertionError(f"RGB-D object path launches: {counts}")
    return res


def drive_detections(seq: KittiSequence, num_frames: int) -> list:
    """Detections of a perfect 3D detector on a `make_kitti` drive of
    `num_frames` frames at the fabricator's defaults (six cars, seed 2):
    each visible car's box and label, and its ellipsoid in the camera frame
    with `fit_ok` (the fields a 3D detector fills, read by the object
    step's measured-ellipsoid branch).  numpy dicts, one per frame."""
    scene = drive_scene(num_frames=num_frames, device="cpu")[0]
    H, W = seq.load_gray_pair(0)[0].shape
    intr = stereo_cfg(seq, 1).intr
    out = []
    for T_wc in seq.poses[:num_frames]:
        T_cw = torch.from_numpy(np.linalg.inv(T_wc).astype(np.float32))
        det = gt_detections(scene, T_cw, intr, width=W, height=H)
        det["ellipsoid_cam"] = quadric.transform_ellipsoid(scene.ellipsoids, T_cw)
        det["fit_ok"] = det["valid"]
        out.append({k: v.numpy() for k, v in det.items()})
    return out


def stereo_objects_path(tmp: str) -> dict:
    """Phase 14: `run_kitti --lidar-detections --global-ba` on phase 9's
    drive at its defaults, then the same drive through `track_stereo`
    with a perfect 3D detector's detections and `run_global_ba`; every
    joint BA timed by CUDA events."""
    seq_dir, poses = os.path.join(tmp, "kitti"), os.path.join(tmp, "kitti_poses.txt")
    torch.cuda.synchronize()
    zero_counts()
    with FrameTimes("track_stereo") as ft, joint_times() as jt:
        t0 = time.perf_counter()
        out = run_kitti.main([seq_dir, "--poses", poses, "--lidar-detections", "--global-ba", "--save-dir",
                              os.path.join(tmp, "kitti_obj_out")])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    sysm = ft.system
    local = [ms for w, ms in jt.calls if w == sysm.ba_window]
    glob = [ms for w, ms in jt.calls if w == sysm.kmax]
    tracked = [ms for ms, init in zip(ft.ms, ft.was_init) if init]
    res = {"ms_per_frame_end_to_end": wall_ms / KITTI_FRAMES, "ms_per_frame_median": float(np.median(tracked)),
           "kf_frames": sysm.stats["kf_frames"], "obj_ms": sysm.stats["obj_ms"], "det_ms": sysm.stats.get("det_ms", []),
           "joint_local_ms": local, "joint_global_ms": glob, "launches": counts, "out": out,
           "objects_with_measurements": int(((sysm.objects.pm_kf >= 0).sum(1) > 0)[sysm.objects.valid].sum())}
    log(f"phase 14 stereo objects, run_kitti --lidar-detections --global-ba: {KITTI_FRAMES} frames at "
        f"{KITTI_W}x{KITTI_H}, {KITTI_F} features: {res['ms_per_frame_end_to_end']:.3f} ms/frame end to end, median "
        f"{res['ms_per_frame_median']:.3f} ms per tracked frame, keyframes at {sysm.stats['kf_frames']}, ATE "
        f"{out['ate_rmse_m']:.5f} m, RPE {out['rpe_trans_rmse']:.5f} m, objects {out['num_objects']} "
        f"({res['objects_with_measurements']} with pose measurements); object ms per keyframe "
        f"{[round(x, 1) for x in res['obj_ms']]}, LiDAR provider ms {[round(x, 1) for x in res['det_ms']]}, local "
        f"joint BA ms by events {[round(x, 1) for x in local]}, global joint BA ms {[round(x, 1) for x in glob]}; "
        f"launches {counts}")
    # The reference makes no object here (`tools/objects_reference.py`: the
    # cars' boxes hold at most a few stereo keypoints), so neither does the
    # port, and no BA goes joint.
    if not (out["ate_rmse_m"] < 0.6 and out["rpe_trans_rmse"] < 0.25 and out["keyframes"] >= 4
            and out["num_objects"] == KITTI_LIDAR_OBJECTS and not jt.calls):
        raise AssertionError(f"stereo object path failed: {res}")
    if counts["fast_nms"] != KITTI_FRAMES or counts["hamming"] < 1:
        raise AssertionError(f"stereo object path launches: {counts}")

    seq = KittiSequence(seq_dir, poses)
    cfg = stereo_cfg(seq, KITTI_F)
    dets = drive_detections(seq, KITTI_FRAMES)
    pairs = list(seq.prefetch_pairs(range(KITTI_FRAMES)))
    sysm = SlamSystem(cfg, kmax=128, nmax=16384, emax=131072)
    torch.cuda.synchronize()
    zero_counts()
    with FrameTimes("track_stereo") as ft, joint_times() as jt:
        t0 = time.perf_counter()
        for (gl, gr), det in zip(pairs, dets):
            sysm.track_stereo(gl, gr, det)
        sysm.run_global_ba()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    gt = np.stack([np.linalg.inv(T) for T in seq.poses[:KITTI_FRAMES]])
    est = np.stack(sysm.trajectory)
    n_kf = int(sysm.map_state.num_kfs)
    kf_ate = ate_rmse(sysm.map_state.kf_Tcw[:n_kf].cpu().numpy(), gt[np.asarray(sysm.stats["kf_frames"])])
    local = [ms for w, ms in jt.calls if w == sysm.ba_window]
    glob = [ms for w, ms in jt.calls if w == sysm.kmax]
    valid = sysm.objects.valid.cpu().numpy()
    res["system"] = sysm
    res["gt3d"] = g3 = {
        "ms_per_frame_end_to_end": wall_ms / KITTI_FRAMES, "ms_per_frame_median": float(np.median(ft.ms[1:])),
        "kf_frames": sysm.stats["kf_frames"], "obj_ms": sysm.stats["obj_ms"], "joint_local_ms": local,
        "joint_global_ms": glob, "ate_rmse_m": ate_rmse(est, gt), **rpe(est, gt), "kf_ate_rmse_m": kf_ate,
        "objects": int(valid.sum()), "labels": sorted(int(x) for x in sysm.objects.label.cpu().numpy()[valid]),
        "pose_measurements": int((sysm.objects.pm_kf >= 0).sum()), "launches": counts}
    log(f"phase 14 stereo objects from a perfect 3D detector through track_stereo + run_global_ba: "
        f"{g3['ms_per_frame_end_to_end']:.3f} ms/frame end to end (median {g3['ms_per_frame_median']:.3f}), keyframes "
        f"at {g3['kf_frames']}, ATE {g3['ate_rmse_m']:.5f} m, RPE {g3['rpe_trans_rmse']:.5f} m, keyframe ATE after "
        f"the global BA {kf_ate:.5f} m, objects {g3['objects']} labels {g3['labels']}, pose measurements "
        f"{g3['pose_measurements']}; object ms per keyframe {[round(x, 1) for x in g3['obj_ms']]}, local joint BA ms "
        f"by events {[round(x, 1) for x in local]}, global joint BA ms {[round(x, 1) for x in glob]}; launches {counts}")
    if not (g3["ate_rmse_m"] < 0.6 and g3["rpe_trans_rmse"] < 0.25 and len(g3["kf_frames"]) >= 4
            and g3["objects"] >= 1 and len(local) >= 1 and len(glob) == 1 and jt.calls[-1][0] == sysm.kmax):
        raise AssertionError(f"stereo joint path failed: {g3}")
    if counts["fast_nms"] != KITTI_FRAMES:
        raise AssertionError(f"stereo joint path launches: {counts}")
    return res


def objects_card_vs_cpu(tmp: str) -> dict:
    """Phase 15: the object paths on the card against the CPU: 10 RGB-D
    frames of phase 13's scene at 500 features with the renderer's
    detections, and 10 frames of phase 9's small drive with a perfect 3D
    detector's (the local and global joint BA run)."""
    scene = make_scene(num_objects=3, seed=2, device="cpu")
    traj = orbit_trajectory(10, step=0.025, pitch=0.4)
    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    frames = []
    for Tcw in traj:
        g, d, _ = render_scene(scene, Tcw, cfg.intr)
        frames.append((g.numpy(), d.numpy(), {k: v.numpy() for k, v in gt_detections(scene, Tcw, cfg.intr).items()}))
    seq = KittiSequence(os.path.join(tmp, "kitti_small"), os.path.join(tmp, "kitti_small_poses.txt"))
    scfg = stereo_cfg(seq, 500)
    pairs = list(seq.prefetch_pairs(range(10)))
    dets3d = drive_detections(seq, 10)
    res = {}
    for name in ("rgbd", "stereo"):
        runs, dumps = {}, {}
        for dev in ("cuda", "cpu"):
            with ObjectStepDumps() as od:
                if name == "rgbd":
                    runs[dev] = SlamSystem(cfg, device=dev)
                    for g, d, det in frames:
                        runs[dev].track_rgbd(g, d, det)
                else:
                    runs[dev] = SlamSystem(scfg, kmax=16, nmax=4096, emax=32768, device=dev)
                    for (gl, gr), det in zip(pairs, dets3d):
                        runs[dev].track_stereo(gl, gr, det)
                    runs[dev].run_global_ba()
            dumps[dev] = od.steps
        o = {dev: (r.objects.valid.cpu().numpy(), r.objects.label.cpu().numpy(), r.objects.ellipsoid.cpu().numpy())
             for dev, r in runs.items()}
        same = bool((o["cuda"][0] == o["cpu"][0]).all() and (o["cuda"][1] == o["cpu"][1]).all())
        live = o["cpu"][0]
        gap = float(np.linalg.norm(o["cuda"][2][live, :3] - o["cpu"][2][live, :3], axis=1).max(initial=0.0))
        final = ellipsoid_gaps(o["cuda"][2][live], o["cpu"][2][live])
        trace = object_step_trace(dumps["cuda"], dumps["cpu"])
        p = {dev: positions_from_Tcw(np.stack(r.trajectory).astype(np.float64)) for dev, r in runs.items()}
        cam_gap = float(np.linalg.norm(p["cuda"] - p["cpu"], axis=1).max())
        planes_same = bool(torch.equal(runs["cuda"].plane_set.valid.cpu(), runs["cpu"].plane_set.valid))
        kfs = (runs["cuda"].stats["kf_frames"], runs["cpu"].stats["kf_frames"])
        res[name] = {"centre_gap_m": gap, "camera_gap_m": cam_gap, "objects": int(live.sum()), "same_slots": same,
                     "same_planes": planes_same, "kf_frames": kfs, "final_gaps": final, "trace": trace}
        log(f"phase 15 {name} objects card vs CPU, 10 frames at 500 features: keyframes {kfs[0]} vs {kfs[1]}, "
            f"objects {int(o['cuda'][0].sum())} vs {int(live.sum())} (same slots and labels: {same}), max object "
            f"centre gap {gap:.2e} m, final objects' gaps {final}, max camera centre gap {cam_gap:.2e} m, same "
            f"Manhattan plane slots: {planes_same}")
        log(f"  object-step trace (queue C): first step past 1e-5 {trace['first_past_1e-5']}, max by step "
            f"{ {k: float(f'{v:.2e}') for k, v in trace['max_by_step'].items()} }, ellipsoid gaps by step "
            f"{trace['ellipsoid_parts']}, within the per-step bounds: {trace['within_bounds']}")
        if (kfs[0] != kfs[1] or not same or live.sum() < 1 or gap > 0.01 or not object_gaps_ok(final)
                or not trace["within_bounds"] or (name == "rgbd" and not planes_same)):
            raise AssertionError(f"{name} object card and CPU runs disagree: {res[name]}")
    return res


class ShapeSteps:
    """The shape step of every keyframe, installed over the facade's names
    (`gather_shape_inputs`, `reconstruct_due_objects`): host-clock ms of
    each part around a synchronise, the due objects and hypotheses, the
    LM's peak device memory above what was allocated before it, and CPU
    copies of the inputs and of the table before and after the LM.
    `peak` keeps the device's peak from before each LM's reset."""

    NAMES = ("gather_shape_inputs", "reconstruct_due_objects")

    def __init__(self, frame_of=lambda: None):
        self.steps, self.frame_of, self.peak = [], frame_of, 0
        self._saved = {n: getattr(system_mod, n) for n in self.NAMES}

    def __enter__(self):
        gather, lm = (self._saved[n] for n in self.NAMES)

        def sync():
            if torch.cuda.is_available():
                torch.cuda.synchronize()

        def timed_gather(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = gather(*a, **k)
            sync()
            self.steps.append({"frame": self.frame_of(), "gather_ms": (time.perf_counter() - t0) * 1e3,
                               "due": int(out.due.sum()),
                               "inputs": ShapeInputs(*(x.cpu() for x in out))})
            return out

        def timed_lm(table, inputs, params, dec_cfg, Tcw, opt_cfg):
            on_card = table.code.is_cuda
            sync()
            if on_card:
                self.peak = max(self.peak, torch.cuda.max_memory_allocated())
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = lm(table, inputs, params, dec_cfg, Tcw, opt_cfg)
            sync()
            st = self.steps[-1]
            st.update(lm_ms=(time.perf_counter() - t0) * 1e3, hyps=st["due"] * max(1, opt_cfg.num_flips),
                      lm_peak_bytes=torch.cuda.max_memory_allocated() - base if on_card else 0,
                      args=(table, inputs, params, dec_cfg, Tcw, opt_cfg), Tcw=Tcw.cpu(),
                      before={k: getattr(table, k).cpu() for k in ("code", "Tow_shape", "shape_ok")},
                      after={k: getattr(out, k).cpu() for k in ("code", "Tow_shape", "shape_ok")})
            return out

        system_mod.gather_shape_inputs, system_mod.reconstruct_due_objects = timed_gather, timed_lm
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(system_mod, n, fn)


def shape_flop(st: dict) -> float:
    """The decoder FLOP that one shape step's LM needs, as the benchmark
    counts it (`port_bench/metrics/flop.py`: 1 + 4 x iters passes per
    hypothesis over its valid surface points and render samples)."""
    if not st["due"]:
        return 0.0
    _, inputs, _, dec_cfg, _, opt_cfg = st["args"]
    F, due = max(1, opt_cfg.num_flips), inputs.due.cpu()
    valid = [tuple(ok.cpu()[due].sum(-1).repeat_interleave(F) for ok in (inputs.pts_ok, inputs.rays_ok))]
    return shape_step_flop(_layer_dims(dec_cfg), opt_cfg.iters, valid)


def shape_frames(n: int) -> tuple:
    """tests/test_shape_mapping.py's scene (seed 2, three objects) 25
    degrees down on a lateral track of 4 cm per frame, rendered on the card
    at 640x480: numpy gray and depth, the renderer's detections with
    instance masks, the ground-truth T_cw and the scene's truth in the
    first camera's frame."""
    cfg = TrackingConfig()
    scene = make_scene(num_objects=3, seed=2, device="cuda")
    base = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0], dtype=torch.float32))
    frames, gt = [], []
    for i in range(n):
        Tcw = (lie.exp_se3(torch.tensor([0.04 * i, 0, 0, 0, 0, 0], dtype=torch.float32)) @ base).numpy()
        g, d, inst = render_scene(scene, Tcw, cfg.intr)
        det = gt_detections(scene, Tcw, cfg.intr, instance=inst)
        frames.append((g.cpu().numpy(), d.cpu().numpy(), {k: v.cpu().numpy() for k, v in det.items()}))
        gt.append(Tcw)
    truth = quadric.transform_ellipsoid(scene.ellipsoids.cpu(), base[None]).numpy()
    return frames, np.stack(gt), truth


def surface_sdf(sysm, params, dec_cfg, truth) -> dict:
    """Per reconstructed object: the median |SDF| of 200 points of its
    nearest true ellipsoid's surface mapped through Tow_shape
    (tests/test_shape_mapping.py's check)."""
    out = {}
    objs = sysm.objects
    for o in torch.nonzero((objs.valid & objs.shape_ok).cpu())[:, 0].tolist():
        e = objs.ellipsoid[o].cpu().numpy()
        j = int(np.linalg.norm(truth[:, :3] - e[:3], axis=1).argmin())
        d = np.random.default_rng(o).normal(size=(200, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        S = quadric.similarity_transform(torch.from_numpy(truth[j])).numpy()
        pts = torch.from_numpy((d @ S[:3, :3].T + S[:3, 3]).astype(np.float32)).to(objs.code.device)
        sdf = decode_sdf(params, dec_cfg, objs.code[o], lie.transform_points(objs.Tow_shape[o], pts))
        out[o] = float(sdf.abs().median())
    return out


def inside_min(params, dec_cfg, code) -> float:
    """The SDF's minimum over 4096 points of the decoder's cube (below
    zero: the shape has an inside)."""
    cube = (2.0 * torch.rand(4096, 3, generator=torch.Generator().manual_seed(1)) - 1.0).to(code.device)
    return float(decode_sdf(params, dec_cfg, code, cube).min())


def inside(objs, params, dec_cfg) -> dict:
    """`inside_min` of every reconstructed object."""
    return {o: inside_min(params, dec_cfg, objs.code[o])
            for o in torch.nonzero((objs.valid & objs.shape_ok).cpu())[:, 0].tolist()}


def single_object_problem(halves) -> tuple:
    """tests/test_shape.py's problem, drawn from a CPU generator: family
    shape 1's surface 1.8 m ahead at scale 0.35 with 2 mm noise, 256
    points with their rays and depths, and the true frame perturbed by
    (0.06, -0.04, 0.08) m, (0.05, -0.08, 0.04) rad and a scale of e^0.1.
    -> (T_init, pts, ok, rays, depth) on the CPU."""
    gen = torch.Generator().manual_seed(2)
    T_co = lie.exp_se3(torch.tensor([0.1, -0.05, 1.8, 0.0, 0.5, 0.0]))
    d = torch.randn(256, 3, generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    sR = T_co[:3, :3] * 0.35
    pts = (d * halves[1].cpu()) @ sR.T + T_co[:3, 3] + 0.002 * torch.randn(256, 3, generator=gen)
    T_gt = lie.inv_sim3(lie.rt_to_se3(sR, T_co[:3, 3]))
    T0 = lie.exp_sim3(torch.tensor([0.06, -0.04, 0.08, 0.05, -0.08, 0.04, 0.1])) @ T_gt
    return T0, pts, torch.ones(256, dtype=torch.bool), pts / pts[:, 2:3], pts[:, 2]


def shape_single_object(params, dec_cfg, codes, halves) -> dict:
    """`single_object_problem` at the decoder's width on the card, eight
    LM trips from two starts: a zero code (the first shape step of an
    object) and the observed shape's family code (a later step, which
    starts from the object's code).  From the zero code this decoder's
    LM reaches a shape with no inside, as the JAX package does on the
    same problem and decoder (ROADMAP queue C); from the family code the
    shape must keep an inside (a mesh) with its surface on the points."""
    T0, pts, ok, rays, depth = (x.cuda() for x in single_object_problem(halves))
    out = {}
    for name, code in (("zero code", torch.zeros_like(codes[1])), ("family code", codes[1])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = reconstruct_object(params, dec_cfg, T0, code, pts, ok, rays, depth, ok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        mesh = extract_mesh_from_code(params, dec_cfg, res.code, resolution=64)
        surface = decode_sdf(params, dec_cfg, res.code, lie.transform_points(res.T_oc, pts))
        out[name] = {"ms": ms, "is_good": bool(res.is_good), "cost": float(res.cost),
                     "code_norm": float(res.code.norm()), "sdf_min": inside_min(params, dec_cfg, res.code),
                     "surface_median": float(surface.abs().median()), "faces": len(mesh.faces)}
    log(f"phase 16 one object at {tuple(dec_cfg)} (tests/test_shape.py's problem, 8 trips): {out}")
    warm = out["family code"]
    if not (warm["is_good"] and warm["sdf_min"] < 0.0 and warm["faces"] >= 100
            and warm["surface_median"] < SHAPE_SDF):
        raise AssertionError(f"the full-width LM's shape has no inside or misses the surface: {out}")
    return out


def shape_path(tmp: str, prof: Path | None, dump: str | None = None) -> dict:
    """Phase 16: the toy decoder trained on the card at the reference's
    width, then `SlamSystem(shape_prior=...)` through 20 frames of the
    shape scene at 4000 features, every shape step timed and its peak
    memory held under the chunking's estimate; a mesh and the object
    render from a reconstructed code.  With `dump`, the first shape step
    that has due objects is saved there for `tools/shape_step_reference.py`."""
    dec = DeepSDFConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, codes, halves = train_toy_decoder(0, dec, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    xyz = (2.0 * torch.rand(512, 3, generator=torch.Generator().manual_seed(5)) - 1.0).cuda()
    fit = [float((decode_sdf(params, dec, codes[i], xyz)
                  - torch.clamp(ellipsoid_sdf(xyz, halves[i]), -0.3, 0.3)).abs().mean()) for i in range(len(codes))]
    log(f"phase 16 toy decoder at {tuple(dec)} trained on the card: 600 Adam steps of 512 points in {train_s:.2f} s, "
        f"mean |SDF error| {np.mean(fit):.5f} over {len(fit)} shapes")
    if not np.mean(fit) < 0.03:
        raise AssertionError(f"the full-width toy decoder does not fit its family: {fit}")

    frames, gt, truth = shape_frames(SHAPE_FRAMES)
    cfg = TrackingConfig(orb=OrbConfig(num_features=SHAPE_F))
    sysm = SlamSystem(cfg, shape_prior=(params, dec))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with FrameTimes("track_rgbd") as ft, ShapeSteps(lambda: len(ft.ms)) as ss:
        t0 = time.perf_counter()
        for g, d, det in frames:
            sysm.track_rgbd(g, d, det)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = max(ss.peak, torch.cuda.max_memory_allocated())
    ate = ate_rmse(np.stack(sysm.trajectory), gt)
    sdf = surface_sdf(sysm, params, dec, truth)
    steps = [{"kf_frame": st["frame"], "ms": st["gather_ms"] + st["lm_ms"], "gather_ms": st["gather_ms"],
              "lm_ms": st["lm_ms"], "due": st["due"], "hyps": st["hyps"], "tflop": shape_flop(st) / 1e12,
              "lm_peak_bytes": st["lm_peak_bytes"]}
             for st in ss.steps]
    # The LM's largest chunk of hypotheses and the chunking's estimate for it.
    n_pts, n_rays = ss.steps[0]["inputs"].pts_cam.shape[1], ss.steps[0]["inputs"].rays.shape[1]
    per_hyp = reverse_hypothesis_bytes(dec, n_pts, n_rays)
    chunk = chunk_size(dec, n_pts, n_rays, torch.device("cuda"))
    busy = [st for st in steps if st["due"]]
    busy_steps = [st for st in ss.steps if st["due"]]
    per_obj = [st["lm_ms"] / st["due"] for st in busy]
    bound_ms = [st["tflop"] * 1e12 / FP32_OPS_PER_S * 1e3 for st in busy]
    res = {"train_s": train_s, "fit_err": float(np.mean(fit)), "ate_rmse_m": ate, "kf_frames": sysm.stats["kf_frames"],
           "ms_per_frame_end_to_end": wall_ms / SHAPE_FRAMES, "track_ms_median": float(np.median(ft.ms[1:])),
           "steps": steps, "ms_per_due_object": per_obj, "bound_ms": bound_ms,
           "bound_share": [b / st["lm_ms"] for b, st in zip(bound_ms, busy)], "max_memory_bytes": peak,
           "shape_ok": sdf, "objects": int(sysm.objects.valid.sum()), "launches": counts}
    log(f"phase 16 shape drive at {tuple(dec)}: {SHAPE_FRAMES} frames at 640x480, {SHAPE_F} features, omax "
        f"{sysm.omax}: ATE {ate:.5f} m, keyframes at {sysm.stats['kf_frames']}, objects {res['objects']}, "
        f"reconstructed {sorted(sdf)} with median |SDF| of the true surface {[round(v, 4) for v in sdf.values()]}; "
        f"{res['ms_per_frame_end_to_end']:.1f} ms/frame end to end, median tracked frame {res['track_ms_median']:.1f} "
        f"ms; peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    for st in steps:
        bound = st["tflop"] * 1e12 / FP32_OPS_PER_S * 1e3
        log(f"  shape step at frame {st['kf_frame']}: {st['ms']:.1f} ms (gather {st['gather_ms']:.1f}, LM "
            f"{st['lm_ms']:.1f}), {st['due']} due objects, "
            f"{st['hyps']} hypotheses, {st['tflop']:.2f} TFLOP, f32 bound {bound:.1f} ms"
            + (f" ({100 * bound / st['lm_ms']:.1f}% of the LM's time); LM peak {st['lm_peak_bytes'] / 1e9:.3f} GB "
               f"above its start for chunks of up to {min(chunk, st['hyps'])} hypotheses "
               f"({st['lm_peak_bytes'] / 1e9 / min(chunk, st['hyps']):.4f} GB each, estimate {per_hyp / 1e9:.4f})"
               if st["due"] else ""))
    if any(st["lm_peak_bytes"] > min(chunk, st["hyps"]) * per_hyp for st in busy):
        raise AssertionError(f"a shape step's memory exceeds the chunking's estimate of {per_hyp} B per hypothesis")
    if dump:
        st = busy_steps[0]
        table, inputs, params_, _, Tcw, opt = st["args"]
        torch.save({"params": {k: {n: t.cpu() for n, t in p.items()} for k, p in params_.items()}, "truth": truth,
                    "codes": codes.cpu(), "halves": halves.cpu(),
                    "steps": [{"frame": st["frame"], "inputs": ShapeInputs(*(x.cpu() for x in inputs)),
                               "table": {k: getattr(table, k).cpu() for k in table._fields}, "Tcw": Tcw.cpu(),
                               "after": st["after"], "opt": tuple(opt)}]}, dump)
        log(f"phase 16 shape step at frame {st['frame']} saved to {dump}")
    if not (ate < 0.05 and sdf and max(sdf.values()) < SHAPE_SDF):
        raise AssertionError(f"shape drive failed: ATE {ate}, reconstructed {sdf}")
    if counts["fast_nms"] != SHAPE_FRAMES:
        raise AssertionError(f"shape drive launches: {counts}")

    # Meshes of every reconstructed code and of a trained family code.
    meshes = {}
    for name, code in [(f"object {o}", sysm.objects.code[o]) for o in sdf] + [("family shape 0", codes[0])]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = extract_mesh_from_code(params, dec, code, resolution=64)
        ms = (time.perf_counter() - t0) * 1e3
        meshes[name] = {"ms": ms, "vertices": len(mesh.vertices), "faces": len(mesh.faces),
                        "sdf_min": inside_min(params, dec, code), "code_norm": float(code.norm())}
    res["meshes"] = meshes
    png = os.path.join(tmp, "objects_render.png")
    t0 = time.perf_counter()
    img = render_objects_png(png, sysm.objects, sysm.Tcw, cfg.intr, cfg.height, cfg.width, gray=frames[-1][0],
                             shape_prior=sysm.shape_prior)
    res["render_ms"] = (time.perf_counter() - t0) * 1e3
    with open(png, "rb") as f:
        head = f.read(8)
    log(f"phase 16 meshes at 64^3 (extract_mesh_from_code; SDF minimum on 4096 points of the cube, code norm): "
        f"{meshes}; render_objects_png {img.shape} in {res['render_ms']:.1f} ms")
    if head != b"\x89PNG\r\n\x1a\n" or meshes["family shape 0"]["faces"] < 100:
        raise AssertionError("the mesh of a family code or the object render failed")
    res["one_object"] = shape_single_object(params, dec, codes, halves)
    if prof:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        last = next(st for st in reversed(ss.steps) if st["due"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            t0 = time.perf_counter()
            system_mod.reconstruct_due_objects(*last["args"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        events = pr.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_us = sum(self_dev_us(e) for e in kernels)
        gemm_us = sum(self_dev_us(e) for e in kernels if "gemm" in e.key.lower())
        (prof / "profile_shape.txt").write_text(events.table(sort_by="cuda_time_total", row_limit=40))
        res["profile"] = {"ms": ms, "device_busy_ms": busy_us / 1e3, "gemm_ms": gemm_us / 1e3,
                          "kernel_launches": sum(e.count for e in kernels)}
        log(f"profile of one full-width shape step ({last['due']} due objects): {ms:.1f} ms under the profiler, "
            f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / ms:.1f}%), of which GEMM kernels "
            f"{gemm_us / 1e3:.1f} ms ({last['hyps']} hypotheses: {shape_flop(last) / gemm_us / 1e6:.1f} TFLOP/s "
            f"over the GEMM time); {res['profile']['kernel_launches']} kernel launches")
    return res


def shape_card_vs_cpu(frames: list, truth) -> dict:
    """Phase 17: the shape scene's first 10 frames at 500 features with the
    toy-width decoder, on the card and on the CPU: the same keyframes and
    `shape_ok` slots, each run's reconstructed objects with an inside and
    their true surfaces within SHAPE_SDF; each shape step's inputs and
    results compared, its starting frames within SHAPE_INIT_GAP; then one
    LM trip of every step on the CPU run's inputs, card vs CPU."""
    params = train_toy_decoder(0, TOY_DEC, num_shapes=8, steps=400, device="cpu")[0]
    on = {"cpu": params, "cuda": {k: {n: t.cuda() for n, t in p.items()} for k, p in params.items()}}
    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    runs, steps, dumps = {}, {}, {}
    for dev in ("cuda", "cpu"):
        with ShapeSteps() as ss, ObjectStepDumps() as od:
            runs[dev] = SlamSystem(cfg, shape_prior=(on[dev], TOY_DEC), device=dev)
            for g, d, det in frames[:SHAPE_SMALL]:
                runs[dev].track_rgbd(g, d, det)
        steps[dev], dumps[dev] = ss.steps, od.steps
    trace = object_step_trace(dumps["cuda"], dumps["cpu"])
    kfs = (runs["cuda"].stats["kf_frames"], runs["cpu"].stats["kf_frames"])
    ok = {dev: (r.objects.valid & r.objects.shape_ok).cpu().numpy() for dev, r in runs.items()}
    res = {"kf_frames": kfs, "shape_ok": {d: np.nonzero(v)[0].tolist() for d, v in ok.items()}, "steps": [],
           "surface": {d: surface_sdf(r, on[d], TOY_DEC, truth) for d, r in runs.items()},
           "sdf_min": {d: inside(r.objects, on[d], TOY_DEC) for d, r in runs.items()}}
    for a, b in zip(steps["cuda"], steps["cpu"]):
        due = b["inputs"].due.numpy()
        gap = {"due": int(due.sum())}
        if due.any():
            r, q = a["inputs"].rays.numpy()[due], b["inputs"].rays.numpy()[due]
            same = np.all(np.abs(r - q) < 1e-4, axis=-1)
            gap["same_pixels"] = float(same.mean())
            gap["points"] = float(np.abs(a["inputs"].pts_cam.numpy()[due][same]
                                         - b["inputs"].pts_cam.numpy()[due][same]).max(initial=0.0))
            gap["T_oc_init"] = float((a["inputs"].T_oc_init - b["inputs"].T_oc_init)[due].abs().max())
            gap["ellipsoid"] = ellipsoid_gaps(a["args"][0].ellipsoid.cpu().numpy()[due],
                                              b["args"][0].ellipsoid.numpy()[due])
            for k in ("code", "Tow_shape"):
                gap[k] = float((a["after"][k] - b["after"][k])[due].abs().max())
            # One trip on the CPU run's inputs and table, card vs CPU.
            table, inputs, _, _, Tcw, opt = b["args"]
            one = opt._replace(iters=1)
            c = system_mod.reconstruct_due_objects(table, inputs, on["cpu"], TOY_DEC, Tcw, one)
            g = system_mod.reconstruct_due_objects(type(table)(*(x.cuda() for x in table)),
                                                   ShapeInputs(*(x.cuda() for x in inputs)), on["cuda"], TOY_DEC,
                                                   Tcw.cuda(), one)
            gap["one_trip_same_slots"] = bool(torch.equal(g.shape_ok.cpu(), c.shape_ok))
            for k in ("code", "Tow_shape"):
                gap[f"one_trip_{k}"] = float((getattr(g, k).cpu() - getattr(c, k)).abs().max())
        res["steps"].append(gap)
    log(f"phase 17 shapes card vs CPU, {SHAPE_SMALL} frames at 500 features, decoder {tuple(TOY_DEC)}: keyframes "
        f"{kfs[0]} vs {kfs[1]}, reconstructed slots {res['shape_ok']['cuda']} vs {res['shape_ok']['cpu']}, "
        f"true-surface median |SDF| {res['surface']}, SDF minimum over the cube {res['sdf_min']}")
    for gap in res["steps"]:
        log(f"  shape step: {gap}")
    res["trace"] = trace
    log(f"  object-step trace (queue C): first step past 1e-5 {trace['first_past_1e-5']}, ellipsoid gaps by step "
        f"{trace['ellipsoid_parts']}, within the per-step bounds: {trace['within_bounds']}")
    one_trip = [st for st in res["steps"] if st["due"]]
    if (kfs[0] != kfs[1] or not (ok["cuda"] == ok["cpu"]).all() or ok["cpu"].sum() < 1 or not one_trip
            or not trace["within_bounds"]
            or not all(st["one_trip_same_slots"] and st["one_trip_code"] < SHAPE_GAP
                       and st["one_trip_Tow_shape"] < SHAPE_GAP and st["T_oc_init"] < SHAPE_INIT_GAP
                       and object_gaps_ok(st["ellipsoid"]) for st in one_trip)
            or not all(max(res["surface"][d].values()) < SHAPE_SDF and max(res["sdf_min"][d].values()) < 0.0
                       for d in runs)):
        raise AssertionError(f"shape card and CPU runs disagree: {res}")
    return res


def synthetic_path() -> dict:
    """Phase 18: `run_synthetic.main(["30", "--objects"])` at its defaults."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = run_synthetic.main(["30", "--objects"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"phase 18 run_synthetic 30 --objects: {wall_s:.1f} s (decoder training included), ATE "
        f"{out['ate_rmse_m']:.5f} m, keyframes {out['keyframes']}, objects {out['num_objects']}, precision "
        f"{out.get('obj_precision')} recall {out.get('obj_recall')} IoU {out.get('obj_mean_iou')}, shapes "
        f"reconstructed {out['shapes_reconstructed']}; launches {counts}")
    if not (out["ate_rmse_m"] < 0.05 and out["shapes_reconstructed"] >= 1 and out["backend"] == "cuda"):
        raise AssertionError(f"run_synthetic --objects failed: {out}")
    if counts["fast_nms"] != 30:
        raise AssertionError(f"run_synthetic launches: {counts}")
    return {"wall_s": wall_s, "out": out, "launches": counts}


def det2d_macs(cfg) -> int:
    """MACs of one 2D detector forward, from its shapes: the two stride-2
    convs, the four 3x3 convs and the 1x1 heads at stride 4."""
    H, W = cfg.input_hw
    w0, w1, w2 = cfg.widths
    s1, s2 = (H // 2) * (W // 2), (H // 4) * (W // 4)
    return 9 * (s1 * w0 + s2 * w0 * w1 + s2 * w1 * w2 + 3 * s2 * w2 * w2) + s2 * w2 * (cfg.num_classes + 5)


def det3d_macs(cfg, points: int) -> int:
    """MACs of one 3D detector forward over `points` points: the point MLP,
    the stride-2 stem, the three 3x3 convs and the 1x1 heads."""
    C, (w0, w1) = cfg.channels, cfg.widths
    s = (cfg.grid // 2) ** 2
    return points * (6 * C + C * C) + 9 * s * (C * w0 + w0 * w1 + 2 * w1 * w1) + s * w1 * (cfg.num_classes + 8)


CONV_KERNEL_WORDS = ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop", "dgrad", "wgrad")


def device_profile(fn, reps: int, path: Path | None = None, what: str = "") -> dict:
    """Device time per call of `fn` over `reps` profiled calls, its kernel
    launches per call and the share of the device time in convolution
    kernels (cuDNN's, by kernel name); the table goes to `path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(self_dev_us(e) for e in events)
    conv = sum(self_dev_us(e) for e in events if any(w in e.key.lower() for w in CONV_KERNEL_WORDS))
    if path is not None:
        path.write_text(f"== {what}, {reps} calls ==\n"
                        + prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    return {"device_ms": total / reps / 1e3, "launches": sum(e.count for e in events) / reps,
            "conv_share": conv / total if total else 0.0}


def bbox_iou(a, b) -> float:
    x0, y0, x1, y1 = max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])
    i = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    return i / max((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - i, 1e-6)


def detector2d_views() -> list:
    """tests/test_detector2d.py's 8 SLAM views (scenes 2 and 999, orbit
    frames 0, 10, 20, 29, 25 degrees down) at full resolution, rendered on
    the card: (gray, truth boxes, truth valid)."""
    cfg = TrackingConfig()
    pitch = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0], dtype=torch.float32)).numpy()
    views = []
    for seed in (2, 999):
        scene = make_scene(num_objects=3, seed=seed, device="cuda")
        traj = orbit_trajectory(30)
        for fi in (0, 10, 20, 29):
            T = traj[fi] @ pitch
            gray, _, _ = render_scene(scene, T, cfg.intr)
            gt = gt_detections(scene, T, cfg.intr)
            views.append((gray, gt["bbox"].cpu().numpy(), gt["valid"].cpu().numpy()))
    return views


def detector2d_quality(params, cfg, views) -> dict:
    """Recall at IoU > 0.4 over the valid truth boxes and false positives
    (IoU < 0.2 with every truth box, valid or not), as
    tests/test_detector2d.py counts them."""
    hits = tot = fp = 0
    for gray, gtb, gtv in views:
        det = det2d.detect_objects(params, cfg, gray)
        pb, pv = det["bbox"].cpu().numpy(), det["valid"].cpu().numpy()
        for g in gtb[gtv]:
            tot += 1
            hits += max((bbox_iou(g, p) for p, v in zip(pb, pv) if v), default=0.0) > 0.4
        fp += sum(1 for p, v in zip(pb, pv) if v and max(bbox_iou(g, p) for g in gtb) < 0.2)
    return {"recall": hits / max(tot, 1), "hits": hits, "truth": tot, "false_positives": fp}


def rel_gap(a: dict, b: dict) -> float:
    """Largest gap of two param dicts relative to b's largest magnitude."""
    scale = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in b) / scale


def fed_step(params: dict, loss_fn, inputs: tuple, device: str, lr: float):
    """One Adam update (the training's optimizer and schedule) of a copy of
    `params` on `device`, on fed inputs -> (loss, grads, params)."""
    p = {k: v.detach().clone().to(device) for k, v in params.items()}
    opt, _ = det2d.adam(p, lr, 10)
    loss = loss_fn(p, *(x.to(device) for x in inputs))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = {k: v.grad.detach().clone() for k, v in p.items()}
    opt.step()
    return float(loss.detach()), grads, {k: v.detach() for k, v in p.items()}


def detector2d_path(tmp: str, prof: Path | None) -> dict:
    """Phase 19: the learned 2D detector trained on the card at the
    reference's width, its quality and card-vs-CPU gates, its times, then
    the detect-online RGB-D drives."""
    cfg, intr = det2d.DetectorConfig(), TrackingConfig().intr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = det2d.train_detector(DET2D_SEED, cfg, device="cuda", **DET2D_RECIPE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    views = detector2d_views()
    q = detector2d_quality(params, cfg, views)

    # Card vs CPU on the same params and views.
    on_cpu = {k: v.cpu() for k, v in params.items()}
    box_gap, agree, same = 0.0, 1.0, True
    for gray, _, _ in views:
        a, b = det2d.detect_objects(params, cfg, gray), det2d.detect_objects(on_cpu, cfg, gray.cpu())
        va, vb = a["valid"].cpu(), b["valid"]
        same &= bool(torch.equal(va, vb) and torch.equal(a["label"].cpu()[vb], b["label"][vb]))
        if vb.any():
            box_gap = max(box_gap, float((a["bbox"].cpu()[vb] - b["bbox"][vb]).abs().max()))
            agree = min(agree, float((a["mask"].cpu()[vb] == b["mask"][vb]).float().mean()))
    # One training step from the same start on the same fed view (rendered
    # once, on the CPU).
    scene = make_scene(num_objects=4, seed=100, device="cpu")
    T_cw = orbit_trajectory(64, step=0.03, pitch=0.35)[20]
    g, _, inst = render_scene(scene, T_cw, intr)
    d = gt_detections(scene, T_cw, intr)
    start = det2d.init_detector(torch.Generator().manual_seed(DET2D_SEED), cfg, device="cpu")
    steps = {dev: fed_step(start, lambda p, *x: det2d.detector_loss(p, cfg, *x),
                           (g, d["bbox"], d["label"], d["valid"], inst), dev, DET2D_RECIPE["lr"])
             for dev in ("cuda", "cpu")}
    step_loss_gap = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    step_grad_gap = rel_gap(steps["cuda"][1], steps["cpu"][1])
    step_param_gap = rel_gap(steps["cuda"][2], steps["cpu"][2])

    # Times: one detect_objects call on a 480x640 frame, one training step.
    gray = views[0][0]
    flop = 2 * det2d_macs(cfg)
    train_params = {k: v.clone() for k, v in params.items()}
    opt, sched = det2d.adam(train_params, 1e-5, 10 ** 6)
    scene = make_scene(num_objects=4, seed=100, device="cuda")
    times = {
        "detect_objects": {"ms": cuda_ms(lambda: det2d.detect_objects(params, cfg, gray), 50),
                           **device_profile(lambda: det2d.detect_objects(params, cfg, gray), 10,
                                            prof / "profile_detector2d.txt" if prof else None,
                                            "detect_objects at 480x640"),
                           "bound_ms": flop / FP32_OPS_PER_S * 1e3, "flop": flop},
        "train_step": {"ms": cuda_ms(lambda: det2d.train_step(train_params, opt, sched, cfg, scene, T_cw, intr), 20),
                       **device_profile(lambda: det2d.train_step(train_params, opt, sched, cfg, scene, T_cw, intr), 5,
                                        prof / "profile_detector2d_train.txt" if prof else None,
                                        "one training step at 480x640 (render, targets, forward, backward, Adam)"),
                       "bound_ms": 3 * flop / FP32_OPS_PER_S * 1e3, "flop": 3 * flop},
    }
    res = {"train_s": train_s, "ms_per_step": train_s * 1e3 / DET2D_RECIPE["steps"], "loss_first20": first,
           "loss_last20": last, "quality": q, "same_rows": same, "box_gap_px": box_gap, "mask_agree": agree,
           "step_loss_gap": step_loss_gap, "step_grad_gap": step_grad_gap, "step_param_gap": step_param_gap,
           "times": times}
    log(f"phase 19 2D detector at {cfg.widths} on {cfg.input_hw}: trained on the card in {train_s:.1f} s "
        f"({res['ms_per_step']:.2f} ms per step, {DET2D_RECIPE['steps']} steps), loss {first:.4f} -> {last:.4f} "
        f"(means of the first and last 20); on the 8 SLAM views recall {q['hits']}/{q['truth']} = "
        f"{q['recall']:.3f}, {q['false_positives']} false positives; card vs CPU: same valid rows and labels "
        f"{same}, box gap {box_gap:.2e} px, masks agree on {100 * agree:.4f}% of pixels; one training step: loss "
        f"gap {step_loss_gap:.2e}, gradients {step_grad_gap:.2e}, params {step_param_gap:.2e} (relative to the largest "
        f"magnitude)")
    for name, t in times.items():
        log(f"  {name}: {t['ms']:.3f} ms by events, {t['device_ms']:.3f} ms device time, {t['launches']:.0f} "
            f"kernel launches, convolutions {100 * t['conv_share']:.1f}% of the device time; bound "
            f"{t['bound_ms']:.4f} ms ({t['flop'] / 1e9:.2f} GFLOP at 67 TFLOP/s)")
    if not (last < first and q["recall"] >= DET2D_RECALL and q["false_positives"] <= DET2D_FP and same
            and box_gap <= DET2D_BOX_GAP and agree >= DET2D_MASK_AGREE and step_loss_gap <= DET_STEP_GAP
            and step_param_gap <= DET_STEP_GAP):
        raise AssertionError(f"2D detector failed: {res}")

    # Detect-online: run_tum --detector on phase 13's sequence.
    weights = os.path.join(tmp, "detector2d.npz")
    det2d.save_detector2d(weights, params, cfg)
    seq_dir, conf = os.path.join(tmp, "mono"), os.path.join(tmp, "tum4000.yaml")
    torch.cuda.synchronize()
    zero_counts()
    with FrameTimes("track_rgbd") as ft, CallTimes(system_mod, "detect_objects") as dt:
        t0 = time.perf_counter()
        out = run_tum.main([seq_dir, "--detector", weights, "--config", conf])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    gt, gt_labels = scene_truth(0.025, 0.4)
    tum = online_objects(ft.system, out, gt, gt_labels)
    tum.update(ms_per_frame_end_to_end=wall_ms / MONO_FRAMES, det_ms=dt.ms, launches=counts,
               kf_frames=ft.system.stats["kf_frames"], obj_ms=ft.system.stats["obj_ms"])
    log(f"phase 19 run_tum --detector on phase 13's sequence ({MONO_FRAMES} frames, {TUM_OBJ_F} features): "
        f"{tum['ms_per_frame_end_to_end']:.3f} ms/frame end to end, keyframes at {tum['kf_frames']}, ATE "
        f"{out['ate_rmse_m']:.5f} m, objects {out['num_objects']} ({tum['seen_twice']} of the scene's labels with >= "
        f"2 observations), precision {tum['precision']:.3f} recall {tum['recall']:.3f}; detect_objects ms per "
        f"keyframe by events {[round(x, 2) for x in dt.ms]}, object ms per keyframe "
        f"{[round(x, 1) for x in tum['obj_ms']]}; launches {counts}")
    if not (out["ate_rmse_m"] < 0.05 and tum["seen_twice"] >= 1 and len(dt.ms) == len(tum["kf_frames"])):
        raise AssertionError(f"run_tum --detector failed: {tum}")
    if counts["fast_nms"] != MONO_FRAMES or counts["hamming"] < 1:
        raise AssertionError(f"run_tum --detector launches: {counts}")
    res["run_tum"] = tum

    # run_synthetic 30 --objects --detector.  Its training is the recipe
    # trained above (the same call and arguments): the phase hands it those
    # params rather than train the same detector twice.
    recipe = []

    def trained(seed, dcfg, device, **kw):
        recipe.append((seed, dcfg, torch.device(device).type, kw))
        return params, losses

    torch.cuda.synchronize()
    zero_counts()
    saved_train, det2d.train_detector = det2d.train_detector, trained
    try:
        with FrameTimes("track_rgbd") as ft, CallTimes(system_mod, "detect_objects") as dt:
            t0 = time.perf_counter()
            out = run_synthetic.main(["30", "--objects", "--detector"])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        det2d.train_detector = saved_train
    if recipe != [(DET2D_SEED, cfg, "cuda", DET2D_RECIPE)]:
        raise AssertionError(f"run_synthetic --detector trained another recipe: {recipe}")
    counts = read_counts()
    objs = ft.system.objects
    seen = int((objs.valid & (objs.obs_count >= 2) & (objs.label >= 0) & (objs.label <= 2)).sum())
    res["run_synthetic"] = syn = {"wall_s": wall_s, "out": out, "det_ms": dt.ms, "seen_twice": seen,
                                  "launches": counts}
    log(f"phase 19 run_synthetic 30 --objects --detector: {wall_s:.1f} s (decoder training included; the "
        f"detector is the one trained above, the same recipe), ATE {out['ate_rmse_m']:.5f} m, keyframes {out['keyframes']}, objects {out['num_objects']} "
        f"({seen} with >= 2 observations), precision {out.get('obj_precision')} recall {out.get('obj_recall')}, "
        f"shapes {out['shapes_reconstructed']}; detect_objects ms per keyframe {[round(x, 2) for x in dt.ms]}; "
        f"launches {counts}")
    if not (out["ate_rmse_m"] < 0.05 and seen >= 1 and out["backend"] == "cuda" and len(dt.ms) == out["keyframes"]):
        raise AssertionError(f"run_synthetic --detector failed: {syn}")
    if counts["fast_nms"] != 30:
        raise AssertionError(f"run_synthetic --detector launches: {counts}")
    return res


def online_objects(sysm, out, gt, gt_labels) -> dict:
    """A detect-online drive's objects against the scene: those of its
    labels with >= 2 observations, precision and recall."""
    objs = sysm.objects
    valid = objs.valid.cpu().numpy()
    labels = objs.label.cpu().numpy()
    seen = int((valid & (objs.obs_count.cpu().numpy() >= 2) & np.isin(labels, np.unique(gt_labels))).sum())
    ev = evaluate_objects(objs.ellipsoid.cpu().numpy()[valid], labels[valid], gt, gt_labels)
    return {"seen_twice": seen, "precision": ev.precision, "recall": ev.recall, "out": out}


def detector3d_quality(params, cfg, scans) -> dict:
    """tests/test_detector3d.py's bars over fresh scans: recall within 2 m,
    false positives per scan, centre, size and yaw (mod pi) errors."""
    hits = tot = fp = 0
    cerr, serr, yerr = [], [], []
    for pts, pv, gt in scans:
        det = det3d.detect_objects_3d(params, cfg, pts, pv)
        dv = det.valid.cpu().numpy()
        dc, ds, dy = (getattr(det, k).cpu().numpy()[dv] for k in ("center", "size", "yaw"))
        gc, gs, gy, gv = (gt[k].cpu().numpy() for k in ("center", "size", "yaw", "valid"))
        used = np.zeros(len(dc), bool)
        for b in np.nonzero(gv)[0]:
            tot += 1
            if len(dc) == 0:
                continue
            d = np.linalg.norm(dc - gc[b], axis=1)
            j = int(np.argmin(d))
            if d[j] < 2.0 and not used[j]:
                used[j] = True
                hits += 1
                cerr.append(d[j])
                serr.append(np.abs(ds[j] - gs[b]).mean())
                yerr.append(abs((dy[j] - gy[b] + np.pi / 2) % np.pi - np.pi / 2))
        fp += int((~used).sum())
    return {"recall": hits / max(tot, 1), "hits": hits, "truth": tot, "fp_per_scan": fp / len(scans),
            "centre_m": float(np.mean(cerr)) if cerr else np.inf, "size_m": float(np.mean(serr)) if serr else np.inf,
            "yaw_deg": float(np.degrees(np.mean(yerr))) if yerr else np.inf}


def detector3d_path(tmp: str, prof: Path | None) -> dict:
    """Phase 20: the learned 3D detector trained on the card at the
    reference's width, its quality and card-vs-CPU gates, its times, then
    `run_kitti --detector3d` on phase 9's drive."""
    cfg = det3d.Detector3DConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = det3d.train_detector3d(0, cfg, steps=DET3D_STEPS, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    scans = [det3d.synth_scan(torch.Generator().manual_seed(50_000 + s), cfg, device="cuda") for s in range(12)]
    q = detector3d_quality(params, cfg, scans)
    g = torch.Generator().manual_seed(7)
    ground = torch.stack([cfg.x_min + 30.0 * torch.rand(4096, generator=g), torch.full((4096,), cfg.ground_y),
                          0.5 + 29.5 * torch.rand(4096, generator=g)], -1).cuda()
    empty = int(det3d.detect_objects_3d(params, cfg, ground, torch.ones(4096, dtype=torch.bool,
                                                                         device="cuda")).valid.sum())
    # Card vs CPU on one scan.
    pts, pv, _ = scans[0]
    a = det3d.detect_objects_3d(params, cfg, pts, pv)
    b = det3d.detect_objects_3d({k: v.cpu() for k, v in params.items()}, cfg, pts.cpu(), pv.cpu())
    same = bool(torch.equal(a.valid.cpu(), b.valid))
    centre_gap = float((a.center.cpu() - b.center)[b.valid].abs().max()) if b.valid.any() else 0.0
    # Times: detect_objects_3d on a scan padded to the 32768-point budget,
    # one training step.
    budget = 32768
    full = torch.zeros((budget, 3), device="cuda")
    full[: pts.shape[0]] = pts
    fvalid = torch.arange(budget, device="cuda") < pts.shape[0]
    flop = 2 * det3d_macs(cfg, budget)
    train_params = {k: v.clone() for k, v in params.items()}
    opt, sched = det2d.adam(train_params, 1e-5, 10 ** 6)
    sp, spv, sg = scans[1]

    def step():
        loss = det3d.detector3d_loss(train_params, cfg, sp, spv, sg["center"], sg["size"], sg["yaw"], sg["valid"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()

    step_flop = 3 * 2 * det3d_macs(cfg, sp.shape[0])
    times = {
        "detect_objects_3d": {"ms": cuda_ms(lambda: det3d.detect_objects_3d(params, cfg, full, fvalid), 50),
                              **device_profile(lambda: det3d.detect_objects_3d(params, cfg, full, fvalid), 10,
                                               prof / "profile_detector3d.txt" if prof else None,
                                               "detect_objects_3d on a 32768-point scan"),
                              "bound_ms": flop / FP32_OPS_PER_S * 1e3, "flop": flop},
        "train_step": {"ms": cuda_ms(step, 20),
                       **device_profile(step, 5, prof / "profile_detector3d_train.txt" if prof else None,
                                        "one 3D training step (loss, backward, Adam; the scan drawn before)"),
                       "bound_ms": step_flop / FP32_OPS_PER_S * 1e3, "flop": step_flop},
    }
    res = {"train_s": train_s, "ms_per_step": train_s * 1e3 / DET3D_STEPS, "loss_first20": first,
           "loss_last20": last, "quality": q, "empty_scan_detections": empty, "same_rows": same,
           "centre_gap_m": centre_gap, "times": times}
    log(f"phase 20 3D detector (grid {cfg.grid}, {cfg.channels} channels, widths {cfg.widths}): trained on the card "
        f"in {train_s:.1f} s ({res['ms_per_step']:.2f} ms per step, {DET3D_STEPS} steps, scans drawn included), "
        f"loss {first:.4f} -> {last:.4f}; on 12 fresh scans {q}; ground-only scan: {empty} detections; card vs CPU: "
        f"same valid rows {same}, centre gap {centre_gap:.2e} m")
    for name, t in times.items():
        log(f"  {name}: {t['ms']:.3f} ms by events, {t['device_ms']:.3f} ms device time, {t['launches']:.0f} "
            f"kernel launches, convolutions {100 * t['conv_share']:.1f}% of the device time; bound "
            f"{t['bound_ms']:.4f} ms ({t['flop'] / 1e9:.2f} GFLOP at 67 TFLOP/s)")
    if not (last < first and q["recall"] > DET3D_BARS["recall"] and q["fp_per_scan"] < DET3D_BARS["fp_per_scan"]
            and q["centre_m"] < DET3D_BARS["centre_m"] and q["size_m"] < DET3D_BARS["size_m"]
            and q["yaw_deg"] < DET3D_BARS["yaw_deg"] and empty == 0 and same and centre_gap <= 1e-3):
        raise AssertionError(f"3D detector failed: {res}")

    weights = os.path.join(tmp, "detector3d.npz")
    det3d.save_detector3d(weights, params, cfg)
    seq_dir, poses = os.path.join(tmp, "kitti"), os.path.join(tmp, "kitti_poses.txt")
    torch.cuda.synchronize()
    zero_counts()
    with FrameTimes("track_stereo") as ft:
        t0 = time.perf_counter()
        out = run_kitti.main([seq_dir, "--poses", poses, "--detector3d", weights, "--save-dir",
                              os.path.join(tmp, "kitti_d3d_out")])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    sysm = ft.system
    kitti = {"ms_per_frame_end_to_end": wall_ms / KITTI_FRAMES, "kf_frames": sysm.stats["kf_frames"],
             "det_ms": sysm.stats.get("det_ms", []), "obj_ms": sysm.stats["obj_ms"], "launches": counts, "out": out}
    res["run_kitti"] = kitti
    log(f"phase 20 run_kitti --detector3d on phase 9's drive ({KITTI_FRAMES} frames at {KITTI_W}x{KITTI_H}): "
        f"{kitti['ms_per_frame_end_to_end']:.3f} ms/frame end to end, keyframes at {kitti['kf_frames']}, ATE "
        f"{out['ate_rmse_m']:.5f} m, RPE {out['rpe_trans_rmse']:.5f} m, objects {out['num_objects']}; provider ms "
        f"per keyframe (scan read + detector + box projection) {[round(x, 1) for x in kitti['det_ms']]}, object ms "
        f"per keyframe {[round(x, 1) for x in kitti['obj_ms']]}; launches {counts}")
    if not (out["ate_rmse_m"] < 0.6 and out["rpe_trans_rmse"] < 0.25 and out["keyframes"] >= 4
            and out["num_objects"] >= 1 and len(kitti["det_ms"]) == len(kitti["kf_frames"])):
        raise AssertionError(f"run_kitti --detector3d failed: {kitti}")
    if counts["fast_nms"] != KITTI_FRAMES or counts["hamming"] < 1:
        raise AssertionError(f"run_kitti --detector3d launches: {counts}")
    return res


def profile_objects(tmp: str, stereo_sys, path: Path) -> None:
    """torch.profiler tables of the object step of one warm RGB-D keyframe
    (phase 13's sequence, 4000 features) and of one local joint BA call on
    phase 14's final map (the perfect-detector run), written to `path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seq = TumSequence(os.path.join(tmp, "mono"))
    det_dir = os.path.join(tmp, "mono", "detections")
    cfg = TrackingConfig(orb=OrbConfig(num_features=TUM_OBJ_F))
    sysm = SlamSystem(cfg, device="cuda")
    for i in range(13):
        gray, depth, _, _ = seq.load(i)
        det = load_detection_cache(os.path.join(det_dir, f"{i}.npz"))
        sysm.track_rgbd(gray, depth, det)
    d = torch.from_numpy(depth).cuda()
    frame = process_frame(torch.from_numpy(gray).cuda(), d, cfg)
    tables = []
    for what, fn in (("object step of a warm RGB-D keyframe (13 frames in)",
                      lambda: sysm._process_objects(det, d, frame)),
                     (f"one local joint BA (window {stereo_sys.ba_window}) on phase 14's map",
                      lambda: system_mod.joint_ba_step(stereo_sys.map_state, stereo_sys.objects, stereo_sys.cfg,
                                                       stereo_sys.ba_window))):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy_us = sum(self_dev_us(e) for e in events if e.device_type == DeviceType.CUDA)
        log(f"profile of the {what}: {ms:.1f} ms under the profiler, device busy {busy_us / 1e3:.1f} ms")
        tables.append(f"== {what} ==\n" + events.table(sort_by="cuda_time_total", row_limit=40))
    path.write_text("\n\n".join(tables))


def mono_kernels(gen) -> dict:
    """K2 at the monocular shapes against plain, then timed."""
    k2, k2_in = {}, {}
    for A, B in MONO_K2:
        a, b, rows, even = planted_words(A, B, gen)
        check_k2(a, b, f"mono shape ({A}, {B})", rows, even)
        k2[f"at_{A}x{B}"] = k2_times(a, b, gen, 100)
        k2_in[(A, B)] = (a, b)
        log(f"  K2 at ({A}, {B}), exactly equal to plain (planted rows at 0 and 256): {k2[f'at_{A}x{B}']}")
    return {"k2": k2, "k2_inputs": k2_in}


def stereo_kernels(pair, gen) -> dict:
    """K1 over one 16-level launch on a KITTI-size stereo pair and K2 at
    the stereo shapes, each against its plain version, then timed."""
    orb = OrbConfig(num_features=KITTI_F, pyramid=PyramidConfig(height=KITTI_H, width=KITTI_W))
    ths = (orb.fast_threshold, orb.fast_threshold_min)
    levels = build_pyramid(pair[0].float(), orb.pyramid) + build_pyramid(pair[1].float(), orb.pyramid)
    before = fast_score_nms_pyramid.launches
    got = fast_score_nms_pyramid(levels, ths)
    torch.cuda.synchronize()
    if fast_score_nms_pyramid.launches != before + 1 or len(levels) != 16:
        raise AssertionError("the stereo pair's 16 levels did not go in one launch")
    err = 0.0
    for img, maps, refs in zip(levels, got, fast_score_nms_pyramid_plain(levels, ths)):
        for m, r in zip(maps, refs):
            err = max(err, float((m - r).abs().max()))
            if not torch.equal(m, r):
                raise AssertionError(f"K1 differs from plain on the stereo pair, level {tuple(img.shape)}")
    px = sum(im.numel() for im in levels)
    k1_s = {"bytes": px * 4 * (1 + len(ths)) / HBM_BYTES_PER_S,
            "operations": px * len(ths) * K1_OPS_PER_PX / FP32_OPS_PER_S}
    k1 = {"ms": cuda_ms(lambda: fast_score_nms_pyramid(levels, ths), 200),
          "plain_ms": cuda_ms(lambda: fast_score_nms_pyramid_plain(levels, ths), 5),
          "bound_ms": max(k1_s.values()) * 1e3, "bound_by": max(k1_s, key=k1_s.get), "library_ms": None,
          "max_abs_err": err, "unit": f"one stereo frame at {KITTI_W}x{KITTI_H}: one launch over 2 x 8 levels "
                                      "x 2 thresholds"}
    log(f"K1 on a {KITTI_W}x{KITTI_H} stereo pair: 16 levels in one launch, bitwise equal to plain; {k1}")
    k2, k2_in = {}, {}
    for A, B in STEREO_K2:
        a, b, rows, even = planted_words(A, B, gen)
        check_k2(a, b, f"stereo shape ({A}, {B})", rows, even)
        k2[f"at_{A}x{B}"] = k2_times(a, b, gen, 100)
        k2_in[(A, B)] = (a, b)
        log(f"  K2 at ({A}, {B}), exactly equal to plain (planted rows at 0 and 256): {k2[f'at_{A}x{B}']}")
    return {"k1": k1, "k2": k2, "levels": levels, "ths": ths, "k2_inputs": k2_in}


def profiled_window(track, inputs, path: Path, what: str) -> None:
    """`track(*x)` for each x of `inputs` under torch.profiler: the operator
    table goes to `path`; the device's busy share of the window and each
    kernel's device time per launch are logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            track(*x)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    path.write_text(events.table(sort_by="cuda_time_total", row_limit=60))
    # Kernel rows only: an operator's row repeats its kernels' time.
    busy_us = sum(self_dev_us(e) for e in events if e.device_type == DeviceType.CUDA)
    log(f"profile of {what} (written to {path}): window {window_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / window_us:.1f}%)")
    for e in events:
        for name in KERNEL_NAMES:
            if name in e.key and self_dev_us(e) > 0:
                log(f"  device time of {name}: {e.count} launches, {self_dev_us(e) / e.count:.2f} us each")


def self_dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def render_sequence(n: int, cfg, device):
    """Rendered frames as a camera delivers them: uint8 gray, uint16 depth."""
    room = make_room(device=device)
    Tcw_gt = orbit_trajectory(n)
    frames = []
    for i in range(n):
        g, d = render_frame(room, Tcw_gt[i], cfg.intr)
        g8 = torch.clamp(torch.round(g), 0, 255).to(torch.uint8).cpu().numpy()
        d16 = torch.clamp(torch.round(d * cfg.depth_png_scale), 0, 65535).cpu().numpy().astype(np.uint16)
        frames.append((g8, d16))
    return frames, Tcw_gt


def run_slam(cfg, frames, device, warmup: int = 10):
    sysm = SlamSystem(cfg, device=device)
    wall = []
    for g8, d16 in frames:
        t0 = time.perf_counter()
        sysm.track_rgbd(g8, d16)
        if device == "cuda":
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return sysm, wall[warmup:]


def dist_problems(path: Path) -> np.ndarray:
    """Phase 21's problems at full capacity (stereo edges): the point BA,
    and the joint BA with 32 objects, each measured from 4 random keyframes (its true
    camera-object transform), started 0.1 m off.  Returns each point's
    number of inlier observations."""
    prob = make_ba_problem(**DIST_PROBLEM)
    rng = np.random.default_rng(5)
    O, M, K = DIST_OBJECTS, DIST_RING, DIST_PROBLEM["num_cams"]
    T_wo = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    T_wo[:, :3, 3] = rng.uniform([-2.5, -1.5, -2.5], [2.5, 1.5, 2.5], (O, 3))
    T_oc = np.tile(np.eye(4, dtype=np.float32), (O, M, 1, 1))
    kf = np.full((O, M), -1, np.int32)
    for o in range(O):
        for j, k in enumerate(rng.choice(K, 4, replace=False)):
            T_oc[o, j] = np.linalg.inv(T_wo[o]) @ np.linalg.inv(prob.Tcw_gt[k])
            kf[o, j] = k
    T_wo_init = T_wo.copy()
    T_wo_init[:, :3, 3] += rng.normal(0, 0.1, (O, 3))
    objects = {"Tow": np.linalg.inv(T_wo_init).astype(np.float32), "obj_fixed": np.zeros(O, bool),
               "obj_cam_idx": np.clip(kf, 0, None).reshape(-1),
               "obj_obj_idx": np.repeat(np.arange(O, dtype=np.int32), M),
               "obj_T_oc": T_oc.reshape(-1, 4, 4), "obj_valid": (kf >= 0).reshape(-1)}
    save_problems(path, [{"name": "map", "kind": "map_ba", "prefix": "p", "iters": DIST_ITERS, "time": True},
                         {"name": "joint", "kind": "map_joint_ba", "prefix": "p", "iters": DIST_ITERS,
                          "time": True}], {"p": {**problem_arrays(prob, DIST_BF), **objects}})
    inliers = prob.valid & ~prob.is_outlier
    return np.bincount(prob.pt_idx[inliers], minlength=prob.points_init.shape[0])


def rank_launches(stderr: str) -> list:
    """The kernel launches each rank reported at its end (multihost)."""
    out = {}
    for line in stderr.splitlines():
        if line.startswith("[rank ") and "] launches " in line:
            out[int(line[6:line.index("/")])] = json.loads(line.split("] launches ", 1)[1])
    return [out[r] for r in sorted(out)]


def cli_mesh_run(main_fn, argv: list) -> tuple[dict, list, list, float]:
    """A command line with `--mesh 2`: it starts its two ranks; their stderr
    (which it copies to its own) gives each rank's launches and its final
    map's SHA-256."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        out = main_fn(argv + ["--mesh", "2"])
    wall = time.perf_counter() - t0
    sys.stderr.write(buf.getvalue())
    digests = [line.split("] map ", 1)[1] for line in buf.getvalue().splitlines()
               if line.startswith("[rank ") and "] map " in line]
    return out, rank_launches(buf.getvalue()), digests, wall


def drive_joint_world_gap(tmp: str, state: dict, gt_Tcw: np.ndarray) -> dict:
    """The one-device `run_kitti` run's map and objects before its global
    BA through the sharded joint BA on one rank (this process) and on two
    (gloo ranks sharing the card): the world sizes agree within
    `DIST_GAPS` (keyframe and object positions, the points' 99.9th
    percentile and the most a point with 4 or more observations moves) and
    the ranks return the same bits.  The keyframe ATE before and after it
    and after the single-device joint BA on the same map are reported, not
    gated: the reference's sharded joint BA parts from its single-device
    one on this drive (`tools/dist_joint_gap.py`)."""
    from qsp_slam_tpu_torch.parallel.mesh import make_mesh
    from qsp_slam_tpu_torch.slam.distributed_mapping import global_joint_ba_sharded
    from qsp_slam_tpu_torch.slam.joint_mapping import joint_ba_step

    m, o, cfg = state["m"], state["o"], state["cfg"]
    n = int(m.num_kfs)
    live = m.kf_valid[:n].cpu().numpy()
    gt_kf = gt_Tcw[np.asarray(state["kf_frames"])][live]

    def kf_ate(kf_Tcw) -> float:
        return float(ate_rmse(np.asarray(kf_Tcw)[:n][live], gt_kf))

    m1, o1 = global_joint_ba_sharded(m, o, cfg, make_mesh(1, axis="map", device="cuda"))
    ms, _ = joint_ba_step(m, o, cfg, window=m.kf_Tcw.shape[0])
    arrays = {f: getattr(m, f).cpu().numpy() for f in m._fields}
    arrays.update({f"obj/{f}": getattr(o, f).cpu().numpy() for f in o._fields})
    arrays.update(intr=np.zeros(4, np.float32), bf=np.float32(0))
    camera = {"fx": cfg.fx, "fy": cfg.fy, "cx": cfg.cx, "cy": cfg.cy, "baseline": cfg.baseline}
    path, out_dir = Path(tmp, "drive_map.npz"), Path(tmp, "drive_map_w2")
    save_problems(path, [{"name": "drive", "kind": "global_joint_ba", "prefix": "d", "iters": 10,
                          "camera": camera}], {"d": arrays})
    spawn_ranks(2, [str(path), str(out_dir)], target=REPLAY, timeout=600)
    outs = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]
    same = all(np.array_equal(outs[1][k], outs[0][k]) for k in outs[0])
    two = outs[0]
    ob_ok = (m.ob_valid & (m.ob_kf < n)).cpu().numpy()
    obs = np.bincount(m.ob_pt.cpu().numpy()[ob_ok], minlength=m.pt_xyz.shape[0])
    pt_ok = m.pt_valid.cpu().numpy()
    d_pt = np.linalg.norm(m1.pt_xyz.cpu().numpy().astype(np.float64) - two["drive/pt_xyz"], axis=1)[pt_ok]
    obj_ok = o.valid.cpu().numpy()
    gaps = {"keyframes": float(np.abs(m1.kf_Tcw.cpu().numpy()[:n] - two["drive/kf_Tcw"][:n]).max()),
            "objects": float(np.abs(o1.ellipsoid.cpu().numpy()[obj_ok, :3]
                                    - two["drive/ellipsoid"][obj_ok, :3]).max(initial=0.0)),
            "points_p999": float(np.percentile(d_pt, 99.9)),
            "points_max_4_observations": float(d_pt[obs[pt_ok] >= 4].max()), "points_max": float(d_pt.max())}
    res = {"gaps": gaps, "ranks_identical": same, "points": int(pt_ok.sum()), "objects": int(obj_ok.sum()),
           "kf_ate_m": {"before": kf_ate(m.kf_Tcw.cpu().numpy()), "single_joint": kf_ate(ms.kf_Tcw.cpu().numpy()),
                        "sharded_world1": kf_ate(m1.kf_Tcw.cpu().numpy()),
                        "sharded_world2": kf_ate(two["drive/kf_Tcw"])}}
    log(f"phase 21 the drive's map before its global BA ({n} keyframes, {res['points']} points, {res['objects']} "
        f"objects), sharded joint BA world 1 vs world 2: {gaps}, ranks identical {same}; keyframe ATE {res['kf_ate_m']}")
    checks = [("keyframes", DIST_GAPS["poses"]), ("objects", DIST_GAPS["poses"]),
              ("points_p999", DIST_GAPS["points_p999"]), ("points_max_4_observations", DIST_GAPS["points_max_4_seen"])]
    if not same or any(not gaps[k] <= bound for k, bound in checks):
        raise AssertionError(f"the drive's sharded joint BA at world 1 and 2: {res}")
    return res


def distribution_path(tmp: str) -> dict:
    """Phase 21: (a) the map-sharded point and joint BA at run_kitti's
    capacity as one rank (NCCL) and as two ranks sharing the card (gloo);
    (b) `run_tum --global-ba --mesh 2` on phase 7's sequence (the point
    branch) and `run_kitti --global-ba --mesh 2` on phase 9's drive with
    phase 14's perfect 3D detector's detections (the joint branch), each
    against the same command on one device, and the one-device drive's map
    through the sharded joint BA on one rank and on two; (c) the dry run
    over two ranks."""
    t_phase = time.perf_counter()
    res = {}
    probs = Path(tmp, "dist_problems.npz")
    inliers = dist_problems(probs)
    runs = {}
    for world in (1, 2):
        out_dir = Path(tmp, f"dist_w{world}")
        t0 = time.perf_counter()
        lines = [r.json() for r in spawn_ranks(world, [str(probs), str(out_dir)], target=REPLAY, timeout=600)]
        wall = time.perf_counter() - t0
        outs = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
        same = all(np.array_equal(o[k], outs[0][k]) for o in outs[1:] for k in outs[0])
        runs[world] = {"lines": lines, "out": outs[0], "ranks_identical": same, "wall_s": wall}
        for case in ("map", "joint"):
            f = [ln["cases"][case] for ln in lines]
            log(f"phase 21 {case}-sharded BA at K 128, N 16384, {DIST_ITERS} trips, world {world} "
                f"({lines[0]['backend']}): {max(x['ms_per_trip'] for x in f):.3f} ms per LM trip by events (max over "
                f"ranks; call {max(x['ms'] for x in f):.1f} ms, entry {max(x['ms_entry'] for x in f):.1f} ms), "
                f"{f[0]['collective_bytes_per_trip']} collective bytes per trip, peak "
                f"{[round(x['peak_mb'], 1) for x in f]} MB per rank, cost {f[0]['cost0']:.2f} -> "
                f"{float(outs[0][case + '/cost']):.2f}; ranks identical {same}; spawn to exit {wall:.1f} s")
    one, two = runs[1]["out"], runs[2]["out"]
    gaps, checks = {}, []
    for k in one:
        d = np.abs(one[k].astype(np.float64) - two[k])
        if k.endswith("/cost"):
            gaps[k] = float(d) / abs(float(one[k]))
            checks.append((k, gaps[k], DIST_GAPS["cost"]))
        elif k.endswith("/points"):
            per_point = np.linalg.norm(d, axis=1)
            gaps[k] = {q: float(np.percentile(per_point, q)) for q in (50, 99, 99.9)} | {
                "max": float(per_point.max()), "max_4_inliers": float(per_point[inliers >= 4].max()),
                "max_by_inliers": {int(c): float(per_point[inliers == c].max()) for c in np.unique(inliers)}}
            checks.append((k, gaps[k][99.9], DIST_GAPS["points_p999"]))
            checks.append((k + " (4+ inliers, max)", gaps[k]["max_4_inliers"], DIST_GAPS["points_max_4_seen"]))
        else:
            gaps[k] = float(d.max())
            checks.append((k, gaps[k], DIST_GAPS["poses"]))
    res["solve"] = {w: {"backend": r["lines"][0]["backend"], "cases": [ln["cases"] for ln in r["lines"]],
                        "ranks_identical": r["ranks_identical"]} for w, r in runs.items()}
    res["solve_gaps"] = gaps
    log(f"phase 21 world 1 vs world 2: {gaps}")
    for k, d, bound in checks:
        if not d <= bound:
            raise AssertionError(f"sharded BA world 1 and 2 disagree on {k}: {d} > {bound}")
    falls = all(float(runs[w]["out"][f"{c}/cost"]) < runs[w]["lines"][0]["cases"][c]["cost0"]
                for w in (1, 2) for c in ("map", "joint"))
    if not (runs[2]["ranks_identical"] and falls and runs[1]["lines"][0]["backend"] == "nccl"
            and runs[2]["lines"][0]["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")):
        raise AssertionError(f"sharded BA: ranks identical {runs[2]['ranks_identical']}, cost falls {falls}, "
                             f"backends {[runs[w]['lines'][0]['backend'] for w in (1, 2)]}")

    # (b) the command lines, single device against two ranks.
    seq_dir = os.path.join(tmp, "tum_mesh")
    make_tum.main([seq_dir, "--frames", str(FRAMES)])
    conf = os.path.join(tmp, "tum_mesh.yaml")
    Path(conf).write_text("ORBextractor.nFeatures: 4000\n")
    base = [seq_dir, "--config", conf, "--global-ba"]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    single = run_tum.main(base + ["--save-dir", os.path.join(tmp, "tum_single")])
    single_s = time.perf_counter() - t0
    single_counts = read_counts()
    mesh, launches, digests, mesh_s = cli_mesh_run(run_tum.main,
                                                   base + ["--save-dir", os.path.join(tmp, "tum_mesh2")])
    maps = [load_map(os.path.join(tmp, d, "map.npz")) for d in ("tum_single", "tum_mesh2")]
    n_kf = int(maps[0]["num_kfs"])
    kf_gap = float(np.abs(maps[0]["kf_Tcw"][:n_kf, :3, 3] - maps[1]["kf_Tcw"][:n_kf, :3, 3]).max())
    res["run_tum"] = {"single": single, "mesh": mesh, "launches_per_rank": launches, "single_launches": single_counts,
                      "kf_translation_gap_m": kf_gap, "map_digests": digests, "single_s": single_s, "mesh_s": mesh_s}
    log(f"phase 21 run_tum --global-ba on phase 7's sequence ({FRAMES} frames, 4000 features): one device "
        f"{single_s:.1f} s, ATE {single['ate_rmse_m']:.5f} m, keyframe ATE {single.get('kf_ate_rmse_m')}, "
        f"{single['keyframes']} keyframes, launches {single_counts}; --mesh 2 {mesh_s:.1f} s ({mesh['mesh']}), "
        f"ATE {mesh['ate_rmse_m']:.5f} m, keyframe ATE {mesh.get('kf_ate_rmse_m')}, {mesh['keyframes']} keyframes, "
        f"keyframe translations within {kf_gap:.2e} m of one device's; launches per rank {launches}; ranks' final "
        f"maps {digests}")
    e1, e2 = single.get("kf_ate_rmse_m"), mesh.get("kf_ate_rmse_m")
    if not (mesh["ate_rmse_m"] < 0.05 and mesh["keyframes"] == single["keyframes"] == n_kf
            and e1 is not None and e2 is not None and abs(e2 - e1) < max(0.02, 0.5 * e1) and kf_gap < 0.05
            and mesh["mesh"]["size"] == 2):
        raise AssertionError(f"run_tum --mesh 2: {res['run_tum']}")
    if len(launches) != 2 or any(c["fast_nms"] != FRAMES for c in launches) or single_counts["fast_nms"] != FRAMES:
        raise AssertionError(f"run_tum --mesh 2: K1 must launch once per frame on each rank: {launches}")
    if len(digests) != 2 or digests[0] != digests[1]:
        raise AssertionError(f"run_tum --mesh 2: the ranks' final maps differ: {digests}")

    kitti_dir, poses = os.path.join(tmp, "kitti"), os.path.join(tmp, "kitti_poses.txt")
    det_dir = os.path.join(tmp, "kitti_dets")
    os.makedirs(det_dir, exist_ok=True)
    for i, det in enumerate(drive_detections(KittiSequence(kitti_dir, poses), KITTI_FRAMES)):
        save_detection_cache(os.path.join(det_dir, f"{i}.npz"), det)
    base = [kitti_dir, "--poses", poses, "--detections", det_dir, "--global-ba"]
    torch.cuda.synchronize()
    zero_counts()
    state = {}
    run_global_ba = SlamSystem.run_global_ba

    def keep_state(self, iters: int = 10):
        state.update(m=self.map_state, o=self.objects, cfg=self.cfg, kf_frames=list(self.stats["kf_frames"]))
        return run_global_ba(self, iters)

    SlamSystem.run_global_ba = keep_state  # the one-device run's map before its global BA
    t0 = time.perf_counter()
    try:
        single = run_kitti.main(base + ["--save-dir", os.path.join(tmp, "kitti_single")])
    finally:
        SlamSystem.run_global_ba = run_global_ba
    single_s = time.perf_counter() - t0
    single_counts = read_counts()
    mesh, launches, digests, mesh_s = cli_mesh_run(run_kitti.main,
                                                   base + ["--save-dir", os.path.join(tmp, "kitti_mesh2")])
    reports = [json.loads(Path(tmp, d, "report.json").read_text()) for d in ("kitti_single", "kitti_mesh2")]
    res["run_kitti"] = {"single": single, "mesh": mesh, "launches_per_rank": launches,
                        "single_launches": single_counts, "global_ba": [r["global_ba"] for r in reports],
                        "map_digests": digests, "single_s": single_s, "mesh_s": mesh_s}
    log(f"phase 21 run_kitti --detections (perfect 3D detector) --global-ba on phase 9's drive ({KITTI_FRAMES} "
        f"frames): one device {single_s:.1f} s, ATE {single['ate_rmse_m']:.5f} m, keyframe ATE "
        f"{single.get('kf_ate_rmse_m')}, {single['keyframes']} keyframes, {single['num_objects']} objects, global BA "
        f"{reports[0]['global_ba']}; --mesh 2 {mesh_s:.1f} s ({mesh['mesh']}), ATE {mesh['ate_rmse_m']:.5f} m, "
        f"keyframe ATE {mesh.get('kf_ate_rmse_m')}, {mesh['keyframes']} keyframes, {mesh['num_objects']} objects, "
        f"global BA {reports[1]['global_ba']}; launches per rank {launches}; ranks' final maps {digests}")
    e2 = mesh.get("kf_ate_rmse_m")
    if not (mesh["ate_rmse_m"] < 0.6 and mesh["rpe_trans_rmse"] < 0.25 and mesh["keyframes"] == single["keyframes"]
            and e2 is not None and e2 < 0.6
            and reports[0]["global_ba"][-1:] == ["joint"] and reports[1]["global_ba"][-1:] == ["joint-sharded"]):
        raise AssertionError(f"run_kitti --mesh 2: {res['run_kitti']}")
    gt_Tcw = np.stack([np.linalg.inv(T) for T in KittiSequence(kitti_dir, poses).poses[:KITTI_FRAMES]])
    res["run_kitti"]["drive_map"] = drive_joint_world_gap(tmp, state, gt_Tcw)
    if len(launches) != 2 or any(c["fast_nms"] != KITTI_FRAMES for c in launches):
        raise AssertionError(f"run_kitti --mesh 2: K1 must launch once per stereo frame on each rank: {launches}")
    if len(digests) != 2 or digests[0] != digests[1]:
        raise AssertionError(f"run_kitti --mesh 2: the ranks' final maps differ: {digests}")

    # (c) the dry run.
    t0 = time.perf_counter()
    res["dryrun"] = dryrun_multichip(2, timeout=600)
    log(f"phase 21 dry run over 2 ranks on the card ({time.perf_counter() - t0:.1f} s): {res['dryrun']}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21 distribution: {res['phase_s']:.1f} s")
    return res


def ply_counts(path: str) -> dict:
    """The element counts of a PLY header: {"vertex": V, "face": T}."""
    counts = {}
    with open(path) as f:
        for line in f:
            if line.startswith("element "):
                _, name, n = line.split()
                counts[name] = int(n)
            if line.strip() == "end_header":
                return counts
    raise AssertionError(f"{path}: no end_header")


def ply_vertices(path: str) -> np.ndarray:
    n = ply_counts(path)["vertex"]
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    return np.array([[float(x) for x in ln.split()[:3]] for ln in lines[start:start + n]])


def luminance(rgb: np.ndarray) -> np.ndarray:
    """PIL's integer RGB -> L, which the native decoder applies."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.float32)


class Recorded:
    """Records the arguments of every call of a module's function (installed
    over its name) and passes the call on."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []
        self._saved = getattr(module, name)

    def __enter__(self):
        saved = self._saved

        def recorded(*a, **k):
            self.calls.append((a, k))
            return saved(*a, **k)

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._saved)


def shaped_synthetic_map(tmp: str) -> tuple:
    """run_synthetic's object scene (30 frames, 1000 features, three objects
    seen 25 degrees down with the renderer's detections and masks) with a
    toy-width decoder in the reference checkpoint's layout (8 layers, the
    latent in at layer 4; run_synthetic's own toy decoder has 6 layers,
    which `--checkpoint` cannot load in either package), trained on the
    card: -> (map path, checkpoint path, params, decoder config, system)."""
    dec_cfg = DeepSDFConfig(code_dim=16, hidden=96, num_layers=8, latent_in=(4,))
    params, _, _ = train_toy_decoder(0, dec_cfg, num_shapes=8, steps=300, batch=512, device="cuda")
    cfg = TrackingConfig(orb=OrbConfig(num_features=1000))
    scene = make_scene(num_objects=3, seed=2, device="cuda")
    pitch = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0], dtype=torch.float32)).numpy()
    Tcw_gt = np.einsum("fij,jk->fik", orbit_trajectory(30), pitch).astype(np.float32)
    sysm = SlamSystem(cfg, shape_prior=(params, dec_cfg), device="cuda")
    for T in Tcw_gt:
        gray, depth, inst = render_scene(scene, T, cfg.intr)
        det = gt_detections(scene, T, cfg.intr, instance=inst)
        sysm.track_rgbd(gray, depth, {k: v.cpu().numpy() for k, v in det.items()})
    map_path, ckpt = os.path.join(tmp, "shaped_map.npz"), os.path.join(tmp, "decoder_ref_layout.pth")
    save_map(map_path, sysm.map_state, sysm.objects)
    torch.save({"model_state_dict": DeepSDFDecoder(dec_cfg, params).state_dict()}, ckpt)
    return map_path, ckpt, params, dec_cfg, sysm


def tools_path(tmp: str, tum13: dict) -> dict:
    """Phase 22: the tools at full width on phase 13's sequence (see the
    module docstring), each step a span of the port's `Tracer` that ends in
    a synchronise."""
    tr = Tracer()
    seq_dir, conf = os.path.join(tmp, "mono"), os.path.join(tmp, "tum4000.yaml")
    save_dir, frames_dir = os.path.join(tmp, "tools_out"), os.path.join(tmp, "tools_frames")
    res = {}

    # (a) run_tum --detections --save-dir --save-frames ------------------
    torch.cuda.synchronize()
    zero_counts()
    with tr.span("a run_tum --save-dir --save-frames"), FrameTimes("track_rgbd") as ft, \
            Recorded(frame_draw, "save_annotated") as saved:
        out = run_tum.main([seq_dir, "--detections", os.path.join(seq_dir, "detections"), "--config", conf,
                            "--save-dir", save_dir, "--save-frames", frames_dir, "--frame-every", "10"])
        torch.cuda.synchronize()
    counts = read_counts()
    sysm = ft.system
    g = rgbd_objects_gates(sysm, out, "phase 22 run_tum --save-frames")
    m = load_map(os.path.join(save_dir, "map.npz"))
    n_pts, n_obj = int(m["pt_valid"].sum()), int(m["obj_valid"].sum())
    ply = {n: ply_counts(os.path.join(save_dir, f"{n}.ply"))
           for n in ("map_points", "trajectory", "object_wireframes")}
    _, Tcw = load_trajectory_tum(os.path.join(save_dir, "CameraTrajectory.txt"))
    centres = np.stack([np.linalg.inv(T)[:3, 3] for T in Tcw])
    traj_gap = float(np.abs(ply_vertices(os.path.join(save_dir, "trajectory.ply")) - centres).max())
    pngs = sorted(os.listdir(frames_dir))
    marks = []
    for (path, gray), kw in ((c[0][:2], c[1]) for c in saved.calls):
        decoded = native_loader.load_png(path)
        drawn = frame_draw.annotate_frame(gray, **kw)
        if decoded is None or decoded.shape != (480, 640) or not np.array_equal(decoded, luminance(drawn)):
            raise AssertionError(f"phase 22: {path} does not decode to the frame drawn")
        marks.append(int((drawn == (0, 230, 80)).all(-1).sum()))
    res["a"] = {"out": out, "launches": counts, "points": n_pts, "objects": n_obj, "ply": ply,
                "trajectory_gap_m": traj_gap, "frames": pngs, "tracked_mark_px": marks,
                "track_ms_median": out["track_ms_median"]}
    log(f"phase 22a run_tum --detections --save-dir --save-frames --frame-every 10: ATE {out['ate_rmse_m']:.5f} m, "
        f"objects {out['num_objects']} labels {g['labels']}, recall {g['ev'].recall:.3f}, planes {g['planes_2_votes']}; "
        f"launches {counts}; map_points.ply {ply['map_points']} for {n_pts} valid points, trajectory.ply "
        f"{ply['trajectory']} (centres within {traj_gap:.2e} m), object_wireframes.ply {ply['object_wireframes']} for "
        f"{n_obj} objects; frames {pngs}, tracked-mark pixels {marks}; track_ms_median "
        f"{out['track_ms_median']:.3f} (phase 13: {tum13['out']['track_ms_median']:.3f})")
    if counts["fast_nms"] != MONO_FRAMES or counts["hamming"] < 1:
        raise AssertionError(f"phase 22 launches: {counts}")
    if not (ply["map_points"] == {"vertex": n_pts} and ply["trajectory"] == {"vertex": MONO_FRAMES}
            and ply["object_wireframes"] == {"vertex": 72 * n_obj} and traj_gap <= 1e-5):
        raise AssertionError(f"phase 22 scene export: {res['a']}")
    if len(pngs) != len(range(0, MONO_FRAMES, 10)) or len(marks) != len(pngs) or min(marks[1:]) < 100:
        raise AssertionError(f"phase 22 annotated frames: {pngs}, marks {marks}")

    # (b) visualize_map on the saved map ----------------------------------
    with tr.span("b visualize_map 640x480"), CallTimes(object_render, "render_objects_png") as rt:
        viz = visualize_map.main([os.path.join(save_dir, "map.npz"), "--out", os.path.join(tmp, "viz")])
        torch.cuda.synchronize()
    res["b"] = {"json": viz, "render_ms": rt.ms}
    log(f"phase 22b visualize_map: {viz}, ms per render (CUDA events) {[round(x, 3) for x in rt.ms]}")
    if not (viz["keyframes"] == int(m["num_kfs"]) and viz["points"] == n_pts and viz["objects"] == n_obj
            and len(viz["renders"]) == 2 and all(os.path.exists(p) for p in viz["renders"])):
        raise AssertionError(f"phase 22 visualize_map: {viz}")

    # (c) a map with shapes: extract_objects and visualize_map -----------
    with tr.span("c shaped map (train, 30 frames)"):
        map_path, ckpt, params, dec_cfg, shaped = shaped_synthetic_map(tmp)
        torch.cuda.synchronize()
    sm = load_map(map_path)
    due = np.nonzero(sm["obj_valid"] & sm["obj_shape_ok"])[0]
    cli_cfg = DeepSDFConfig(code_dim=sm["obj_code"].shape[1])  # what --checkpoint reads
    with tr.span("c expected meshes at 64"):
        want = {}
        for i in due:
            mesh = extract_mesh_from_code(params, cli_cfg, torch.from_numpy(sm["obj_code"][i]).cuda(), resolution=64)
            if len(mesh.vertices):
                want[f"object_{i}.ply"] = {"vertex": len(mesh.vertices), "face": len(mesh.faces)}
        torch.cuda.synchronize()
    mesh_dir = os.path.join(tmp, "meshes")
    with tr.span("c extract_objects --resolution 64"):
        written = extract_objects.main([map_path, "--out", mesh_dir, "--checkpoint", ckpt, "--resolution", "64"])
        torch.cuda.synchronize()
    got = {n: ply_counts(os.path.join(mesh_dir, n)) for n in sorted(os.listdir(mesh_dir))}
    with tr.span("c visualize_map with shapes"), CallTimes(object_render, "render_objects_png") as rt2:
        viz2 = visualize_map.main([map_path, "--out", os.path.join(tmp, "viz_shapes"), "--checkpoint", ckpt])
        torch.cuda.synchronize()
    res["c"] = {"shape_ok": due.tolist(), "meshes": got, "render_ms": rt2.ms, "json": viz2}
    log(f"phase 22c shaped map (run_synthetic's scene, 30 frames, decoder 16/96/8 in the reference layout): "
        f"keyframes {shaped.stats['keyframes']}, objects {int(sm['obj_valid'].sum())}, shape_ok {due.tolist()}; "
        f"extract_objects wrote {written}: {got}; "
        f"expected {want}; visualize_map {viz2['renders']}, ms per render {[round(x, 3) for x in rt2.ms]}")
    if len(due) < 1 or written != len(want) or got != want or len(viz2["renders"]) != 2:
        raise AssertionError(f"phase 22 shapes: written {written}, {got} vs {want}")

    # (d) the dense builder on the card and on the CPU -------------------
    seq = TumSequence(seq_dir)
    views = [seq.load(i)[:2] for i in range(MONO_FRAMES)]
    poses = sysm.trajectory[:MONO_FRAMES]
    built, ms = {}, {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for dev in ("cuda", "cpu"):
        b = DenseBuilder(sysm.cfg.intr, device=dev)
        with tr.span(f"d dense builder {dev}"):
            t0 = time.perf_counter()
            for (gray, depth), T in zip(views, poses):
                b.process_frame(gray, depth, T)
            torch.cuda.synchronize()
            ms[dev] = (time.perf_counter() - t0) * 1e3 / MONO_FRAMES
        built[dev] = b
    shared = len(np.intersect1d(built["cuda"]._keys, built["cpu"]._keys))
    most = max(built["cuda"].num_points, built["cpu"].num_points)
    res["d"] = {"points": built["cuda"].num_points, "points_cpu": built["cpu"].num_points, "shared": shared,
                "ms_per_frame": ms["cuda"], "ms_per_frame_cpu": ms["cpu"],
                "peak_mb": (torch.cuda.max_memory_allocated() - held) / 2**20}
    log(f"phase 22d DenseBuilder over {MONO_FRAMES} frames at stride 4, voxel 0.05 m: {res['d']['points']} points "
        f"on the card, {res['d']['points_cpu']} on the CPU, {shared} keys shared ({most - shared} not), "
        f"{ms['cuda']:.3f} ms per frame on the card (host clock, the host hash included; CPU {ms['cpu']:.3f}), "
        f"peak device memory above what was held before {res['d']['peak_mb']:.1f} MiB")
    if shared < 0.999 * most or shared < 1000:
        raise AssertionError(f"phase 22 dense builder: {res['d']}")

    # (e) the label tool ---------------------------------------------------
    labels = os.path.join(tmp, "labels")
    shutil.copytree(os.path.join(seq_dir, "detections"), labels)
    text = io.StringIO()
    with tr.span("e label_tool"), contextlib.redirect_stdout(text):
        n0 = len(load_detection_cache(os.path.join(labels, "5.npz"))["label"])
        label_tool.main(["det", "add", labels, "5", "--bbox", "10", "20", "50", "60", "--label", "2", "--prob", "0.8"])
        label_tool.main(["det", "list", labels, "--frame", "5", "--all"])
        label_tool.main(["det", "remove", labels, "5", str(n0)])
        gt_file = os.path.join(tmp, "gt.npz")
        label_tool.main(["gt", "from-map", gt_file, "--map", os.path.join(save_dir, "map.npz")])
    with np.load(gt_file) as z:
        n_gt = len(z["label"])
    after = load_detection_cache(os.path.join(labels, "5.npz"))
    lines = text.getvalue().splitlines()
    log(f"phase 22e label_tool: {lines[0]}; {lines[-1]}; {len(lines)} lines; gt objects {n_gt} for {n_obj}")
    if n_gt != n_obj or len(after["label"]) != n0 or "label=2 prob=0.80 bbox=(10,20,50,60)" not in text.getvalue():
        raise AssertionError(f"phase 22 label tool: {lines}")

    # (f) one tracked frame under the device trace ------------------------
    trace_dir = os.path.join(tmp, "trace")
    gray, depth = views[-1]
    with tr.span("f one frame under device_trace"), device_trace(trace_dir, device="cuda"):
        sysm.track_rgbd(gray, depth)
        torch.cuda.synchronize()
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    names_k1 = traces and KERNEL_NAMES[0] in Path(trace_dir, traces[0]).read_text()
    report = tr.report()
    log(f"phase 22f device trace {traces} names {KERNEL_NAMES[0]}: {bool(names_k1)}; Tracer report {json.dumps(report)}")
    if not names_k1:
        raise AssertionError(f"phase 22: the device trace does not name {KERNEL_NAMES[0]}")
    res["f"] = {"report": report}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, help="write a torch.profiler table here")
    ap.add_argument("--shape-dump", default=None,
                    help="save phase 16's first full-width shape step here (for tools/shape_step_reference.py)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # 1. card, build ---------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build(["fast_nms", "hamming"], verbose=True)
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        print(f"[nvcc {name}]\n{text}", file=sys.stderr)

    cfg = TrackingConfig(orb=OrbConfig(num_features=4000), depth_png_scale=5000.0)
    frames, Tcw_gt = render_sequence(FRAMES, cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    # 2. K1 against its plain version ----------------------------------
    ths = (cfg.orb.fast_threshold, cfg.orb.fast_threshold_min)
    levels = build_pyramid(torch.from_numpy(frames[0][0]).cuda().float(), cfg.orb.pyramid)
    odd = [torch.randint(0, 256, s, generator=gen, device="cuda").float()
           for s in ((8, 8), (7, 300), (37, 53), (250, 33))]
    calls = [levels, build_pyramid(torch.from_numpy(frames[FRAMES // 2][0]).cuda().float(), cfg.orb.pyramid),
             odd[:2] + [levels[6]] + odd[2:]]
    k1_err, n_maps = 0.0, 0

    def k1_check(got, ref, what):
        nonlocal k1_err, n_maps
        if not torch.equal(got > 0, ref > 0):
            raise AssertionError(f"K1 keep mask differs: {what}")
        k1_err = max(k1_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from plain: {what}")
        n_maps += 1

    for imgs in calls:
        before = fast_score_nms_pyramid.launches
        got = fast_score_nms_pyramid(imgs, ths)
        torch.cuda.synchronize()
        if fast_score_nms_pyramid.launches != before + 1:
            raise AssertionError("fast_score_nms_pyramid did not launch exactly once")
        for img, maps, refs in zip(imgs, got, fast_score_nms_pyramid_plain(imgs, ths)):
            for t, m, r in zip(ths, maps, refs):
                k1_check(m, r, f"pyramid call, {tuple(img.shape)} t={t}")
    for img in levels + odd:
        for t in ths:
            got = fast_score_nms(img, t)
            torch.cuda.synchronize()
            k1_check(got, fast_score_nms_plain(img, t), f"single image {tuple(img.shape)} t={t}")
    log(f"phase 2 K1 vs plain: {len(calls)} pyramid calls (two frames' 8 levels, 4 odd shapes + a level) "
        f"and {len(levels) + len(odd)} single images, x 2 thresholds; {n_maps} maps bitwise equal, "
        f"max abs err {k1_err}")

    # 3. K2 against its plain version ----------------------------------
    k2_in = {}
    for A, B in K2_SHAPES:
        a, b, rows, even = planted_words(A, B, gen)
        k2_in[(A, B)] = (a, b)
        check_k2(a, b, f"({A}, {B})", rows, even)
    log(f"phase 3 K2 vs plain: {', '.join(map(str, K2_SHAPES))} exactly equal, "
        "planted rows at distance 0 and 256 included")

    # 4. main path at full width --------------------------------------
    zero_counts()
    sysm, wall = run_slam(cfg, frames, "cuda")
    launches = read_counts()
    est = np.stack(sysm.trajectory)
    ate = ate_rmse(est, Tcw_gt[: len(est)])
    s = sysm.summary()
    log(f"phase 4 main path: {len(frames)} frames, {s['keyframes']} keyframes, "
        f"{s['num_points']} points, ATE {ate:.5f} m, launches {launches}")
    log(f"  ms/frame median after 10 warm-up frames: {float(np.median(wall)):.3f} "
        f"(track {s['track_ms_median']:.3f}, local BA + fusion per keyframe {s['ba_ms_median']:.3f})")
    if not np.isfinite(est).all() or ate >= 0.05 or s["keyframes"] < 2:
        raise AssertionError(f"main path failed: ATE {ate}, keyframes {s['keyframes']}")
    if launches["fast_nms"] != len(frames) or launches["hamming"] < 1:
        raise AssertionError(f"kernel launches off the main path: {launches}")

    # 5. small input: card against the CPU reference --------------------
    small = TrackingConfig(orb=OrbConfig(num_features=500), depth_png_scale=5000.0)
    runs = {dev: run_slam(small, frames[:10], dev, warmup=0)[0] for dev in ("cuda", "cpu")}
    p = {dev: positions_from_Tcw(np.stack(r.trajectory).astype(np.float64)) for dev, r in runs.items()}
    gap = float(np.linalg.norm(p["cuda"] - p["cpu"], axis=1).max())
    same_kfs = runs["cuda"].stats["kf_frames"] == runs["cpu"].stats["kf_frames"]
    log(f"phase 5 card vs CPU reference, 10 frames at 500 features: max centre gap {gap:.2e} m, "
        f"keyframes {runs['cuda'].stats['kf_frames']} vs {runs['cpu'].stats['kf_frames']}")
    if gap > 0.01 or not same_kfs:
        raise AssertionError("card and CPU runs disagree")

    # 6. kernel times --------------------------------------------------
    # K1: one call per frame, 8 levels x 2 thresholds.  Bound: each pyramid
    # pixel read once (4 B) and written once per threshold (4 B each).
    px = sum(im.numel() for im in levels)
    k1_s = {"bytes": px * 4 * (1 + len(ths)) / HBM_BYTES_PER_S,
            "operations": px * len(ths) * K1_OPS_PER_PX / FP32_OPS_PER_S}

    # K2: the yardsticks compute K2's function (checked here on ±1 rows).
    k2_time = {}
    for A, B in ((8192, 4000), (2048, 2048)):
        pm_a, pm_b = (torch.where(torch.rand(n, 256, generator=gen, device="cuda") < 0.5, 1, -1).to(torch.int8)
                      for n in (A, B))
        got = hamming_packed(pack_pm(pm_a), pack_pm(pm_b))
        if not (torch.equal(got, ((256 - pm_a.float() @ pm_b.float().T) // 2).to(torch.int32))
                and torch.equal(got, (256 - torch._int_mm(pm_a, pm_b.T)) // 2)):
            raise AssertionError(f"K2 differs from the ±1 matmul yardsticks at ({A}, {B})")
        k2_time[(A, B)] = k2_times(*k2_in[(A, B)], gen, 100)
    kernels = [
        {
            "name": "fast_score_nms", "route": "cuda",
            "source": "qsp_slam_tpu_torch/csrc/fast_nms.cu",
            "replaces": "qsp_slam_tpu/ops/fast_pallas.py:129",
            "launches": launches["fast_nms"], "max_abs_err": k1_err,
            "ms": cuda_ms(lambda: fast_score_nms_pyramid(levels, ths), 200),
            "plain_ms": cuda_ms(lambda: fast_score_nms_pyramid_plain(levels, ths), 10),
            "bound_ms": max(k1_s.values()) * 1e3,
            "bound_by": max(k1_s, key=k1_s.get),
            "library_ms": None,
            "unit": "one frame: one launch over 8 pyramid levels x 2 thresholds",
        },
        {
            "name": "hamming_packed", "route": "cuda",
            "source": "qsp_slam_tpu_torch/csrc/hamming.cu",
            "replaces": "qsp_slam_tpu/ops/hamming.py:48",
            "launches": launches["hamming"], "max_abs_err": 0.0,
            **k2_time[(8192, 4000)],
            "unit": "one call at (8192 map points, 4000 features); library_ms: f32 matmul, "
                    "library_int8_ms: int8 matmul, both of the ±1 rows",
            "at_2048x2048": k2_time[(2048, 2048)],
        },
    ]
    for k in kernels:
        log(f"phase 6 {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} by {k['bound_by']})")
    log(f"phase 6 hamming_packed at (2048, 2048): {k2_time[(2048, 2048)]}")

    # 7. the TUM command line --------------------------------------------
    tum = tum_path(cfg)

    # 8. recovery -------------------------------------------------------
    prof_dir = Path(args.profile) if args.profile else None
    if prof_dir:
        prof_dir.mkdir(parents=True, exist_ok=True)
    rec = recovery_path(cfg, frames, Tcw_gt, sysm, profile=prof_dir)
    # 9-10. the KITTI stereo path and loop closing ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        kit = kitti_path(tmp, keep=20 if prof_dir else 0)
        loop = loop_path(tmp)
        mono = mono_path(tmp, keep=20 if prof_dir else 0)
        rgbd_obj = rgbd_objects_path(tmp)
        stereo_obj = stereo_objects_path(tmp)
        objects_card_vs_cpu(tmp)
        if prof_dir:
            profile_objects(tmp, stereo_obj.pop("system"), prof_dir / "profile_objects.txt")
        shape = shape_path(tmp, prof_dir, args.shape_dump)
        shape_frames_small, _, shape_truth = shape_frames(SHAPE_SMALL)
        shape_card_vs_cpu(shape_frames_small, shape_truth)
        synth = synthetic_path()
        d2 = detector2d_path(tmp, prof_dir)
        d3 = detector3d_path(tmp, prof_dir)
        dist21 = distribution_path(tmp)
        tools = tools_path(tmp, rgbd_obj)
    st = stereo_kernels(kit.pop("pair"), gen)
    mk = mono_kernels(gen)
    kernels[0]["launches_kitti_path"] = kit["launches"]["fast_nms"]
    kernels[0]["launches_loop_path"] = loop["launches"]["fast_nms"]
    kernels[0]["stereo_pair"] = st["k1"]
    kernels[1]["launches_kitti_path"] = kit["launches"]["hamming_shapes"]
    kernels[1]["launches_loop_path"] = loop["launches"]["hamming_shapes"]
    kernels[1]["stereo"] = st["k2"] | {
        "unit": "ms of one call at (left, right features), (local map, features), (features, snapshot rows) "
                "at 2000 and 1000 features"}
    kernels[0]["launches_mono_path"] = mono["launches"]["fast_nms"]
    kernels[1]["launches_mono_path"] = mono["launches"]["hamming_shapes"]
    kernels[1]["mono"] = mk["k2"] | {
        "unit": "ms of one call at (features, features) bootstrap, (snapshot rows, features) triangulation, "
                "(map capacity, features) tracking at 1000 features"}
    kernels[0]["launches_rgbd_objects_path"] = rgbd_obj["launches"]["fast_nms"]
    kernels[1]["launches_rgbd_objects_path"] = rgbd_obj["launches"]["hamming_shapes"]
    kernels[0]["launches_stereo_objects_path"] = stereo_obj["launches"]["fast_nms"]
    kernels[1]["launches_stereo_objects_path"] = stereo_obj["launches"]["hamming_shapes"]
    kernels[0]["launches_tum_path"] = tum["launches"]["fast_nms"]
    kernels[0]["launches_shape_path"] = shape["launches"]["fast_nms"]
    kernels[1]["launches_shape_path"] = shape["launches"]["hamming_shapes"]
    kernels[0]["launches_synthetic_objects_path"] = synth["launches"]["fast_nms"]
    kernels[1]["launches_synthetic_objects_path"] = synth["launches"]["hamming_shapes"]
    kernels[1]["launches_tum_path"] = tum["launches"]["hamming"]
    for name, path in (("detector2d_run_tum", d2["run_tum"]), ("detector2d_run_synthetic", d2["run_synthetic"]),
                       ("detector3d_run_kitti", d3["run_kitti"])):
        kernels[0][f"launches_{name}_path"] = path["launches"]["fast_nms"]
        kernels[1][f"launches_{name}_path"] = path["launches"]["hamming_shapes"]
    kernels[0]["launches_tools_path"] = tools["a"]["launches"]["fast_nms"]
    kernels[1]["launches_tools_path"] = tools["a"]["launches"]["hamming_shapes"]
    for name in ("run_tum", "run_kitti"):
        kernels[0][f"launches_mesh2_{name}_path"] = [c["fast_nms"] for c in dist21[name]["launches_per_rank"]]
        kernels[1][f"launches_mesh2_{name}_path"] = [c["hamming"] for c in dist21[name]["launches_per_rank"]]
    kernels[1]["recovery"] = {
        "at_" + shape: times for shape, times in rec["k2"].items()
    } | {
        f"{name}_lost_frame": {"ms": rec[name]["ms"], "launches": rec[name]["launches"]["hamming_shapes"]}
        for name in ("kick", "kick_warm", "teleport", "teleport_warm")
    } | {
        "svd_ms": rec["svd_ms"],
        "unit": "ms of one call at (features, snapshot rows) and (4 snapshots' rows, features); lost-frame ms "
                "by CUDA events around track_rgbd (the first kick is the process's first lost frame); "
                "launches per (A, B) in that frame",
    }

    if prof_dir:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sysm2 = SlamSystem(cfg, device="cuda")
        for g8, d16 in frames[:12]:
            sysm2.track_rgbd(g8, d16)
        torch.cuda.synchronize()
        profiled_window(sysm2.track_rgbd, frames[12:20], prof_dir / "profile.txt", "main-path frames 12-19")
        pairs = kit["kept"]["pairs"]
        sysm3 = SlamSystem(kit["kept"]["cfg"], kmax=128, nmax=16384, emax=131072, device="cuda")
        for gl, gr in pairs[:12]:
            sysm3.track_stereo(gl, gr)
        torch.cuda.synchronize()
        profiled_window(sysm3.track_stereo, pairs[12:20], prof_dir / "profile_kitti.txt",
                        f"KITTI-drive frames 12-19 at {KITTI_W}x{KITTI_H}, {KITTI_F} features")
        sysm4 = SlamSystem(TrackingConfig(), enable_objects=True, device="cuda")
        for g, d in mono["kept"][:12]:
            sysm4.track_mono(g, d)
        torch.cuda.synchronize()
        profiled_window(sysm4.track_mono, mono["kept"][12:20], prof_dir / "profile_mono.txt",
                        f"monocular frames 12-19 with objects at 640x480, {MONO_F} features")

        # Each kernel alone, `reps` back-to-back calls per shape in one
        # profiled window: device time per call, which the events of phase 6
        # cannot show where the host takes longer per call than the card.
        # The profiler can drop the first kernel records of a window (85 of
        # 260 in one run), so 300 warm-up calls lead and each shape takes
        # its records from the end of the window, in launch order.  (Windows
        # of their own per shape lost records too.)
        reps = 50
        alone = [("K1, one frame (8 levels x 2 thresholds)", KERNEL_NAMES[0],
                  lambda: fast_score_nms_pyramid(levels, ths)),
                 (f"K1, one {KITTI_W}x{KITTI_H} stereo pair (2 x 8 levels x 2 thresholds)", KERNEL_NAMES[0],
                  lambda: fast_score_nms_pyramid(st["levels"], st["ths"]))]
        k2_all = [(sh, k2_in[sh]) for sh in ((8192, 4000), (2048, 2048))]
        k2_all += list(rec["k2_inputs"].items()) + list(st["k2_inputs"].items()) + list(mk["k2_inputs"].items())
        for (A, B), (a, b) in k2_all:
            alone.append((f"K2 at ({A}, {B})", KERNEL_NAMES[1], lambda a=a, b=b: hamming_packed(a, b)))
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            for fn in [alone[0][2]] * 300 + [fn for _, _, fn in alone for _ in range(reps)]:
                fn()
            torch.cuda.synchronize()
        launched = sorted((e for e in pr.events() if e.device_type == DeviceType.CUDA),
                          key=lambda e: e.time_range.start)
        seen = {n: [e.time_range.elapsed_us() for e in launched if n in e.name] for n in KERNEL_NAMES}
        per_call = {}
        for what, name, _ in reversed(alone):
            per_call[what], seen[name] = seen[name][-reps:], seen[name][:-reps]
        for what, _, _ in alone:
            us = per_call[what]
            log(f"  device time per call, {what}: " + (
                f"{sum(us) / reps:.2f} us" if len(us) == reps
                else f"not measured (the profiler kept {len(us)} of {reps} launches)"))

    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

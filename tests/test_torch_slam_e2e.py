"""End-to-end slice test of the PyTorch port: the configuration of
`tests/test_slam_e2e.py` (500 features, kmax=16, nmax=2048, emax=16384,
ba_window=6, objects and loop closing off) through both packages on the
same rendered frames.

The port must meet the JAX test's bounds (ATE < 0.05 m, worst per-frame
error < 0.12 m, >= 2 keyframes, > 200 points), keep every camera centre
within 1 cm of the JAX run's, and insert keyframes at the same frames.
"""

import numpy as np
import pytest
import torch

from qsp_slam_tpu.slam.system import SlamSystem as JaxSlamSystem
from qsp_slam_tpu.slam.tracking import TrackingConfig as JaxTrackingConfig
from qsp_slam_tpu.frontend.orb import OrbConfig as JaxOrbConfig
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.eval.ate import ate_rmse, positions_from_Tcw, umeyama_alignment
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)

NUM_FRAMES = 20
CAPACITY = dict(kmax=16, nmax=2048, emax=16384, ba_window=6)


@pytest.fixture(scope="module")
def runs():
    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    room = make_room(device="cpu")
    Tcw_gt = orbit_trajectory(NUM_FRAMES)
    frames = [tuple(x.numpy() for x in render_frame(room, Tcw_gt[i], cfg.intr))
              for i in range(NUM_FRAMES)]
    port = SlamSystem(cfg, device="cpu", **CAPACITY)
    ref = JaxSlamSystem(JaxTrackingConfig(orb=JaxOrbConfig(num_features=500)),
                        enable_objects=False, enable_loop_closing=False, **CAPACITY)
    for gray, depth in frames:
        port.track_rgbd(gray, depth)
    for gray, depth in frames:
        ref.track_rgbd(gray, depth)
    return port, ref, Tcw_gt


class TestPortEndToEnd:
    def test_ate_within_bound(self, runs):
        port, _, Tcw_gt = runs
        est = np.stack(port.trajectory)
        assert len(est) == NUM_FRAMES
        assert ate_rmse(est, Tcw_gt) < 0.05

    def test_worst_frame_within_bound(self, runs):
        port, _, Tcw_gt = runs
        p_est = positions_from_Tcw(np.stack(port.trajectory).astype(np.float64))
        p_gt = positions_from_Tcw(Tcw_gt.astype(np.float64))
        s, R, t = umeyama_alignment(p_est, p_gt)
        err = np.linalg.norm((s * (R @ p_est.T)).T + t - p_gt, axis=1)
        assert err.max() < 0.12, err.max()

    def test_keyframes_and_map_grow(self, runs):
        port, _, _ = runs
        s = port.summary()
        assert s["keyframes"] >= 2
        assert s["num_points"] > 200
        assert s["num_obs"] > s["num_points"]

    def test_follows_jax_trajectory(self, runs):
        port, ref, _ = runs
        p_port = positions_from_Tcw(np.stack(port.trajectory).astype(np.float64))
        p_ref = positions_from_Tcw(np.stack(ref.trajectory).astype(np.float64))
        assert np.linalg.norm(p_port - p_ref, axis=1).max() < 0.01

    def test_same_keyframes_as_jax(self, runs):
        port, ref, _ = runs
        assert port.stats["kf_frames"] == ref.stats["kf_frames"]
        assert port.summary()["keyframes"] == ref.summary()["keyframes"]

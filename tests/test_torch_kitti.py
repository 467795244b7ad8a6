"""The port's KITTI path on the CPU: the fabricator, the reader, the
command line and stereo checkpoints, against the JAX package.

Tolerances: poses files equal to 1e-6; PNGs at most 1 gray level apart on
at most 1e-3 of the pixels (the two f32 renders differ in the last bits of
the ray products, which moves a few values across an integer before the
truncation to 8 bits); calibration and times files identical; velodyne
points within 1e-2 m (the same depths, backprojected).  Stereo
checkpoints are tested in `test_torch_stereo.py`, beside the JAX stereo
session they resume.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from qsp_slam_tpu.data import kitti as jkitti
from qsp_slam_tpu.data import make_kitti as jmake
from qsp_slam_tpu_torch import run_kitti
from qsp_slam_tpu_torch.data import kitti as tkitti
from qsp_slam_tpu_torch.data import make_kitti as tmake
from qsp_slam_tpu_torch.data import native_loader

torch.set_num_threads(1)


@pytest.mark.parametrize("loop", [False, True])
def test_make_kitti_matches_jax(tmp_path, loop):
    extra = ["--frames", "4", "--height", "96", "--width", "312"] + (["--loop"] if loop else [])
    for name, mod in (("t", tmake), ("j", jmake)):
        mod.main([str(tmp_path / name), *extra, "--poses-out", str(tmp_path / name / "poses.txt"), "--cpu"])
    t, j = tmp_path / "t", tmp_path / "j"
    np.testing.assert_allclose(np.loadtxt(t / "poses.txt"), np.loadtxt(j / "poses.txt"), rtol=0, atol=1e-6)
    for name in ("calib.txt", "times.txt"):
        assert (t / name).read_text() == (j / name).read_text()
    for sub in ("image_0", "image_1"):
        names = sorted(os.listdir(t / sub))
        assert names == sorted(os.listdir(j / sub)) and len(names) == 4
        for n in names:
            got = np.asarray(Image.open(t / sub / n))
            assert got.dtype == np.uint8 and got.shape == (96, 312)
            np.testing.assert_array_equal(native_loader.load_png(str(t / sub / n)), got.astype(np.float32))
            diff = np.abs(got.astype(np.int64) - np.asarray(Image.open(j / sub / n)).astype(np.int64))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (sub, n, diff.max(), (diff > 0).sum())
    for i in range(4):
        vt = np.fromfile(t / "velodyne" / f"{i:06d}.bin", np.float32).reshape(-1, 4)
        vj = np.fromfile(j / "velodyne" / f"{i:06d}.bin", np.float32).reshape(-1, 4)
        assert vt.shape == vj.shape and len(vt) > 1000
        np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-2)


def test_to_u8_wraps_as_numpy_astype():
    x = np.array([292.5, -3.2, 255.9, 511.0, -0.5, 1000.7, 17.99], np.float32)
    np.testing.assert_array_equal(tmake._to_u8(torch.from_numpy(x)), x.astype(np.uint8))


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """A 6-frame forward drive at 192x624 (the fabricator's default size)."""
    root = tmp_path_factory.mktemp("drive")
    tmake.make_kitti_sequence(str(root / "seq"), num_frames=6, poses_out=str(root / "poses.txt"), device="cpu")
    return root


def test_kitti_sequence_reads_the_layout(drive):
    seq = tkitti.KittiSequence(str(drive / "seq"), str(drive / "poses.txt"))
    ref = jkitti.KittiSequence(str(drive / "seq"), str(drive / "poses.txt"))
    assert len(seq) == 6 and abs(seq.baseline - 0.54) < 1e-3 and seq.baseline == ref.baseline
    assert seq.intrinsics == ref.intrinsics and seq.intrinsics["fx"] == np.float32(0.58 * 624)
    for k in ref.calib:
        np.testing.assert_array_equal(seq.calib[k], ref.calib[k])
    np.testing.assert_array_equal(seq.times, ref.times)
    np.testing.assert_array_equal(seq.poses, ref.poses)
    pairs = list(seq.prefetch_pairs(range(6)))
    for i in (0, 5):
        for got, want, side in zip(pairs[i], seq.load_gray_pair(i), ("image_0", "image_1")):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(want, np.asarray(Image.open(drive / "seq" / side / f"{i:06d}.png"),
                                                           np.float32))
    velo = seq.load_velodyne(2, max_points=3000)
    np.testing.assert_array_equal(velo, ref.load_velodyne(2, max_points=3000))
    assert velo.shape == (3000, 4)
    pts = seq.transform_velo_to_cam(seq.load_velodyne(0))
    np.testing.assert_allclose(pts, ref.transform_velo_to_cam(ref.load_velodyne(0)), rtol=0, atol=1e-6)
    assert np.median(pts[:, 2]) > 1.0  # forward in the camera frame


# The JAX CLI's keys, in its order: `SlamSystem.summary()`, `global_ba`
# with --global-ba, then the ground-truth metrics.
CLI_KEYS = ["frames", "keyframes", "track_fps", "num_points", "num_obs", "num_objects", "loops_closed",
            "track_ms_median", "ba_ms_median", "global_ba", "ate_rmse_m", "rpe_trans_rmse",
            "rpe_rot_rmse_deg", "pairs", "kf_ate_rmse_m"]


def test_run_kitti_cli(drive, capsys):
    out = run_kitti.main([str(drive / "seq"), "--poses", str(drive / "poses.txt"), "--save-dir",
                          str(drive / "out"), "--num-features", "500", "--kmax", "16", "--nmax", "4096",
                          "--emax", "32768", "--global-ba", "--cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(printed) == CLI_KEYS
    assert printed == json.loads(json.dumps(out))
    assert out["frames"] == 5 and out["keyframes"] >= 2 and out["ate_rmse_m"] < 0.6
    report = json.loads((drive / "out" / "report.json").read_text())
    for key in ("loop_events", "loop_scan", "capacity_events", "resets", "relocalizations", "peak_rss_mb"):
        assert key in report, key
    traj = np.loadtxt(drive / "out" / "trajectory.txt")
    assert traj.shape == (6, 12)


@pytest.mark.parametrize("flag", [["--detections", "d"], ["--lidar-detections"], ["--detector3d", "p.npz"],
                                  ["--mesh", "2"]])
def test_run_kitti_later_slices_refuse(flag):
    """Every flag is taken now: the object flags and the learned 3D detector
    go on to read the sequence (`tests/test_torch_joint.py` and
    `test_run_kitti_detector3d` run them end to end); `--mesh 2` runs the
    command as two ranks, each of which fails to read it, which fails the
    command."""
    if flag[0] in ("--detections", "--lidar-detections", "--detector3d"):
        with pytest.raises(FileNotFoundError, match="calib.txt"):
            run_kitti.main(["unused", *flag, "--cpu"])
        return
    with pytest.raises(RuntimeError, match="calib.txt"):
        run_kitti.main(["unused", *flag, "--cpu"])


def test_run_kitti_detector3d(drive, tmp_path, capsys):
    """`run_kitti --detector3d PARAMS_NPZ` (weights written by the JAX
    package at its default width, the heatmap bias raised so that the
    random init fires): implies `--lidar-detections`, and the learned
    detector's dict is computed once per keyframe from the scan and feeds
    the object step's measured ellipsoids."""
    import jax
    import jax.numpy as jnp

    from qsp_slam_tpu.perception import detector3d as j3d
    from qsp_slam_tpu_torch.perception import detector3d as t3d

    jp = j3d.init_detector3d(jax.random.PRNGKey(0), j3d.Detector3DConfig())
    j3d.save_detector3d(str(tmp_path / "d3d.npz"), {**jp, "hm_b": jnp.full(1, 1.5)}, j3d.Detector3DConfig())
    calls, real = [], t3d.lidar_detections_learned

    def learned(*a, **k):
        calls.append(real(*a, **k))
        return calls[-1]

    t3d.lidar_detections_learned = learned
    try:
        out = run_kitti.main([str(drive / "seq"), "--poses", str(drive / "poses.txt"), "--detector3d",
                              str(tmp_path / "d3d.npz"), "--save-dir", str(tmp_path / "out"), "--num-features",
                              "500", "--kmax", "16", "--nmax", "4096", "--emax", "32768", "--cpu"])
    finally:
        t3d.lidar_detections_learned = real
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    report = json.loads((tmp_path / "out" / "report.json").read_text())
    assert out["keyframes"] >= 2 and report["det_keyframes"] == len(calls) == out["keyframes"]
    assert all(set(d) >= {"ellipsoid_cam", "fit_ok"} and d["ellipsoid_cam"].shape == (8, 9) for d in calls)

"""A cell's sensor and scene come from files: a tiny stereo rehearsal
through `harness/cell.py: run`, the RGB-D cell's frames pinned bit for
bit, the errors for an unknown sensor, scene or `System.options` key, and
K1's least time per launch by the sensor's images."""

import hashlib

import numpy as np
import pytest
import torch

from port_bench.harness import cell as cell_mod
from port_bench.harness import checks, setup
from port_bench.metrics import bounds
from port_bench.traffic.generator import generate
from port_bench_tiny import tiny_cell

TUM = "tum_rgbd_dsp.shapes"
# sha256 of the tiny cell's 44 frames (gray, depth, detections) as the
# generator rendered them while `room_objects` was a function inside it.
TINY_FRAMES_SHA256 = "b2bd65d77d93f9b4e014713f7cfef115c94fe3ffc3cc441c1d1e8a02c84973cc"


def _digest(frames) -> str:
    h = hashlib.sha256()
    for a, b, det in frames:
        for x in (a, b, *(det[k] for k in sorted(det))):
            x = np.ascontiguousarray(x)
            h.update(str((x.dtype.str, x.shape)).encode())
            h.update(x.tobytes())
    return h.hexdigest()


def _stereo(cell: dict) -> dict:
    return dict(cell, config=dict(cell["config"], sensor="stereo"))


def test_the_rgbd_frames_are_those_of_the_scene_in_code():
    c = tiny_cell(TUM)
    traffic = generate(c["traffic"], setup.camera(c["config"]), "cpu", setup.sensor(c["config"]))
    assert len(traffic.frames) == 44 and _digest(traffic.frames) == TINY_FRAMES_SHA256
    assert all(d is f[1] for d, f in zip(traffic.depth, traffic.frames))  # RGB-D: the depth fed is the truth


def test_a_stereo_frame_is_a_left_and_a_right_image_with_the_truth_aside():
    c = _stereo(tiny_cell(TUM, frames=2))
    cam = setup.camera(c["config"])
    rgbd = generate(c["traffic"], cam, "cpu", setup.sensor(tiny_cell(TUM)["config"]))
    stereo = generate(c["traffic"], cam, "cpu", setup.sensor(c["config"]))
    (left, right, det), (gray, depth, det_rgbd) = stereo.frames[0], rgbd.frames[0]
    assert right.dtype == np.uint8 and np.array_equal(left, gray) and not np.array_equal(left, right)
    assert np.array_equal(stereo.depth[0], depth)
    assert all(np.array_equal(det[k], det_rgbd[k]) for k in det_rgbd)


def test_a_tiny_stereo_run(monkeypatch):
    """One shape period (the window's least is three; one keeps this test
    short), stopped at its shape step: K1 and K2 exact on the stereo
    launches, the pyramids of both images, the shape step's depths held to
    the captured keypoint depth image, and that image against the truth."""
    monkeypatch.setattr(cell_mod, "MIN_PERIODS", 1)
    torch.set_num_threads(4)
    run = cell_mod.run(_stereo(tiny_cell(TUM, frames=20)), 99, 0.0, False, device="cpu")
    n = run["numbers"]
    assert run["periods"] == 1 and n["shape_hypotheses"] > 0
    assert n["k1_calls"] == 3 and n["k2_calls"] >= 3
    assert n["k1_mismatch"] == 0 and n["k2_mismatch"] == 0 and n["pyramid_gap"] == 0.0
    assert n["shape_input_gap"] <= run["limits"]["shape_input_gap"]
    assert 0.0 < n["keypoint_depth_gap"] < 0.2


def test_the_keypoint_depth_gap_is_a_median_relative_gap():
    class Traffic:
        depth = {5: np.full((4, 6), 2.0, np.float32)}

    img = torch.zeros(4, 6)
    img[0, :3] = torch.tensor([2.2, 2.0, 1.9])  # gaps 0.1, 0, 0.05; the rest holds no keypoint
    assert checks._keypoint_depth_numbers(Traffic, {5: img})["keypoint_depth_gap"] == pytest.approx(0.05)
    assert checks._keypoint_depth_numbers(Traffic, {}) == {}


def test_an_unknown_sensor_names_the_file_it_looked_for():
    c = tiny_cell(TUM)
    c["config"]["sensor"] = "lidar"
    with pytest.raises(FileNotFoundError, match=r"harness/sensors/lidar\.py"):
        cell_mod.run(c, 99, 0.0, False, device="cpu")


def test_an_unknown_scene_names_the_file_it_looked_for():
    c = tiny_cell(TUM, frames=2)
    c["traffic"]["scene"] = "highway"
    with pytest.raises(FileNotFoundError, match=r"traffic/scenes/highway\.py"):
        cell_mod.run(c, 99, 0.0, False, device="cpu")


def test_system_options_reach_the_system_and_unknown_keys_are_named():
    cfg = tiny_cell(TUM)["config"]
    raw = setup.decoder_weights(cfg, 1, "cpu")
    assert setup.build_system(cfg, raw, "cpu").enable_loop_closing  # no System.options: the defaults
    sysm = setup.build_system(dict(cfg, **{"System.options": {"enable_loop_closing": False}}), raw, "cpu")
    assert not sysm.enable_loop_closing
    for key in ("due_every_keyframe", "kmax"):  # not a field; a field the configuration's own keys set
        with pytest.raises(ValueError, match=key):
            setup.build_system(dict(cfg, **{"System.options": {key: 1}}), raw, "cpu")


def test_a_stereo_k1_launch_is_bound_by_twice_the_rgbd_work():
    cfg = tiny_cell(TUM)["config"]
    rgbd, stereo = setup.k1_level_shapes(cfg), setup.k1_level_shapes(dict(cfg, sensor="stereo"))
    assert rgbd == setup.level_shapes(cfg) and stereo == rgbd + rgbd
    b1, b2 = bounds.k1_launch(rgbd), bounds.k1_launch(stereo)
    assert all(b2[k] == 2 * b1[k] for k in b1)
    # ... and the readers follow: one launch of each at the same device time
    from port_bench.run import read_metric

    trace = {"kernels": {"k1": {"launches": 1, "device_s": 1e-3}}}
    one = read_metric("k1_roofline_pct", {"trace": trace, "config": cfg})
    assert one == pytest.approx(1e5 * bounds.least_s(b1))
    assert read_metric("k1_roofline_pct", {"trace": trace, "config": dict(cfg, sensor="stereo")}) == 2 * one
    rows = [{"frame": 0, "ms": 1.0, "k1_launches": 1, "k2_shapes": {}}]
    mfu = [read_metric("mfu_pct", {"span_rows": rows, "shape_steps": [], "config": c})
           for c in (cfg, dict(cfg, sensor="stereo"))]
    assert mfu[1] == 2 * mfu[0] > 0

"""The port's tool command lines against the JAX package's on the CPU:
`run_tum --save-frames --frame-every 5 --save-dir` on one written
sequence with objects (12 frames, 500 features; one run per package,
shared by the module), then `visualize_map` and `extract_objects` on the
saved map, with and without shapes.

Tolerances: per tracked frame the keypoints within 1e-4 px and the
tracked flags equal on >= 99% of all keypoints (the trackers' f32
rounding parts a few matches late in the run); the annotated frames the
same files, pixel-equal outside the text but for the squares of
keypoints whose flag differs (16 pixels each); the status line equal on
the same state; the scene PLYs parsed within 1e-5; renders with at most
0.5% of the pixels apart (`tests/test_torch_shape.py`'s bound); meshes
with equal faces and world vertices within 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from qsp_slam_tpu import extract_objects as jextract
from qsp_slam_tpu import run_tum as jrun_tum
from qsp_slam_tpu import visualize_map as jviz
from qsp_slam_tpu.slam import system as jsystem
from qsp_slam_tpu.viz import frame_draw as jdraw
from qsp_slam_tpu_torch import extract_objects as textract
from qsp_slam_tpu_torch import run_tum as trun_tum
from qsp_slam_tpu_torch import visualize_map as tviz
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.core import quadric as tquadric
from qsp_slam_tpu_torch.data import make_tum as tmake
from qsp_slam_tpu_torch.data.io import load_detection_cache, load_map, load_trajectory_tum
from qsp_slam_tpu_torch.models import deepsdf as tsdf
from qsp_slam_tpu_torch.slam import system as tsystem
from qsp_slam_tpu_torch.viz import frame_draw as tdraw

# One thread, as in the other port test files: every xdist worker imports every
# test module, and the last one imported sets the worker's count for all of them.
torch.set_num_threads(1)

SMALL = tsdf.DeepSDFConfig(code_dim=16, hidden=32, num_layers=8, latent_in=(4,))  # a reference-format layout


def read_ply(path) -> dict:
    lines = open(path).read().splitlines()
    end = lines.index("end_header")
    header, body = lines[:end + 1], lines[end + 1:]
    out, at = {"header": header}, 0
    for line in header:
        if line.startswith("element "):
            _, name, n = line.split()
            out[name] = np.array([[float(x) for x in r.split()] for r in body[at:at + int(n)]]).reshape(int(n), -1)
            at += int(n)
    return out


def plys_agree(a, b, atol=1e-5) -> None:
    names = sorted(f for f in os.listdir(a) if f.endswith(".ply"))
    assert names == sorted(f for f in os.listdir(b) if f.endswith(".ply"))
    for n in names:
        ref, got = read_ply(os.path.join(a, n)), read_ply(os.path.join(b, n))
        assert got.keys() == ref.keys() and got["header"] == ref["header"], n
        for k in ref:
            if k != "header":
                np.testing.assert_allclose(got[k], ref[k], atol=atol, err_msg=n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' `run_tum --detections --save-dir --save-frames
    --frame-every 5` on one sequence, each frame's `last_frame_info` and
    the status line after each frame recorded."""
    tmp = tmp_path_factory.mktemp("tools_cli")
    seq = str(tmp / "seq")
    tmake.main([seq, "--frames", "12", "--objects", "3", "--detections", "--step", "0.025", "--pitch", "0.4",
                "--seed", "2", "--cpu"])
    (tmp / "c.yaml").write_text("ORBextractor.nFeatures: 500\n")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, system, cli, draw in (("jax", jsystem, jrun_tum, jdraw), ("port", tsystem, trun_tum, tdraw)):
            seen = out[name] = {"info": [], "status": []}
            track = system.SlamSystem.track_rgbd

            def recorded(self, *a, _track=track, _seen=seen, _draw=draw, **k):
                T = _track(self, *a, **k)
                _seen["info"].append(self.last_frame_info)
                _seen["status"].append(_draw.frame_status(self, len(_seen["status"])))
                return T

            mp.setattr(system.SlamSystem, "track_rgbd", recorded)
            seen["out"] = cli.main([seq, "--config", str(tmp / "c.yaml"), "--detections", os.path.join(seq, "detections"),
                                    "--save-dir", str(tmp / name), "--save-frames", str(tmp / f"{name}_frames"),
                                    "--frame-every", "5", "--cpu"])
            seen["dir"], seen["frames"] = tmp / name, tmp / f"{name}_frames"
    out["tmp"] = tmp
    return out


def test_frame_info_matches_the_reference(runs):
    ref, got = runs["jax"]["info"], runs["port"]["info"]
    assert len(ref) == len(got) == 12 and ref[0] is None and got[0] is None
    agree = total = 0
    for a, b in zip(ref[1:], got[1:]):
        assert b["kp_xy"].dtype == np.float32 and b["kp_xy"].shape == a["kp_xy"].shape == (500, 2)
        np.testing.assert_allclose(b["kp_xy"], a["kp_xy"], atol=1e-4)
        agree += int((a["kp_tracked"] == b["kp_tracked"]).sum())
        total += len(a["kp_tracked"])
        assert b["kp_tracked"].sum() > 50
    assert agree >= 0.99 * total, (agree, total)
    assert runs["port"]["status"] == runs["jax"]["status"]


def test_annotated_frames_match_the_reference(runs):
    names = sorted(os.listdir(runs["jax"]["frames"]))
    assert names == ["000000.png", "000005.png", "000010.png"]
    assert sorted(os.listdir(runs["port"]["frames"])) == names
    pil = ImageDraw.Draw(Image.new("RGB", (640, 480)))
    for n in names:
        ref = np.asarray(Image.open(runs["jax"]["frames"] / n).convert("RGB"))
        got = np.asarray(Image.open(runs["port"]["frames"] / n))
        assert got.shape == ref.shape == (480, 640, 3)
        i = int(n[:-4])
        texts = [((4, 480 - 13), runs["port"]["status"][i])]
        det = load_detection_cache(os.path.join(runs["tmp"], "seq", "detections", f"{i}.npz"))
        texts += [((b[0] + 2, max(b[1] - 11, 0)), f"{int(lab)}:{p:.2f}")
                  for b, lab, p, v in zip(det["bbox"], det["label"], det["prob"], det["valid"]) if v]
        in_text = np.zeros(ref.shape[:2], bool)
        for xy, s in texts:
            for x0, y0, x1, y1 in (pil.textbbox(xy, s), tdraw.text_box(xy, s)):
                in_text[max(int(y0), 0):int(y1) + 1, max(int(x0), 0):int(x1) + 1] = True
        a, b = runs["jax"]["info"][i], runs["port"]["info"][i]
        flips = 0 if a is None else int((a["kp_tracked"] != b["kp_tracked"]).sum())
        assert ((got != ref).any(-1) & ~in_text).sum() <= 16 * flips, n
        assert (got[:, :, 1] == 230).any() or i == 0  # tracked keypoints drawn


def test_scene_export_matches_the_reference(runs):
    jdir, tdir = runs["jax"]["dir"], runs["port"]["dir"]
    for d in (jdir, tdir):
        assert {"map_points.ply", "object_wireframes.ply", "trajectory.ply"} <= set(os.listdir(d))
    m = load_map(str(tdir / "map.npz"))
    assert len(read_ply(tdir / "map_points.ply")["vertex"]) == int(m["pt_valid"].sum())
    assert len(read_ply(tdir / "object_wireframes.ply")["vertex"]) == 72 * int(m["obj_valid"].sum())
    _, Tcw = load_trajectory_tum(str(tdir / "CameraTrajectory.txt"))
    centres = np.stack([np.linalg.inv(T)[:3, 3] for T in Tcw])
    np.testing.assert_allclose(read_ply(tdir / "trajectory.ply")["vertex"], centres, atol=1e-5)
    assert runs["port"]["out"]["num_objects"] == runs["jax"]["out"]["num_objects"] == 3
    jt, tt = read_ply(jdir / "trajectory.ply")["vertex"], read_ply(tdir / "trajectory.ply")["vertex"]
    assert np.abs(jt - tt).max() < 0.005


def renders_agree(a_dir, b_dir, names) -> None:
    for n in names:
        ref = np.asarray(Image.open(os.path.join(a_dir, n)).convert("RGB"))
        got = np.asarray(Image.open(os.path.join(b_dir, n)))
        assert got.shape == ref.shape
        assert np.mean((got != ref).any(-1)) <= 0.005, n


def test_visualize_map_without_shapes(runs, capsys):
    """The JAX run's saved map (objects, no codes) through both viewers."""
    mp = str(runs["jax"]["dir"] / "map.npz")
    outs = {}
    for name, cli in (("jax", jviz), ("port", tviz)):
        d = str(runs["tmp"] / f"viz_{name}")
        capsys.readouterr()
        outs[name] = cli.main([mp, "--out", d, "--views", "0", "-1", "--wh", "160", "120", "--cpu"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == outs[name]
    ref, got = outs["jax"], outs["port"]
    assert {k: v for k, v in got.items() if k not in ("out", "renders")} == \
        {k: v for k, v in ref.items() if k not in ("out", "renders")}
    assert [os.path.basename(p) for p in got["renders"]] == [os.path.basename(p) for p in ref["renders"]]
    assert got["objects"] == 3 and len(got["renders"]) == 2
    plys_agree(ref["out"], got["out"])
    renders_agree(ref["out"], got["out"], [os.path.basename(p) for p in ref["renders"]])


@pytest.fixture(scope="module")
def shaped_map(runs):
    """The saved map with codes from a small decoder in the reference's
    layout (8 layers, latent in at 4) trained here, each object's shape
    frame on its ellipsoid, and that decoder as a reference-format
    checkpoint."""
    params, codes, _ = tsdf.train_toy_decoder(0, SMALL, num_shapes=4, steps=300, batch=512, device="cpu")
    ckpt = str(runs["tmp"] / "decoder.pth")
    torch.save({"model_state_dict": tsdf.DeepSDFDecoder(SMALL, params).state_dict()}, ckpt)
    m = load_map(str(runs["jax"]["dir"] / "map.npz"))
    O = len(m["obj_valid"])
    e = torch.from_numpy(m["obj_ellipsoid"])
    T_wo = tquadric.pose_of(e)
    T_wo[:, :3, :3] *= tquadric.scale_of(e).max(dim=-1).values[:, None, None]
    m["obj_Tow_shape"] = tlie.inv_sim3(T_wo).numpy()
    m["obj_code"] = codes.numpy()[np.arange(O) % 4]
    m["obj_shape_ok"] = m["obj_valid"].copy()
    m["obj_shape_ok"][np.nonzero(m["obj_valid"])[0][-1]] = False
    path = str(runs["tmp"] / "shaped.npz")
    np.savez_compressed(path, **m)
    return path, ckpt, m


def test_extract_objects_matches_the_reference(runs, shaped_map, capsys):
    path, ckpt, m = shaped_map
    counts = {}
    for name, cli in (("jax", jextract), ("port", textract)):
        counts[name] = cli.main([path, "--out", str(runs["tmp"] / f"meshes_{name}"), "--checkpoint", ckpt,
                                 "--resolution", "24", "--cpu"])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["meshes_written"] == counts[name]
    assert counts["port"] == counts["jax"] == int((m["obj_valid"] & m["obj_shape_ok"]).sum()) >= 1
    ref_dir, got_dir = runs["tmp"] / "meshes_jax", runs["tmp"] / "meshes_port"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(ref_dir))
    for n in os.listdir(ref_dir):
        ref, got = read_ply(ref_dir / n), read_ply(got_dir / n)
        assert got["header"] == ref["header"] and len(got["face"]) > 20
        np.testing.assert_array_equal(got["face"], ref["face"])
        np.testing.assert_allclose(got["vertex"], ref["vertex"], atol=1e-4)


def test_visualize_map_with_shapes(runs, shaped_map):
    path, ckpt, _ = shaped_map
    outs = {name: cli.main([path, "--out", str(runs["tmp"] / f"vizs_{name}"), "--checkpoint", ckpt, "--views", "-1",
                            "--wh", "160", "120", "--intr", "130.2", "130.25", "81.3", "62.4", "--cpu"])
            for name, cli in (("jax", jviz), ("port", tviz))}
    assert outs["port"]["objects"] == outs["jax"]["objects"] and outs["port"]["points"] == outs["jax"]["points"]
    plys_agree(outs["jax"]["out"], outs["port"]["out"])
    renders_agree(outs["jax"]["out"], outs["port"]["out"], [os.path.basename(p) for p in outs["jax"]["renders"]])


def test_tools_need_a_device(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mp = str(runs["jax"]["dir"] / "map.npz")
    for cli in (tviz, textract):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([mp, "--out", str(runs["tmp"] / "nodev")])

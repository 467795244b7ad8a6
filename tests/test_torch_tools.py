"""Parity of the port's tools with the JAX package on the CPU: the PLY
export, the tracer, the frame drawer, the dense builder, the label tool
and the helpers no system path calls.

The same seeded numpy inputs go through both packages.  Tolerances: the
PLY writers byte-equal, wireframes and scene files parsed within 1e-5;
the tracer's report the same keys and counts; the frame drawer
pixel-equal to PIL's drawing outside the text (the port's bitmap glyphs
are its own; they stay inside their text box); the dense builder the same
voxel keys in the same order, points within 1e-5 and colours equal; the
label tool the same printed lines and npz contents; `distort_points`
within 1e-4 px, `projection_matrix` within 1e-6 relative, `from_K`,
`edge_budget_for` and `cull_points` exact, `object_frame_points` within
1e-5.
"""

import os
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from qsp_slam_tpu import label_tool as jlabel
from qsp_slam_tpu.core import camera as jcam
from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.models import losses as jloss
from qsp_slam_tpu.perception.dense_builder import DenseBuilder as JDenseBuilder
from qsp_slam_tpu.slam import local_mapping as jlm
from qsp_slam_tpu.slam import map as jmap
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu.utils import tracing as jtracing
from qsp_slam_tpu.viz import export as jexport
from qsp_slam_tpu.viz import frame_draw as jdraw
from qsp_slam_tpu_torch import label_tool as tlabel
from qsp_slam_tpu_torch.convert import map_state_from_numpy
from qsp_slam_tpu_torch.core import camera as tcam
from qsp_slam_tpu_torch.models import losses as tloss
from qsp_slam_tpu_torch.models.mesh import Mesh
from qsp_slam_tpu_torch.perception.dense_builder import DenseBuilder
from qsp_slam_tpu_torch.slam import local_mapping as tlm
from qsp_slam_tpu_torch.slam.map import empty_map
from qsp_slam_tpu_torch.slam.objects import empty_objects
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig
from qsp_slam_tpu_torch.utils import tracing as ttracing
from qsp_slam_tpu_torch.viz import export as texport
from qsp_slam_tpu_torch.viz import frame_draw as tdraw

# One thread, as in the other port test files: every xdist worker imports every
# test module, and the last one imported sets the worker's count for all of them.
torch.set_num_threads(1)

FR1_DIST = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)  # tests/test_undistort.py's coefficients


def read_ply(path) -> dict:
    """Header lines and the rows of each element as float arrays."""
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


def random_ellipsoids(rng, n):
    e = np.concatenate([rng.uniform(-2, 2, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 3)),
                        rng.uniform(0.1, 0.8, (n, 3))], axis=1)
    return e.astype(np.float32)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

class TestExport:
    def test_ply_writers_write_the_same_bytes(self, rng, tmp_path):
        pts = rng.normal(size=(40, 3)).astype(np.float32)
        colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        faces = rng.integers(0, 40, (25, 3)).astype(np.int32)
        for name, jwrite, twrite in (
            ("cloud", lambda p: jexport.save_ply_points(p, pts, colors),
             lambda p: texport.save_ply_points(p, torch.from_numpy(pts), torch.from_numpy(colors))),
            ("bare", lambda p: jexport.save_ply_points(p, pts), lambda p: texport.save_ply_points(p, pts)),
            ("mesh", lambda p: jexport.save_ply_mesh(p, pts, faces),
             lambda p: texport.save_ply_mesh(p, torch.from_numpy(pts), faces)),
        ):
            jwrite(str(tmp_path / f"j_{name}.ply"))
            twrite(str(tmp_path / f"t_{name}.ply"))
            assert (tmp_path / f"t_{name}.ply").read_bytes() == (tmp_path / f"j_{name}.ply").read_bytes(), name

    def test_ellipsoid_wireframe(self, rng):
        for e in random_ellipsoids(rng, 6):
            ref = jexport.ellipsoid_wireframe(e)
            got = texport.ellipsoid_wireframe(torch.from_numpy(e))
            assert got.shape == ref.shape == (72, 3)
            np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_export_scene(self, rng, tmp_path):
        """One numpy map, object table, mesh set and trajectory through both
        packages; the port also from its own `MapState` and `ObjectTable`."""
        pt_valid = rng.uniform(size=64) < 0.7
        m = SimpleNamespace(pt_xyz=rng.normal(size=(64, 3)).astype(np.float32), pt_valid=pt_valid)
        valid = np.array([True, False, True, True])
        objs = SimpleNamespace(ellipsoid=random_ellipsoids(rng, 4), valid=valid)
        mesh = Mesh(vertices=rng.normal(size=(10, 3)).astype(np.float32),
                    faces=rng.integers(0, 10, (6, 3)).astype(np.int32))
        traj = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(x))) for x in
                         rng.normal(scale=0.3, size=(5, 6)).astype(np.float32)])
        jexport.export_scene(str(tmp_path / "j"), m, objs, {"a": mesh}, traj)
        texport.export_scene(str(tmp_path / "t"), m, objs, {"a": mesh}, traj)
        tm = empty_map(4, 64, 256, device="cpu")._replace(pt_xyz=torch.from_numpy(m.pt_xyz),
                                                          pt_valid=torch.from_numpy(pt_valid))
        to = empty_objects(4, device="cpu")._replace(ellipsoid=torch.from_numpy(objs.ellipsoid),
                                                     valid=torch.from_numpy(valid))
        texport.export_scene(str(tmp_path / "t2"), tm, to, {"a": mesh}, torch.from_numpy(traj))
        names = sorted(os.listdir(tmp_path / "j"))
        assert names == ["map_points.ply", "object_a.ply", "object_wireframes.ply", "trajectory.ply"]
        for d in ("t", "t2"):
            assert sorted(os.listdir(tmp_path / d)) == names
            for n in names:
                ref, got = read_ply(tmp_path / "j" / n), read_ply(tmp_path / d / n)
                assert got.keys() == ref.keys() and got["header"] == ref["header"], n
                for k in ref:
                    if k != "header":
                        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=n)
        assert len(read_ply(tmp_path / "t" / "object_wireframes.ply")["vertex"]) == 72 * valid.sum()
        assert len(read_ply(tmp_path / "t" / "map_points.ply")["vertex"]) == pt_valid.sum()


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class TestTracer:
    def test_same_spans_same_report(self, tmp_path):
        reports = []
        for mod in (jtracing, ttracing):
            tr = mod.Tracer()
            for name in ("a", "b", "a", "c", "a"):
                with tr.span(name):
                    sum(range(1000))
            off = mod.Tracer(enabled=False)
            with off.span("a"):
                pass
            assert not off.spans
            reports.append(tr.report())
            assert tr.dump(str(tmp_path / f"{mod.__name__}.json")) == open(tmp_path / f"{mod.__name__}.json").read()
        ref, got = reports
        assert got.keys() == ref.keys()
        for k in ref:
            if k != "max_rss_mb":
                assert got[k]["count"] == ref[k]["count"] and got[k].keys() == ref[k].keys(), k
        assert got["max_rss_mb"] > 10

    def test_device_trace_writes_a_trace_on_the_cpu(self, tmp_path):
        with ttracing.device_trace(str(tmp_path / "trace"), device="cpu"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = [f for f in os.listdir(tmp_path / "trace") if f.endswith(".json")]
        assert files and "aten::mm" in open(tmp_path / "trace" / files[0]).read()


# ---------------------------------------------------------------------------
# Frame drawing
# ---------------------------------------------------------------------------

def pil_rectangle(shape, box, width, fill):
    img = Image.new("RGB", shape[::-1])
    d = ImageDraw.Draw(img)
    if fill:
        d.rectangle(box, fill=(255, 255, 255))
    else:
        d.rectangle(box, outline=(255, 255, 255), width=width)
    return np.asarray(img)


class TestFrameDraw:
    def test_rectangles_are_pils_pixels(self):
        """Float corners in and out of the image, degenerate boxes, outline
        widths 1 and 2 and fills: the same pixels as `ImageDraw.rectangle`."""
        rng = np.random.default_rng(1)
        H, W = 40, 50
        for t in range(600):
            x0, y0 = rng.uniform(-8, 55), rng.uniform(-8, 45)
            w, h = rng.uniform(0, 15), rng.uniform(0, 15)
            if t % 4 == 0:
                x0, y0, w, h = round(x0) + 0.5, round(y0) + 0.5, round(w), round(h)
            box = [np.float32(x0), np.float32(y0), np.float32(x0 + w), np.float32(y0 + h)]
            for width, fill in ((1, False), (2, False), (1, True)):
                got = np.zeros((H, W, 3), np.uint8)
                tdraw.draw_rectangle(got, box, (255, 255, 255), width=width, fill=fill)
                np.testing.assert_array_equal(got, pil_rectangle((H, W), box, width, fill), err_msg=str(box))
        with pytest.raises(ValueError):
            tdraw.draw_rectangle(np.zeros((H, W, 3), np.uint8), [5, 5, 4, 9], (1, 1, 1))

    def test_annotate_frame_is_pils_image_outside_the_text(self, rng, tmp_path):
        H, W = 120, 160
        gray = rng.uniform(-20, 280, (H, W)).astype(np.float32)
        kp = rng.uniform(-3, 165, (300, 2)).astype(np.float32)
        kp[:5] = 0.0  # padding slots
        tracked = rng.uniform(size=300) < 0.5
        corners = rng.uniform(-10, 170, (8, 2, 2)).astype(np.float32)
        boxes = np.concatenate([corners.min(1), corners.max(1)], axis=1)[:, [0, 1, 2, 3]]
        labels = np.arange(8)  # every palette colour, two cycled
        probs = rng.uniform(size=8).astype(np.float32)
        valid = np.ones(8, bool)
        valid[3] = False
        status = "f3 OK kfs=2 pts=100 objs=1 loops=0"
        kw = dict(kp_xy=kp, kp_tracked=tracked, bboxes=boxes, labels=labels, probs=probs, bbox_valid=valid,
                  status=status)
        ref = np.asarray(jdraw.annotate_frame(gray, **kw))
        got = tdraw.annotate_frame(gray, **kw)
        assert got.shape == ref.shape == (H, W, 3) and got.dtype == np.uint8
        texts = [((b[0] + 2, max(b[1] - 11, 0)), f"{int(lab)}:{p:.2f}")
                 for b, lab, p, v in zip(boxes, labels, probs, valid) if v] + [((4, H - 13), status)]
        in_text = np.zeros((H, W), bool)
        pil = ImageDraw.Draw(Image.new("RGB", (W, H)))
        for xy, s in texts:
            for x0, y0, x1, y1 in (pil.textbbox(xy, s), tdraw.text_box(xy, s)):
                in_text[max(int(y0), 0):int(y1) + 1, max(int(x0), 0):int(x1) + 1] = True
            blank = np.zeros((H, W, 3), np.uint8)
            tdraw.draw_text(blank, xy, s, (255, 255, 255))
            ys, xs = np.nonzero(blank.any(-1))
            x0, y0, x1, y1 = tdraw.text_box(xy, s)
            assert len(ys) and ys.min() >= y0 and ys.max() <= y1 and xs.min() >= x0 and xs.max() <= x1, s
        differ = (got != ref).any(-1)
        assert not (differ & ~in_text).any(), np.argwhere(differ & ~in_text)[:5]
        assert in_text.mean() < 0.25
        # The status bar: black but for the text's white glyphs.
        bar = got[H - 14:, :][~in_text[H - 14:, :]]
        assert (bar == 0).all() and (got[H - 13:H - 6, 4:200] == 255).all(-1).any()

        tdraw.save_annotated(str(tmp_path / "f" / "000001.png"), gray, **kw)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f" / "000001.png")), got)
        plain = tdraw.annotate_frame(gray)
        g8 = np.clip(gray, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(plain, np.stack([g8] * 3, -1))
        np.testing.assert_array_equal(plain, np.asarray(jdraw.annotate_frame(gray)))


# ---------------------------------------------------------------------------
# Dense builder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def room_frames():
    """Three views of the reference's room (gray, depth in meters, T_cw)."""
    from qsp_slam_tpu.data.render import make_room, orbit_trajectory, render_frame

    cfg = JTrackingConfig()
    room = make_room()
    traj = orbit_trajectory(7, step=0.05)
    out = []
    for i in (0, 3, 6):
        gray, depth = render_frame(room, jnp.asarray(traj[i]), cfg.intr)
        out.append((np.asarray(gray), np.asarray(depth), np.asarray(traj[i], np.float32)))
    return out


class TestDenseBuilder:
    @pytest.mark.parametrize("max_points", [2_000_000, 1500])
    def test_same_cloud_in_the_same_order(self, room_frames, max_points, tmp_path):
        ref = JDenseBuilder(JTrackingConfig().intr, voxel=0.1, max_points=max_points)
        got = DenseBuilder(TrackingConfig().intr, voxel=0.1, max_points=max_points, device="cpu")
        for gray, depth, T_cw in room_frames:
            ref.process_frame(gray, depth, T_cw)
            got.process_frame(gray, depth, T_cw)
            assert got.num_points == ref.num_points
        assert got.num_points == min(max_points, ref.num_points) and got.num_points > 1000
        np.testing.assert_array_equal(got._keys, np.array(list(ref._voxels.keys()), np.int64))
        (p_ref, g_ref), (p_got, g_got) = ref.cloud(), got.cloud()
        assert p_got.dtype == np.float32 and g_got.dtype == np.float32
        np.testing.assert_allclose(p_got, p_ref, atol=1e-5)
        np.testing.assert_array_equal(g_got, g_ref)
        if max_points < 2_000_000:
            return
        ref.save_ply(str(tmp_path / "j.ply"))
        got.save_ply(str(tmp_path / "t.ply"))
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()

    def test_needs_a_device(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DenseBuilder(TrackingConfig().intr)


# ---------------------------------------------------------------------------
# Label tool
# ---------------------------------------------------------------------------

def npz_contents(d) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in sorted(files):
            with np.load(os.path.join(root, f)) as z:
                out[os.path.relpath(os.path.join(root, f), d)] = {k: z[k] for k in z.files}
    return out


def test_label_tool_matches_the_reference(tmp_path, capsys):
    """Every subcommand, errors included, on copies of one directory."""
    from qsp_slam_tpu.data.io import save_detection_cache, save_map
    from qsp_slam_tpu.slam.map import empty_map
    from qsp_slam_tpu.slam.objects import empty_objects

    base = tmp_path / "base"
    (base / "det").mkdir(parents=True)
    mask = np.zeros((2, 24, 32), bool)
    mask[0, 2:6, 3:9] = True
    save_detection_cache(str(base / "det" / "3.npz"), {
        "bbox": np.array([[1, 1, 9, 9], [2, 2, 8, 8]], np.float32), "label": np.array([0, 1], np.int32),
        "prob": np.array([0.9, 0.8], np.float32), "valid": np.array([True, False]), "mask": mask})
    obj = empty_objects(omax=4)
    e = jnp.asarray([1.0, 0.5, 2.0, 0, 0.3, 0, 0.2, 0.15, 0.2])
    obj = obj._replace(ellipsoid=obj.ellipsoid.at[0].set(e).at[2].set(e + 1), label=obj.label.at[0].set(2),
                       valid=obj.valid.at[0].set(True).at[2].set(True))
    save_map(str(base / "map.npz"), empty_map(4, 64, 256), objects=obj)
    ell = ["1.0", "0.5", "2.0", "0", "0.3", "0", "0.2", "0.15", "0.2"]
    script = [
        ["det", "list", "{d}/det"], ["det", "list", "{d}/det", "--all"],
        ["det", "add", "{d}/det", "3", "--bbox", "10", "20", "50", "60", "--label", "2", "--prob", "0.8"],
        ["det", "add", "{d}/det", "0", "--bbox", "5", "5", "30", "30", "--label", "1"],
        ["det", "list", "{d}/det", "--frame", "3"], ["det", "remove", "{d}/det", "3", "0"],
        ["det", "remove", "{d}/det", "0", "5"], ["det", "list", "{d}/det", "--all"],
        ["gt", "add", "{d}/gt.npz", "--ellipsoid", *ell, "--label", "1"], ["gt", "list", "{d}/gt.npz"],
        ["gt", "remove", "{d}/gt.npz", "3"], ["gt", "remove", "{d}/gt.npz", "0"],
        ["gt", "from-map", "{d}/gt2.npz", "--map", "{d}/map.npz"], ["gt", "list", "{d}/gt2.npz"],
    ]
    outputs = {}
    for name, tool in (("jax", jlabel), ("port", tlabel)):
        d = tmp_path / name
        shutil.copytree(base, d)
        lines = []
        for cmd in script:
            try:
                tool.main([a.format(d=d) for a in cmd])
            except SystemExit as e:
                lines.append(f"exit: {e.code}")
            lines.append(capsys.readouterr().out.replace(str(d), "DIR"))
        outputs[name] = (lines, npz_contents(d))
    (ref_lines, ref_npz), (got_lines, got_npz) = outputs["jax"], outputs["port"]
    assert got_lines == ref_lines
    assert any("exit: index 5 out of range" in x for x in got_lines) and "seeded 2 objects" in "".join(got_lines)
    assert got_npz.keys() == ref_npz.keys()
    for f in ref_npz:
        assert got_npz[f].keys() == ref_npz[f].keys(), f
        for k in ref_npz[f]:
            assert got_npz[f][k].dtype == ref_npz[f][k].dtype, (f, k)
            np.testing.assert_array_equal(got_npz[f][k], ref_npz[f][k], err_msg=f"{f}:{k}")


# ---------------------------------------------------------------------------
# Helpers no system path calls
# ---------------------------------------------------------------------------

class TestHelpers:
    def test_distort_points(self, rng):
        intr = TrackingConfig().intr
        uv = rng.uniform([40, 40], [600, 440], size=(500, 2)).astype(np.float32)
        ref = np.asarray(jcam.distort_points(jnp.asarray(uv), JTrackingConfig().intr, FR1_DIST))
        got = tcam.distort_points(torch.from_numpy(uv), intr, FR1_DIST)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
        back = tcam.undistort_points(got, intr, FR1_DIST).numpy()
        assert np.abs(back - uv).max() < 1e-2
        assert np.abs(got.numpy() - uv).max() > 3.0  # the coefficients move the border pixels

    def test_projection_matrix_and_from_K(self, rng):
        K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
        ref_intr = jcam.Intrinsics.from_K(jnp.asarray(K))
        intr = tcam.Intrinsics.from_K(K)
        assert intr == tcam.Intrinsics.from_K(torch.from_numpy(K))
        assert tuple(intr) == tuple(float(np.float32(v)) for v in ref_intr)
        np.testing.assert_array_equal(tcam.intrinsic_matrix(intr).numpy(), K)
        T = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(x))) for x in rng.normal(size=(6, 6)).astype(np.float32)])
        ref = np.asarray(jcam.projection_matrix(jnp.asarray(T), ref_intr))
        got = tcam.projection_matrix(torch.from_numpy(T), intr)
        assert got.shape == (6, 3, 4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(tcam.projection_matrix(torch.from_numpy(T[0]), intr).numpy(), ref[0],
                                   rtol=1e-6, atol=1e-5)

    def test_edge_budget_for(self):
        for emax in (4096, 65536, 100000, 131072):
            for floor in (1024, 4096):
                for num_obs in (0, 1, 4095, 4096, 4097, 8192, 9000, 65535, 65536, 70000, 200000):
                    assert tlm.edge_budget_for(num_obs, emax, floor) == jlm.edge_budget_for(num_obs, emax, floor)

    def test_cull_points(self, rng):
        """On a JAX map with random edges, carried over to the port."""
        m = jmap.empty_map(8, 256, 2048)
        m = m._replace(ob_pt=jnp.asarray(rng.integers(0, 256, 2048), jnp.int32),
                       ob_valid=jnp.asarray(rng.uniform(size=2048) < 0.3),
                       pt_valid=jnp.asarray(rng.uniform(size=256) < 0.8),
                       pt_xyz=jnp.asarray(rng.normal(size=(256, 3)), jnp.float32))
        tm = map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}, device="cpu")
        for min_obs in (2, 3, 5):
            ref = jlm.cull_points(m, min_obs)
            got = tlm.cull_points(tm, min_obs)
            np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(ref.pt_valid))
            np.testing.assert_array_equal(got.pt_obs_count.numpy(), np.asarray(ref.pt_obs_count))
            assert 0 < int(got.pt_valid.sum()) < int(tm.pt_valid.sum())

    def test_object_frame_points(self, rng):
        xi = rng.normal(scale=0.4, size=(4, 7)).astype(np.float32)
        T = np.asarray(jlie.exp_sim3(jnp.asarray(xi)))
        pts = rng.normal(size=(4, 30, 3)).astype(np.float32)
        ref = np.asarray(jloss.object_frame_points(jnp.asarray(T), jnp.asarray(pts)))
        got = tloss.object_frame_points(torch.from_numpy(T), torch.from_numpy(pts))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)

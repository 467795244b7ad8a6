"""Parity of the port's dataset and persistence path with the JAX package:
the TUM reader, trajectory and map files, the YAML config, the fabricated
sequences, the TUM command line and checkpoints.

Tolerances: parsed frames and associations equal; the TUM trajectory round
trip 1e-6; config fields equal; both decoders read the port's PNGs to the
renderer's own pixels exactly; `run_tum` equals the port's `SlamSystem` fed
the same decoded frames exactly; a JAX checkpoint resumed in the port keeps
the next 3 camera centres within 1 cm of the JAX run resumed from it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.data import io as jio
from qsp_slam_tpu.data import tum as jtum
from qsp_slam_tpu_torch.convert import tracking_config_from_fields
from qsp_slam_tpu_torch.data import io as tio
from qsp_slam_tpu_torch.data import make_tum as tmake
from qsp_slam_tpu_torch.data import native_loader
from qsp_slam_tpu_torch.data import tum as ttum
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.eval.ate import positions_from_Tcw
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)


@pytest.fixture
def tum_dir(tmp_path, rng):
    """`tests/test_io_eval.py`'s tiny TUM-format sequence (PIL-written),
    plus one palette-coded RGB frame that the native decoder declines."""
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(4):
        t = 100.0 + i * 0.033
        img = Image.fromarray(rng.integers(0, 255, (24, 32), np.uint8), mode="L")
        (img.convert("P") if i == 2 else img).save(root / "rgb" / f"{i}.png")
        d = (rng.uniform(0.5, 3.0, (24, 32)) * 5000).astype(np.uint16)
        Image.fromarray(d, mode="I;16").save(root / "depth" / f"{i}.png")
        rgb_lines.append(f"{t:.6f} rgb/{i}.png")
        depth_lines.append(f"{t + 0.005:.6f} depth/{i}.png")
        gt_lines.append(f"{t:.6f} {0.1 * i} 0 0 0 0 0 1")
    gt_lines.append("100.2 0.5 0.1 -0.2 0.1 0.2 0.3 0.9")
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(depth_lines))
    (root / "groundtruth.txt").write_text("\n".join(gt_lines))
    return root


class TestTum:
    def test_parse_and_associate(self, tum_dir):
        got, ref = ttum.TumSequence(str(tum_dir)), jtum.TumSequence(str(tum_dir))
        assert got.rgb_list == ref.rgb_list and got.depth_list == ref.depth_list
        assert len(got) == len(ref) == 4
        for g, r in zip(got.frames, ref.frames):
            assert g[:3] == r[:3]
            np.testing.assert_array_equal(g[3], r[3])
        for (tg, Tg), (tr, Tr) in zip(got.gt, ref.gt):
            assert tg == tr
            np.testing.assert_allclose(Tg, Tr, atol=1e-7)
        for i in range(4):
            for g, r in zip(got.load(i), ref.load(i)):
                np.testing.assert_array_equal(g, r)
        assert got.decoded_by == {0: "native", 1: "native", 2: "pil", 3: "native"}

    def test_associate(self, rng):
        a = [(t, None) for t in np.sort(rng.uniform(0, 2, 40))]
        b = [(t, None) for t in np.sort(rng.uniform(0, 2, 35))]
        assert ttum.associate(a, b) == jtum.associate(a, b)

    def test_prefetch_iter_matches_load(self, tum_dir):
        seq = ttum.TumSequence(str(tum_dir))
        got = list(seq.prefetch_iter([0, 2, 3], threads=2, lookahead=1))
        assert [g[4] for g in got] == [0, 2, 3]
        for gray, depth, t, T_cw, i in got:
            for a, b in zip((gray, depth, t, T_cw), seq.load(i)):
                np.testing.assert_array_equal(a, b)


class TestFiles:
    def test_tum_trajectory_roundtrip(self, tmp_path, rng):
        Tcw = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.3, (5, 6)), jnp.float32)))
        ts = 100 + np.arange(5) * 0.1
        tio.save_trajectory_tum(str(tmp_path / "t.txt"), ts, Tcw)
        jio.save_trajectory_tum(str(tmp_path / "j.txt"), ts, Tcw)
        ts2, Tcw2 = tio.load_trajectory_tum(str(tmp_path / "t.txt"))
        np.testing.assert_allclose(ts2, ts, atol=1e-6)
        np.testing.assert_allclose(Tcw2, Tcw, atol=1e-6)
        for name in ("t.txt", "j.txt"):
            np.testing.assert_allclose(tio.load_trajectory_tum(str(tmp_path / name))[1],
                                       jio.load_trajectory_tum(str(tmp_path / name))[1], atol=1e-6)

    def test_kitti_format(self, tmp_path, rng):
        Tcw = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.3, (3, 6)), jnp.float32)))
        tio.save_trajectory_kitti(str(tmp_path / "t.txt"), Tcw)
        jio.save_trajectory_kitti(str(tmp_path / "j.txt"), Tcw)
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()

    def test_map_files(self, tmp_path):
        from qsp_slam_tpu.slam import map as jmap
        from qsp_slam_tpu_torch.convert import map_state_from_numpy

        m = jmap.empty_map(8, 64, 256)
        m, _ = jmap.add_keyframe(m, jnp.asarray(np.asarray(jlie.exp_se3(jnp.asarray([0.1, 0, 0.2, 0, 0.3, 0.0])))))
        m, _ = jmap.add_points(m, jnp.arange(12.0).reshape(4, 3), jnp.ones((4, 256), jnp.int8),
                               jnp.zeros(4, jnp.int32), jnp.zeros((4, 3)), jnp.asarray([1, 1, 0, 1], bool))
        tm = map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}, "cpu")
        tio.save_map(str(tmp_path / "t.npz"), tm)
        jio.save_map(str(tmp_path / "j.npz"), m)
        got, ref = tio.load_map(str(tmp_path / "t.npz")), jio.load_map(str(tmp_path / "j.npz"))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        tio.export_map_txt(str(tmp_path / "t"), tm)
        jio.export_map_txt(str(tmp_path / "j"), m)
        np.testing.assert_array_equal(np.loadtxt(tmp_path / "t" / "MapPoints.txt"),
                                      np.loadtxt(tmp_path / "j" / "MapPoints.txt"))
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "Cameras.txt"),
                                   np.loadtxt(tmp_path / "j" / "Cameras.txt"), atol=1e-6)
        # With an object table (empty here; tests/test_torch_objects.py
        # fills one): the reference's object keys and an empty object list.
        from qsp_slam_tpu.slam.objects import empty_objects as jempty
        from qsp_slam_tpu_torch.slam.objects import empty_objects as tempty

        tio.save_map(str(tmp_path / "to.npz"), tm, objects=tempty(4, device="cpu"))
        jio.save_map(str(tmp_path / "jo.npz"), m, objects=jempty(4))
        got, ref = tio.load_map(str(tmp_path / "to.npz")), jio.load_map(str(tmp_path / "jo.npz"))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        tio.export_map_txt(str(tmp_path / "to"), tm, objects=tempty(4, device="cpu"))
        assert (tmp_path / "to" / "MapObjects.txt").read_text() == ""

    def test_detection_cache(self, tmp_path, rng):
        det = {"bbox": rng.uniform(0, 600, (3, 4)).astype(np.float32), "label": np.array([0, 2, 1]),
               "prob": np.array([0.9, 0.5, 0.0], np.float32), "valid": np.array([True, True, False]),
               "mask": rng.random((3, 24, 37)) < 0.5}
        tio.save_detection_cache(str(tmp_path / "t.npz"), det)
        got, ref = tio.load_detection_cache(str(tmp_path / "t.npz")), jio.load_detection_cache(str(tmp_path / "t.npz"))
        for k in det:
            np.testing.assert_array_equal(got[k], det[k])
            np.testing.assert_array_equal(got[k], ref[k])

    def test_yaml_config(self, tmp_path):
        from qsp_slam_tpu.slam.config import tracking_config_from_yaml as jcfg
        from qsp_slam_tpu_torch.slam.config import tracking_config_from_yaml as tcfg

        y = tmp_path / "seq.yaml"
        y.write_text(
            "%YAML:1.0\n"
            "Camera.fx: 500.0\nCamera.fy: 501.0\nCamera.cx: 320.0\nCamera.cy: 240.0\n"
            "Camera.width: 640\nCamera.height: 480\nCamera.bf: 40.0\n"
            "Camera.k1: 0.26\nCamera.p2: 0.002\nThDepth: 40.0\nDepthMapFactor: 5000.0\n"
            "ORBextractor.nFeatures: 1500\nORBextractor.scaleFactor: 1.25\n"
            "ORBextractor.nLevels: 6\nORBextractor.iniThFAST: 18\nORBextractor.minThFAST: 6\n"
        )
        got = tcfg(str(y), min_track_inliers=25)
        ref = jcfg(str(y), min_track_inliers=25)
        assert got == tracking_config_from_fields(ref._asdict())
        assert got.orb.pyramid.num_levels == 6 and abs(got.baseline - 0.08) < 1e-12
        y.write_text("Camera.fx: 500.0\nBogus.key: 1\n")
        with pytest.warns(UserWarning, match="Bogus.key"):
            tcfg(str(y))


class TestMakeTum:
    @pytest.mark.parametrize("distort", [None, "0.05,-0.02,0.001,0.0005,0.0"])
    def test_pngs(self, tmp_path, distort):
        """Both decoders read the port's PNGs to the renderer's own pixels.
        Against the JAX `make_tum`'s PNGs at most 1 level differs, on at
        most 1e-4 of the pixels: the two f32 renders differ in the last
        bits of the ray products, which moves a few values across an
        integer before the truncation to uint8/uint16."""
        from qsp_slam_tpu.data import make_tum as jmake

        extra = ["--frames", "3"] + (["--distort", distort] if distort else [])
        tmake.main([str(tmp_path / "t"), *extra, "--cpu"])
        jmake.main([str(tmp_path / "j"), *extra, "--cpu"])
        seq = ttum.TumSequence(str(tmp_path / "t"))
        assert len(seq) == 3
        for sub in ("rgb", "depth"):
            names = sorted(os.listdir(tmp_path / "t" / sub))
            assert names == sorted(os.listdir(tmp_path / "j" / sub))
            for name in names:
                p = str(tmp_path / "t" / sub / name)
                pil = np.asarray(Image.open(p))
                assert pil.dtype == (np.uint8 if sub == "rgb" else np.uint16)
                np.testing.assert_array_equal(native_loader.load_png(p), pil.astype(np.float32))
                ref = np.asarray(Image.open(tmp_path / "j" / sub / name)).astype(np.int64)
                diff = np.abs(pil.astype(np.int64) - ref)
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (sub, name, diff.max(), (diff > 0).sum())
        if distort:
            assert (tmp_path / "t" / "calib.yaml").read_text() == (tmp_path / "j" / "calib.yaml").read_text()
        else:
            # Undistorted, the PNGs are the port renderer's frames truncated.
            cfg = TrackingConfig()
            g, d = render_frame(make_room(seed=1, device="cpu"), orbit_trajectory(3, 0.01, 0.35)[1], cfg.intr)
            gray, depth, _, T_cw = seq.load(1)
            np.testing.assert_array_equal(gray, torch.clamp(g, 0, 255).to(torch.uint8).float().numpy())
            d16 = torch.clamp(d * 5000.0, 0, 65535).to(torch.int32).numpy().astype(np.uint16)
            np.testing.assert_array_equal(depth, d16.astype(np.float32) * np.float32(1 / 5000.0))
            np.testing.assert_allclose(T_cw, orbit_trajectory(3, 0.01, 0.35)[1], atol=1e-5)

    def test_object_free_scene_is_the_seeded_room(self):
        from qsp_slam_tpu.data.render import make_scene

        for seed in (1, 4):
            ref = make_scene(num_objects=1, seed=seed).room
            got = make_room(seed=seed, device="cpu")
            np.testing.assert_array_equal(got.textures.numpy(), np.asarray(ref.textures))
            np.testing.assert_array_equal(got.normals.numpy(), np.asarray(ref.normals))

    def test_objects_wait_for_slice_6(self, tmp_path):
        """Fabricated objects and detections (tests/test_torch_objects.py
        holds them to the reference) feed `run_tum --detections`, which
        spawns objects from the first frame's depth; table scenes build."""
        tmake.main([str(tmp_path), "--frames", "1", "--cpu", "--objects", "2", "--detections"])
        assert (tmp_path / "detections" / "0.npz").exists()
        from qsp_slam_tpu_torch import run_tum
        from qsp_slam_tpu_torch.data.render import make_scene

        scene = make_scene(num_tables=1, device="cpu")
        assert scene.slabs.shape == (1, 5) and float(scene.ellipsoids[0, 1] + scene.ellipsoids[0, 7]) == \
            pytest.approx(float(scene.slabs[0, 1]), abs=1e-5)  # object 0 rests on the table
        (tmp_path / "c.yaml").write_text("ORBextractor.nFeatures: 500\n")
        out = run_tum.main([str(tmp_path), "--detections", str(tmp_path / "detections"), "--config",
                            str(tmp_path / "c.yaml"), "--save-dir", str(tmp_path / "out"), "--cpu"])
        assert out["frames"] == 0 and out["num_objects"] >= 1
        z = tio.load_map(str(tmp_path / "out" / "map.npz"))
        assert int(z["obj_valid"].sum()) == out["num_objects"]


class TestRunTum:
    def test_equals_the_system_in_memory(self, tmp_path):
        root = tmp_path / "seq"
        tmake.main([str(root), "--frames", "12", "--cpu"])
        (tmp_path / "c.yaml").write_text("ORBextractor.nFeatures: 500\n")
        from qsp_slam_tpu_torch import run_tum

        out = run_tum.main([str(root), "--config", str(tmp_path / "c.yaml"), "--save-dir",
                            str(tmp_path / "out"), "--cpu"])
        assert out["ate_rmse_m"] < 0.05
        assert out["decoded_by"] == {"native": 12}
        for key in ("frames", "keyframes", "track_fps", "num_points", "num_obs", "num_objects",
                    "loops_closed", "track_ms_median", "ba_ms_median", "ate_rmse_m",
                    "rpe_trans_rmse", "rpe_rot_rmse_deg", "pairs", "kf_ate_rmse_m"):
            assert key in out, key
        seq = ttum.TumSequence(str(root))
        sysm = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=500)), device="cpu")
        for i in range(len(seq)):
            gray, depth, _, _ = seq.load(i)
            sysm.track_rgbd(gray, depth)
        ts, Tcw = tio.load_trajectory_tum(str(tmp_path / "out" / "CameraTrajectory.txt"))
        np.testing.assert_allclose(Tcw, np.stack(sysm.trajectory), atol=1e-6)
        assert out["num_points"] == sysm.summary()["num_points"]
        assert out["keyframes"] == sysm.summary()["keyframes"]
        z = tio.load_map(str(tmp_path / "out" / "map.npz"))
        np.testing.assert_array_equal(z["pt_xyz"], sysm.map_state.pt_xyz.numpy())

    @pytest.mark.parametrize("flag", [["--detections", "d"], ["--mesh", "2"], ["--detector", "w.npz"],
                                      ["--save-frames", "f"]])
    def test_later_slices_refuse(self, flag):
        """Every flag of the later slices is taken: `--detections`,
        `--detector` and `--save-frames` go on to read the sequence, which
        fails here (`tests/test_torch_structures.py`,
        `tests/test_torch_detector2d.py` and `tests/test_torch_tools_cli.py`
        run them); `--mesh 2` runs the command as two ranks, each of which
        fails to read the sequence, which fails the command
        (`tests/test_torch_distributed_system.py` runs it)."""
        from qsp_slam_tpu_torch import run_tum

        if flag[0] == "--mesh":
            with pytest.raises(RuntimeError, match="rgb.txt"):
                run_tum.main(["unused", *flag, "--cpu"])
            return
        with pytest.raises(FileNotFoundError, match="rgb.txt"):
            run_tum.main(["unused", *flag, "--cpu"])


class TestCheckpoint:
    def test_jax_checkpoint_resumes_in_the_port(self, tmp_path):
        from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
        from qsp_slam_tpu.slam.checkpoint import load_checkpoint as jload
        from qsp_slam_tpu.slam.checkpoint import save_checkpoint as jsave
        from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem
        from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
        from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint, save_checkpoint

        cap = dict(kmax=16, nmax=2048, emax=16384, ba_window=6)
        jcfg = JTrackingConfig(orb=JOrbConfig(num_features=400))
        room = make_room(device="cpu")
        traj = orbit_trajectory(12)
        frames = [tuple(x.numpy() for x in render_frame(room, traj[i], TrackingConfig().intr)) for i in range(11)]
        ref = JSlamSystem(jcfg, enable_objects=False, enable_loop_closing=False, **cap)
        for f in frames[:8]:
            ref.track_rgbd(*f)
        ckpt = str(tmp_path / "state.npz")
        jsave(ckpt, ref)
        resumed = JSlamSystem(jcfg, enable_objects=False, enable_loop_closing=False, **cap)
        jload(ckpt, resumed)
        port = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=400)), device="cpu", kmax=2,
                          nmax=512, emax=1024, ba_window=6)
        load_checkpoint(ckpt, port)
        assert (port.kmax, port.nmax, port.emax) == (16, 2048, 16384)
        assert port.stats["frames"] == ref.stats["frames"] and port.initialized
        for f in frames[8:]:
            a, b = resumed.track_rgbd(*f), port.track_rgbd(*f)
            gap = np.linalg.norm(positions_from_Tcw(np.stack([a, b]).astype(np.float64))[0]
                                 - positions_from_Tcw(np.stack([a, b]).astype(np.float64))[1])
            assert gap < 0.01, gap
        # The port's own checkpoint resumes exactly.
        save_checkpoint(str(tmp_path / "port.npz"), port)
        again = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=400)), device="cpu", ba_window=6)
        load_checkpoint(str(tmp_path / "port.npz"), again)
        np.testing.assert_array_equal(again.Tcw, port.Tcw)
        for name in ("pt_xyz", "ob_valid", "num_pts"):
            assert torch.equal(getattr(again.map_state, name), getattr(port.map_state, name))
        assert torch.equal(again.loop_state.db.signatures, port.loop_state.db.signatures)

    def test_migrate_loop_state(self, rng):
        """An old-format place database (and no `loop.kf_octave`) is rebuilt
        from the snapshot descriptors with the JAX package's signature
        functions.  The JAX migration itself raises here: it zeroes the
        rows past the count in a read-only view of a JAX array (ROADMAP
        queue C)."""
        from qsp_slam_tpu.slam import place_recognition as jpr
        from qsp_slam_tpu.slam.checkpoint import _migrate_loop_state as jmigrate
        from qsp_slam_tpu_torch.slam.checkpoint import _migrate_loop_state

        desc = np.where(rng.random((4, 64, 256)) < 0.5, 1, -1).astype(np.int8)
        ok = rng.random((4, 64)) < 0.9
        old = {"loop.kf_desc": desc, "loop.kf_feat_ok": ok,
               "loop.db.signatures": rng.random((4, 512)).astype(np.float32),
               "loop.db.count": np.asarray(3, np.int32)}
        got = dict(old)
        _migrate_loop_state(got)
        sigs = np.stack([np.asarray(jpr.quantize_signature(jpr.bow_signature(jnp.asarray(d), jnp.asarray(o))))
                         for d, o in zip(desc, ok)])
        sigs[3:] = 0
        np.testing.assert_array_equal(got["loop.db.signatures"], sigs)
        np.testing.assert_array_equal(got["loop.db.df"], (sigs > 0).sum(0).astype(np.float32))
        np.testing.assert_array_equal(got["loop.kf_octave"], np.zeros((4, 64), np.int8))
        with pytest.raises(ValueError, match="read-only"):
            jmigrate(dict(old))

    def test_later_state_refuses(self, tmp_path):
        """Manhattan planes, relations and the fused ground plane's count
        resume (they refused before the RGB-D object path was ported)."""
        from qsp_slam_tpu_torch.perception.relations import Relations
        from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint, save_checkpoint

        port = SlamSystem(TrackingConfig(), device="cpu", kmax=2, nmax=64, emax=128)
        port.plane_set = port.plane_set._replace(valid=torch.tensor([False, True] + [False] * 6),
                                                 votes=torch.arange(8, dtype=torch.int32))
        port.relations = Relations(kind=torch.ones((32, 8), dtype=torch.int32), distance=torch.full((32, 8), 0.5))
        port._gp_count = 3
        p = str(tmp_path / "c.npz")
        save_checkpoint(p, port)
        back = SlamSystem(TrackingConfig(), device="cpu", kmax=2, nmax=64, emax=128)
        load_checkpoint(p, back)
        for a, b in zip(back.plane_set + back.relations, port.plane_set + port.relations):
            assert torch.equal(a, b)
        assert back._gp_count == 3

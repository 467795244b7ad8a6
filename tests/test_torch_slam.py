"""Parity of the PyTorch port's map, tracking and local mapping against the
JAX package, started from map states that the JAX package built and
carried across with `qsp_slam_tpu_torch.convert`.

Stated tolerances: integer, boolean and descriptor arrays of the map
exactly; poses atol 1e-4; point positions atol 1e-4 (1e-3 after local BA,
whose Schur solve sums in another order); everything a frame adds to the
map exactly.  The frame's features: xy, octave and validity exact,
per-keypoint Hamming <= 2, angle atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.slam import local_mapping as jlm
from qsp_slam_tpu.slam import loop_closing as jloop
from qsp_slam_tpu.slam import map as jmap
from qsp_slam_tpu.slam import tracking as jtr
from qsp_slam_tpu_torch import convert
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.frontend.matcher import pack_pm
from qsp_slam_tpu_torch.frontend.orb import Features
from qsp_slam_tpu_torch.slam import local_mapping as tlm
from qsp_slam_tpu_torch.slam import loop_closing as tloop
from qsp_slam_tpu_torch.slam import map as tmap
from qsp_slam_tpu_torch.slam import tracking as ttr
from qsp_slam_tpu_torch.slam.system import SlamSystem

torch.set_num_threads(1)

KMAX, NMAX, EMAX = 16, 2048, 16384
FLOAT_ATOL = {"kf_Tcw": 1e-4, "pt_xyz": 1e-4, "pt_normal": 1e-5, "ob_uv": 1e-4, "ob_ur": 1e-4}


def T(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def as_np(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def port_frame(jf) -> ttr.FrameData:
    return ttr.FrameData(
        feats=Features(**{k: T(v) for k, v in jf.feats._asdict().items()}),
        depth=T(jf.depth), u_right=T(jf.u_right),
    )


def port_track(jr) -> ttr.TrackResult:
    return ttr.TrackResult(**{k: T(v) for k, v in jr._asdict().items()})


def assert_map_equal(got: tmap.MapState, ref, atol=None):
    atol = dict(FLOAT_ATOL, **(atol or {}))
    for name in tmap.MapState._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        if name in atol:
            np.testing.assert_allclose(g, r, rtol=0, atol=atol[name], err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def _dummy_track(nmax):
    return jtr.TrackResult(
        Tcw=jnp.eye(4, dtype=jnp.float32), match_pt=jnp.full(nmax, -1, jnp.int32),
        match_inlier=jnp.zeros(nmax, bool), num_matches=jnp.int32(0), num_inliers=jnp.int32(0),
        pred_dev_t=jnp.float32(0), pred_dev_r=jnp.float32(0), tracked_close=jnp.int32(0),
        untracked_close=jnp.int32(0),
    )


@pytest.fixture(scope="module")
def world():
    """Frames 0 and 3 of the synthetic orbit, keyframe 0 built by the JAX
    package, frame 3 tracked against it and inserted as keyframe 1."""
    jcfg = jtr.TrackingConfig(orb=jtr.OrbConfig(num_features=500))
    cfg = convert.tracking_config_from_fields(jcfg._asdict())
    room = make_room(device="cpu")
    Tcw_gt = orbit_trajectory(4)
    frames = [tuple(x.numpy() for x in render_frame(room, Tcw_gt[i], cfg.intr)) for i in (0, 3)]
    jf0 = jtr.process_frame(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]), jcfg)
    m1 = jtr.keyframe_insertion(jmap.empty_map(KMAX, NMAX, EMAX), jnp.eye(4, dtype=jnp.float32),
                                jf0, _dummy_track(NMAX), jcfg)
    jf3 = jtr.process_frame(jnp.asarray(frames[1][0]), jnp.asarray(frames[1][1]), jcfg)
    pred = np.asarray(Tcw_gt[3]) @ np.asarray(
        [[1, 0, 0, 0.01], [0, 1, 0, -0.01], [0, 0, 1, 0.02], [0, 0, 0, 1]], np.float32)
    jr3 = jtr.track_frame(m1, jnp.asarray(pred), jf3, jcfg)
    m2 = jtr.keyframe_insertion(m1, jr3.Tcw, jf3, jr3, jcfg)
    return dict(jcfg=jcfg, cfg=cfg, frames=frames, jf0=jf0, jf3=jf3, m1=m1, jr3=jr3, m2=m2,
                pred=pred)


class TestConvert:
    def test_config_and_map_round_trip(self, world):
        cfg = world["cfg"]
        assert cfg.orb.num_features == 500
        assert cfg.intr == tuple(float(v) for v in world["jcfg"].intr)
        m = convert.map_state_from_numpy(as_np(world["m1"]), device="cpu")
        assert_map_equal(m, world["m1"], atol={k: 0 for k in FLOAT_ATOL})
        assert int(m.num_pts) > 200

    def test_loop_state_and_snapshot(self, world):
        jf0, cfg = world["jf0"], world["cfg"]
        from qsp_slam_tpu.core.camera import backproject

        pts = backproject(jf0.feats.xy, jf0.depth, world["jcfg"].intr)
        jls = jloop.snapshot_keyframe(jloop.empty_loop_state(KMAX), jf0.feats.desc_pm, jf0.feats.valid,
                                      pts, jf0.depth > 0.0, jf0.feats.xy, jf0.feats.octave)
        f = port_frame(jf0)
        from qsp_slam_tpu_torch.core.camera import backproject as tbackproject

        tls = tloop.snapshot_keyframe(
            tloop.empty_loop_state(KMAX, device="cpu"), f.feats.desc_pm, f.feats.valid,
            tbackproject(f.feats.xy, f.depth, cfg.intr), f.depth > 0.0, f.feats.xy, f.feats.octave,
        )
        carried = convert.loop_state_from_numpy(
            {k: (v._asdict() if k == "db" else np.asarray(v)) for k, v in jls._asdict().items()},
            device="cpu",
        )
        for name in tloop.LoopState._fields:
            g, c, r = getattr(tls, name), getattr(carried, name), getattr(jls, name)
            pairs = zip(g, c, r) if name == "db" else [(g, c, r)]
            for gi, ci, ri in pairs:
                ri = np.asarray(ri)
                tol = 1e-5 if ri.dtype == np.float32 else 0
                np.testing.assert_allclose(gi.numpy(), ri, rtol=0, atol=tol, err_msg=name)
                np.testing.assert_array_equal(ci.numpy(), ri, err_msg=name)
        assert int(tls.db.count) == 1
        grown = tloop.grow_loop_state(tls, 2 * KMAX)
        assert grown.kf_desc.shape[0] == 2 * KMAX and int(grown.db.count) == 1
        assert torch.equal(grown.kf_desc[:KMAX], tls.kf_desc)


class TestTracking:
    def test_process_frame(self, world):
        """The RGB-D frame constructor and, inside it, `extract_features`:
        xy, octave and validity exact, per-keypoint Hamming <= 2 between
        the two descriptors, angle atol 1e-3."""
        g, d = world["frames"][1]
        got = ttr.process_frame(torch.from_numpy(g), torch.from_numpy(d), world["cfg"])
        ref = world["jf3"]
        gf, rf = got.feats, ref.feats
        np.testing.assert_array_equal(gf.xy.numpy(), np.asarray(rf.xy))
        np.testing.assert_array_equal(gf.octave.numpy(), np.asarray(rf.octave))
        np.testing.assert_array_equal(gf.valid.numpy(), np.asarray(rf.valid))
        valid = gf.valid.numpy()
        assert valid.sum() > 400
        xor = np.ascontiguousarray(gf.desc_bits.numpy() ^ np.asarray(rf.desc_bits).view(np.int32))
        ham = np.unpackbits(xor.view(np.uint8), axis=1).sum(axis=1)
        assert ham[valid].max() <= 2, ham[valid].max()
        np.testing.assert_allclose(gf.angle.numpy()[valid], np.asarray(rf.angle)[valid], atol=1e-3)
        # The two descriptor forms agree (bit j of word w = bit 32w + j).
        assert torch.equal(pack_pm(gf.desc_pm), gf.desc_bits)
        np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=1e-6)
        np.testing.assert_allclose(got.u_right.numpy(), np.asarray(ref.u_right), atol=1e-4)

    def test_decode_inputs_png_units(self):
        cfg = ttr.TrackingConfig(depth_png_scale=5000.0)
        g, d = ttr.decode_inputs(torch.zeros(2, 2, dtype=torch.uint8),
                                 torch.full((2, 2), 10000, dtype=torch.uint16), cfg)
        assert g.dtype == torch.float32 and torch.all(d == 2.0)

    def test_track_frame(self, world):
        m = convert.map_state_from_numpy(as_np(world["m1"]), device="cpu")
        got = ttr.track_frame(m, T(world["pred"]), port_frame(world["jf3"]), world["cfg"])
        ref = world["jr3"]
        np.testing.assert_array_equal(got.match_pt.numpy(), np.asarray(ref.match_pt))
        np.testing.assert_array_equal(got.match_inlier.numpy(), np.asarray(ref.match_inlier))
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
        for k in ("num_matches", "num_inliers", "tracked_close", "untracked_close"):
            assert int(getattr(got, k)) == int(getattr(ref, k)), k
        assert int(got.num_inliers) > 100

    def test_track_frame_local_map_budget(self, world):
        jcfg = world["jcfg"]._replace(local_map_budget=600)
        cfg = world["cfg"]._replace(local_map_budget=600)
        ref = jtr.track_frame(world["m1"], jnp.asarray(world["pred"]), world["jf3"], jcfg)
        m = convert.map_state_from_numpy(as_np(world["m1"]), device="cpu")
        got = ttr.track_frame(m, T(world["pred"]), port_frame(world["jf3"]), cfg)
        np.testing.assert_array_equal(got.match_pt.numpy(), np.asarray(ref.match_pt))
        np.testing.assert_array_equal(got.match_inlier.numpy(), np.asarray(ref.match_inlier))
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)

    def test_keyframe_insertion(self, world):
        m = convert.map_state_from_numpy(as_np(world["m1"]), device="cpu")
        jr3 = world["jr3"]
        got = ttr.keyframe_insertion(m, T(jr3.Tcw), port_frame(world["jf3"]), port_track(jr3),
                                     world["cfg"])
        assert_map_equal(got, world["m2"])
        assert int(got.num_kfs) == 2 and int(got.num_obs) > int(m.num_obs)

    def test_need_keyframe(self):
        jcfg, cfg = jtr.TrackingConfig(), ttr.TrackingConfig()
        for args in ((1, 300, 300, 0, 0), (3, 200, 300, 150, 10), (5, 100, 400, 200, 10),
                     (30, 400, 400, 200, 0), (4, 300, 300, 50, 90)):
            f, n, last, tc, uc = args
            assert ttr.need_keyframe(f, n, last, cfg, tc, uc) == jtr.need_keyframe(f, n, last, jcfg, tc, uc)


class TestDuplicateScatterQuirks:
    """The JAX package's `.at[idx].set(src)` with duplicate indices keeps
    the last row in index order on XLA:CPU.  Two writes of its keyframe
    insertion depend on that (faults of the reference, kept by the port)."""

    def test_last_row_wins(self):
        idx = np.array([0, 3, 0, 0, 1, 0])
        src = np.array([False, True, True, False, True, False])
        ref = np.asarray(jnp.zeros(5, bool).at[idx].set(src))
        got = tmap.scatter_set_last(torch.zeros(5, dtype=torch.bool), T(idx), T(src))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert not ref[0]
        rows = np.arange(12, dtype=np.float32).reshape(6, 2)
        ref2 = np.asarray(jnp.zeros((5, 2)).at[idx].set(rows))
        got2 = tmap.scatter_set_last(torch.zeros(5, 2), T(idx), T(rows))
        np.testing.assert_array_equal(got2.numpy(), ref2)

    def _insert(self, world, match_pt, match_inlier):
        jr = world["jr3"]._replace(match_pt=jnp.asarray(match_pt), match_inlier=jnp.asarray(match_inlier))
        ref = jtr.keyframe_insertion(world["m1"], jr.Tcw, world["jf3"], jr, world["jcfg"])
        m = convert.map_state_from_numpy(as_np(world["m1"]), device="cpu")
        got = ttr.keyframe_insertion(m, T(jr.Tcw), port_frame(world["jf3"]), port_track(jr), world["cfg"])
        assert_map_equal(got, ref)
        return got

    def test_feature_zero_always_counts_unmatched(self, world):
        """Map point 5 is an inlier match of feature 0, yet every unmatched
        map row also writes False into feature 0 after it: feature 0 also
        becomes a new map point."""
        f = world["jf3"]
        assert float(f.depth[0]) > 0 and bool(f.feats.valid[0])
        match_pt = np.full(NMAX, -1, np.int32)
        inlier = np.zeros(NMAX, bool)
        match_pt[5], inlier[5] = 0, True
        m1 = world["m1"]
        got = self._insert(world, match_pt, inlier)
        n0 = int(m1.num_pts)
        new_xyz = got.pt_xyz[n0:int(got.num_pts)].numpy()
        from qsp_slam_tpu_torch.core.camera import backproject
        from qsp_slam_tpu_torch.core.lie import inv_se3, transform_points

        p0 = transform_points(inv_se3(T(world["jr3"].Tcw)),
                              backproject(T(f.feats.xy[:1]), T(f.depth[:1]), world["cfg"].intr))
        assert np.abs(new_xyz - p0.numpy()).max(axis=1).min() < 1e-5

    def test_point_zero_vote_overwritten(self, world):
        """Point 0 is an inlier, but every non-inlier map row writes point
        0's old accumulator back after it: its vote is lost."""
        m1 = world["m1"]
        match_pt = np.full(NMAX, -1, np.int32)
        inlier = np.zeros(NMAX, bool)
        match_pt[0], inlier[0] = 7, True
        match_pt[9], inlier[9] = 8, True
        got = self._insert(world, match_pt, inlier)
        np.testing.assert_array_equal(got.pt_desc_acc[0].numpy(), np.asarray(m1.pt_desc_acc[0]))
        # Point 9's vote, with no later duplicate, lands.
        assert not np.array_equal(got.pt_desc_acc[9].numpy(), np.asarray(m1.pt_desc_acc[9]))


class TestMapOps:
    def test_compact_and_grow(self, world, rng):
        m2 = world["m2"]
        kill = rng.random(NMAX) < 0.3
        jm = m2._replace(pt_valid=m2.pt_valid & ~jnp.asarray(kill))
        tm = convert.map_state_from_numpy(as_np(jm), device="cpu")
        assert_map_equal(tmap.compact_edges(tm), jmap.compact_edges(jm))
        assert_map_equal(tmap.compact_points(tm), jmap.compact_points(jm))
        assert_map_equal(tmap.grow_map(tm, kmax=32, emax=2 * EMAX),
                         jmap.grow_map(jm, kmax=32, emax=2 * EMAX))

    def test_add_points_overflow(self, rng):
        P = 12
        xyz = rng.normal(size=(P, 3)).astype(np.float32)
        desc = rng.choice(np.int8([-1, 1]), size=(P, 256))
        octave = rng.integers(0, 8, P).astype(np.int32)
        normal = rng.normal(size=(P, 3)).astype(np.float32)
        valid = rng.random(P) < 0.7
        jm, jids = jmap.add_points(jmap.empty_map(4, 6, 16), jnp.asarray(xyz), jnp.asarray(desc),
                                   jnp.asarray(octave), jnp.asarray(normal), jnp.asarray(valid))
        tm, tids = tmap.add_points(tmap.empty_map(4, 6, 16, device="cpu"), T(xyz), T(desc), T(octave),
                                   T(normal), T(valid))
        assert_map_equal(tm, jm)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


class TestLocalMapping:
    def test_local_ba_step(self, world):
        jcfg, cfg = world["jcfg"], world["cfg"]
        budget = jlm.window_edge_budget(6, jcfg, EMAX)
        assert tlm.window_edge_budget(6, cfg, EMAX) == budget
        ref = jlm.local_ba_step(world["m2"], jcfg, 6, budget)
        m = convert.map_state_from_numpy(as_np(world["m2"]), device="cpu")
        got = tlm.local_ba_step(m, cfg, 6, budget)
        assert_map_equal(got, ref, atol={"pt_xyz": 1e-3})
        # Keyframe 0 is anchored; keyframe 1 moved.
        np.testing.assert_array_equal(got.kf_Tcw[0].numpy(), np.asarray(world["m2"].kf_Tcw[0]))

    def test_fuse_map_points(self, world):
        m2 = world["m2"]
        # Plant duplicates: copies of early points re-added as new points.
        jm = m2._replace(pt_xyz=m2.pt_xyz.at[600:640].set(m2.pt_xyz[100:140] + 1e-3),
                         pt_desc=m2.pt_desc.at[600:640].set(m2.pt_desc[100:140]))
        ref = jlm.fuse_map_points(jm)
        got = tlm.fuse_map_points(convert.map_state_from_numpy(as_np(jm), device="cpu"))
        assert_map_equal(got, ref)

    def test_cull_keyframes(self, rng):
        E = 4000
        jm = jmap.empty_map(12, 256, E)
        jm = jm._replace(
            kf_valid=jnp.ones(12, bool), num_kfs=jnp.int32(10),
            ob_kf=jnp.asarray(rng.integers(0, 10, E).astype(np.int32)),
            ob_pt=jnp.asarray(rng.integers(0, 256, E).astype(np.int32)),
            ob_valid=jnp.asarray(rng.random(E) < 0.95), num_obs=jnp.int32(E),
        )
        ref = jlm.cull_keyframes(jm)
        got = tlm.cull_keyframes(convert.map_state_from_numpy(as_np(jm), device="cpu"))
        assert_map_equal(got, ref)
        assert int(got.kf_valid.sum()) == 11  # one keyframe went


class TestSystemScope:
    @pytest.mark.parametrize("kw", [dict(mesh=object())])
    def test_later_slices_raise(self, kw):
        """The mesh is a system field now (slice 9): anything but a
        `parallel.mesh.Mesh` raises (`tests/test_torch_distributed_system.py`
        drives real meshes)."""
        with pytest.raises(TypeError, match="mesh"):
            SlamSystem(ttr.TrackingConfig(), kmax=4, nmax=64, emax=256, device="cpu", **kw)

    def test_detector_is_taken(self):
        """The learned detector (slice 8) is a system field now: its params
        land on the system's device (`tests/test_torch_detector2d.py`
        drives detect-online)."""
        from qsp_slam_tpu_torch.perception.detector2d import DetectorConfig, init_detector

        cfg = DetectorConfig(widths=(4, 4, 4))
        sysm = SlamSystem(ttr.TrackingConfig(), kmax=4, nmax=64, emax=256, device="cpu",
                          detector=(init_detector(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg))
        assert sysm.detector[1] == cfg and all(v.device.type == "cpu" for v in sysm.detector[0].values())

    def test_loop_closing_flag_builds_a_looping_system(self, world):
        """`enable_loop_closing=True` (the default, as in the reference)
        builds a system that runs loop closing: from keyframe 12 on every
        keyframe queries the place database and logs a scan row; with the
        flag off it only snapshots."""
        f = port_frame(world["jf3"])
        rows = {}
        for on in (True, False):
            sysm = SlamSystem(world["cfg"], kmax=16, nmax=64, emax=256, device="cpu", enable_loop_closing=on)
            assert sysm.enable_loop_closing is on and sysm.summary()["loops_closed"] == 0
            for kf in range(14):
                sysm._loop_closing(f, kf)
            assert int(sysm.loop_state.db.count) == 14
            rows[on] = [r[0] for r in sysm.stats.get("loop_scan", [])]
        assert rows == {True: [12, 13], False: []}

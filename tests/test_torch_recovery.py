"""Parity of the port's recovery path with the JAX package, and the JAX
recovery tests' assertions on the port alone.

Same numpy inputs (seeded, or one rendered frame's port features handed to
both packages) go through the JAX function and the port's on the CPU.
Tolerances: quaternions 1e-6; word ids, word masks and mutual matches
exact; place scores rtol 1e-5, top-k ids as sets where the score gaps
exceed that and in order on ties; RANSAC on the indices `jax.random.choice`
draws (fed to the port through `draw`): pose within 1e-3 m and 1e-3 rad,
equal inlier count, equal `ok`; RPE 1e-9.  The system tests run 500
features, as the JAX tests do.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.eval import ate as jate
from qsp_slam_tpu.frontend import matcher as jmatcher
from qsp_slam_tpu.frontend import pnp as jpnp
from qsp_slam_tpu.frontend.orb import Features as JFeatures
from qsp_slam_tpu.slam import loop_closing as jloop
from qsp_slam_tpu.slam import place_recognition as jpr
from qsp_slam_tpu.slam import relocalization as jreloc
from qsp_slam_tpu.slam.tracking import FrameData as JFrameData
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.core.camera import backproject
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.eval import ate as tate
from qsp_slam_tpu_torch.frontend import matcher as tmatcher
from qsp_slam_tpu_torch.frontend import pnp as tpnp
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.slam import loop_closing as tloop
from qsp_slam_tpu_torch.slam import place_recognition as tpr
from qsp_slam_tpu_torch.slam import relocalization as treloc
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig, process_frame

torch.set_num_threads(1)

CFG = TrackingConfig(orb=OrbConfig(num_features=500))
JINTR = JIntrinsics(*(jnp.float32(v) for v in CFG.intr))
TRAJ = orbit_trajectory(30)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def room():
    return make_room(device="cpu")


@pytest.fixture(scope="module")
def frames(room):
    """Port features of rendered frames 0, 3, 4, 6, 12 and 13."""
    return {i: process_frame(*render_frame(room, TRAJ[i], CFG.intr), CFG) for i in (0, 3, 4, 6, 12, 13)}


def jax_frame(f):
    """The same frame as a JAX FrameData (bits as uint32, as the JAX
    extractor stores them)."""
    ft = f.feats
    feats = JFeatures(
        xy=jnp.asarray(ft.xy.numpy()), response=jnp.asarray(ft.response.numpy()),
        angle=jnp.asarray(ft.angle.numpy()), octave=jnp.asarray(ft.octave.numpy()),
        desc_bits=jnp.asarray(ft.desc_bits.numpy().view(np.uint32)),
        desc_pm=jnp.asarray(ft.desc_pm.numpy()), valid=jnp.asarray(ft.valid.numpy()),
    )
    return JFrameData(feats=feats, depth=jnp.asarray(f.depth.numpy()), u_right=jnp.asarray(f.u_right.numpy()))


def snap_both(lss, f, scramble=False):
    """Snapshot one frame into a (JAX, port) pair of loop states, from the
    same numpy arrays; `scramble` permutes the 3D points (a decoy with the
    right appearance and the wrong geometry)."""
    pts = backproject(f.feats.xy, f.depth, CFG.intr).numpy()
    if scramble:
        pts = pts[np.random.default_rng(0).permutation(pts.shape[0])]
    args = (f.feats.desc_pm.numpy(), f.feats.valid.numpy(), pts, (f.depth > 0).numpy(), f.feats.xy.numpy())
    jls, tls = lss
    return (jloop.snapshot_keyframe(jls, *(jnp.asarray(a) for a in args)),
            tloop.snapshot_keyframe(tls, *(T(a) for a in args)))


def jax_draw(keys):
    """A `draw` for the port that returns what `jax.random.choice` draws
    inside the JAX `pnp_ransac` from each of `keys` (one per problem)."""
    def draw(valid, gen, num_hyp):
        lead = valid.shape[:-1]
        v = valid.reshape(-1, valid.shape[-1]).numpy()
        i6, i4 = [], []
        for key, row in zip(keys, v):
            M = row.shape[0]
            p = jnp.asarray(row).astype(jnp.float32)
            p = p / jnp.maximum(jnp.sum(p), 1.0)
            k1, k2 = jax.random.split(key)
            i6.append(np.asarray(jax.random.choice(k1, M, shape=(num_hyp // 2, 6), p=p)))
            i4.append(np.asarray(jax.random.choice(k2, M, shape=(num_hyp - num_hyp // 2, 4), p=p)))
        n6, n4 = num_hyp // 2, num_hyp - num_hyp // 2
        return T(np.stack(i6)).reshape(lead + (n6, 6)), T(np.stack(i4)).reshape(lead + (n4, 4))
    return draw


def assert_same_pose(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    c_got = -got[:3, :3].T @ got[:3, 3]
    c_ref = -ref[:3, :3].T @ ref[:3, 3]
    assert np.linalg.norm(c_got - c_ref) < 1e-3, (what, c_got, c_ref)
    cos = np.clip((np.trace(got[:3, :3].T @ ref[:3, :3]) - 1) / 2, -1, 1)
    assert np.arccos(cos) < 1e-3, (what, np.arccos(cos))


def assert_same_pnp(got, ref, what=""):
    assert bool(got.ok) == bool(ref.ok), what
    assert int(got.num_inliers) == int(ref.num_inliers), (what, int(got.num_inliers), int(ref.num_inliers))
    if bool(ref.ok):
        assert_same_pose(got.Tcw.numpy(), ref.Tcw, what)


class TestQuaternions:
    def test_quat_to_rotmat(self, rng):
        q = rng.normal(size=(64, 4)).astype(np.float32)
        q[:8, 3] = -np.abs(q[:8, 3])  # w < 0
        np.testing.assert_allclose(tlie.quat_to_rotmat(T(q)).numpy(),
                                   np.asarray(jlie.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)

    @pytest.mark.parametrize("branch", ["w", "x", "y", "z", "random"])
    def test_rotmat_to_quat(self, rng, branch):
        """Each Shepperd candidate wins somewhere: near identity (w), and
        near a half turn about x, y or z; quaternions with w < 0 come back
        with w >= 0."""
        if branch == "random":
            q = rng.normal(size=(64, 4)).astype(np.float32)
            q[:16, 3] = -np.abs(q[:16, 3])
        else:
            base = np.array({"w": [0.3, -0.5, 0.8], "x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[branch], np.float64)
            base /= np.linalg.norm(base)
            ang = 0.3 if branch == "w" else np.pi - 0.2
            jitter = rng.normal(0, 0.05, (16, 3))
            ax = base + jitter
            ax /= np.linalg.norm(ax, axis=1, keepdims=True)
            q = np.concatenate([ax * np.sin(ang / 2), np.full((16, 1), np.cos(ang / 2))], 1).astype(np.float32)
            q[::2] *= -1  # w < 0 half the time
        R = np.asarray(jlie.quat_to_rotmat(jnp.asarray(q)))
        got = tlie.rotmat_to_quat(T(R)).numpy()
        ref = np.asarray(jlie.rotmat_to_quat(jnp.asarray(R)))
        np.testing.assert_allclose(got, ref, atol=1e-6)
        assert (got[:, 3] >= 0).all()
        np.testing.assert_allclose(tlie.quat_to_rotmat(T(got)).numpy(), R, atol=1e-6)


class TestMatching:
    def test_quantize_words(self, frames):
        for f in frames.values():
            got = tpr.quantize_words(f.feats.desc_pm).numpy()
            ref = np.asarray(jpr.quantize_words(jnp.asarray(f.feats.desc_pm.numpy())))
            np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("gated", [False, True])
    def test_mutual_match_and_word_mask(self, frames, gated):
        a, b = frames[3], frames[4]
        wa, wb = tpr.quantize_words(a.feats.desc_pm), tpr.quantize_words(b.feats.desc_pm)
        wm = tmatcher.word_mask(wa, wb)
        jwm = jmatcher.word_mask(jnp.asarray(wa.numpy()), jnp.asarray(wb.numpy()))
        np.testing.assert_array_equal(wm.numpy(), np.asarray(jwm))
        valid_b = b.feats.valid & (b.depth > 0)
        dist = tmatcher.hamming_matrix(a.feats.desc_bits, b.feats.desc_bits)
        got = tmatcher.mutual_match(dist, a.feats.valid, valid_b, ratio=0.85,
                                    pair_mask=wm if gated else None)
        ref = jmatcher.mutual_match(
            jnp.asarray(a.feats.desc_pm.numpy()), jnp.asarray(a.feats.valid.numpy()),
            jnp.asarray(b.feats.desc_pm.numpy()), jnp.asarray(valid_b.numpy()),
            ratio=0.85, pair_mask=jwm if gated else None,
        )
        assert int(ref.valid.sum()) > 50
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


class TestPlaceQueries:
    @pytest.fixture(scope="class")
    def dbs(self, frames):
        jdb, tdb = jpr.empty_database(8), tpr.empty_database(8, "cpu")
        # Frame 12 twice: two keyframes with equal scores (a tie).
        for i in (0, 3, 6, 12, 12, 13):
            f = frames[i]
            sig = tpr.bow_signature(f.feats.desc_pm, f.feats.valid)
            jdb = jpr.add_signature(jdb, jnp.asarray(sig.numpy()))
            tdb = tpr.add_signature(tdb, sig)
        return jdb, tdb

    def test_scores_and_queries(self, frames, dbs):
        jdb, tdb = dbs
        for q in (4, 12):
            f = frames[q]
            sig = tpr.bow_signature(f.feats.desc_pm, f.feats.valid)
            jsig = jnp.asarray(sig.numpy())
            got_s = tpr._idf_scores(tdb, sig).numpy()
            ref_s = np.asarray(jpr._idf_scores(jdb, jsig))
            np.testing.assert_allclose(got_s, ref_s, rtol=1e-5, atol=1e-7)
            for ex in (0, 2):
                b, s = tpr.query(tdb, sig, exclude_recent=ex)
                jb, js = jpr.query(jdb, jsig, exclude_recent=ex)
                assert int(b) == int(jb)
                np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
                got = tpr.query_topk(tdb, sig, k=4, exclude_recent=ex)
                ref = jpr.query_topk(jdb, jsig, k=4, exclude_recent=ex)
                self._same_topk(got, ref, got_s)
                got = tpr.query_topk_with_ref(tdb, sig, k=4, exclude_recent=ex, ref_window=3)
                ref = jpr.query_topk_with_ref(jdb, jsig, k=4, exclude_recent=ex, ref_window=3)
                self._same_topk(got[:2], ref[:2], got_s)
                np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)

    @staticmethod
    def _same_topk(got, ref, scores):
        ids, s = got[0].numpy(), got[1].numpy()
        rids, rs = np.asarray(ref[0]), np.asarray(ref[1])
        np.testing.assert_allclose(s, rs, rtol=1e-5)
        # Ties (the duplicated keyframe) in order; other ids as sets of the
        # slots whose score gaps exceed the tolerance.
        tie = np.isclose(s[:, None], s[None, :], rtol=1e-5) & ~np.eye(len(s), dtype=bool)
        if tie.any():
            np.testing.assert_array_equal(ids, rids)
        assert set(ids.tolist()) == set(rids.tolist())

    def test_tie_goes_to_lower_index(self, frames, dbs):
        _, tdb = dbs
        f = frames[12]
        ids, s = tpr.query_topk(tdb, tpr.bow_signature(f.feats.desc_pm, f.feats.valid), k=2, exclude_recent=0)
        assert ids.tolist() == [3, 4] and float(s[0]) == float(s[1])


class TestPnP:
    def _problem(self, rng, M=150, garbage=False):
        if garbage:
            pts = rng.normal(size=(M, 3)).astype(np.float32)
            uv = rng.uniform(0, 640, (M, 2)).astype(np.float32)
            return pts, uv
        pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (M, 3)).astype(np.float32)
        T_gt = np.asarray(jlie.exp_se3(jnp.asarray([0.3, -0.1, 0.2, 0.1, 0.25, -0.05])))
        pc = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
        uv = np.stack([CFG.intr.fx * pc[:, 0] / pc[:, 2] + CFG.intr.cx,
                       CFG.intr.fy * pc[:, 1] / pc[:, 2] + CFG.intr.cy], 1)
        uv = uv + rng.normal(0, 0.5, (M, 2))
        out = rng.random(M) < 0.3
        uv[out] += rng.uniform(20, 100, (out.sum(), 2))
        return pts, uv.astype(np.float32)

    @pytest.mark.parametrize("case", ["outliers", "garbage", "hint"])
    def test_on_jax_draws(self, rng, case):
        pts, uv = self._problem(rng, garbage=case == "garbage")
        valid = np.ones(len(pts), bool)
        valid[::9] = False
        key = jax.random.PRNGKey({"outliers": 0, "garbage": 1, "hint": 3}[case])
        kw, jkw = {}, {}
        if case == "hint":
            hint = np.array([0.2, -0.1, -0.3], np.float32)
            kw = dict(center_hint=T(hint), max_center_dist=3.0)
            jkw = dict(center_hint=jnp.asarray(hint), max_center_dist=3.0)
        ref = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), JINTR, key, **jkw)
        got = tpnp.pnp_ransac(T(pts), T(uv), T(valid), CFG.intr, None, draw=jax_draw([key]), **kw)
        assert_same_pnp(got, ref, case)
        assert bool(ref.ok) == (case != "garbage")

    def test_hypotheses_on_well_conditioned_samples(self, rng):
        """Per hypothesis: the 6-point DLT pose equals the reference's
        wherever both LAPACKs return the same null vector (its sign is not
        canonicalised by the reference, see ROADMAP queue C), and the planar
        pose on coplanar samples equals it outright."""
        pts, uv = self._problem(rng)
        xn = np.stack([(uv[:, 0] - CFG.intr.cx) / CFG.intr.fx, (uv[:, 1] - CFG.intr.cy) / CFG.intr.fy], 1)
        same_sign = 0
        for _ in range(24):
            i = rng.choice(len(pts), 6, replace=False)
            X, x = pts[i], xn[i].astype(np.float32)
            got = tpnp._dlt_pose(T(X), T(x)).numpy()
            ref = np.asarray(jpnp._dlt_pose(jnp.asarray(X), jnp.asarray(x)))
            Xh = np.concatenate([X, np.ones((6, 1), np.float32)], 1)
            z = np.zeros_like(Xh)
            A = np.concatenate([np.concatenate([Xh, z, -x[:, :1] * Xh], 1),
                                np.concatenate([z, Xh, -x[:, 1:] * Xh], 1)])
            v_t = torch.linalg.svd(T(A)).Vh[-1].numpy()
            v_j = np.asarray(jnp.linalg.svd(jnp.asarray(A))[2])[-1]
            if np.dot(v_t, v_j) > 0:
                same_sign += 1
                np.testing.assert_allclose(got, ref, atol=1e-3)
        assert same_sign >= 4
        for _ in range(8):
            X = np.concatenate([rng.uniform(-1, 1, (4, 2)), np.full((4, 1), 4.0)], 1).astype(np.float32)
            x = (X[:, :2] + rng.normal(0, 1e-3, (4, 2))) / 4.3
            x = x.astype(np.float32)
            np.testing.assert_allclose(tpnp._planar_pose(T(X), T(x)).numpy(),
                                       np.asarray(jpnp._planar_pose(jnp.asarray(X), jnp.asarray(x))),
                                       atol=1e-3)

    def test_planar_pose_can_be_a_reflection(self, rng):
        """A fault of the reference that the port keeps (ROADMAP queue C):
        the plane frame's sign is not fixed, so on a wall seen almost head
        on the planar pose comes back with det(R) = -1 in both packages,
        while it still reprojects the wall's points."""
        X = np.concatenate([rng.uniform(-1, 1, (4, 2)), np.full((4, 1), 4.0)], 1).astype(np.float32)
        x = (X[:, :2] / 4.0).astype(np.float32)
        got = tpnp._planar_pose(T(X), T(x)).numpy()
        ref = np.asarray(jpnp._planar_pose(jnp.asarray(X), jnp.asarray(x)))
        assert np.linalg.det(got[:3, :3]) < -0.99 and np.linalg.det(ref[:3, :3]) < -0.99
        pc = X @ got[:3, :3].T + got[:3, 3]
        np.testing.assert_allclose(pc[:, :2] / pc[:, 2:], x, atol=1e-5)

    def test_sample_draws_valid_rows(self):
        valid = torch.zeros(2, 50, dtype=torch.bool)
        valid[0, 10:20] = True
        i6, i4 = tpnp.pnp_sample(valid, torch.Generator().manual_seed(0), 256)
        assert i6.shape == (2, 128, 6) and i4.shape == (2, 128, 4)
        assert ((i6[0] >= 10) & (i6[0] < 20)).all() and ((i4[0] >= 10) & (i4[0] < 20)).all()


class TestRelocalization:
    """`tests/test_relocalization.py`'s two cases, and the reference-
    keyframe tier on the same snapshots, through both packages on the
    indices the JAX keys draw."""

    @pytest.fixture(scope="class")
    def plain(self, frames):
        lss = (jloop.empty_loop_state(8, 384), tloop.empty_loop_state(8, 384, device="cpu"))
        for i in (0, 6, 12):
            lss = snap_both(lss, frames[i])
        kf = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
        kf[:3] = TRAJ[[0, 6, 12]]
        return lss, kf

    @pytest.fixture(scope="class")
    def decoy(self, frames):
        lss = (jloop.empty_loop_state(8, 384), tloop.empty_loop_state(8, 384, device="cpu"))
        lss = snap_both(lss, frames[3], scramble=True)
        lss = snap_both(lss, frames[4])
        kf = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
        kf[0], kf[1] = TRAJ[20], TRAJ[4]
        return lss, kf

    def _reloc(self, lss, kf, frame, key, k=4):
        jls, tls = lss
        ref = jreloc.relocalize(jls, jnp.asarray(kf), jax_frame(frame), CFG, key, k=k)
        got = treloc.relocalize(tls, T(kf), frame, CFG, None, k=k,
                                draw=jax_draw(list(jax.random.split(key, k))))
        return got, ref

    def test_plain(self, plain, frames, room):
        f7 = process_frame(*render_frame(room, TRAJ[7], CFG.intr), CFG)
        got, ref = self._reloc(*plain, f7, jax.random.PRNGKey(1))
        assert_same_pnp(got, ref, "plain")
        assert bool(got.ok)
        assert np.linalg.norm(got.Tcw.numpy()[:3, 3] - TRAJ[7][:3, 3]) < 0.1

    def test_decoy_picks_candidate_2(self, decoy, frames):
        lss, kf = decoy
        sig = tpr.bow_signature(frames[3].feats.desc_pm, frames[3].feats.valid)
        assert tpr.query_topk(lss[1].db, sig, k=4, exclude_recent=0)[0][:2].tolist() == [0, 1]
        got, ref = self._reloc(lss, kf, frames[3], jax.random.PRNGKey(5))
        assert_same_pnp(got, ref, "decoy")
        assert bool(got.ok) and bool(ref.ok)
        # The winner is candidate 2 (keyframe 1) in both: its pose, not the decoy's.
        for T_est in (got.Tcw.numpy(), np.asarray(ref.Tcw)):
            assert np.linalg.norm(T_est[:3, 3] - TRAJ[3][:3, 3]) < 0.1
        got1, ref1 = self._reloc(lss, kf, frames[3], jax.random.PRNGKey(5), k=1)
        assert not bool(got1.ok) and not bool(ref1.ok)

    @pytest.mark.parametrize("case", ["plain", "decoy"])
    def test_track_reference_keyframe(self, plain, decoy, frames, case):
        (jls, tls), kf = plain if case == "plain" else decoy
        ref_kf, q, last = (2, 13, 12) if case == "plain" else (1, 3, 4)
        f = frames[q]
        ref = jreloc.track_reference_keyframe(jls, jnp.asarray(kf), jnp.int32(ref_kf), jax_frame(f),
                                              jnp.asarray(TRAJ[last]), CFG)
        key = jax.random.fold_in(jax.random.PRNGKey(41), ref_kf)
        got = treloc.track_reference_keyframe(tls, T(kf), ref_kf, f, T(TRAJ[last]), CFG,
                                              draw=jax_draw([key]))
        assert_same_pnp(got, ref, case)
        assert int(got.num_inliers) >= CFG.min_track_inliers
        assert np.linalg.norm(got.Tcw.numpy()[:3, 3] - TRAJ[q][:3, 3]) < 0.08


def test_rpe(rng):
    est = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.3, (12, 6)), jnp.float32)))
    gt = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.3, (12, 6)), jnp.float32)))
    for delta in (1, 3, 20):
        got, ref = tate.rpe(est, gt, delta), jate.rpe(est, gt, delta)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-9)


# -- the JAX recovery tests' assertions on the port alone -------------------


def _track(sysm, room, i):
    g, d = render_frame(room, TRAJ[i], CFG.intr)
    return sysm.track_rgbd(g.numpy(), d.numpy())


@pytest.fixture(scope="module")
def mapped(room):
    """A system after frames 0-11; tests take copies."""
    sysm = SlamSystem(CFG, kmax=16, nmax=4096, emax=32768, device="cpu")
    for i in range(12):
        _track(sysm, room, i)
    assert sysm.stats["keyframes"] >= 3
    return sysm


def test_ref_kf_fallback_recovers_without_full_reloc(mapped, room):
    """A 2 m kick to the motion model: the reference-keyframe tier recovers
    the pose and full relocalization never runs (`test_recovery_tiers.py`)."""
    sysm = copy.deepcopy(mapped)
    kick = np.eye(4, dtype=np.float32)
    kick[0, 3] = 2.0
    sysm.velocity = kick
    T_est = _track(sysm, room, 12)
    assert sysm.stats.get("ref_kf_recoveries", 0) >= 1
    assert sysm.stats.get("relocalizations", 0) == 0
    assert np.linalg.norm(T_est[:3, 3] - TRAJ[12][:3, 3]) < 0.08
    for i in range(13, 16):
        T_est = _track(sysm, room, i)
    assert np.linalg.norm(T_est[:3, 3] - TRAJ[15][:3, 3]) < 0.08
    assert sysm.stats["track_ok"][-4:] == [False, True, True, True]


def test_poisoned_bootstrap_auto_resets(room):
    """Initialized on noise: tracking fails, the early-map reset fires, and
    the re-bootstrapped map tracks metrically (`test_reset_localization.py`)."""
    rng = np.random.default_rng(7)
    sysm = SlamSystem(CFG, kmax=16, nmax=4096, emax=32768, device="cpu")
    sysm.track_rgbd(rng.integers(0, 255, (CFG.height, CFG.width)).astype(np.float32),
                    rng.uniform(1.0, 4.0, (CFG.height, CFG.width)).astype(np.float32))
    assert sysm.initialized
    for i in range(8):
        _track(sysm, room, i)
    assert sysm.stats.get("resets", 0) >= 1, "auto-reset never fired"
    assert sysm.initialized
    # The stores were rebuilt: snapshot slot k is keyframe k again.
    assert int(sysm.loop_state.db.count) == int(sysm.map_state.num_kfs)
    T_prev, rel_errs = None, []
    for i in range(8, 13):
        T_est = _track(sysm, room, i).copy()
        if T_prev is not None:
            rel_est = T_est @ np.linalg.inv(T_prev)
            rel_gt = TRAJ[i] @ np.linalg.inv(TRAJ[i - 1])
            rel_errs.append(np.abs(rel_est - rel_gt).max())
        T_prev = T_est
    assert float(np.median(rel_errs)) < 0.02, rel_errs


def test_localization_only_freezes_map(mapped, room):
    """A frozen map: poses stay accurate while keyframes, points and the
    place database never change; switching back restores mapping
    (`test_reset_localization.py`)."""
    sysm = copy.deepcopy(mapped)
    kfs, pts, db = sysm.stats["keyframes"], int(sysm.map_state.num_pts), int(sysm.loop_state.db.count)
    sysm.set_localization_mode(True)
    errs = []
    for i in range(6, 12):
        errs.append(np.linalg.norm(_track(sysm, room, i)[:3, 3] - TRAJ[i][:3, 3]))
    assert sysm.stats["keyframes"] == kfs
    assert int(sysm.map_state.num_pts) == pts
    assert int(sysm.loop_state.db.count) == db
    assert sysm.stats.get("resets", 0) == 0
    assert float(np.median(errs[1:])) < 0.05, errs
    sysm.set_localization_mode(False)
    for i in range(12, 17):
        _track(sysm, room, i)
    assert sysm.stats["keyframes"] > kfs


def test_relocalization_tier_recovers_a_teleport(mapped, room, monkeypatch):
    """With the reference-keyframe tier failing, a teleport back to frame 2
    under a half-turn prediction is recovered by relocalization, which
    resets the motion model (`test_pnp.py`'s teleport)."""
    from qsp_slam_tpu_torch.slam import system as system_mod

    sysm = copy.deepcopy(mapped)
    fail = tpnp.PnPResult(torch.eye(4), torch.zeros(1, dtype=torch.bool), torch.tensor(0), torch.tensor(False))
    monkeypatch.setattr(system_mod, "track_reference_keyframe", lambda *a, **k: fail)
    sysm.velocity = tlie.exp_se3(torch.tensor([0, 0, 0, 0, 3.1, 0])).numpy()
    T_est = _track(sysm, room, 2)
    assert sysm.stats["track_ok"][-1] is False
    assert sysm.stats.get("relocalizations", 0) == 1 and sysm.stats.get("ref_kf_recoveries", 0) == 0
    assert np.linalg.norm(T_est[:3, 3] - TRAJ[2][:3, 3]) < 0.1
    np.testing.assert_array_equal(sysm.velocity, np.eye(4, dtype=np.float32))


def test_run_global_ba_keeps_the_trajectory(mapped):
    sysm = copy.deepcopy(mapped)
    n = int(sysm.map_state.num_kfs)
    before = sysm.map_state.kf_Tcw[:n].clone()
    sysm.run_global_ba()
    after = sysm.map_state.kf_Tcw[:n]
    assert torch.equal(after[0], before[0])  # the gauge keyframe is fixed
    err = [np.linalg.norm(tlie.inv_se3(after[k])[:3, 3].numpy() - np.linalg.inv(TRAJ[f])[:3, 3])
           for k, f in enumerate(sysm.stats["kf_frames"])]
    assert max(err) < 0.05, err
    np.testing.assert_array_equal(sysm.Tcw, after[n - 1].numpy())

"""Parity of the port's monocular path with the JAX package on the CPU, and
the JAX monocular tests' assertions on the port alone.

Same seeded numpy inputs (or one rendered sequence's port features handed
to both packages) go through the JAX function and the port's.  The
two-view draws are the reference's `jax.random.choice` indices for
`PRNGKey(31)` (or the test's key), fed to the port through `draw`.
Tolerances: the rotation histogram, epipolar gates, matches and inlier
masks exact; f32 geometry 1e-4; the two-view pose 1e-3 (a weighted SVD
refit in f32 over a few hundred rows) and candidate stacks as sets (SVD
and `eigh` sign and basis freedom reorder them); loop correction 1e-4;
the 16-frame run: the same bootstrap frame, keyframes and map size, camera
centres within 1e-3 gauge units (the unit is the median depth of the
bootstrap, ~2 m here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.frontend import initializer as jini
from qsp_slam_tpu.frontend import matcher as jmatcher
from qsp_slam_tpu.frontend.orb import Features as JFeatures
from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from qsp_slam_tpu.slam import loop_closing as jloop
from qsp_slam_tpu.slam import map as jmap
from qsp_slam_tpu.slam import mono as jmono
from qsp_slam_tpu.slam.objects import empty_objects as jempty_objects
from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem
from qsp_slam_tpu.slam.tracking import FrameData as JFrameData
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu_torch import convert
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.core.camera import Intrinsics, project
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.eval.ate import positions_from_Tcw
from qsp_slam_tpu_torch.frontend import initializer as tini
from qsp_slam_tpu_torch.frontend import matcher as tmatcher
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.slam import loop_closing as tloop
from qsp_slam_tpu_torch.slam import map as tmap
from qsp_slam_tpu_torch.slam import mono as tmono
from qsp_slam_tpu_torch.slam import objects as tobj
from qsp_slam_tpu_torch.slam import system as system_mod
from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint, save_checkpoint
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig, process_frame

torch.set_num_threads(1)

CFG = TrackingConfig(orb=OrbConfig(num_features=500))
JCFG = JTrackingConfig(orb=JOrbConfig(num_features=500))
INTR = Intrinsics(*(float(np.float32(v)) for v in (520.9, 521.0, 325.1, 249.7)))
JINTR = JIntrinsics(*(jnp.float32(v) for v in INTR))
TRAJ = orbit_trajectory(16, step=0.025)  # tests/test_mono_e2e.py's orbit
SYS = dict(kmax=16, nmax=4096, emax=32768, ba_window=6)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_two_view_draw(valid, gen, num_hyp, key=None):
    """The reference's draws: `jax.random.choice` with p = valid / sum
    under the split of PRNGKey(generator seed), or of `key`."""
    key = jax.random.PRNGKey(gen.initial_seed()) if key is None else key
    kE, kH = jax.random.split(key)
    v = jnp.asarray(valid.numpy())
    p = v.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    M = v.shape[0]
    return (T(jax.random.choice(kE, M, shape=(num_hyp, 8), p=p)),
            T(jax.random.choice(kH, M, shape=(num_hyp, 4), p=p)))


def jax_frame(f):
    ft = f.feats
    feats = JFeatures(**{k: jnp.asarray(getattr(ft, k).numpy().view(np.uint32) if k == "desc_bits"
                                        else getattr(ft, k).numpy()) for k in JFeatures._fields})
    return JFrameData(feats=feats, depth=jnp.asarray(f.depth.numpy()), u_right=jnp.asarray(f.u_right.numpy()))


@pytest.fixture(scope="module")
def grays():
    room = make_room(device="cpu")
    return [render_frame(room, TRAJ[i], INTR)[0].numpy() for i in range(len(TRAJ))]


@pytest.fixture(scope="module")
def frames(grays):
    zero = torch.zeros(480, 640)
    return [process_frame(T(g), zero, CFG) for g in grays[:6]]


# -- matcher -------------------------------------------------------------------


def test_rotation_consistency(rng):
    """Exact against the reference, with count ties among the bins."""
    for n in (50, 400):
        a = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        b = (a - rng.choice([0.1, 0.35, 1.2, 2.0, -0.5], n) + rng.normal(0, 0.02, n)).astype(np.float32)
        valid = rng.random(n) < 0.8
        ref = jmatcher.rotation_consistency(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
        got = tmatcher.rotation_consistency(T(a), T(b), T(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert 0 < int(got.sum()) < int(valid.sum())


def test_epipolar_mask(rng):
    """Exact against the reference, with and without the octave scaling."""
    A, B = 300, 500
    uv_a = rng.uniform([0, 0], [640, 480], (A, 2)).astype(np.float32)
    uv_b = rng.uniform([0, 0], [640, 480], (B, 2)).astype(np.float32)
    T21 = np.asarray(jlie.exp_se3(jnp.asarray([0.3, -0.05, 0.1, 0.02, -0.1, 0.03], jnp.float32)))
    octave = rng.integers(0, 8, B).astype(np.int32)
    for oct_b in (None, octave):
        ref = jmatcher.epipolar_mask(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(T21), JINTR,
                                     octave_b=None if oct_b is None else jnp.asarray(oct_b), sigma_px=2.0)
        got = tmatcher.epipolar_mask(T(uv_a), T(uv_b), T(T21), INTR,
                                     octave_b=None if oct_b is None else T(oct_b), sigma_px=2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert 0 < int(got.sum()) < A * B


# -- two-view initializer ----------------------------------------------------------


def _scene(rng, kind):
    """tests/test_mono_stereo.py's three correspondence sets."""
    M = 200 if kind == "general" else 150
    if kind == "planar":
        pts = np.concatenate([rng.uniform([-2, -1.5], [2, 1.5], (M, 2)), np.full((M, 1), 5.0)], -1)
        xi = [0.4, 0.0, 0.1, 0.0, -0.08, 0.0]
    else:
        pts = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (M, 3))
        xi = [0.3, 0.02, 0.05, 0.02, -0.06, 0.01] if kind == "general" else [0, 0, 0, 0, 0.06, 0]
    pts = T(pts.astype(np.float32))
    T2 = tlie.exp_se3(T(np.asarray(xi, np.float32)))
    uv1, uv2 = project(pts, INTR)[0].numpy(), project(tlie.transform_points(T2, pts), INTR)[0].numpy()
    if kind == "general":
        uv1 = (uv1 + rng.normal(0, 0.3, (M, 2))).astype(np.float32)
        uv2 = (uv2 + rng.normal(0, 0.3, (M, 2))).astype(np.float32)
    return pts.numpy(), T2.numpy(), uv1, uv2


@pytest.mark.parametrize("kind,seed", [("general", 0), ("planar", 1), ("rotation", 2)])
def test_two_view_init(rng, kind, seed):
    """The three scenes of tests/test_mono_stereo.py on the reference's draws:
    the same `ok`, model choice and inliers, the pose within 1e-3; and the
    JAX tests' own assertions on the port."""
    pts, T2, uv1, uv2 = _scene(rng, kind)
    M = uv1.shape[0]
    key = jax.random.PRNGKey(seed)
    ref = jini.two_view_init(jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(M, bool), JINTR, key)
    got = tini.two_view_init(T(uv1), T(uv2), torch.ones(M, dtype=torch.bool), INTR, None,
                             draw=functools.partial(jax_two_view_draw, key=key))
    assert bool(got.ok) == bool(ref.ok) and bool(got.used_homography) == bool(ref.used_homography)
    np.testing.assert_array_equal(got.pt_ok.numpy(), np.asarray(ref.pt_ok))
    np.testing.assert_allclose(got.T_cw2.numpy(), np.asarray(ref.T_cw2), atol=1e-3)
    ok = got.pt_ok.numpy()
    np.testing.assert_allclose(got.points.numpy()[ok], np.asarray(ref.points)[ok], atol=1e-3, rtol=1e-3)
    if kind == "rotation":
        assert not bool(got.ok)  # no parallax, no initialization
        return
    assert bool(got.ok)
    t_est, t_gt = got.T_cw2.numpy()[:3, 3], T2[:3, 3]
    assert np.dot(t_est, t_gt) / (np.linalg.norm(t_est) * np.linalg.norm(t_gt)) > 0.99
    if kind == "planar":
        assert bool(got.used_homography)
    else:
        assert np.abs(got.T_cw2.numpy()[:3, :3] - T2[:3, :3]).max() < 0.01
        assert ok.sum() > 120
        ratio = got.points.numpy()[ok][:, 2] / pts[ok][:, 2]
        assert np.std(ratio) / np.mean(ratio) < 0.05


def _as_set(stack, decimals=3):
    return sorted(tuple(np.round(T_.reshape(-1), decimals)) for T_ in np.asarray(stack))


def test_initializer_pieces(rng):
    """Triangulation and the error functions 1e-4; the 8-point and 4-point
    solutions up to sign; the candidate stacks of both decompositions as
    sets (their order depends on SVD and eigh bases)."""
    pts, T2, uv1, uv2 = _scene(rng, "general")
    x1, x2 = (((uv - [INTR.cx, INTR.cy]) / [INTR.fx, INTR.fy]).astype(np.float32) for uv in (uv1, uv2))
    r1, r2 = (np.concatenate([x, np.ones((len(x), 1), np.float32)], -1) for x in (x1, x2))
    for got, ref in zip(tini._triangulate(T(r1), T(r2), T(T2)), jini._triangulate(jnp.asarray(r1), jnp.asarray(r2),
                                                                                   jnp.asarray(T2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    E_ref = np.asarray(jini._essential_8pt(jnp.asarray(x1[:8]), jnp.asarray(x2[:8])))
    E = tini._essential_8pt(T(x1[:8]), T(x2[:8])).numpy()
    np.testing.assert_allclose(E * np.sign(np.sum(E * E_ref)), E_ref, atol=1e-4)
    H_ref = np.asarray(jini._homography_4pt(jnp.asarray(x1[:4]), jnp.asarray(x2[:4])))
    H = tini._homography_4pt(T(x1[:4]), T(x2[:4])).numpy()
    np.testing.assert_allclose(H * np.sign(np.sum(H * H_ref)), H_ref, atol=1e-4)
    np.testing.assert_allclose(tini._epipolar_err(T(E_ref), T(x1), T(x2)).numpy(),
                               np.asarray(jini._epipolar_err(jnp.asarray(E_ref), jnp.asarray(x1), jnp.asarray(x2))),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tini._homography_err(T(H_ref), T(x1), T(x2)).numpy(),
                               np.asarray(jini._homography_err(jnp.asarray(H_ref), jnp.asarray(x1),
                                                               jnp.asarray(x2))), rtol=1e-4, atol=1e-6)
    assert _as_set(tini._decompose_E(T(E_ref))) == _as_set(jini._decompose_E(jnp.asarray(E_ref)))
    _, _, uvp1, uvp2 = _scene(rng, "planar")
    xp1, xp2 = (((uv - [INTR.cx, INTR.cy]) / [INTR.fx, INTR.fy]).astype(np.float32) for uv in (uvp1, uvp2))
    Hp = np.asarray(jini._homography_4pt(jnp.asarray(xp1[:4]), jnp.asarray(xp2[:4])))
    w = np.ones(len(xp1), np.float32)
    assert _as_set(tini._decompose_H(T(Hp), T(xp1), T(w))) == _as_set(
        jini._decompose_H(jnp.asarray(Hp), jnp.asarray(xp1), jnp.asarray(w)))


def test_two_view_sample():
    """Draws only valid rows, the same on every call for one seed; with no
    valid row it draws uniformly."""
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::7] = True
    i8, i4 = tini.two_view_sample(valid, torch.Generator().manual_seed(31), 128)
    assert i8.shape == (128, 8) and i4.shape == (128, 4)
    assert valid[i8].all() and valid[i4].all()
    j8, _ = tini.two_view_sample(valid, torch.Generator().manual_seed(31), 128)
    assert torch.equal(i8, j8)
    i8, _ = tini.two_view_sample(torch.zeros(300, dtype=torch.bool), torch.Generator().manual_seed(1), 16)
    assert len(torch.unique(i8)) > 20


# -- slam/mono ----------------------------------------------------------------


def test_mono_initialize(frames):
    """One K2 call at (F, F), mutual match, rotation filter, two-view init on
    the reference's draws: equal to the reference on rendered frames 0, 2."""
    f1, f2 = frames[0], frames[2]
    ref = jmono.mono_initialize(jax_frame(f1), jax_frame(f2), JCFG, jax.random.PRNGKey(31))
    from qsp_slam_tpu_torch.ops.hamming import hamming_packed

    before = hamming_packed.launches
    got = tmono.mono_initialize(f1, f2, CFG, torch.Generator().manual_seed(31), draw=jax_two_view_draw)
    assert hamming_packed.launches == before  # the CPU runs the plain version, uncounted
    assert bool(got.ok) and bool(ref.ok)
    for name in ("pt_ok", "uv1", "uv2", "octave2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.T_cw2.numpy(), np.asarray(ref.T_cw2), atol=1e-3)
    ok = got.pt_ok.numpy()
    np.testing.assert_allclose(got.pts_w.numpy()[ok], np.asarray(ref.pts_w)[ok], atol=1e-3)


def test_triangulate_new_points(frames):
    """Triangulation of frame 4 against frame 0's snapshot at their true
    poses: the epipolar-gated mutual match, the gates, the new points' ids
    and observations equal the reference's; positions within 1e-3
    relative (the midpoint solve over a short baseline amplifies f32
    rounding by about depth / baseline, ~20 here), other floats 1e-4."""
    jm = jmap.empty_map(kmax=8, nmax=2048, emax=8192)
    jm, _ = jmap.add_keyframe(jm, jnp.asarray(TRAJ[0]))
    jm, kf1 = jmap.add_keyframe(jm, jnp.asarray(TRAJ[4]))
    f0, f4 = frames[0], frames[4]
    S = 384
    prev = (f0.feats.desc_pm[:S], f0.feats.xy[:S], f0.feats.valid[:S])
    matched = np.zeros(CFG.orb.num_features, bool)
    matched[::5] = True
    ref = jmono.triangulate_new_points(jm, *(jnp.asarray(x.numpy()) for x in prev), jnp.int32(0), kf1,
                                       jax_frame(f4), jnp.asarray(matched), JCFG)
    m = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}, device="cpu")
    got = tmono.triangulate_new_points(m, *prev, 0, torch.tensor(1, dtype=torch.int32), f4, T(matched), CFG)
    assert int(got.num_pts) == int(ref.num_pts) > 20
    for name in tmap.MapState._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-3 if name == "pt_xyz" else 0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


# -- loop closing --------------------------------------------------------------


def test_feature_points_from_matches_scatter():
    """tests/test_recovery_tiers.py's case (invalid and out-of-range rows
    drop), and the reference's result on a random table with negative and
    out-of-range indices."""
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[0, 3] = 0.5
    pts, ok = tloop.feature_points_from_matches(
        T(np.array([[0.0, 0.0, 2.0], [1.0, 0.0, 3.0], [0.0, 1.0, 4.0]], np.float32)),
        T(np.array([1, -1, 5], np.int32)), T([True, False, True]), T(Tcw), 4)
    assert pts.shape == (4, 3) and ok.shape == (4,)
    assert bool(ok[1]) and int(ok.sum()) == 1
    np.testing.assert_allclose(pts[1].numpy(), [0.5, 0.0, 2.0], atol=1e-6)
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    match_pt = rng.permutation(100)[:64].astype(np.int32) - 20
    inl = rng.random(64) < 0.7
    Tcw = np.asarray(jlie.exp_se3(jnp.asarray([0.1, 0.2, 0.3, 0.1, 0.2, 0.3], jnp.float32)))
    ref = jloop.feature_points_from_matches(jnp.asarray(xyz), jnp.asarray(match_pt), jnp.asarray(inl),
                                            jnp.asarray(Tcw), 60)
    got = tloop.feature_points_from_matches(T(xyz), T(match_pt), T(inl), T(Tcw), 60)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)


def test_scale_drift_corrected():
    """tests/test_sim3_loop.py: a 12-keyframe circle with 2% scale drift
    per keyframe, closed over Sim(3), with objects anchored at keyframes 3
    and 11 (and one at a pose no keyframe has): poses, scales and objects
    equal the reference's; the end pose moves to the truth."""
    K = 12
    gt = [np.asarray(jlie.exp_se3(jnp.asarray([np.sin(2 * np.pi * k / K), 0, 1 - np.cos(2 * np.pi * k / K),
                                               0, 0, 0], jnp.float32))) for k in range(K)]
    est = []
    for k in range(K):
        E = gt[k].copy()
        E[:3, 3] *= 1.02 ** k
        est.append(E)
    jm = jmap.empty_map(kmax=16, nmax=64, emax=256)
    for k in range(K):
        jm, _ = jmap.add_keyframe(jm, jnp.asarray(est[k]))
    jo = jempty_objects(4)
    jo = jo._replace(
        ellipsoid=jo.ellipsoid.at[:3].set(jnp.asarray([[0.5, 0.2, 1.0, 0.1, 0.2, 0.3, 0.2, 0.3, 0.4],
                                                       [-0.5, 0.1, 1.5, 0.0, 0.1, 0.0, 0.3, 0.2, 0.2],
                                                       [0.2, 0.2, 0.2, 0.0, 0.0, 0.5, 0.1, 0.1, 0.1]])),
        valid=jo.valid.at[:3].set(True), label=jo.label.at[:3].set(jnp.asarray([0, 1, 1])),
        obs_count=jo.obs_count.at[:3].set(1), obs_next=jo.obs_next.at[:3].set(1),
        obs_Tcw=jo.obs_Tcw.at[0, 0].set(jnp.asarray(est[3])).at[1, 0].set(jnp.asarray(est[11]))
        .at[2, 0].set(jnp.asarray(gt[5])),
    )
    T_rel = np.asarray(gt[K - 1] @ np.linalg.inv(gt[0]), np.float32)
    jdet = jloop.LoopDetection(found=jnp.asarray(True), match_kf=jnp.int32(0), T_cur_match=jnp.asarray(T_rel),
                               num_inliers=jnp.int32(50), score=jnp.asarray(0.9))
    ref_m, ref_o = jloop.correct_loop(jm, jo, jnp.int32(K - 1), jdet, fix_scale=False, iters=25)
    m = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}, device="cpu")
    o = convert.object_table_from_numpy({k: np.asarray(v) for k, v in jo._asdict().items()}, device="cpu")
    det = tloop.LoopDetection(found=torch.tensor(True), match_kf=torch.tensor(0, dtype=torch.int32),
                              T_cur_match=T(T_rel), num_inliers=torch.tensor(50), score=torch.tensor(0.9))
    got_m, got_o = tloop.correct_loop(m, o, K - 1, det, fix_scale=False, iters=25)
    np.testing.assert_allclose(got_m.kf_Tcw.numpy(), np.asarray(ref_m.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(got_o.ellipsoid.numpy(), np.asarray(ref_o.ellipsoid), atol=1e-4)
    np.testing.assert_array_equal(got_o.valid.numpy(), np.asarray(ref_o.valid))
    assert np.abs(got_o.ellipsoid[:2].numpy() - o.ellipsoid[:2].numpy()).max() > 1e-3  # re-anchored
    np.testing.assert_array_equal(got_o.ellipsoid[2].numpy(), o.ellipsoid[2].numpy())  # no matching keyframe
    err_before = np.linalg.norm(est[K - 1][:3, 3] - gt[K - 1][:3, 3])
    err_after = np.linalg.norm(got_m.kf_Tcw[K - 1].numpy()[:3, 3] - gt[K - 1][:3, 3])
    assert err_after < 0.5 * err_before
    assert abs(float(tlie.sim3_scale(got_m.kf_Tcw[K - 1])) - 1.0) < 0.15


# -- the system ----------------------------------------------------------------


@pytest.fixture(scope="module")
def e2e(grays):
    """16 frames of the orbit through both packages at 500 features, the
    port on the reference's two-view draws.  The maps right after the
    bootstrap are kept."""
    js = JSlamSystem(JCFG, enable_objects=False, **SYS)
    ts = SlamSystem(CFG, device="cpu", **SYS)
    orig = system_mod.mono_initialize
    system_mod.mono_initialize = functools.partial(tmono.mono_initialize, draw=jax_two_view_draw)
    boot = {}
    try:
        for g in grays:
            js.track_mono(g)
            ts.track_mono(g)
            if ts.initialized and "port" not in boot:
                boot = {"port": ts.map_state, "jax": js.map_state, "ref": ts._mono_ref}
    finally:
        system_mod.mono_initialize = orig
    return js, ts, boot


def test_track_mono_matches_the_reference(e2e):
    js, ts, _ = e2e
    assert ts.initialized and js.initialized
    assert ts.stats["kf_frames"] == js.stats["kf_frames"]
    assert ts.stats["kf_frames"][:2] == [0, 1]
    s, r = ts.summary(), js.summary()
    for key in ("frames", "keyframes", "num_points", "num_obs", "num_objects", "loops_closed"):
        assert s[key] == r[key], key
    assert s["keyframes"] >= 3 and s["num_points"] > 300
    p = positions_from_Tcw(np.stack(ts.trajectory).astype(np.float64))
    q = positions_from_Tcw(np.stack(js.trajectory).astype(np.float64))
    assert np.linalg.norm(p - q, axis=1).max() < 1e-3


def test_bootstrap_descriptors_come_from_frame_two_in_frame_one_order(e2e, grays):
    """ROADMAP queue C: the bootstrap's points are aligned with frame 1's
    features, but `add_points` is given frame 2's descriptor table in that
    order (`system.py:1024`), so point i takes the descriptor of frame 2's
    feature i, not of its match.  Both packages store the same table."""
    _, ts, boot = e2e
    jm, m = boot["jax"], boot["port"]
    n = int(m.num_pts)
    assert n == int(jm.num_pts) > 100
    np.testing.assert_array_equal(m.pt_desc[:n].numpy(), np.asarray(jm.pt_desc[:n]))
    # Rebuild the bootstrap's inputs: frames 0 and 1.
    zero = torch.zeros(480, 640)
    f1 = process_frame(T(grays[0]), zero, CFG)
    f2 = process_frame(T(grays[1]), zero, CFG)
    init = tmono.mono_initialize(f1, f2, CFG, torch.Generator().manual_seed(31), draw=jax_two_view_draw)
    rows = torch.nonzero(init.pt_ok)[:, 0]
    dist = tmatcher.hamming_matrix(f1.feats.desc_bits, f2.feats.desc_bits)
    j = tmatcher.mutual_match(dist, f1.feats.valid, f2.feats.valid, max_dist=50, ratio=0.9).idx.long()
    stored = m.pt_desc[:n]
    assert torch.equal(stored, f2.feats.desc_pm[rows])
    assert (stored != f2.feats.desc_pm[j[rows]]).any(dim=1).float().mean() > 0.9


def test_mono_mid_bootstrap_resume(tmp_path, grays):
    """tests/test_checkpoint.py's case across packages: the JAX system sees
    frame 0 twice (no parallax, so it stays in the bootstrap) and saves;
    the port resumes that checkpoint with the reference frame and its age,
    and then tracks as a port system that saw the same two frames (the
    reference's keypoint responses and angles differ from the port's in the
    last bits, so those compare within 1e-4 relative)."""
    from qsp_slam_tpu.slam.checkpoint import save_checkpoint as jsave

    js = JSlamSystem(JCFG, enable_objects=False, **SYS)
    ts = SlamSystem(CFG, device="cpu", **SYS)
    for _ in range(2):
        js.track_mono(grays[0])
        ts.track_mono(grays[0])
    assert not js.initialized and js._mono_ref is not None
    jsave(str(tmp_path / "mono.npz"), js)
    resumed = SlamSystem(CFG, device="cpu", **SYS)
    load_checkpoint(str(tmp_path / "mono.npz"), resumed)
    assert resumed._sensor == "mono" and not resumed.initialized
    assert resumed._mono_ref_age == js._mono_ref_age == ts._mono_ref_age == 1
    for name, a, b in zip(resumed._mono_ref.feats._fields, resumed._mono_ref.feats, ts._mono_ref.feats):
        if a.dtype.is_floating_point and name != "xy":
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            assert torch.equal(a, b), name
    for i in range(2, 7):
        np.testing.assert_allclose(resumed.track_mono(grays[i]), ts.track_mono(grays[i]), atol=1e-5)
    assert resumed.initialized and ts.initialized
    # The port's own checkpoint resumes mid-run too.
    save_checkpoint(str(tmp_path / "port.npz"), ts)
    again = SlamSystem(CFG, device="cpu", **SYS)
    load_checkpoint(str(tmp_path / "port.npz"), again)
    np.testing.assert_allclose(again.track_mono(grays[7]), ts.track_mono(grays[7]), atol=1e-5)


def test_mono_poisoned_bootstrap_auto_resets(grays):
    """tests/test_recovery_tiers.py: noise frames right after the bootstrap
    lose tracking; with <= 5 keyframes the early-map reset fires and the
    monocular bootstrap re-seeds from live frames."""
    sysm = SlamSystem(CFG, device="cpu", **SYS)
    for g in grays[:2]:
        sysm.track_mono(g)
    assert sysm.initialized
    rng = np.random.default_rng(0)
    for _ in range(2):
        sysm.track_mono(rng.uniform(0, 255, (480, 640)).astype(np.float32))
    assert sysm.stats.get("resets", 0) == 1 and not sysm.initialized
    assert sysm.objects.valid.sum() == 0 and sysm.ground_plane is None
    # The noise frame is the new reference: after 10 failed attempts the
    # reference moves to a live frame, and the next one bootstraps.
    for g in grays[2:15]:
        sysm.track_mono(g)
    assert sysm.initialized and sysm.stats["keyframes"] >= 2


def test_mono_localization_only_freezes_map(grays):
    """tests/test_recovery_tiers.py: in localization-only mode the frozen
    map grows no keyframes and no points while tracking goes on."""
    sysm = SlamSystem(CFG, device="cpu", **SYS)
    for g in grays[:7]:
        sysm.track_mono(g)
    assert sysm.initialized and sysm.stats["keyframes"] >= 3
    kfs, pts = sysm.stats["keyframes"], int(sysm.map_state.num_pts)
    sysm.set_localization_mode(True)
    for g in grays[1:6]:
        sysm.track_mono(g)
    assert sysm.stats["keyframes"] == kfs and int(sysm.map_state.num_pts) == pts
    assert sysm.stats.get("resets", 0) == 0
    assert sum(sysm.stats["track_ok"][-5:]) >= 4
    fresh = SlamSystem(CFG, device="cpu", localization_only=True, **SYS)
    fresh.track_mono(grays[0])
    assert not fresh.initialized and fresh._mono_ref is None  # no map, no bootstrap


def test_rgbd_and_stereo_detections_wait_for_slice_6():
    """RGB-D and stereo detections are taken (they refused before their
    object path was ported): on blank frames no ground plane is found, so
    the objects wait and the table stays empty."""
    det = {"bbox": np.zeros((1, 4), np.float32), "label": np.zeros(1, np.int32),
           "prob": np.ones(1, np.float32), "valid": np.ones(1, bool)}
    g = np.zeros((480, 640), np.uint8)
    for track in ("rgbd", "stereo"):
        sysm = SlamSystem(CFG, device="cpu", **SYS)
        assert sysm.enable_objects  # the default, as in the reference
        if track == "rgbd":
            sysm.track_rgbd(g, np.zeros((480, 640), np.uint16), det)
        else:
            sysm.track_stereo(g, g, det)
        assert sysm.initialized and sysm.ground_plane is None and sysm._gp_count == 0
        assert isinstance(sysm.objects, tobj.ObjectTable) and not bool(sysm.objects.valid.any())

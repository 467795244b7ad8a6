"""Parity of the port's loop closing with the JAX package on the CPU.

Same seeded numpy inputs (or one rendered scene's port features handed to
both packages) go through the JAX function and the port's.  RANSAC runs on
the raw draws of the reference's `jax.random.randint` keys, fed to the port
through `draw`.  Tolerances: Sim(3) Lie functions 1e-5 (2e-5 on the log
near a half turn); Horn and RANSAC transforms 1e-4 with equal inlier masks;
the image-space polish 1e-3 (ten damped Gauss-Newton steps in f32); pose
graphs 1e-4, their edge Jacobians 2e-4 (+1e-3 relative); the consistency
gate and place queries exact; verification transforms 1e-3 with equal
inlier counts and `found`; loop correction 1e-4 on poses and points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.opt import pose_graph as jpg
from qsp_slam_tpu.opt import sim3_solver as jss
from qsp_slam_tpu.slam import loop_closing as jloop
from qsp_slam_tpu.slam import map as jmap
from qsp_slam_tpu.slam.objects import empty_objects
from qsp_slam_tpu_torch import convert
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.core.camera import Intrinsics, backproject, project
from qsp_slam_tpu_torch.data.render import make_room, render_frame
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.opt import pose_graph as tpg
from qsp_slam_tpu_torch.opt import sim3_solver as tss
from qsp_slam_tpu_torch.slam import loop_closing as tloop
from qsp_slam_tpu_torch.slam import map as tmap
from qsp_slam_tpu_torch.slam import objects as tobjects
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig, process_frame

torch.set_num_threads(1)

INTR = Intrinsics(500.0, 500.0, 320.0, 240.0)
JINTR = JIntrinsics(*(jnp.float32(v) for v in INTR))


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_draws(*keys):
    """A `draw` for the port that returns the raw `jax.random.randint`
    draws of `keys`, one key per call, in order."""
    keys = list(keys)

    def draw(n_rows, gen, num_hyp):
        return T(jax.random.randint(keys.pop(0), (num_hyp, 3), 0, n_rows))
    return draw


# -- Sim(3) Lie functions ------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 1.5])
def test_sim3_lie(rng, scale):
    xi = (rng.normal(size=(64, 7)) * scale).astype(np.float32)
    xi[:4] = 0.0
    Tg, Tr = tlie.exp_sim3(T(xi)).numpy(), np.asarray(jlie.exp_sim3(jnp.asarray(xi)))
    np.testing.assert_allclose(Tg, Tr, atol=1e-5)
    np.testing.assert_allclose(tlie.log_sim3(T(Tr)).numpy(), np.asarray(jlie.log_sim3(jnp.asarray(Tr))),
                               atol=2e-5 if scale > 1 else 1e-5)
    np.testing.assert_allclose(tlie.inv_sim3(T(Tr)).numpy(), np.asarray(jlie.inv_sim3(jnp.asarray(Tr))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tlie.sim3_scale(T(Tr)).numpy(), np.asarray(jlie.sim3_scale(jnp.asarray(Tr))),
                               rtol=1e-5)
    np.testing.assert_allclose(tlie.adjoint_se3(T(Tr)).numpy(), np.asarray(jlie.adjoint_se3(jnp.asarray(Tr))),
                               atol=1e-5)


@pytest.mark.parametrize("sim3", [False, True])
def test_edge_jacobians_match_jax_jacfwd(rng, sim3):
    """The pose graph's residuals and Jacobians equal the reference's
    `vmap(jacfwd)` over the edges, at random poses and at the identity
    residual (edges whose measurement equals the current relative pose)."""
    E = 12
    exp = jlie.exp_sim3 if sim3 else jlie.exp_se3
    d = 7 if sim3 else 6
    Ti = np.asarray(exp(jnp.asarray(rng.normal(0, 0.5, (E, d)), jnp.float32)))
    Tj = np.asarray(exp(jnp.asarray(rng.normal(0, 0.5, (E, d)), jnp.float32)))
    M = np.array(exp(jnp.asarray(rng.normal(0, 0.5, (E, d)), jnp.float32)))
    M[:4] = np.asarray(jpg.relative_measurement(jnp.asarray(Ti[:4]), jnp.asarray(Tj[:4]), sim3))

    def edge_res(xi_i, xi_j, a, b, m):
        return jpg._residual(exp(xi_i) @ a, exp(xi_j) @ b, m, sim3)

    z = jnp.zeros(d)

    @jax.jit
    def reference(a, b, m):
        return (jax.vmap(lambda a, b, m: edge_res(z, z, a, b, m))(a, b, m),
                jax.vmap(lambda a, b, m: jax.jacfwd(edge_res, argnums=(0, 1))(z, z, a, b, m))(a, b, m))

    jr, (jJi, jJj) = reference(*(jnp.asarray(x) for x in (Ti, Tj, M)))
    r, Ji, Jj = tpg.edge_jacobians(T(Ti), T(Tj), torch.linalg.inv(T(M)), sim3)
    for got, ref in ((r, jr), (Ji, jJi), (Jj, jJj)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


# -- the Sim(3) solver -------------------------------------------------------------


class TestSim3Solver:
    @pytest.mark.parametrize("with_scale", [True, False])
    def test_horn(self, rng, with_scale):
        src = rng.normal(size=(30, 3)).astype(np.float32)
        xi = np.array([0.3, -0.2, 0.5, 0.2, -0.1, 0.4, 0.25 if with_scale else 0.0], np.float32)
        T_gt = np.asarray(jlie.exp_sim3(jnp.asarray(xi)))
        dst = src @ T_gt[:3, :3].T + T_gt[:3, 3]
        w = rng.uniform(0.5, 1.0, 30).astype(np.float32)
        got = tss.horn_alignment(T(src), T(dst), T(w), with_scale).numpy()
        ref = np.asarray(jss.horn_alignment(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale))
        np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_allclose(got, T_gt, atol=1e-4)

    def test_ransac_sim3(self, rng):
        """`tests/test_loop.py`'s outlier case on the JAX draws."""
        N = 100
        src = (rng.normal(size=(N, 3)) * 2.0).astype(np.float32)
        T_gt = np.asarray(jlie.exp_se3(jnp.asarray([0.4, 0.1, -0.3, 0.1, 0.3, -0.2])))
        dst = src @ T_gt[:3, :3].T + T_gt[:3, 3]
        out = rng.random(N) < 0.3
        dst[out] += rng.uniform(0.5, 2.0, (out.sum(), 3))
        valid = rng.random(N) < 0.9
        key = jax.random.PRNGKey(0)
        ref = jss.ransac_sim3(jnp.asarray(src), jnp.asarray(dst.astype(np.float32)), jnp.asarray(valid), key,
                              with_scale=False)
        got = tss.ransac_sim3(T(src), T(dst.astype(np.float32)), T(valid), None, with_scale=False,
                              draw=jax_draws(key))
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
        assert bool(got.ok) and bool(ref.ok)
        np.testing.assert_allclose(got.T_ds.numpy(), np.asarray(ref.T_ds), atol=1e-4)
        np.testing.assert_allclose(got.T_ds.numpy(), T_gt, atol=0.02)

    def _reproj_problem(self, rng, N=150):
        pts_src = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(4, 20, (N, 1))], 1).astype(np.float32)
        T_gt = np.asarray(jlie.exp_se3(jnp.asarray([0.3, -0.1, 0.5, 0.02, 0.08, -0.03])))
        pts_dst = pts_src @ T_gt[:3, :3].T + T_gt[:3, 3]
        # Depth noise along the ray, outliers, both pixels from the points.
        pts_dst = pts_dst * rng.uniform(0.97, 1.03, (N, 1))
        out = rng.random(N) < 0.25
        pts_dst[out] += rng.uniform(-2, 2, (out.sum(), 3))
        uv_src = project(T(pts_src), INTR)[0].numpy() + rng.normal(0, 0.5, (N, 2))
        uv_dst = project(T(pts_dst.astype(np.float32)), INTR)[0].numpy() + rng.normal(0, 0.5, (N, 2))
        oct_ = rng.integers(0, 4, (2, N))
        sig2 = (np.float32(1.2) ** (2.0 * oct_)).astype(np.float32)
        valid = rng.random(N) < 0.9
        return [x.astype(np.float32) for x in (pts_src, pts_dst, uv_src, uv_dst)] + [sig2[0], sig2[1], valid], T_gt

    @pytest.mark.parametrize("with_scale", [False, True])
    def test_ransac_sim3_reproj_and_polish(self, rng, with_scale):
        args, T_gt = self._reproj_problem(rng)
        key = jax.random.PRNGKey(3)
        ref = jss.ransac_sim3_reproj(*(jnp.asarray(a) for a in args), key, JINTR, with_scale=with_scale)
        got = tss.ransac_sim3_reproj(*(T(a) for a in args), None, INTR, with_scale=with_scale,
                                     draw=jax_draws(key))
        assert bool(got.ok) and bool(ref.ok)
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
        np.testing.assert_allclose(got.T_ds.numpy(), np.asarray(ref.T_ds), atol=1e-4)
        # The image gate and the polish on the winner's inliers.
        w = got.inliers.numpy().astype(np.float32)
        T0 = got.T_ds.numpy()
        polish = tss.refine_sim3_reproj(T(T0), *(T(a) for a in args[:6]), T(w), INTR, with_scale=with_scale)
        jpolish = jss.refine_sim3_reproj(jnp.asarray(T0), *(jnp.asarray(a) for a in args[:6]), jnp.asarray(w),
                                         JINTR, with_scale=with_scale)
        np.testing.assert_allclose(polish.numpy(), np.asarray(jpolish), atol=1e-3)
        assert np.linalg.norm(polish.numpy()[:3, 3] - T_gt[:3, 3]) < 0.3
        gate = tss.sim3_image_inliers(polish, *(T(a) for a in args), INTR, with_scale=with_scale)
        jgate = jss.sim3_image_inliers(jnp.asarray(polish.numpy()), *(jnp.asarray(a) for a in args), JINTR,
                                       with_scale=with_scale)
        np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))

    def test_valid_triples_repeat_rows(self):
        """The draws are independent, so a triple may repeat a row, as in
        the reference."""
        valid = torch.zeros(40, dtype=torch.bool)
        valid[[3, 9]] = True
        idx = tss._sample_valid_triples(valid, tss.sim3_sample(40, torch.Generator().manual_seed(0), 64))
        assert set(idx.unique().tolist()) <= {3, 9}
        assert (idx[:, 0] == idx[:, 1]).any()


# -- the pose graph ------------------------------------------------------------------


def _circle_drift():
    """`tests/test_loop.py`: cameras on a circle, biased odometry, one true
    loop edge."""
    V = 24
    gt = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(
        [np.sin(2 * np.pi * k / V), 0.0, 1 - np.cos(2 * np.pi * k / V), 0, 2 * np.pi * k / V, 0], jnp.float32)))
        for k in range(V)])
    noise = np.asarray(jlie.exp_se3(jnp.asarray([0.01, 0.004, 0.01, 0.0, 0.006, 0.0])))
    est = [gt[0]]
    for k in range(1, V):
        est.append(noise @ (gt[k] @ np.linalg.inv(gt[k - 1])) @ est[-1])
    est = np.stack(est).astype(np.float32)
    TT = [est[k] @ np.linalg.inv(est[k + 1]) for k in range(V - 1)] + [gt[V - 1] @ np.linalg.inv(gt[0])]
    return gt, est, list(range(V - 1)) + [V - 1], list(range(1, V)) + [0], TT, [1.0] * (V - 1) + [5.0], 25


def _scale_drift():
    V = 10
    gt = np.stack([np.asarray(jlie.exp_se3(jnp.asarray([0.5 * k, 0, 0, 0, 0, 0], jnp.float32))) for k in range(V)])
    est = np.stack([np.asarray(jlie.exp_sim3(jnp.asarray([0.5 * k * (1.02 ** k) - 0.5 * k, 0, 0, 0, 0, 0, 0.02 * k],
                                                         jnp.float32))) @ gt[k] for k in range(V)])
    TT = [np.asarray(jpg.relative_measurement(est[k], est[k + 1], sim3=True)) for k in range(V - 1)]
    TT.append(np.asarray(jpg.relative_measurement(gt[V - 1], gt[0], sim3=True)))
    return gt, est.astype(np.float32), list(range(V)), list(range(1, V)) + [0], TT, [1.0] * (V - 1) + [5.0], 30


@pytest.mark.parametrize("scenario,sim3", [("circle", False), ("scale", True)])
def test_pose_graph(scenario, sim3):
    gt, est, ii, jj, TT, ww, iters = (_circle_drift if scenario == "circle" else _scale_drift)()
    V = est.shape[0]
    fixed = np.zeros(V, bool)
    fixed[0] = True
    TT = np.stack(TT).astype(np.float32)
    jedges = jpg.PoseGraphEdges(jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32), jnp.asarray(TT),
                                jnp.asarray(ww, jnp.float32))
    tedges = tpg.PoseGraphEdges(T(np.int32(ii)), T(np.int32(jj)), T(TT), T(np.float32(ww)))
    ref, rcost = jpg.optimize_pose_graph(jnp.asarray(est), jnp.asarray(fixed), jedges, sim3=sim3, iters=iters)
    got, cost = tpg.optimize_pose_graph(T(est), T(fixed), tedges, sim3=sim3, iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(float(cost), float(rcost), rtol=1e-3, atol=1e-7)
    if scenario == "circle" and not sim3:
        drift = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
        assert np.linalg.norm(got.numpy()[-1][:3, 3] - gt[-1][:3, 3]) < 0.05 * drift
    if scenario == "scale":
        s_end, s_drift = float(tlie.sim3_scale(got[-1])), float(tlie.sim3_scale(T(est[-1])))
        assert abs(s_end - 1.0) < abs(s_drift - 1.0) * 0.5


def test_relative_measurement(rng):
    A, B = (np.asarray(jlie.exp_sim3(jnp.asarray(rng.normal(0, 0.4, (8, 7)), jnp.float32))) for _ in range(2))
    for sim3 in (False, True):
        np.testing.assert_allclose(tpg.relative_measurement(T(A), T(B), sim3).numpy(),
                                   np.asarray(jpg.relative_measurement(jnp.asarray(A), jnp.asarray(B), sim3)),
                                   atol=1e-5)


# -- the consistency gate ------------------------------------------------------------


@pytest.mark.parametrize("rounds,kw", [
    ([([5], [0.9]), ([6], [0.9]), ([5], [0.9])], dict(required=3, neighborhood=3)),
    ([([5], [0.9]), ([], []), ([5], [0.9])], {}),
    ([([5], [0.9]), ([30], [0.9]), ([5], [0.9])], dict(required=3, neighborhood=3)),
    ([([5, 20], [0.5, 0.6]), ([5, 20], [0.5, 0.6]), ([5, 20], [0.5, 0.9])], dict(required=3, neighborhood=3)),
    ([([5, -1], [0.5, 0.1]), ([4, 60], [0.5, 0.7]), ([12, 61], [0.2, 0.1]), ([60, 3], [0.3, 0.3]),
      ([], []), ([50], [0.4])], {}),
])
def test_consistency_gate(rounds, kw):
    """`tests/test_loop_hardening.py`'s cases and a longer mixed stream:
    the same choices and history, round by round."""
    got, ref = tloop.ConsistencyGate(**kw), jloop.ConsistencyGate(**kw)
    for cands, scores in rounds:
        assert got.update(cands, scores) == ref.update(cands, scores)
        assert got.history == ref.history


# -- detection, verification and correction on rendered frames ---------------------------


CFG = TrackingConfig(orb=OrbConfig(num_features=400))


@pytest.fixture(scope="module")
def loop_scene():
    """`tests/test_loop_integration.py`'s scene: keyframe 0 at the origin,
    keyframes 1-14 sweeping away, snapshotted into both packages' stores."""
    room = make_room(device="cpu")

    def frame_at(T_cw):
        g, d = render_frame(room, T_cw, CFG.intr)
        f = process_frame(g, d, CFG)
        return f, backproject(f.feats.xy, f.depth, CFG.intr), f.depth > 0

    jls, tls = jloop.empty_loop_state(kmax=32), tloop.empty_loop_state(kmax=32, device="cpu")
    poses = [np.asarray(jlie.exp_se3(jnp.asarray([0.12 * k, 0, 0, 0, 0.05 * k, 0], jnp.float32)))
             for k in range(15)]
    for P in poses:
        f, pts, ok = frame_at(P)
        args = (f.feats.desc_pm, f.feats.valid, pts, ok, f.feats.xy, f.feats.octave)
        jls = jloop.snapshot_keyframe(jls, *(jnp.asarray(a.numpy()) for a in args))
        tls = tloop.snapshot_keyframe(tls, *args)
    return frame_at, jls, tls, poses


def _both_detect(loop_scene, T_cur, seed, **kw):
    frame_at, jls, tls, _ = loop_scene
    f, pts, ok = frame_at(T_cur)
    args = (f.feats.desc_pm, f.feats.valid, pts, ok)
    key = jax.random.PRNGKey(seed)
    ref = jloop.detect_loop(jls, *(jnp.asarray(a.numpy()) for a in args), key, intr=JINTR_CFG,
                            xy=jnp.asarray(f.feats.xy.numpy()), octave=jnp.asarray(f.feats.octave.numpy()), **kw)
    got = tloop.detect_loop(tls, *args, None, CFG.intr, f.feats.xy, f.feats.octave,
                            draw=jax_draws(key, jax.random.fold_in(key, 1)), **kw)
    return got, ref


JINTR_CFG = JIntrinsics(*(jnp.float32(v) for v in CFG.intr))


def _same_detection(got, ref):
    """Equal decisions and counts; the transforms where a loop was found
    (a refused candidate's few-inlier fit is ill-conditioned)."""
    assert bool(got.found) == bool(ref.found)
    assert int(got.match_kf) == int(ref.match_kf)
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(float(got.score), float(ref.score), rtol=1e-5)
    if bool(ref.found):
        np.testing.assert_allclose(got.T_cur_match.numpy(), np.asarray(ref.T_cur_match), atol=1e-3)


def test_detect_loop_revisit(loop_scene):
    T_cur = np.asarray(jlie.exp_se3(jnp.asarray([0.05, 0.02, 0.03, 0.0, 0.03, 0.0])))
    got, ref = _both_detect(loop_scene, T_cur, 0, exclude_recent=10)
    _same_detection(got, ref)
    assert bool(got.found)
    mk = int(got.match_kf)
    expected = T_cur @ np.linalg.inv(loop_scene[3][mk])
    np.testing.assert_allclose(got.T_cur_match.numpy(), expected, atol=0.03)


def test_detect_loop_new_view(loop_scene):
    T_cur = np.asarray(jlie.exp_se3(jnp.asarray([0, 0, 0, 0, 2.6, 0], jnp.float32)))
    got, ref = _both_detect(loop_scene, T_cur, 1)
    _same_detection(got, ref)
    assert not bool(got.found)


def test_verify_loop_decoy_and_true(rng):
    """`tests/test_loop_hardening.py`'s decoy: same descriptors, unrelated
    geometry, refused; the rigidly moved revisit accepted."""
    rng = np.random.default_rng(3)
    F = 128
    desc = rng.choice([-1, 1], size=(F, 256)).astype(np.int8)
    xyz = rng.uniform(-2, 2, size=(F, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(3.0, 12.0, size=F)
    decoy = rng.uniform(-2, 2, size=(F, 3)).astype(np.float32)
    decoy[:, 2] = rng.uniform(3.0, 12.0, size=F)
    th = 0.1
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    true = xyz @ R.T + np.array([0.3, -0.1, 0.5], np.float32)
    ok = np.ones(F, bool)
    zo = np.zeros(F, np.int32)

    def uv(p):
        return project(T(p), INTR)[0].numpy()

    jls = jloop.snapshot_keyframe(jloop.empty_loop_state(kmax=8, snap=F), *(jnp.asarray(a) for a in (
        desc, ok, xyz, ok, uv(xyz), zo)))
    tls = tloop.snapshot_keyframe(tloop.empty_loop_state(kmax=8, snap=F, device="cpu"), *(T(a) for a in (
        desc, ok, xyz, ok, uv(xyz), zo)))
    key = jax.random.PRNGKey(0)
    for pts, expect in ((decoy, False), (true, True)):
        ref = jloop.verify_loop(jls, jnp.int32(0), jnp.asarray(desc), jnp.asarray(ok), jnp.asarray(pts),
                                jnp.asarray(ok), key, intr=JINTR, xy=jnp.asarray(uv(pts)), octave=jnp.asarray(zo))
        got = tloop.verify_loop(tls, 0, T(desc), T(ok), T(pts), T(ok), None, INTR, T(uv(pts)), T(zo),
                                draw=jax_draws(key, jax.random.fold_in(key, 1)))
        assert bool(got.found) == bool(ref.found) == expect
        assert int(got.num_inliers) == int(ref.num_inliers)
        if expect:
            np.testing.assert_allclose(got.T_cur_match.numpy(), np.asarray(ref.T_cur_match), atol=1e-3)
            np.testing.assert_allclose(got.T_cur_match.numpy()[:3, :3], R, atol=2e-2)


def test_correct_loop_pulls_drifted_chain():
    """`tests/test_loop_integration.py`'s drifted chain: the pose graph
    pulls the last keyframe to the truth and the points anchored at
    keyframe 3 move with it, as in the reference."""
    K = 16
    gt = [np.asarray(jlie.exp_se3(jnp.asarray([0.5 * np.sin(2 * np.pi * k / K), 0, 0.5 * (1 - np.cos(2 * np.pi * k / K)),
                                               0, 0, 0], jnp.float32))) for k in range(K)]
    jm = jmap.empty_map(kmax=32, nmax=256, emax=1024)
    for k in range(K):
        drift = np.asarray(jlie.exp_se3(jnp.asarray([0.02 * k, 0.01 * k, 0, 0, 0, 0], jnp.float32)))
        jm, _ = jmap.add_keyframe(jm, jnp.asarray(drift @ gt[k]))
    pts = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (8, 3)), jnp.float32)
    jm, ids = jmap.add_points(jm, pts, jnp.zeros((8, 256), jnp.int8), jnp.zeros(8, jnp.int32),
                              jnp.zeros((8, 3)), jnp.ones(8, bool))
    jm = jmap.add_observations(jm, jnp.int32(3), ids, jnp.zeros((8, 2)), jnp.full(8, -1.0),
                               jnp.zeros(8, jnp.int32))
    T_rel = np.asarray(gt[K - 1] @ np.linalg.inv(gt[0]), np.float32)
    jdet = jloop.LoopDetection(found=jnp.asarray(True), match_kf=jnp.int32(0), T_cur_match=jnp.asarray(T_rel),
                               num_inliers=jnp.int32(50), score=jnp.asarray(0.9))
    ref, _ = jloop.correct_loop(jm, empty_objects(8), jnp.int32(K - 1), jdet)
    m = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}, device="cpu")
    det = tloop.LoopDetection(found=torch.tensor(True), match_kf=torch.tensor(0, dtype=torch.int32),
                              T_cur_match=T(T_rel), num_inliers=torch.tensor(50), score=torch.tensor(0.9))
    got, _ = tloop.correct_loop(m, tobjects.empty_objects(8, device="cpu"), K - 1, det)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(ref.pt_xyz), atol=1e-4)
    err_before = np.linalg.norm(m.kf_Tcw[K - 1].numpy()[:3, 3] - gt[K - 1][:3, 3])
    err_after = np.linalg.norm(got.kf_Tcw[K - 1].numpy()[:3, 3] - gt[K - 1][:3, 3])
    assert err_after < 0.3 * err_before
    assert np.abs(got.pt_xyz[:8].numpy() - m.pt_xyz[:8].numpy()).max() > 1e-4


def test_loop_closing_runs_in_the_system(monkeypatch):
    """`enable_loop_closing` (on by default) builds a system whose
    keyframes from 12 on query the place database and feed the gate; a
    consistent candidate goes to verification with 40 inliers required
    and a generator seeded from 77 + keyframe id; a found loop is
    corrected, globally adjusted and counted."""
    from qsp_slam_tpu_torch.slam import system as system_mod

    sysm = SlamSystem(CFG, kmax=16, nmax=64, emax=256, device="cpu")
    assert sysm.enable_loop_closing and sysm.summary()["loops_closed"] == 0
    calls = []

    def fake_verify(ls, cand, desc, valid, pts, ok, gen, min_inliers=None, **kw):
        calls.append((cand, gen.initial_seed(), min_inliers))
        return tloop.LoopDetection(torch.tensor(True), torch.tensor(cand, dtype=torch.int32), torch.eye(4),
                                   torch.tensor(55), torch.tensor(0.0))

    monkeypatch.setattr(system_mod, "verify_loop", fake_verify)
    monkeypatch.setattr(system_mod, "correct_loop",
                        lambda m, objs, kf, det, **kw: calls.append(("corr", kf)) or (m, objs))
    monkeypatch.setattr(system_mod, "global_ba_step", lambda m, cfg, iters: calls.append("gba") or m)
    rng = np.random.default_rng(0)
    place_a, place_b = (process_frame(torch.from_numpy(rng.integers(0, 255, (480, 640)).astype(np.float32)),
                                      torch.full((480, 640), 2.0), CFG) for _ in range(2))
    # Keyframes 0-3 and 12-15 see place A, keyframes 4-11 place B.
    for kf in range(16):
        sysm._loop_closing(place_b if 4 <= kf < 12 else place_a, kf)
    scan = sysm.stats["loop_scan"]
    assert [row[0] for row in scan] == [12, 13, 14, 15]
    assert [row[4] for row in scan][:2] == [-1, -1] and scan[2][4] in (0, 1, 2, 3) and scan[3][4] == -1
    assert calls == [(scan[2][4], 77 + 14, 40), ("corr", 14), "gba"]
    assert sysm.loops_closed == 1 and sysm.stats["loop_events"] == [(14, scan[2][4], 55)]
    assert sysm.summary()["loops_closed"] == 1

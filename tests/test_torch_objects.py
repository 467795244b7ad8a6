"""Parity of the port's monocular object path with the JAX package on the
CPU: quadric and plane algebra, the quadric factors, ground-plane RANSAC,
the aspect-prior initialization and refinement, the object table, the
renderer's detector, the saved maps, and the system and command line with
detections.

Same seeded numpy inputs go through the JAX function and the port's; the
RANSAC draws are the reference's `jax.random.uniform` numbers for the
same key, fed to the port through `draw`.  Tolerances: masks, labels,
slots, counters and associations exact; f32 geometry 1e-4 (1e-3 relative
through a conic); the LM refinements 1e-3 (twelve damped Gauss-Newton
trips in f32 whose accept decisions compare costs); the 12-frame run:
the same keyframes, objects, slots and labels, the ground plane within
1e-3 and the ellipsoids within 0.02 gauge units (the refinement amplifies
the trajectory's 1e-4 differences through the box residuals).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import plane as jplane
from qsp_slam_tpu.core import quadric as jq
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.data import io as jio
from qsp_slam_tpu.data import render as jrender
from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from qsp_slam_tpu.opt import quadric_factors as jqf
from qsp_slam_tpu.perception import groundplane as jgp
from qsp_slam_tpu.perception import prior_infer as jpi
from qsp_slam_tpu.slam import objects as jobj
from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu_torch import convert
from qsp_slam_tpu_torch.core import plane as tplane
from qsp_slam_tpu_torch.core import quadric as tq
from qsp_slam_tpu_torch.core.camera import Intrinsics, intrinsic_matrix
from qsp_slam_tpu_torch.data import io as tio
from qsp_slam_tpu_torch.data import render as trender
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.opt import quadric_factors as tqf
from qsp_slam_tpu_torch.perception import groundplane as tgp
from qsp_slam_tpu_torch.perception import prior_infer as tpi
from qsp_slam_tpu_torch.slam import mono as tmono
from qsp_slam_tpu_torch.slam import objects as tobj
from qsp_slam_tpu_torch.slam import system as system_mod
from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)

INTR = Intrinsics(*(float(np.float32(v)) for v in (520.9, 521.0, 325.1, 249.7)))
JINTR = JIntrinsics(*(jnp.float32(v) for v in INTR))
K = np.asarray(JINTR.K)
F = 600
CFG = TrackingConfig(orb=OrbConfig(num_features=F))
JCFG = JTrackingConfig(orb=JOrbConfig(num_features=F))
N_FRAMES = 12


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_plane_draw(gen, num_hyp):
    """The reference's ground-plane draws for PRNGKey(generator seed)."""
    key = jax.random.PRNGKey(gen.initial_seed())
    return (T(jax.random.uniform(key, (num_hyp, 3))),
            T(jax.random.uniform(jax.random.fold_in(key, 1), (num_hyp,))))


def jax_two_view_draw(valid, gen, num_hyp):
    kE, kH = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
    v = jnp.asarray(valid.numpy())
    p = v.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return (T(jax.random.choice(kE, v.shape[0], shape=(num_hyp, 8), p=p)),
            T(jax.random.choice(kH, v.shape[0], shape=(num_hyp, 4), p=p)))


def random_ellipsoids(rng, n):
    e = np.concatenate([rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3)), rng.uniform(-0.6, 0.6, (n, 3)),
                        rng.uniform(0.1, 0.6, (n, 3))], -1)
    return e.astype(np.float32)


def random_pose(rng, scale=0.3):
    from qsp_slam_tpu.core import lie as jlie

    return np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, scale, 6), jnp.float32)))


# -- algebra -------------------------------------------------------------------


def test_quadric_algebra(rng):
    """Every function of core/quadric against the reference, 1e-4 (the
    conic and its box 1e-3 relative); masks exact."""
    e = random_ellipsoids(rng, 32)
    e2 = random_ellipsoids(rng, 32)
    Tcw = random_pose(rng)
    Tsim = Tcw.copy()
    Tsim[:3] *= np.float32(1.3)
    Tsim[3] = [0, 0, 0, 1]
    je, te = jnp.asarray(e), T(e)
    Kt = intrinsic_matrix(INTR)
    P = K @ Tcw[:3]

    def close(got, ref, tol=1e-4, rtol=1e-5):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=rtol)

    close(tq.euler_to_rotmat(te[:, 3:6]), jq.euler_to_rotmat(je[:, 3:6]))
    close(tq.rotmat_to_euler(tq.euler_to_rotmat(te[:, 3:6])), jq.rotmat_to_euler(jq.euler_to_rotmat(je[:, 3:6])))
    close(tq.pose_of(te), jq.pose_of(je))
    close(tq.from_pose_scale(tq.pose_of(te), te[:, 6:]), jq.from_pose_scale(jq.pose_of(je), je[:, 6:]))
    close(tq.similarity_transform(te), jq.similarity_transform(je))
    close(tq.dual_quadric(te), jq.dual_quadric(je), rtol=1e-4)
    for M in (Tcw, Tsim):
        close(tq.transform_ellipsoid(te, T(M)), jq.transform_ellipsoid(je, jnp.asarray(M)))
    C_ref = jq.project_to_conic(je, jnp.asarray(P))
    C = tq.project_to_conic(te, T(P))
    close(C, C_ref, tol=1e-3, rtol=1e-3)
    close(tq.conic_center(C), jq.conic_center(C_ref), tol=1e-2, rtol=1e-4)
    np.testing.assert_array_equal(tq.is_ellipse(C).numpy(), np.asarray(jq.is_ellipse(C_ref)))
    close(tq.conic_bbox(T(np.asarray(C_ref))), jq.conic_bbox(C_ref), tol=1e-3, rtol=1e-5)
    close(tq.project_bbox(te, T(Tcw), Kt), jq.project_bbox(je, jnp.asarray(Tcw), jnp.asarray(K)), tol=1e-2,
          rtol=1e-4)
    np.testing.assert_array_equal(tq.check_observability(te, T(Tcw)[None]).numpy(),
                                  np.asarray(jq.check_observability(je, jnp.asarray(Tcw)[None])))
    boxes = np.sort(rng.uniform(0, 600, (32, 2, 2)), axis=1).transpose(0, 2, 1).reshape(32, 4).astype(np.float32)
    boxes = boxes[:, [0, 2, 1, 3]]
    close(tq.bbox_iou(T(boxes)[:, None], T(boxes)[None]),
          jq.bbox_iou(jnp.asarray(boxes)[:, None], jnp.asarray(boxes)[None]), tol=1e-6)
    close(tq.ellipsoid_log_error(te, T(e2)), jq.ellipsoid_log_error(je, jnp.asarray(e2)))
    yaw = rng.uniform(-3, 3, 32).astype(np.float32)
    close(tq.rotate_about_z(te, T(yaw)), jq.rotate_about_z(je, jnp.asarray(yaw)))
    close(tq.center_distance_2d(te, T(e2)), jq.center_distance_2d(je, jnp.asarray(e2)))


def test_plane_algebra(rng):
    pi = rng.normal(size=(16, 4)).astype(np.float32)
    pts = rng.normal(size=(16, 20, 3)).astype(np.float32)
    Tm = random_pose(rng)
    n, p = rng.normal(size=(16, 3)).astype(np.float32), rng.normal(size=(16, 3)).astype(np.float32)
    for got, ref in (
        (tplane.normalize(T(pi)), jplane.normalize(jnp.asarray(pi))),
        (tplane.from_normal_point(T(n), T(p)), jplane.from_normal_point(jnp.asarray(n), jnp.asarray(p))),
        (tplane.point_distance(T(pi), T(pts)), jplane.point_distance(jnp.asarray(pi), jnp.asarray(pts))),
        (tplane.transform(T(pi), T(Tm)), jplane.transform(jnp.asarray(pi), jnp.asarray(Tm))),
        (tplane.angle_between(T(pi), T(pi[::-1].copy())), jplane.angle_between(jnp.asarray(pi),
                                                                                jnp.asarray(pi[::-1].copy()))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)


# -- factors and priors ------------------------------------------------------------


def _histories(rng, O, M=16):
    """Objects seen from several poses around the origin, with noisy boxes
    (some on the image border) and empty slots."""
    e = random_ellipsoids(rng, O)
    # Upright on GROUND_W (y = 1.2, y down): the z axis along -y, the
    # bottom on the plane.
    e[:, 3] = np.pi / 2 + rng.normal(0, 0.05, O)
    e[:, 4] = rng.normal(0, 0.05, O)
    e[:, 1] = 1.2 - e[:, 8]
    Tcw = np.stack([[random_pose(rng, 0.1) for _ in range(M)] for _ in range(O)]).astype(np.float32)
    box = np.asarray(jax.vmap(lambda ee, Ts: jax.vmap(lambda Tt: jq.project_bbox(ee, Tt, jnp.asarray(K)))(Ts))(
        jnp.asarray(e), jnp.asarray(Tcw)))
    box = np.clip(box + rng.normal(0, 3, box.shape), 0, [639, 479, 639, 479]).astype(np.float32)
    w = np.where(rng.random((O, M)) < 0.6, rng.uniform(0.5, 1.0, (O, M)), 0.0).astype(np.float32)
    w[0, 2:] = 0.0  # one object with two observations
    e0 = e.copy()
    e0[:, :3] += rng.normal(0, 0.05, (O, 3))
    e0[:, 6:] *= rng.uniform(0.8, 1.25, (O, 3))
    return e0.astype(np.float32), Tcw, box, w


GROUND_W = np.asarray([0.02, -0.999, 0.01, 1.2], np.float32)


def test_quadric_factors_and_refine_object(rng):
    """The residual pieces 1e-4 (the box residual 1e-3 relative), the
    border mask exact, and the LM of `refine_object` over a batch of
    objects against the reference's vmap: costs 1e-2 relative, ellipsoids
    0.02 (the weight-100 priors against 10 px box sigmas leave the normal
    equations near 1e6 in condition, so f32 steps part at that level)."""
    e0, Tcw, box, w = _histories(rng, 6)
    np.testing.assert_array_equal(tqf.border_edge_mask(T(box), (640, 480)).numpy(),
                                  np.asarray(jqf.border_edge_mask(jnp.asarray(box), (640, 480))))
    np.testing.assert_allclose(
        tqf.bbox_residual(T(e0)[:, None], T(Tcw), T(K), T(box)).numpy(),
        np.asarray(jax.vmap(lambda ee, Ts, bs: jax.vmap(lambda Tt, b: jqf.bbox_residual(ee, Tt, jnp.asarray(K), b))(
            Ts, bs))(jnp.asarray(e0), jnp.asarray(Tcw), jnp.asarray(box))), atol=1e-2, rtol=1e-3)
    up = -GROUND_W[:3]
    np.testing.assert_allclose(tqf.gravity_residual(T(e0), T(up)).numpy(),
                               np.asarray(jax.vmap(lambda ee: jqf.gravity_residual(ee, jnp.asarray(up)))(
                                   jnp.asarray(e0))), atol=1e-5)
    np.testing.assert_allclose(tqf.support_residual(T(e0), T(GROUND_W)).numpy(),
                               np.asarray(jax.vmap(lambda ee: jqf.support_residual(ee, jnp.asarray(GROUND_W)))(
                                   jnp.asarray(e0))), atol=1e-5)
    obs = tqf.ObjectObservations(T(Tcw), T(box), T(w))
    got, cost = tqf.refine_object(T(e0), obs, T(K), T(GROUND_W), img_wh=(640, 480))
    ref, rcost = jax.vmap(lambda ee, Ts, bs, ww: jqf.refine_object(
        ee, jqf.ObjectObservations(Ts, bs, ww), jnp.asarray(K), jnp.asarray(GROUND_W), img_wh=(640, 480)))(
        *(jnp.asarray(x) for x in (e0, Tcw, box, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.02)
    np.testing.assert_allclose(cost.numpy(), np.asarray(rcost), rtol=1e-2)


def test_generate_init_guess(rng):
    """tests/test_mono_objects.py's footprint case on the port, and a batch
    of boxes against the reference's vmap, 1e-4."""
    intr = Intrinsics(500.0, 500.0, 320.0, 240.0)
    e = tpi.generate_init_guess(T(np.array([[280.0, 240.0, 360.0, 440.0]], np.float32)),
                                T(np.array([0.0, -1.0, 0.0, 1.2], np.float32)), intr, torch.ones(1), torch.ones(1))[0]
    assert abs(float(e[2]) - 3.0) < 0.15 and abs(float(e[1]) - 0.6) < 0.12 and abs(float(e[8]) - 0.6) < 0.1
    assert abs(float(e[1] + e[8]) - 1.2) < 0.1
    boxes = np.sort(rng.uniform(0, 480, (20, 2, 2)), axis=1).transpose(0, 2, 1).reshape(20, 4)[:, [0, 2, 1, 3]]
    boxes = boxes.astype(np.float32)
    plane_c = np.asarray([0.05, -0.95, -0.3, 1.1], np.float32)
    ad, ae = rng.uniform(0.5, 2, 20).astype(np.float32), rng.uniform(0.5, 2, 20).astype(np.float32)
    got = tpi.generate_init_guess(T(boxes), T(plane_c), INTR, T(ad), T(ae))
    ref = jax.vmap(lambda b, a1, a2: jpi.generate_init_guess(b, jnp.asarray(plane_c), JINTR, a1, a2))(
        jnp.asarray(boxes), jnp.asarray(ad), jnp.asarray(ae))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    d = tpi.default_priors(device="cpu")
    assert d.d.shape == (16,) and bool((d.d == 1).all() and (d.e == 1).all())


def test_refine_with_priors(rng):
    """The aspect-prior LM over a batch of objects against the reference's
    vmap, 1e-3 (12 trips whose accept tests compare f32 costs)."""
    e0, Tcw, box, w = _histories(rng, 6)
    ad, ae = rng.uniform(0.7, 1.4, 6).astype(np.float32), rng.uniform(0.7, 1.4, 6).astype(np.float32)
    obs = tqf.ObjectObservations(T(Tcw), T(box), T(w))
    got, cost = tpi.refine_with_priors(T(e0), obs, T(K), T(GROUND_W), T(ad), T(ae), img_wh=(640, 480))
    ref, rcost = jax.vmap(lambda ee, Ts, bs, ww, a1, a2: jpi.refine_with_priors(
        ee, jqf.ObjectObservations(Ts, bs, ww), jnp.asarray(K), jnp.asarray(GROUND_W), a1, a2, img_wh=(640, 480)))(
        *(jnp.asarray(x) for x in (e0, Tcw, box, w, ad, ae)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(cost.numpy(), np.asarray(rcost), rtol=1e-3, atol=1e-3)
    assert np.abs(got.numpy() - e0).max() > 1e-2  # it moved


# -- ground plane --------------------------------------------------------------


def _room_cloud(rng, n=1500):
    """A sparse cloud like a monocular map's: floor (y = 1.2, the camera's
    up is -y), walls, objects, outliers; a third invalid."""
    floor = np.c_[rng.uniform(-3, 3, n // 5), 1.2 + rng.normal(0, 0.005, n // 5), rng.uniform(1, 6, n // 5)]
    wall = np.c_[rng.uniform(-3, 3, n // 2), rng.uniform(-1.5, 1.2, n // 2), 6.0 + rng.normal(0, 0.005, n // 2)]
    rest = rng.uniform([-3, -1.5, 1], [3, 1.2, 6], (n - n // 5 - n // 2, 3))
    pts = np.concatenate([floor, wall, rest]).astype(np.float32)
    valid = rng.random(len(pts)) < 0.7
    return pts, valid


@pytest.mark.parametrize("hint", [False, True])
def test_ransac_plane(rng, hint):
    """On the reference's draws: the plane 1e-4, the inlier count exact;
    both the plain and the ground-hint branches."""
    pts, valid = _room_cloud(rng)
    key = jax.random.PRNGKey(7)
    kw = dict(normal_hint=jnp.asarray([0.0, -1.0, 0.0]), hint_cos_min=0.7, below_frac=0.05) if hint else {}
    ref_pi, ref_n = jgp.ransac_plane(jnp.asarray(pts), jnp.asarray(valid), key, inlier_th=0.02, **kw)
    tkw = dict(normal_hint=torch.tensor([0.0, -1.0, 0.0]), hint_cos_min=0.7, below_frac=0.05) if hint else {}
    pi, n_inl = tgp.ransac_plane(T(pts), T(valid), torch.Generator().manual_seed(7), inlier_th=0.02,
                                 draw=jax_plane_draw, **tkw)
    assert int(n_inl) == int(ref_n) > 100
    np.testing.assert_allclose(pi.numpy(), np.asarray(ref_pi), atol=1e-4)


def test_ground_plane_estimates(rng):
    """`adaptive_inlier_th` and `estimate_ground_plane_points` on a
    monocular-map-like cloud; `depth_to_cloud` and `estimate_ground_plane`
    on a rendered depth image: 1e-4, counts and `ok` exact."""
    pts, valid = _room_cloud(rng)
    np.testing.assert_allclose(float(tgp.adaptive_inlier_th(T(pts), T(valid))),
                               float(jgp.adaptive_inlier_th(jnp.asarray(pts), jnp.asarray(valid))), rtol=1e-6)
    ref = jgp.estimate_ground_plane_points(jnp.asarray(pts), jnp.asarray(valid), jax.random.PRNGKey(403),
                                           min_inlier_frac=0.04)
    got = tgp.estimate_ground_plane_points(T(pts), T(valid), torch.Generator().manual_seed(403),
                                           min_inlier_frac=0.04, draw=jax_plane_draw)
    assert bool(got.ok) == bool(ref.ok) and int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(got.plane.numpy(), np.asarray(ref.plane), atol=1e-4)
    assert got.plane[1] < -0.9  # the floor, normal up
    room = trender.make_room(device="cpu")
    Tcw = trender.orbit_trajectory(1, pitch=0.4)[0]
    depth = trender.render_frame(room, Tcw, INTR)[1].numpy()
    for g, r in zip(tgp.depth_to_cloud(T(depth), INTR), jgp.depth_to_cloud(jnp.asarray(depth), JINTR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    ref = jgp.estimate_ground_plane(jnp.asarray(depth), JINTR, jax.random.PRNGKey(2))
    got = tgp.estimate_ground_plane(T(depth), INTR, torch.Generator().manual_seed(2), draw=jax_plane_draw)
    assert bool(got.ok) == bool(ref.ok) and int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(got.plane.numpy(), np.asarray(ref.plane), atol=1e-4)


# -- the object table ----------------------------------------------------------


def _jtable(t) -> jobj.ObjectTable:
    return jobj.ObjectTable(**{k: jnp.asarray(v.numpy()) for k, v in t._asdict().items()})


def assert_table(got, ref, atol=1e-5):
    for name in tobj.ObjectTable._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=atol, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_empty_objects_match():
    assert_table(tobj.empty_objects(8, device="cpu"), jobj.empty_objects(8))


def test_associate_and_integrate_keyframes(rng):
    """Three keyframes of detections folded into a 5-slot table: association
    (IoU and label gates, one claimant per object), new objects in the first
    free slot in detection order, rings past their capacity, motion votes
    that make an object dynamic, advance, cull and merge: all exact (floats
    1e-5, IoUs 1e-4) against the reference."""
    O = 5
    table = tobj.empty_objects(O, obs_per_object=4, device="cpu")
    jt = jobj.empty_objects(O, obs_per_object=4)
    truth = random_ellipsoids(rng, 3)
    truth[:, 3:6] = 0.0
    Kt, jK = T(K), jnp.asarray(K)
    for kf in range(6):
        Tcw = random_pose(rng, 0.05)
        e_cam = np.array(jq.transform_ellipsoid(jnp.asarray(truth), jnp.asarray(Tcw)))
        if kf >= 3:
            e_cam[2, 2] += 0.4 * (kf - 2)  # object 2 recedes: votes, then dynamic
        e_cam = np.concatenate([e_cam, e_cam[:1] + 0.01]).astype(np.float32)  # a duplicate detection
        box = np.asarray(jq.project_bbox(jnp.asarray(e_cam), jnp.eye(4), jK))
        label = np.asarray([0, 1, 2, 0], np.int32) if kf != 4 else np.asarray([0, -1, 2, 0], np.int32)
        prob = rng.uniform(0.5, 1.0, 4).astype(np.float32)
        dvalid = np.asarray([True, True, True, kf % 2 == 0])
        fit_ok = dvalid & np.asarray([True, True, kf != 5, True])
        jt = jobj.advance_dynamic_objects(jt, jnp.int32(kf))
        table = tobj.advance_dynamic_objects(table, kf)
        ja = jobj.associate_detections(jt, jnp.asarray(Tcw), jK, jnp.asarray(box), jnp.asarray(label),
                                       jnp.asarray(dvalid))
        ta = tobj.associate_detections(table, T(Tcw), Kt, T(box), T(label), T(dvalid))
        np.testing.assert_array_equal(ta.obj_for_det.numpy(), np.asarray(ja.obj_for_det))
        np.testing.assert_allclose(ta.iou.numpy(), np.asarray(ja.iou), atol=1e-4)  # through the conic
        jt = jobj.integrate_keyframe(jt, jnp.asarray(Tcw), jnp.asarray(box), jnp.asarray(label), jnp.asarray(prob),
                                     jnp.asarray(dvalid), jnp.asarray(e_cam), jnp.asarray(fit_ok), ja,
                                     kf_id=jnp.int32(kf))
        table = tobj.integrate_keyframe(table, T(Tcw), T(box), T(label), T(prob), T(dvalid), T(e_cam), T(fit_ok),
                                        ta, kf_id=kf)
        assert_table(table, jt)
        jt, table = jobj.merge_duplicates(jt), tobj.merge_duplicates(table)
        jt, table = jobj.cull_objects(jt, jnp.int32(kf + 6)), tobj.cull_objects(table, kf + 6)
        assert_table(table, jt)
    assert bool(table.dynamic.any()) and int(table.obs_next.max()) > 4  # votes fired, a ring wrapped
    assert int(table.num_objects) >= 3


def test_refine_objects_mono(rng):
    """The whole table refined in one batched LM: live static objects with
    two or more observations move, the rest keep their ellipsoid; 1e-3."""
    e0, Tcw, box, w = _histories(rng, 6)
    t = tobj.empty_objects(8, device="cpu")
    t = t._replace(ellipsoid=torch.cat([T(e0), torch.zeros(2, 9)]),
                   obs_Tcw=torch.cat([T(Tcw), t.obs_Tcw[6:]]), obs_bbox=torch.cat([T(box), t.obs_bbox[6:]]),
                   obs_weight=torch.cat([T(w), t.obs_weight[6:]]),
                   valid=T([True, True, True, True, False, True, False, False]),
                   dynamic=T([False, False, True, False, False, False, False, False]),
                   label=T(np.asarray([0, 3, 1, 20, 2, 1, -1, -1], np.int32)))
    d = rng.uniform(0.7, 1.4, 16).astype(np.float32)
    e = rng.uniform(0.7, 1.4, 16).astype(np.float32)
    got = tobj.refine_objects_mono(t, T(K), T(GROUND_W), T(d), T(e), img_wh=(640, 480))
    ref = jobj.refine_objects_mono(_jtable(t), jnp.asarray(K), jnp.asarray(GROUND_W), jnp.asarray(d),
                                   jnp.asarray(e), img_wh=(640, 480))
    np.testing.assert_allclose(got.ellipsoid.numpy(), np.asarray(ref.ellipsoid), atol=1e-3, rtol=1e-3)
    moved = np.abs(got.ellipsoid.numpy() - t.ellipsoid.numpy()).max(axis=1) > 0
    np.testing.assert_array_equal(moved, [True, True, False, True, False, True, False, False])


# -- renderer, maps, checkpoints -------------------------------------------------------


def test_gt_detections_and_scene(rng):
    """The renderer's detector on the reference's scene: boxes 1e-2 px,
    labels, validity and instance masks exact; table slabs still refuse."""
    jscene = jrender.make_scene(num_objects=3, seed=2)
    scene = trender.make_scene(num_objects=3, seed=2, device="cpu")
    traj = trender.orbit_trajectory(12, step=0.025, pitch=0.4)
    inst = torch.from_numpy(rng.integers(-1, 3, (480, 640)).astype(np.int32))
    for i in (0, 11):
        ref = jrender.gt_detections(jscene, jnp.asarray(traj[i]), JINTR, instance=jnp.asarray(inst.numpy()))
        got = trender.gt_detections(scene, traj[i], INTR, instance=inst)
        np.testing.assert_allclose(got["bbox"].numpy(), np.asarray(ref["bbox"]), atol=1e-2)
        for k in ("label", "valid", "prob", "mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        assert int(got["valid"].sum()) >= 1
    jt = jrender.make_scene(num_objects=3, seed=2, num_tables=1, table_height=0.7)
    t = trender.make_scene(num_objects=3, seed=2, num_tables=1, table_height=0.7, device="cpu")
    for name in ("ellipsoids", "labels", "albedo", "slabs", "slab_albedo"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jt, name)), err_msg=name)


def test_save_map_and_export_with_objects(tmp_path, rng):
    """The map file and the text export with an object table carry the
    reference's keys and values."""
    from qsp_slam_tpu.slam import map as jmap

    jm = jmap.empty_map(kmax=4, nmax=16, emax=32)
    jm, _ = jmap.add_keyframe(jm, jnp.eye(4))
    jt = jobj.empty_objects(4)
    jt = jt._replace(ellipsoid=jt.ellipsoid.at[:2].set(jnp.asarray(random_ellipsoids(rng, 2))),
                     valid=jt.valid.at[:2].set(True), label=jt.label.at[:2].set(jnp.asarray([2, 0])))
    m = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}, device="cpu")
    t = convert.object_table_from_numpy({k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    tio.save_map(str(tmp_path / "t.npz"), m, objects=t, codes=np.ones((2, 3), np.float32))
    jio.save_map(str(tmp_path / "j.npz"), jm, objects=jt, codes=np.ones((2, 3), np.float32))
    got, ref = tio.load_map(str(tmp_path / "t.npz")), jio.load_map(str(tmp_path / "j.npz"))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    tio.export_map_txt(str(tmp_path / "t"), m, objects=t)
    jio.export_map_txt(str(tmp_path / "j"), jm, objects=jt)
    assert (tmp_path / "t" / "MapObjects.txt").read_text() == (tmp_path / "j" / "MapObjects.txt").read_text()


# -- the system and the command line -------------------------------------------------


@pytest.fixture(scope="module")
def scene_frames():
    """tests/test_mono_objects.py's scene and orbit: rendered gray frames and
    the renderer's detections, from the reference package."""
    scene = jrender.make_scene(num_objects=3, seed=2)
    traj = jrender.orbit_trajectory(N_FRAMES, step=0.025, pitch=0.4)
    out = []
    for i in range(N_FRAMES):
        g, _, _ = jrender.render_scene(scene, jnp.asarray(traj[i]), JINTR)
        det = jrender.gt_detections(scene, jnp.asarray(traj[i]), JINTR)
        out.append((np.asarray(g), {k: np.asarray(v) for k, v in det.items()}))
    return out


@pytest.fixture(scope="module")
def e2e(scene_frames):
    """Both packages through the object scene with detections, objects on,
    loop closing off, default capacities (the command line's, so the two
    share the reference's compiled programs); the port on the reference's
    two-view and ground-plane draws."""
    kw = dict(enable_loop_closing=False)
    js = JSlamSystem(JCFG, **kw)
    ts = SlamSystem(CFG, enable_objects=True, device="cpu", **kw)
    patches = {"mono_initialize": functools.partial(tmono.mono_initialize, draw=jax_two_view_draw),
               "estimate_ground_plane_points": functools.partial(tgp.estimate_ground_plane_points,
                                                                 draw=jax_plane_draw)}
    saved = {k: getattr(system_mod, k) for k in patches}
    try:
        for k, v in patches.items():
            setattr(system_mod, k, v)
        for g, d in scene_frames:
            js.track_mono(g, d)
            ts.track_mono(g, d)
    finally:
        for k, v in saved.items():
            setattr(system_mod, k, v)
    return js, ts


def test_track_mono_with_detections_matches_the_reference(e2e):
    js, ts = e2e
    assert ts.stats["kf_frames"] == js.stats["kf_frames"] and len(ts.stats["kf_frames"]) >= 4
    s, r = ts.summary(), js.summary()
    for key in ("keyframes", "num_points", "num_obs", "num_objects"):
        assert s[key] == r[key], key
    np.testing.assert_array_equal(ts.objects.valid.numpy(), np.asarray(js.objects.valid))
    np.testing.assert_array_equal(ts.objects.label.numpy(), np.asarray(js.objects.label))
    np.testing.assert_array_equal(ts.objects.obs_count.numpy(), np.asarray(js.objects.obs_count))
    assert s["num_objects"] >= 2 and set(ts.objects.label[ts.objects.valid].tolist()) <= {0, 1, 2}
    np.testing.assert_allclose(ts.ground_plane, js.ground_plane, atol=1e-3)
    assert ts._gp_inliers == js._gp_inliers
    valid = ts.objects.valid.numpy()
    np.testing.assert_allclose(ts.objects.ellipsoid.numpy()[valid], np.asarray(js.objects.ellipsoid)[valid],
                               atol=0.02)
    assert len(ts.stats["obj_ms"]) == len(ts.stats["kf_frames"]) - 2  # every monocular keyframe


def test_jax_object_session_resumes_in_the_port(e2e, tmp_path):
    """A JAX checkpoint of the object session: the table, the ground plane
    and the map come across as they are."""
    from qsp_slam_tpu.slam.checkpoint import save_checkpoint as jsave

    js, _ = e2e
    jsave(str(tmp_path / "j.npz"), js)
    port = SlamSystem(CFG, enable_objects=True, device="cpu")
    load_checkpoint(str(tmp_path / "j.npz"), port)
    assert_table(port.objects, js.objects, atol=0)
    np.testing.assert_array_equal(port.ground_plane, js.ground_plane)
    assert port.omax == 32 and port._sensor == "mono" and port.initialized
    np.testing.assert_array_equal(port._mono_ref.feats.xy.numpy(), np.asarray(js._mono_ref.feats.xy))


def test_make_tum_and_run_mono_with_detections(tmp_path):
    """`make_tum --objects 2 --detections` into `run_mono --detections` on 6
    frames: the port's fabricator writes the reference's detections (boxes
    1e-2 px) and both command lines on the reference's sequence give the
    same summary (the port on the reference's draws)."""
    from qsp_slam_tpu import run_mono as jrun
    from qsp_slam_tpu.data import make_tum as jmake
    from qsp_slam_tpu_torch import run_mono as trun
    from qsp_slam_tpu_torch.data import make_tum as tmake

    jdir, tdir = tmp_path / "j", tmp_path / "t"
    args = ["--frames", "6", "--objects", "2", "--detections", "--step", "0.025", "--pitch", "0.4", "--seed", "2"]
    jmake.main([str(jdir), *args])
    tmake.main([str(tdir), *args, "--cpu"])
    for i in (0, 5):
        ref, got = jio.load_detection_cache(str(jdir / f"detections/{i}.npz")), tio.load_detection_cache(
            str(tdir / f"detections/{i}.npz"))
        np.testing.assert_allclose(got["bbox"], ref["bbox"], atol=1e-2)
        for k in ("label", "valid", "prob"):
            np.testing.assert_array_equal(got[k], ref[k])
        assert (got["mask"] != ref["mask"]).mean() < 1e-3  # f32 renders differ on rare silhouette pixels
    (tmp_path / "c.yaml").write_text(f"ORBextractor.nFeatures: {F}\n")
    flags = ["--detections", str(jdir / "detections"), "--config", str(tmp_path / "c.yaml"), "--cpu"]
    ref = jrun.main([str(jdir), *flags])
    saved = {k: getattr(system_mod, k) for k in ("mono_initialize", "estimate_ground_plane_points")}
    try:
        system_mod.mono_initialize = functools.partial(tmono.mono_initialize, draw=jax_two_view_draw)
        system_mod.estimate_ground_plane_points = functools.partial(tgp.estimate_ground_plane_points,
                                                                    draw=jax_plane_draw)
        got = trun.main([str(jdir), *flags, "--save-dir", str(tmp_path / "out")])
    finally:
        for k, v in saved.items():
            setattr(system_mod, k, v)
    for key in ("frames", "keyframes", "num_points", "num_objects", "loops_closed"):
        assert got[key] == ref[key], key
    assert abs(got["ate_rmse_m_sim3"] - ref["ate_rmse_m_sim3"]) < 1e-3
    assert got["num_objects"] >= 1
    assert (tmp_path / "out" / "CameraTrajectory.txt").read_text().count("\n") == 6

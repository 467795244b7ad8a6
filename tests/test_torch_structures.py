"""Parity of the port's RGB-D object path with the JAX package on the CPU:
the depth ellipsoid fit, Manhattan planes, relations, symmetry, the
support-aware refinement, the table scenes, the object evaluation, the
RGB-D object step through `track_rgbd`, its checkpoints, `run_tum
--detections` and detect-online with the learned 2D detector; and the
object-table cases of the reference's object,
lifecycle and velocity tests.

The same seeded numpy inputs go through both packages; the reference's
`jax.random` draws for each key are fed to the port through `draw`.
Tolerances: pixel indices, masks, plane slots, votes, relation kinds,
labels and slots exact; f32 geometry 1e-4 (fits: 1e-4 on the ellipsoid;
sums over 1024 samples reduce in another order); the LM refinements
1e-3 (eight damped Gauss-Newton trips in f32 whose accept tests compare
costs); the 12-frame run: the same keyframes, objects, slots, labels and
plane slots, the ellipsoids within 0.01 m (the refinement carries the
trajectories' 1e-5 m differences through the box residuals).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.core import plane as jplane
from qsp_slam_tpu.core import quadric as jq
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.data import render as jrender
from qsp_slam_tpu.eval import objects as jeval
from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from qsp_slam_tpu.opt import quadric_factors as jqf
from qsp_slam_tpu.perception import ellipsoid_fit as jfit
from qsp_slam_tpu.perception import groundplane as jgp
from qsp_slam_tpu.perception import manhattan as jman
from qsp_slam_tpu.perception import relations as jrel
from qsp_slam_tpu.perception import symmetry as jsym
from qsp_slam_tpu.slam import objects as jobj
from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.core import quadric as tq
from qsp_slam_tpu_torch.core.camera import Intrinsics
from qsp_slam_tpu_torch.data import io as tio
from qsp_slam_tpu_torch.data import render as trender
from qsp_slam_tpu_torch.eval import objects as teval
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.opt import quadric_factors as tqf
from qsp_slam_tpu_torch.perception import ellipsoid_fit as tfit
from qsp_slam_tpu_torch.perception import groundplane as tgp
from qsp_slam_tpu_torch.perception import manhattan as tman
from qsp_slam_tpu_torch.perception import relations as trel
from qsp_slam_tpu_torch.perception import symmetry as tsym
from qsp_slam_tpu_torch.slam import objects as tobj
from qsp_slam_tpu_torch.slam import system as system_mod
from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)

INTR = Intrinsics(*(float(np.float32(v)) for v in (520.9, 521.0, 325.1, 249.7)))
JINTR = JIntrinsics(*(jnp.float32(v) for v in INTR))
K = np.asarray(JINTR.K)
N_FRAMES = 12
SYS = dict(kmax=16, nmax=2048, emax=16384, ba_window=6, omax=8, enable_loop_closing=False)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jnp_(x):
    return jnp.asarray(np.asarray(x))


# -- the reference's draws, fed to the port -------------------------------------


def jax_plane_draw(gen, num_hyp):
    """Ground-plane draws of PRNGKey(generator seed)."""
    key = jax.random.PRNGKey(gen.initial_seed())
    return T(jax.random.uniform(key, (num_hyp, 3))), T(jax.random.uniform(jax.random.fold_in(key, 1), (num_hyp,)))


class JaxRoundDraws:
    """Manhattan rounds: each call splits the key of the generator's seed
    once more, as the reference's `key, k = split(key)` per round."""

    def __init__(self):
        self.gen, self.key = None, None

    def __call__(self, gen, num_hyp):
        if gen is not self.gen:
            self.gen, self.key = gen, jax.random.PRNGKey(gen.initial_seed())
        self.key, k = jax.random.split(self.key)
        return T(jax.random.uniform(k, (num_hyp, 3))), T(jax.random.uniform(jax.random.fold_in(k, 1), (num_hyp,)))


def jax_bbox_draw(gen, num_det, num_samples):
    """Pixel draws of split(PRNGKey(generator seed), D), v from fold_in(k, 1)."""
    keys = jax.random.split(jax.random.PRNGKey(gen.initial_seed()), num_det)
    u = jax.vmap(lambda k: jax.random.uniform(k, (num_samples,)))(keys)
    v = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (num_samples,)))(keys)
    return T(jnp.stack([u, v], -1))


def gen(seed):
    return torch.Generator().manual_seed(seed)


# -- fixtures ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_frame():
    """tests/test_perception.py's frame: the seed-2 scene seen 25 degrees
    down."""
    scene = jrender.make_scene(num_objects=3, seed=2)
    T_cw = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.44, 0, 0], jnp.float32))
    gray, depth, inst = jrender.render_scene(scene, T_cw, JINTR)
    det = jrender.gt_detections(scene, T_cw, JINTR)
    gp = jgp.estimate_ground_plane(depth, JINTR, jax.random.PRNGKey(0))
    return scene, np.asarray(T_cw), np.asarray(depth), {k: np.asarray(v) for k, v in det.items()}, gp


@pytest.fixture(scope="module")
def room_frame():
    """tests/test_perception_extras.py's frame (seed-3 scene)."""
    scene = jrender.make_scene(num_objects=2, seed=3)
    T_cw = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.35, 0.3, 0], jnp.float32))
    _, depth, _ = jrender.render_scene(scene, T_cw, JINTR)
    return np.asarray(depth)


# -- ellipsoid fit ------------------------------------------------------------------


def test_yaw_grids_are_the_reference_bits():
    """The fit's 36 yaws and symmetry's 24 coarse and 16 fine offsets equal
    the reference's compiled `jnp.linspace` bit for bit."""
    for args, kw in (((0.0, np.pi / 2, 36), {}), ((0.0, np.pi, 24), dict(endpoint=False)),
                     ((-np.pi / 24, np.pi / 24, 16), {})):
        ref = np.asarray(jax.jit(lambda: jnp.linspace(*args, **kw))())
        np.testing.assert_array_equal(tfit.jax_linspace(*args, **kw).numpy(), ref)


def test_sample_bbox_pixels_and_core_mask(scene_frame):
    """On the reference's draws: the pixel indices exactly (the scaling is
    one fused multiply-add there, one rounding here), the points 1e-6 and
    the validity and core masks exactly, also with rows padded by invalid
    samples (the sorts put +inf where `jnp.sort` does)."""
    _, _, depth, det, gp = scene_frame
    bbox = det["bbox"][det["valid"]]
    D, S = len(bbox), 1024
    keys = jax.random.split(jax.random.PRNGKey(1003), D)
    unit = jax_bbox_draw(gen(1003), D, S)
    tb = T(bbox)
    for d in range(D):
        uv = np.asarray(jfit._sample_bbox_pixels(jnp.asarray(bbox[d]), S, keys[d]))
        got_u = tfit._scaled(unit[d, :, 0], tb[d, 0], tb[d, 2]).numpy()
        got_v = tfit._scaled(unit[d, :, 1], tb[d, 1], tb[d, 3]).numpy()
        np.testing.assert_array_equal(np.round(got_u), np.round(uv[:, 0]))
        np.testing.assert_array_equal(np.round(got_v), np.round(uv[:, 1]))
    pts, valid = tfit.sample_bbox_depth_points(T(depth), tb, INTR, gen(1003), draw=jax_bbox_draw)
    pi = T(np.asarray(gp.plane))
    core = tfit.core_mask(pts, valid, pi)
    for d in range(D):
        rp, rv = jfit.sample_bbox_depth_points(jnp.asarray(depth), jnp.asarray(bbox[d]), JINTR, keys[d])
        np.testing.assert_allclose(pts[d].numpy(), np.asarray(rp), atol=1e-6)
        np.testing.assert_array_equal(valid[d].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(core[d].numpy(), np.asarray(jfit.core_mask(rp, rv, gp.plane)))
        padded = np.asarray(rv) & (np.arange(S) % 3 != 0)
        np.testing.assert_array_equal(tfit.core_mask(pts[d], T(padded), pi).numpy(),
                                      np.asarray(jfit.core_mask(rp, jnp.asarray(padded), gp.plane)))
    assert int(core.sum()) > 200


def test_fit_ellipsoid_depth_matches_the_reference(scene_frame):
    """Batched over the detections on the reference's draws: the same core
    counts, `ok`, yaw (the winning footprint beats the runner-up by more
    than 1e-3 m^2 here) and ellipsoid within 1e-4, IoU score 1e-4."""
    _, _, depth, det, gp = scene_frame
    bbox = det["bbox"][det["valid"]]
    keys = jax.random.split(jax.random.PRNGKey(1000), len(bbox))
    got = tfit.fit_ellipsoid_depth(T(depth), T(bbox), T(np.asarray(gp.plane)), INTR, gen(1000), draw=jax_bbox_draw)
    for d in range(len(bbox)):
        ref = jfit.fit_ellipsoid_depth(jnp.asarray(depth), jnp.asarray(bbox[d]), gp.plane, JINTR, keys[d])
        assert bool(got.ok[d]) == bool(ref.ok) and int(got.num_points[d]) == int(ref.num_points)
        np.testing.assert_allclose(got.ellipsoid_cam[d].numpy(), np.asarray(ref.ellipsoid_cam), atol=1e-4)
        np.testing.assert_allclose(float(got.prob[d]), float(ref.prob), atol=1e-4)
    assert bool(got.ok.any())


def test_fit_recovers_objects_and_rejects_empty(scene_frame):
    """tests/test_perception.py on the port: fitted objects lie within one
    half-axis of the truth, extents within 0.2-3x, score > 0.3; a box over
    empty depth is not ok."""
    scene, T_cw, depth, det, gp = scene_frame
    pi = T(np.asarray(gp.plane))
    res = tfit.fit_ellipsoid_depth(T(depth), T(det["bbox"]), pi, INTR, gen(0))
    checked = 0
    for o in np.where(det["valid"] & res.ok.numpy())[0]:
        e_w = tq.transform_ellipsoid(res.ellipsoid_cam[o], tlie.inv_se3(T(T_cw))).numpy()
        gt = np.asarray(scene.ellipsoids[o])
        assert np.linalg.norm(e_w[:3] - gt[:3]) < gt[6:9].max()
        ratio = np.sort(e_w[6:9]) / np.sort(gt[6:9])
        assert ratio.max() < 3.0 and ratio.min() > 0.2 and float(res.prob[o]) > 0.3
        checked += 1
    assert checked >= 1
    empty = tfit.fit_ellipsoid_depth(torch.zeros_like(T(depth)), T([[100.0, 100.0, 200.0, 200.0]]), pi, INTR, gen(9))
    assert not bool(empty.ok[0])


def test_ground_plane_and_detections_on_the_frame(scene_frame):
    """tests/test_perception.py's frame checks on the port: the RGB-D ground
    plane is the world floor (y = 2.2, normal up) seen from the camera,
    normal within 0.03 and offset within 0.05; each valid detection's box
    holds its object's instance pixels."""
    scene, T_cw, depth, det, _ = scene_frame
    res = tgp.estimate_ground_plane(T(depth), INTR, gen(0))
    assert bool(res.ok)
    expect = np.asarray(jplane.transform(jnp.asarray([0.0, -1.0, 0.0, 2.2]), jnp.asarray(T_cw)))
    np.testing.assert_allclose(res.plane[:3].numpy(), expect[:3], atol=0.03)
    assert abs(float(res.plane[3]) - expect[3]) < 0.05
    tscene = trender.make_scene(num_objects=3, seed=2, device="cpu")
    _, _, inst = trender.render_scene(tscene, T_cw, INTR)
    tdet = trender.gt_detections(tscene, T_cw, INTR)
    for o in np.where(tdet["valid"].numpy())[0]:
        b = tdet["bbox"][o].numpy()
        ys, xs = np.where(inst.numpy() == o)
        if len(xs) >= 50:
            assert xs.min() >= b[0] - 2 and xs.max() <= b[2] + 2 and ys.min() >= b[1] - 2 and ys.max() <= b[3] + 2


def test_global_ba_improves_map():
    """tests/test_object_lifecycle.py's global BA smoke on the port: the
    whole-map BA of a perturbed 6-camera problem halves the camera error."""
    from qsp_slam_tpu.data.synthetic import make_ba_problem
    from qsp_slam_tpu_torch.slam import map as tmap
    from qsp_slam_tpu_torch.slam.local_mapping import global_ba_step

    prob = make_ba_problem(num_cams=6, num_points=200, obs_per_point=4, outlier_frac=0.0, seed=3)
    m = tmap.empty_map(8, 256, 4096, device="cpu")
    for k in range(6):
        m, _ = tmap.add_keyframe(m, T(prob.Tcw_init[k]))
    m, ids = tmap.add_points(m, T(prob.points_init), torch.zeros(200, 256, dtype=torch.int8),
                             torch.zeros(200, dtype=torch.int32), torch.zeros(200, 3),
                             torch.ones(200, dtype=torch.bool))
    for k in range(6):
        sel = prob.kf_idx == k
        pad = 512 - int(sel.sum())
        pt = torch.cat([ids[T(prob.pt_idx[sel]).long()], torch.full((pad,), -1, dtype=torch.int32)])
        m = tmap.add_observations(m, torch.tensor(k, dtype=torch.int32), pt,
                                  torch.cat([T(prob.uv[sel]), torch.zeros(pad, 2)]), torch.full((512,), -1.0),
                                  torch.zeros(512, dtype=torch.int32))
    m2 = global_ba_step(m, TrackingConfig())

    def err(mm):
        return np.linalg.norm(mm.kf_Tcw[:6, :3, 3].numpy() - prob.Tcw_gt[:, :3, 3])

    assert err(m2) < 0.5 * err(m)


def test_fit_ellipsoid_points_sparse(scene_frame, rng):
    """The keypoint fit (min_points 8) on sparse subsets, one with too few
    points, against the reference: 1e-4, ok and counts exact."""
    _, _, depth, det, gp = scene_frame
    bbox = det["bbox"][det["valid"]]
    keys = jax.random.split(jax.random.PRNGKey(5), len(bbox))
    pts = np.stack([np.asarray(jfit.sample_bbox_depth_points(jnp.asarray(depth), jnp.asarray(b), JINTR, k)[0])
                    for b, k in zip(bbox, keys)])
    ok = rng.random(pts.shape[:2]) < 0.05
    ok[0, 10:] = False
    got = tfit.fit_ellipsoid_points(T(pts), T(ok), T(bbox), T(np.asarray(gp.plane)), INTR, min_points=8)
    for d in range(len(bbox)):
        ref = jfit.fit_ellipsoid_points(jnp.asarray(pts[d]), jnp.asarray(ok[d]), jnp.asarray(bbox[d]), gp.plane,
                                        JINTR, min_points=8)
        assert bool(got.ok[d]) == bool(ref.ok) and int(got.num_points[d]) == int(ref.num_points)
        np.testing.assert_allclose(got.ellipsoid_cam[d].numpy(), np.asarray(ref.ellipsoid_cam), atol=1e-4)
    assert not bool(got.ok[0])


def test_fit_detections_structured_with_symmetry(scene_frame):
    """The facade's structure-aware extractor with symmetry completion on
    (`enable_symmetry`, off by default): each detection's sample completed
    down to the supporting plane the set offers (the floor, and a false
    plane 0.3 m above it that the just-below gate must reject) and mirrored
    about its best vertical symmetry plane, on the reference's pixel
    draws.  `ok` exact, ellipsoids 1e-3 (the mirror plane comes from an
    argmin over fine yaws that sit an ulp off the reference's, which moves
    the mirrored half by ~1e-5 m)."""
    _, T_cw, depth, det, gp = scene_frame
    bbox = det["bbox"][det["valid"]]
    pi_w = np.asarray(jplane.transform(gp.plane, jlie.inv_se3(jnp.asarray(T_cw))))
    planes = np.zeros((8, 4), np.float32)
    planes[0], planes[1] = pi_w, pi_w - np.float32([0, 0, 0, 0.3]) * np.sign(pi_w[3])
    votes, valid = np.int32([3, 1, 0, 0, 0, 0, 0, 0]), np.arange(8) < 2
    js = JSlamSystem(JTrackingConfig(), enable_symmetry=True)
    js.plane_set = jman.PlaneSet(jnp.asarray(planes), jnp.asarray(votes), jnp.asarray(valid))
    keys = jax.random.split(jax.random.PRNGKey(1007), len(bbox))
    ref = js._fit_detections_structured(jnp.asarray(depth), jnp.asarray(bbox), keys, gp.plane, jnp.asarray(T_cw))
    ts = SlamSystem(TrackingConfig(), device="cpu", enable_symmetry=True)
    ts.plane_set = tman.PlaneSet(T(planes), T(votes), T(valid))
    with patched({"sample_bbox_depth_points": functools.partial(tfit.sample_bbox_depth_points, draw=jax_bbox_draw)}):
        got = ts._fit_detections_structured(T(depth), T(bbox), gen(1007), T(np.asarray(gp.plane)), T(T_cw))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    assert bool(got.ok.any())
    np.testing.assert_allclose(got.ellipsoid_cam.numpy(), np.asarray(ref.ellipsoid_cam), atol=1e-3)


# -- Manhattan planes, relations, symmetry -----------------------------------------------


def test_extract_manhattan_planes(room_frame):
    """Four rounds on the reference's per-round draws: planes 1e-4, `ok`
    exact; every kept plane is perpendicular or parallel to the ground."""
    depth = room_frame
    gp = jgp.estimate_ground_plane(jnp.asarray(depth), JINTR, jax.random.PRNGKey(0))
    assert bool(gp.ok)
    pts, valid = jgp.depth_to_cloud(jnp.asarray(depth), JINTR)
    ref_p, ref_ok = jman.extract_manhattan_planes(pts, valid, gp.plane, jax.random.PRNGKey(301), rounds=4,
                                                  min_inliers=40)
    got_p, got_ok = tman.extract_manhattan_planes(T(pts), T(valid), T(np.asarray(gp.plane)), gen(301), rounds=4,
                                                  min_inliers=40, draw=JaxRoundDraws())
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=1e-4)
    assert bool(got_ok.any())
    up = np.asarray(gp.plane[:3])
    for r in np.where(got_ok.numpy())[0]:
        a = abs(float(np.dot(got_p[r, :3].numpy(), up)))
        assert a > 0.85 or a < 0.15


def test_update_plane_set(rng):
    """tests/test_perception_extras.py's votes on the port, and a random
    stream of repeats, near-repeats, rejects and overflow against the
    reference's fold: slots, votes, validity exact, planes 1e-6."""
    ps = tman.empty_plane_set(4, device="cpu")
    pi = T(np.float32([0.0, 0.0, -1.0, 4.0]))
    for _ in range(3):
        ps = tman.update_plane_set(ps, pi[None], T([True]))
    assert int(ps.votes[0]) == 3 and len(tman.dominant_planes(ps, min_votes=3)) == 1
    ps = tman.update_plane_set(ps, T(np.float32([[1.0, 0.0, 0.0, 2.0]])), T([True]))
    assert bool(ps.valid[1])

    base = rng.normal(size=(5, 4)).astype(np.float32)
    ps, jps = tman.empty_plane_set(4, device="cpu"), jman.empty_plane_set(4)
    for _ in range(6):
        idx = rng.integers(0, 5, 4)
        new = base[idx] + rng.normal(0, 0.01, (4, 4)).astype(np.float32) * (rng.random((4, 1)) < 0.5)
        new = (new * rng.choice([-1.0, 1.0], (4, 1))).astype(np.float32)
        ok = rng.random(4) < 0.8
        ps = tman.update_plane_set(ps, T(new), T(ok))
        jps = jman.update_plane_set(jps, jnp.asarray(new), jnp.asarray(ok))
        np.testing.assert_array_equal(ps.votes.numpy(), np.asarray(jps.votes))
        np.testing.assert_array_equal(ps.valid.numpy(), np.asarray(jps.valid))
        np.testing.assert_allclose(ps.planes.numpy(), np.asarray(jps.planes), atol=1e-6)
    assert bool(ps.valid.all())  # the set filled up


def test_relations_support_and_lean():
    """tests/test_perception_extras.py's pair: SUPPORT on the floor, LEAN_ON
    the wall; the port's grid equals the reference's."""
    ells = np.float32([[0.0, 1.7, 3.0, np.pi / 2, 0, 0, 0.2, 0.2, 0.3],
                       [0.0, 1.0, 3.0, np.pi / 2, 0, 0, 0.25, 0.25, 0.4]])
    planes = np.float32([[0.0, -1.0, 0.0, 2.0], [1.0, 0.0, 0.0, 0.25]])
    up = np.float32([0.0, -1.0, 0.0])
    got = trel.extract_relations(T(ells), torch.ones(2, dtype=torch.bool), T(planes), torch.ones(2, dtype=torch.bool),
                                 T(up))
    ref = jrel.extract_relations(jnp.asarray(ells), jnp.ones(2, bool), jnp.asarray(planes), jnp.ones(2, bool),
                                 jnp.asarray(up))
    kind = got.kind.numpy()
    assert kind[0, 0] == trel.SUPPORT and kind[1, 1] == trel.LEAN_ON and kind[0, 1] in (trel.NONE, trel.LEAN_ON)
    np.testing.assert_array_equal(kind, np.asarray(ref.kind))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance), atol=1e-6)


def _random_relation_scene(rng, O=8, P=6):
    e = np.concatenate([rng.uniform([-2, 0.5, 2], [2, 2, 6], (O, 3)), rng.normal(0, 0.05, (O, 3)),
                        rng.uniform(0.1, 0.5, (O, 3))], -1).astype(np.float32)
    e[:, 3] += np.pi / 2
    planes = np.concatenate([rng.normal(0, 0.03, (P, 3)) + [0, -1, 0], rng.uniform(0.5, 2.5, (P, 1))], -1)
    planes[P // 2:, :3] = rng.normal(0, 0.03, (P - P // 2, 3)) + [1, 0, 0]  # walls
    planes[:2, 3] = e[:2, 1] + e[:2, 8] * np.cos(e[:2, 3] - np.pi / 2)  # two objects rest on planes 0, 1
    return e, planes.astype(np.float32), rng.random(O) < 0.8, rng.random(P) < 0.8


def test_relations_and_support_planes_batch(rng):
    """Random objects and planes: relation kinds exact, distances 1e-5,
    and each object's supporting plane as the reference routes it, 1e-6."""
    for _ in range(3):
        e, planes, ov, pv = _random_relation_scene(rng)
        ground = np.float32([0.01, -0.99, 0.02, 2.2])
        up = ground[:3] / np.linalg.norm(ground[:3])
        got = trel.extract_relations(T(e), T(ov), T(planes), T(pv), T(up))
        ref = jrel.extract_relations(jnp.asarray(e), jnp.asarray(ov), jnp.asarray(planes), jnp.asarray(pv),
                                     jnp.asarray(up))
        np.testing.assert_array_equal(got.kind.numpy(), np.asarray(ref.kind))
        np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance), atol=1e-5)
        sp = trel.support_planes_for_objects(got, T(planes), T(pv), T(ground))
        ref_sp = jrel.support_planes_for_objects(ref, jnp.asarray(planes), jnp.asarray(pv), jnp.asarray(ground))
        np.testing.assert_allclose(sp.numpy(), np.asarray(ref_sp), atol=1e-6)
    assert (got.kind.numpy() == trel.SUPPORT).any()


class TestSelectSupportPlane:
    """tests/test_structures.py's cases on the port, and a batch of point
    sets against the reference: exact choice, planes 1e-6."""

    GROUND = np.float32([0.0, -1.0, 0.0, 2.0])

    def _planes(self):
        return T(np.float32([self.GROUND, [0.0, -1.0, 0.0, 1.25], [1.0, 0.0, 0.0, -3.0]])), torch.ones(3, dtype=bool)

    def _box(self, key, lo, hi):
        return T(jax.random.uniform(jax.random.PRNGKey(key), (200, 3), minval=jnp.asarray(lo),
                                    maxval=jnp.asarray(hi)))

    def test_cases(self):
        planes, pv = self._planes()
        ok = torch.ones(200, dtype=torch.bool)
        on_table = trel.select_support_plane(self._box(0, [-0.2, -1.55, 1.8], [0.2, -1.25, 2.2]), ok, planes, pv,
                                             T(self.GROUND))
        np.testing.assert_allclose(on_table.numpy(), [0, -1, 0, 1.25], atol=1e-5)
        on_floor = trel.select_support_plane(self._box(1, [-0.2, 1.6, 1.8], [0.2, 2.0, 2.2]), ok, planes, pv,
                                             T(self.GROUND))
        np.testing.assert_allclose(on_floor.numpy(), [0, -1, 0, 2.0], atol=1e-5)
        fallback = trel.select_support_plane(torch.ones(50, 3), torch.ones(50, dtype=bool), torch.zeros(3, 4),
                                             torch.zeros(3, dtype=bool), T(self.GROUND))
        np.testing.assert_allclose(fallback.numpy(), [0, -1, 0, 2.0], atol=1e-5)

    def test_batch_matches_the_reference(self, rng):
        planes, pv = self._planes()
        pv = T([True, True, False])
        pts = rng.uniform([-0.3, -1.6, 1.5], [0.3, 2.0, 2.5], (6, 200, 3)).astype(np.float32)
        pts[1:3, :, 1] = rng.uniform(-1.55, -1.2, (2, 200))  # on the table
        ok = rng.random((6, 200)) < 0.7
        ok[5] = False
        got = trel.select_support_plane(T(pts), T(ok), planes, pv, T(self.GROUND))
        for d in range(6):
            ref = jrel.select_support_plane(jnp.asarray(pts[d]), jnp.asarray(ok[d]), jnp_(planes), jnp_(pv),
                                            jnp.asarray(self.GROUND))
            np.testing.assert_allclose(got[d].numpy(), np.asarray(ref), atol=1e-6)


def test_support_planes_for_objects_cases():
    """tests/test_structures.py's routing: the SUPPORT relation's plane, else
    the ground."""
    ground = np.float32([0.0, -1.0, 0.0, 2.0])
    planes = T(np.float32([ground, [0.0, -1.0, 0.0, 1.25]]))
    rel = trel.Relations(kind=T(np.int32([[0, trel.SUPPORT], [trel.SUPPORT, 0]])),
                         distance=T(np.float32([[0.5, 0.01], [0.02, 0.8]])))
    sp = trel.support_planes_for_objects(rel, planes, torch.ones(2, dtype=bool), T(ground))
    np.testing.assert_allclose(sp[0].numpy(), [0, -1, 0, 1.25], atol=1e-5)
    np.testing.assert_allclose(sp[1].numpy(), [0, -1, 0, 2.0], atol=1e-5)
    none = trel.Relations(kind=torch.zeros((1, 2), dtype=torch.int32), distance=torch.zeros(1, 2))
    np.testing.assert_allclose(trel.support_planes_for_objects(none, torch.zeros(2, 4), torch.zeros(2, dtype=bool),
                                                               T(ground))[0].numpy(), ground)


def test_estimate_symmetry(rng):
    """tests/test_perception_extras.py's half ellipsoid on the port (the
    x = 0 mid-plane, mirrored points on the surface), and the plane and
    score against the reference (1e-5) on a batch of two clouds."""
    d = rng.normal(size=(400, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    surf = d * [0.3, 0.2, 0.25] + [0.0, 0.0, 2.0]
    front = surf[surf[:, 2] < 2.0].astype(np.float32)
    res = tsym.estimate_symmetry(T(front), torch.ones(len(front), dtype=bool), T(np.float32([0, 1, 0])))
    assert bool(res.ok) and abs(float(res.plane[0])) > 0.9 and res.completed.shape[0] == 2 * len(front)
    comp = res.completed[len(front):].numpy()
    lvl = np.linalg.norm((comp - [0, 0, 2.0]) / [0.3, 0.2, 0.25], axis=1)
    assert np.median(np.abs(lvl - 1.0)) < 0.15
    n = 128
    clouds = np.stack([front[:n], (front[:n] @ np.float32([[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]]))])
    valid = rng.random((2, n)) < 0.9
    up = np.float32([0.02, 1.0, -0.05])
    got = tsym.estimate_symmetry(T(clouds), T(valid), T(up))
    for b in range(2):
        ref = jsym.estimate_symmetry(jnp.asarray(clouds[b]), jnp.asarray(valid[b]), jnp.asarray(up))
        np.testing.assert_allclose(got.plane[b].numpy(), np.asarray(ref.plane), atol=1e-5)
        np.testing.assert_allclose(float(got.score[b]), float(ref.score), atol=1e-5)
        assert bool(got.ok[b]) == bool(ref.ok)


# -- refinement with per-object support planes ------------------------------------------------


def _histories(rng, O, M=16, floor=1.2):
    """Upright objects resting on y = `floor` (one value per object or
    shared), seen from poses around the origin, noisy boxes (some on the
    border), empty slots; the inits perturbed."""
    e = np.concatenate([rng.uniform([-1, -1, 3], [1, 1, 6], (O, 3)), np.zeros((O, 3)),
                        rng.uniform(0.1, 0.6, (O, 3))], -1).astype(np.float32)
    e[:, 3] = np.pi / 2 + rng.normal(0, 0.05, O)
    e[:, 1] = floor - e[:, 8]
    Tcw = np.stack([[np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32))) for _ in range(M)]
                    for _ in range(O)]).astype(np.float32)
    box = np.asarray(jax.vmap(lambda ee, Ts: jax.vmap(lambda Tt: jq.project_bbox(ee, Tt, jnp.asarray(K)))(Ts))(
        jnp.asarray(e), jnp.asarray(Tcw)))
    box = np.clip(box + rng.normal(0, 3, box.shape), 0, [639, 479, 639, 479]).astype(np.float32)
    w = np.where(rng.random((O, M)) < 0.6, rng.uniform(0.5, 1.0, (O, M)), 0.0).astype(np.float32)
    w[0, 2:] = 0.0
    e0 = e.copy()
    e0[:, :3] += rng.normal(0, 0.05, (O, 3))
    e0[:, 6:] *= rng.uniform(0.8, 1.25, (O, 3))
    return e0.astype(np.float32), Tcw, box, w


def test_refine_object_with_per_object_planes(rng):
    """`refine_object` with an (O, 4) plane stack: the residual pieces
    broadcast (1e-5), and the LM against the reference's vmap with each
    object's plane: centres, half-axes and z axes 0.02 (the reference
    test's bound for the same weight-100 priors), costs 5e-2 relative.  The
    turn about the z axis is left out: for a footprint this close to round
    it moves the boxes by well under a pixel, so f32 LM trips part there by
    a few hundredths of a radian, and the final costs (1-5, sub-pixel box
    residuals) by up to 2%."""
    floor = np.float32([0.7, 1.2, 0.7, 1.2, 0.7, 1.2])  # every other object on a table 0.5 m up
    e0, Tcw, box, w = _histories(rng, 6, floor=floor)
    planes = np.tile(np.float32([0.02, -0.999, 0.01, 1.2]), (6, 1))
    planes[:, 3] = floor
    planes[:, :3] += rng.normal(0, 0.01, (6, 3)).astype(np.float32)
    np.testing.assert_allclose(tqf.gravity_residual(T(e0), -T(planes[:, :3])).numpy(),
                               np.asarray(jax.vmap(jqf.gravity_residual)(jnp.asarray(e0), -jnp.asarray(planes[:, :3]))),
                               atol=1e-5)
    np.testing.assert_allclose(tqf.support_residual(T(e0), T(planes)).numpy(),
                               np.asarray(jax.vmap(jqf.support_residual)(jnp.asarray(e0), jnp.asarray(planes))),
                               atol=1e-5)
    got, cost = tqf.refine_object(T(e0), tqf.ObjectObservations(T(Tcw), T(box), T(w)), T(K), T(planes), iters=8,
                                  img_wh=(640, 480))
    ref, rcost = jax.vmap(lambda ee, Ts, bs, ww, pp: jqf.refine_object(
        ee, jqf.ObjectObservations(Ts, bs, ww), jnp.asarray(K), pp, iters=8, img_wh=(640, 480)))(
        *(jnp.asarray(x) for x in (e0, Tcw, box, w, planes)))
    ref = T(np.asarray(ref))
    for sl in (slice(0, 3), slice(6, 9)):
        np.testing.assert_allclose(got[:, sl].numpy(), ref[:, sl].numpy(), atol=0.02)
    np.testing.assert_allclose(tq.euler_to_rotmat(got[:, 3:6])[:, :, 2].numpy(),
                               tq.euler_to_rotmat(ref[:, 3:6])[:, :, 2].numpy(), atol=0.02)
    np.testing.assert_allclose(cost.numpy(), np.asarray(rcost), rtol=5e-2)


def test_refine_objects(rng):
    """The table-level refinement: live static objects with two or more
    observations move (each with its own supporting plane), the rest keep
    their ellipsoid; against the reference 0.02."""
    e0, Tcw, box, w = _histories(rng, 6)
    t = tobj.empty_objects(8, device="cpu")
    t = t._replace(ellipsoid=torch.cat([T(e0), torch.zeros(2, 9)]), obs_Tcw=torch.cat([T(Tcw), t.obs_Tcw[6:]]),
                   obs_bbox=torch.cat([T(box), t.obs_bbox[6:]]), obs_weight=torch.cat([T(w), t.obs_weight[6:]]),
                   valid=T([True, True, True, True, False, True, False, False]),
                   dynamic=T([False, False, True, False, False, False, False, False]))
    ground = np.float32([0.02, -0.999, 0.01, 1.2])
    support = np.tile(ground, (8, 1))
    support[1, 3] = 0.7
    jt = jobj.ObjectTable(**{k: jnp.asarray(v.numpy()) for k, v in t._asdict().items()})
    for sp in (None, support):
        got = tobj.refine_objects(t, T(K), T(ground), support_planes_w=None if sp is None else T(sp),
                                  img_wh=(640, 480))
        ref = jobj.refine_objects(jt, jnp.asarray(K), jnp.asarray(ground),
                                  support_planes_w=None if sp is None else jnp.asarray(sp), img_wh=(640, 480))
        np.testing.assert_allclose(got.ellipsoid.numpy(), np.asarray(ref.ellipsoid), atol=0.02)
        moved = np.abs(got.ellipsoid.numpy() - t.ellipsoid.numpy()).max(axis=1) > 0
        np.testing.assert_array_equal(moved, [True, True, False, True, False, True, False, False])


# -- the object table: the reference's association, merge, lifecycle and velocity cases ---------


def _one_object(e, label=2):
    t = tobj.empty_objects(8, device="cpu")
    return t._replace(ellipsoid=t.ellipsoid.index_copy(0, torch.tensor([0]), T(e)[None]),
                      label=t.label.index_fill(0, torch.tensor([0]), label),
                      valid=t.valid.index_fill(0, torch.tensor([0]), True),
                      num_objects=torch.tensor(1, dtype=torch.int32))


LOOK_DOWN = np.asarray(jlie.exp_se3(jnp.asarray([0, 0, 0, 0.44, 0, 0], jnp.float32)))


def test_association_and_label_gate():
    """tests/test_objects.py: a near box matches, an unrelated box and a
    wrong label do not."""
    e = np.float32([0.5, 1.8, 3.0, 0.0, 0.3, 0.0, 0.3, 0.25, 0.3])
    table = _one_object(e)
    box = tq.project_bbox(T(e), T(LOOK_DOWN), T(K))
    a = tobj.associate_detections(table, T(LOOK_DOWN), T(K), torch.stack([box + 5.0, T(np.float32([10, 10, 60, 60]))]),
                                  T(np.int32([2, 2])), T([True, True]))
    assert a.obj_for_det.tolist() == [0, -1]
    a = tobj.associate_detections(table, T(LOOK_DOWN), T(K), box[None], T(np.int32([5])), T([True]))
    assert a.obj_for_det.tolist() == [-1]


def test_merge_coincident():
    t = tobj.empty_objects(8, device="cpu")
    e = torch.tensor([1.0, 1.0, 1.0, 0, 0, 0, 0.3, 0.3, 0.3])
    ell = t.ellipsoid.clone()
    for i, off in enumerate([0.0, 0.1, 2.0]):
        ell[i] = e + torch.tensor([off] + [0.0] * 8)
    t = t._replace(ellipsoid=ell, label=torch.tensor([1, 1, 1] + [-1] * 5, dtype=torch.int32),
                   valid=torch.tensor([True] * 3 + [False] * 5))
    assert tobj.merge_duplicates(t, dist_threshold=0.5).valid[:3].tolist() == [True, False, True]


def _integrate(table, kf, e_cam, fit_ok=True):
    return tobj.integrate_keyframe(table, torch.eye(4), torch.zeros(1, 4), T(np.int32([1])), T(np.float32([0.9])),
                                   T([True]), T(e_cam)[None], T([fit_ok]),
                                   tobj.Associations(T(np.int32([0])), T(np.float32([0.8]))), kf_id=kf)


class TestLifecycle:
    """tests/test_object_lifecycle.py on the port."""

    E = np.float32([0.0, 1.8, 3.0, 0, 0, 0, 0.3, 0.3, 0.3])

    def test_moving_object_flagged(self):
        t = _integrate(_one_object(self.E, 1), 1, self.E + np.float32([0.5] + [0] * 8))
        assert not bool(t.dynamic[0])
        t = _integrate(t, 2, self.E + np.float32([1.0] + [0] * 8))
        assert bool(t.dynamic[0])

    def test_static_object_not_flagged(self):
        t = _one_object(self.E, 1)
        for k in range(3):
            t = _integrate(t, k + 1, self.E)
        assert not bool(t.dynamic[0]) and int(t.last_seen_kf[0]) == 3

    def test_culling(self):
        t = _one_object(self.E, 1)
        assert not bool(tobj.cull_objects(t, 20).valid[0])  # stale and weak
        t = _integrate(_integrate(t, 1, self.E), 2, self.E)
        assert bool(tobj.cull_objects(t, 20).valid[0])  # stale but strong


VEL = np.float32([0.4, 0.0, 0.0])


def _moving(kf):
    return np.float32([*(np.float32([-1.2, 0.0, 6.0]) + VEL * kf), 0.0, 0.3, 0.0, 0.9, 0.5, 0.6])


def _observe(table, kf):
    e = T(_moving(kf))
    box = tq.project_bbox(e[None], torch.eye(4)[None], T(K))
    assoc = tobj.associate_detections(table, torch.eye(4), T(K), box, T(np.int32([1])), T([True]))
    return tobj.integrate_keyframe(table, torch.eye(4), box, T(np.int32([1])), T(np.float32([0.9])), T([True]),
                                   e[None], T([True]), assoc, kf_id=kf), assoc


class TestVelocityModel:
    """tests/test_dynamic_velocity.py on the port."""

    def test_flags_dynamic_and_learns_velocity(self):
        table = tobj.empty_objects(4, device="cpu")
        for kf in range(4):
            table, assoc = _observe(table, kf)
            assert kf == 0 or int(assoc.obj_for_det[0]) == 0
        assert bool(table.dynamic[0]) and np.linalg.norm(table.vel_center[0].numpy() - VEL) < 0.2
        np.testing.assert_allclose(table.ellipsoid[0, :3].numpy(), _moving(3)[:3], atol=1e-4)

    def test_extrapolation_keeps_association(self):
        table = tobj.empty_objects(4, device="cpu")
        for kf in range(4):
            table, _ = _observe(table, kf)
        box7 = tq.project_bbox(T(_moving(7))[None], torch.eye(4)[None], T(K))
        assoc = tobj.associate_detections(table, torch.eye(4), T(K), box7, T(np.int32([1])), T([True]))
        assert int(assoc.obj_for_det[0]) == -1
        adv = tobj.advance_dynamic_objects(table, 7)
        assert np.linalg.norm(adv.ellipsoid[0, :3].numpy() - _moving(7)[:3]) < 0.35
        assoc = tobj.associate_detections(adv, torch.eye(4), T(K), box7, T(np.int32([1])), T([True]))
        assert int(assoc.obj_for_det[0]) == 0
        assert torch.equal(tobj.advance_dynamic_objects(adv, 7).ellipsoid, adv.ellipsoid)

    def test_static_objects_untouched(self):
        e = T(_moving(0))
        box = tq.project_bbox(e[None], torch.eye(4)[None], T(K))
        table = tobj.integrate_keyframe(tobj.empty_objects(4, device="cpu"), torch.eye(4), box, T(np.int32([1])),
                                        T(np.float32([0.9])), T([True]), e[None], T([True]),
                                        tobj.Associations(T(np.int32([-1])), T(np.float32([0.0]))), kf_id=0)
        assert torch.equal(tobj.advance_dynamic_objects(table, 5).ellipsoid, table.ellipsoid)


# -- renderer and evaluation ----------------------------------------------------------------


def test_table_scene_renders_as_the_reference():
    """A table scene (slabs first in the draw order): the same placements,
    and depth within 1e-4 m and gray within 1e-2 on all but a 1e-3 share
    of pixels (f32 silhouettes), the same instance ids there."""
    jscene = jrender.make_scene(num_objects=3, seed=2, num_tables=1)
    scene = trender.make_scene(num_objects=3, seed=2, num_tables=1, device="cpu")
    Tcw = LOOK_DOWN
    g, d, inst = trender.render_scene(scene, Tcw, INTR)
    rg, rd, rinst = jrender.render_scene(jscene, jnp.asarray(Tcw), JINTR)
    bad = (np.abs(d.numpy() - np.asarray(rd)) > 1e-4) | (np.abs(g.numpy() - np.asarray(rg)) > 1e-2)
    assert bad.mean() < 1e-3
    assert (inst.numpy() != np.asarray(rinst)).mean() < 1e-3
    slab = jrender.render_scene(jscene._replace(ellipsoids=jscene.ellipsoids[:0]), jnp.asarray(Tcw), JINTR)[1]
    assert (np.asarray(slab) != np.asarray(jrender.render_frame(jscene.room, jnp.asarray(Tcw), JINTR)[1])).any()


def test_object_evaluation(rng):
    """tests/test_io_eval.py's object cases on the port, and the reference's
    numbers on random maps (IoU samples from the same seeded generator)."""
    gt = np.float32([[0, 0, 0, 0, 0, 0, 0.3, 0.2, 0.4], [2, 0, 1, 0, 0, 0.5, 0.2, 0.2, 0.2]])
    res = teval.evaluate_objects(gt, np.array([1, 2]), gt, np.array([1, 2]))
    assert res.precision == 1.0 and res.recall == 1.0 and res.mean_iou > 0.9 and res.mean_center_err < 1e-6
    est = np.float32([[0.05, 0, 0, 0, 0, 0, 0.3, 0.2, 0.4], [9, 9, 9, 0, 0, 0, 0.2, 0.2, 0.2]])
    gt2 = gt.copy()
    gt2[1, 5] = 0.0
    res = teval.evaluate_objects(est, np.array([1, 2]), gt2, np.array([1, 2]))
    assert res.precision == 0.5 and res.recall == 0.5 and res.matches[0][:2] == (0, 0)
    a, b = np.float32([0, 0, 0, 0, 0, 0, 1, 1, 1]), np.float32([1, 0, 0, 0, 0, 0, 1, 1, 1])
    lens = 2 * np.pi * (2 / 3 - 1 / 2 + 1 / 24)
    assert abs(teval.ellipsoid_iou_mc(a, b, samples=20000) - lens / (np.pi * 4 / 3 * 2 - lens)) < 0.03
    est = gt[rng.integers(0, 2, 4)] + np.concatenate([rng.normal(0, 0.1, (4, 6)), np.zeros((4, 3))], 1)
    est = est.astype(np.float32)
    got = teval.evaluate_objects(est, np.array([1, 2, 1, 2]), gt, np.array([1, 2]))
    ref = jeval.evaluate_objects(est, np.array([1, 2, 1, 2]), gt, np.array([1, 2]))
    assert got.matches == ref.matches and got.precision == ref.precision and got.recall == ref.recall
    np.testing.assert_allclose([got.mean_iou, got.mean_center_err, got.mean_yaw_err],
                               [ref.mean_iou, ref.mean_center_err, ref.mean_yaw_err], atol=1e-6)


# -- the system -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table_frames():
    """tests/test_structures.py's table scene and lateral track: rendered
    gray, depth and the renderer's detections, from the reference package;
    the world-to-first-camera pose."""
    scene = jrender.make_scene(num_objects=3, seed=2, num_tables=1)
    base = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    out = []
    for i in range(N_FRAMES):
        Tcw = jlie.exp_se3(jnp.asarray([0.04 * i, 0, 0, 0, 0, 0], jnp.float32)) @ base
        g, d, _ = jrender.render_scene(scene, Tcw, JINTR)
        det = jrender.gt_detections(scene, Tcw, JINTR)
        out.append((np.asarray(g), np.asarray(d), {k: np.asarray(v) for k, v in det.items()}))
    return scene, np.asarray(base), out


def reference_draws():
    """The facade's RANSAC and pixel draws replaced by the reference's."""
    return {"estimate_ground_plane": functools.partial(tgp.estimate_ground_plane, draw=jax_plane_draw),
            "extract_manhattan_planes": functools.partial(tman.extract_manhattan_planes, draw=JaxRoundDraws()),
            "sample_bbox_depth_points": functools.partial(tfit.sample_bbox_depth_points, draw=jax_bbox_draw)}


class patched:
    def __init__(self, patches):
        self.patches, self.saved = patches, {k: getattr(system_mod, k) for k in patches}

    def __enter__(self):
        for k, v in self.patches.items():
            setattr(system_mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(system_mod, k, v)


@pytest.fixture(scope="module")
def e2e(table_frames):
    """Both packages through the table scene with detections, structures on
    (the default), the port on the reference's draws."""
    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    js = JSlamSystem(JTrackingConfig(orb=JOrbConfig(num_features=500)), **SYS)
    ts = SlamSystem(cfg, device="cpu", **SYS)
    with patched(reference_draws()):
        for g, d, det in table_frames[2]:
            js.track_rgbd(g, d, det)
            ts.track_rgbd(g, d, det)
    return js, ts


def test_track_rgbd_with_detections_matches_the_reference(e2e):
    js, ts = e2e
    assert ts.stats["kf_frames"] == js.stats["kf_frames"] and len(ts.stats["kf_frames"]) >= 3
    for name in ("valid", "label", "obs_count", "pm_kf"):
        np.testing.assert_array_equal(getattr(ts.objects, name).numpy(), np.asarray(getattr(js.objects, name)), name)
    valid = ts.objects.valid.numpy()
    assert valid.sum() >= 2
    np.testing.assert_allclose(ts.objects.ellipsoid.numpy()[valid], np.asarray(js.objects.ellipsoid)[valid], atol=1e-2)
    np.testing.assert_array_equal(ts.plane_set.valid.numpy(), np.asarray(js.plane_set.valid))
    np.testing.assert_array_equal(ts.plane_set.votes.numpy(), np.asarray(js.plane_set.votes))
    np.testing.assert_allclose(ts.plane_set.planes.numpy(), np.asarray(js.plane_set.planes), atol=1e-3)
    np.testing.assert_array_equal(ts.relations.kind.numpy(), np.asarray(js.relations.kind))
    np.testing.assert_allclose(ts.ground_plane, js.ground_plane, atol=1e-4)
    assert ts._gp_count == js._gp_count
    np.testing.assert_allclose(np.stack(ts.trajectory), np.stack(js.trajectory), atol=1e-4)
    assert len(ts.stats["obj_ms"]) == len(ts.stats["kf_frames"]) - 1


def test_structures_find_the_table_and_type_relations(e2e, table_frames):
    """tests/test_structures.py's and tests/test_objects.py's outcomes on the
    port's run: at least two planes with two votes (the floor and the table
    top), a live object typed SUPPORT, and an object within 0.4 m of the
    truth with its label (the renderer's world mapped through the first
    camera)."""
    _, ts = e2e
    scene, base, _ = table_frames
    assert int((ts.plane_set.valid & (ts.plane_set.votes >= 2)).sum()) >= 2
    assert bool(((ts.relations.kind == trel.SUPPORT).any(dim=1) & ts.objects.valid).any())
    valid = ts.objects.valid.numpy()
    est = tq.transform_ellipsoid(ts.objects.ellipsoid[valid], tlie.inv_se3(T(base))).numpy()
    gt, gt_labels = np.asarray(scene.ellipsoids), np.asarray(scene.labels)
    matched = [l for e, l in zip(est, ts.objects.label.numpy()[valid])
               if np.linalg.norm(gt[:, :3] - e[:3], axis=1).min() < 0.4
               and gt_labels[np.linalg.norm(gt[:, :3] - e[:3], axis=1).argmin()] == l]
    assert len(matched) >= 1


def test_jax_structures_session_resumes_in_the_port(e2e, tmp_path):
    """A JAX checkpoint of the run: planes, relations, the fused ground
    plane and its count come across as they are."""
    from qsp_slam_tpu.slam.checkpoint import save_checkpoint as jsave

    js, _ = e2e
    jsave(str(tmp_path / "j.npz"), js)
    port = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=500)), device="cpu", **SYS)
    load_checkpoint(str(tmp_path / "j.npz"), port)
    for a, b in zip(port.plane_set + port.relations, js.plane_set + js.relations):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(port.ground_plane, js.ground_plane)
    assert port._gp_count == js._gp_count and port._sensor == "rgbd"


@pytest.fixture(scope="module")
def online(table_frames):
    """Detect-online (slice 8): the table scene through both systems with
    no detections and a learned 2D detector at widths (8, 12, 16) on
    240x320 (mean-pooled from the 480x640 frames; the reference's init
    with the heatmap bias raised to 1, so that it fires at every
    keyframe), at `e2e`'s configuration, whose compiled reference
    functions it reuses; the port on the reference's draws.  -> the
    systems and every detection of each."""
    from qsp_slam_tpu.perception import detector2d as jdet
    from qsp_slam_tpu_torch.convert import detector2d_params_from_numpy
    from qsp_slam_tpu_torch.perception import detector2d as tdet

    jcfg = jdet.DetectorConfig(widths=(8, 12, 16), input_hw=(240, 320))
    jp = jdet.init_detector(jax.random.PRNGKey(0), jcfg)
    jp["hm_b"] = jnp.full_like(jp["hm_b"], 1.0)
    tcfg = tdet.DetectorConfig(widths=(8, 12, 16), input_hw=(240, 320))
    tp = detector2d_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    js = JSlamSystem(JTrackingConfig(orb=JOrbConfig(num_features=500)), detector=(jp, jcfg), **SYS)
    ts = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=500)), detector=(tp, tcfg), device="cpu", **SYS)
    ref, got = [], []
    real_j, real_t = jdet.detect_objects, tdet.detect_objects

    def j_detect(*a):
        out = real_j(*a)
        ref.append({k: np.asarray(v) for k, v in out.items()})
        return out

    def t_detect(*a):
        out = real_t(*a)
        got.append({k: v.numpy() for k, v in out.items()})
        return out

    jdet.detect_objects = j_detect
    try:
        with patched(reference_draws() | {"detect_objects": t_detect}):
            for g, d, _ in table_frames[2]:
                js.track_rgbd(g, d, None)
                ts.track_rgbd(g, d, None)
    finally:
        jdet.detect_objects = real_j
    return js, ts, ref, got


def test_detect_online_matches_the_reference(online):
    """The same keyframes; one detection per keyframe in each package,
    boxes within 1e-4 px and labels, `valid` and masks exact; the same
    object slots, labels and observation counts, centres within 1e-3 m."""
    js, ts, ref, got = online
    assert ts.stats["kf_frames"] == js.stats["kf_frames"] and len(ts.stats["kf_frames"]) >= 3
    assert len(got) == len(ref) == len(ts.stats["kf_frames"])
    for t, j in zip(got, ref):
        assert j["valid"].any()
        np.testing.assert_allclose(t["bbox"], j["bbox"], atol=1e-4)
        for k in ("label", "valid", "mask"):
            np.testing.assert_array_equal(t[k], j[k], k)
    for name in ("valid", "label", "obs_count"):
        np.testing.assert_array_equal(getattr(ts.objects, name).numpy(), np.asarray(getattr(js.objects, name)), name)
    valid = ts.objects.valid.numpy()
    assert valid.sum() >= 1
    np.testing.assert_allclose(ts.objects.ellipsoid.numpy()[valid, :3], np.asarray(js.objects.ellipsoid)[valid, :3],
                               atol=1e-3)
    np.testing.assert_allclose(np.stack(ts.trajectory), np.stack(js.trajectory), atol=1e-4)


def test_uint16_depth_reaches_the_object_step_in_png_units(table_frames):
    """As in the reference, the object step reads the depth image as
    given: a uint16 image stays in PNG units there, so every sample lies
    past the 8-unit depth gate and no object is spawned (ROADMAP queue C);
    the same frame in meters spawns its objects."""
    g, d, det = table_frames[2][0]
    runs = {}
    for name, depth in (("meters", d), ("png", np.round(d * 5000.0).astype(np.uint16))):
        runs[name] = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=500)), device="cpu", **SYS)
        runs[name].track_rgbd(g, depth, det)
    assert int(runs["meters"].objects.valid.sum()) >= 1
    assert int(runs["png"].objects.valid.sum()) == 0 and runs["png"].ground_plane is not None


def test_make_tum_and_run_tum_with_detections(tmp_path):
    """`make_tum --objects 2 --detections` into `run_tum --detections` on 5
    frames: both command lines on the reference's sequence give the same
    summary (the port on the reference's draws) and save the objects."""
    from qsp_slam_tpu import run_tum as jrun
    from qsp_slam_tpu.data import make_tum as jmake
    from qsp_slam_tpu_torch import run_tum as trun

    jdir = tmp_path / "j"
    jmake.main([str(jdir), "--frames", "5", "--objects", "2", "--detections"])
    (tmp_path / "c.yaml").write_text("ORBextractor.nFeatures: 500\n")
    flags = ["--detections", str(jdir / "detections"), "--config", str(tmp_path / "c.yaml"), "--cpu"]
    ref = jrun.main([str(jdir), *flags])
    with patched(reference_draws()):
        got = trun.main([str(jdir), *flags, "--save-dir", str(tmp_path / "out")])
    for key in ("frames", "keyframes", "num_points", "num_obs", "num_objects"):
        assert got[key] == ref[key], key
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) < 1e-4 and got["num_objects"] >= 1
    z = tio.load_map(str(tmp_path / "out" / "map.npz"))
    assert int(z["obj_valid"].sum()) == got["num_objects"]

"""Parity of the port's stereo object path with the JAX package on the
CPU: the scatter-add normal blocks and the dense pose solve, the object
edge and the joint camera-point-object BA, `joint_ba_step`, the stereo
object step with its local and global joint BA through `run_kitti
--detections --global-ba` on the stereo scene written in the KITTI layout,
the LiDAR proposals and `run_kitti --lidar-detections` on the same
sequence (both command lines at one configuration, so the reference
compiles its stereo system once).

The same seeded numpy inputs go through both packages; the reference's
ground-plane draws are fed to the port through `draw`.  Tolerances:
masks, slots, labels, detections' validity exact; normal blocks 1e-5
relative (per-edge f32 products summed in another order); the Cholesky
solve 1e-4 relative (a Jacobi-scaled f32 factorization of a system whose
scaled condition number is ~1e3); object-edge Jacobians 1e-4; the joint
LM 2e-3 (fifteen damped trips in f32 whose accept tests compare costs of
~1e3 edges); the 12-frame run: the same keyframes and object slots,
poses 1e-3 m and object centres 0.02 m.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.core import quadric as jq
from qsp_slam_tpu.data import render as jrender
from qsp_slam_tpu.data.synthetic import ba_edges, make_ba_problem
from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from qsp_slam_tpu.opt import joint_ba as jjoint
from qsp_slam_tpu.opt import schur as jschur
from qsp_slam_tpu.perception import lidar_detect as jlidar
from qsp_slam_tpu.slam import map as jmap
from qsp_slam_tpu.slam import objects as jobj
from qsp_slam_tpu.slam.joint_mapping import joint_ba_step as jjoint_ba_step
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu_torch import convert
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.core.camera import Intrinsics
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.opt import joint_ba as tjoint
from qsp_slam_tpu_torch.opt import schur as tschur
from qsp_slam_tpu_torch.opt.reproj import ReprojEdges
from qsp_slam_tpu_torch.perception import groundplane as tgp
from qsp_slam_tpu_torch.perception import lidar_detect as tlidar
from qsp_slam_tpu_torch.slam import system as system_mod
from qsp_slam_tpu_torch.slam.joint_mapping import joint_ba_step
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)

BASELINE = 0.12
N_FRAMES = 12


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_plane_draw(gen, num_hyp):
    """Ground-plane draws of PRNGKey(generator seed)."""
    key = jax.random.PRNGKey(gen.initial_seed())
    return T(jax.random.uniform(key, (num_hyp, 3))), T(jax.random.uniform(jax.random.fold_in(key, 1), (num_hyp,)))


def t_edges(prob, valid=None) -> ReprojEdges:
    return ReprojEdges(T(prob.kf_idx).long(), T(prob.pt_idx).long(), T(prob.uv), T(prob.u_right),
                       T(prob.inv_sigma2), T(prob.valid if valid is None else valid))


def t_intr(intr) -> Intrinsics:
    return Intrinsics(*(float(v) for v in intr))


def cam_rmse(Ta, Tb):
    ca = -np.einsum("kji,kj->ki", np.asarray(Ta)[:, :3, :3], np.asarray(Ta)[:, :3, 3])
    cb = -np.einsum("kji,kj->ki", np.asarray(Tb)[:, :3, :3], np.asarray(Tb)[:, :3, 3])
    return float(np.sqrt(np.mean(np.sum((ca - cb) ** 2, -1))))


# -- the dense system ---------------------------------------------------------------


def test_build_normal_blocks(rng):
    """Scatter-add blocks on random edges (a point sees a camera once)
    against the reference's `segment_sum`s, 1e-5 relative."""
    K, N, E = 6, 40, 150
    pair = rng.choice(K * N, E, replace=False)
    kf, pt = (pair % K).astype(np.int32), (pair // K).astype(np.int32)
    r, Jc, Jp, w = (rng.normal(size=s).astype(np.float32) for s in ((E, 3), (E, 3, 6), (E, 3, 3), (E, 3)))
    w = np.abs(w)
    fixed = np.array([True, False, False, True, False, False])
    got = tschur.build_normal_blocks(T(r), T(Jc), T(Jp), T(w), T(kf).long(), T(pt).long(), K, N, T(fixed))
    ref = jschur.build_normal_blocks(*(jnp.asarray(x) for x in (r, Jc, Jp, w, kf, pt)), K, N, jnp.asarray(fixed))
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=1e-5, atol=1e-5)
    assert float(got.H_cc[0].abs().max()) == 0.0  # fixed cameras contribute no rows


def test_solve_dense_pose_system(rng):
    """An SPD system over 5 pose vertices (two fixed): the Jacobi-scaled f32
    Cholesky against the reference's, 1e-4 relative; fixed vertices take no
    update; an indefinite system gives NaN, not an error."""
    V = 5
    A = rng.normal(size=(6 * V, 6 * V)).astype(np.float32)
    S = (A @ A.T + 6 * V * np.eye(6 * V) * np.repeat(rng.uniform(0.1, 100, V), 6)).astype(np.float32)
    rhs = rng.normal(size=(V, 6)).astype(np.float32)
    fixed = np.array([False, True, False, False, True])
    got = tschur.solve_dense_pose_system(T(S).reshape(V, 6, V, 6), T(rhs), T(fixed))
    ref = jschur.solve_dense_pose_system(jnp.asarray(S).reshape(V, 6, V, 6), jnp.asarray(rhs), jnp.asarray(fixed))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-7)
    assert float(got[fixed].abs().max()) == 0.0
    bad = tschur.solve_dense_pose_system(-T(S).reshape(V, 6, V, 6), T(rhs), T(fixed))
    assert bool(torch.isnan(bad).all())


def test_object_edge_system(rng):
    """Residuals and both Jacobians of the camera-object edge against the
    reference's `jacfwd`, 1e-4; finite at a perfect measurement (the small-
    angle branch of `log_se3` at the identity)."""
    E = 12
    Tcw = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32))) for _ in range(E)])
    Tow = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32))) for _ in range(E)])
    M = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32))) for _ in range(E)])
    M = (M @ Tow @ np.linalg.inv(Tcw)).astype(np.float32)
    M[:3] = (Tow[:3] @ np.linalg.inv(Tcw[:3])).astype(np.float32)  # exact: zero residual
    r, Jc, Jo = tjoint._obj_edge_system(T(Tcw), T(Tow), torch.linalg.inv(T(M)))
    rr, rJc, rJo = jax.jit(jax.vmap(lambda a, b, c: jjoint._obj_edge_system(a, b, c, 1.0)))(
        jnp.asarray(Tcw), jnp.asarray(Tow), jnp.asarray(M))
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), atol=1e-5)
    np.testing.assert_allclose(Jc.numpy(), np.asarray(rJc), atol=1e-4)
    np.testing.assert_allclose(Jo.numpy(), np.asarray(rJo), atol=1e-4)
    assert bool(torch.isfinite(Jc[:3]).all() and torch.isfinite(Jo[:3]).all()) and float(r[:3].abs().max()) < 1e-5


def _object_edges(prob, Tow_gt, rng, noise):
    ci, oi, Ms = [], [], []
    for k in range(len(prob.Tcw_gt)):
        for o in range(len(Tow_gt)):
            n = np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, noise, 6), jnp.float32)))
            ci.append(k)
            oi.append(o)
            Ms.append(n @ Tow_gt[o] @ np.linalg.inv(prob.Tcw_gt[k]))
    return np.int32(ci), np.int32(oi), np.stack(Ms).astype(np.float32)


def _run_both(prob, Tow_init, cam_fixed, obj_fixed, ci, oi, Ms, edge_valid=None):
    jedges = ba_edges(prob)
    if edge_valid is not None:
        jedges = jedges._replace(valid=jnp.asarray(edge_valid))
    ref = jjoint.joint_bundle_adjustment(
        jnp.asarray(prob.Tcw_init), jnp.asarray(Tow_init), jnp.asarray(prob.points_init), jnp.asarray(cam_fixed),
        jnp.asarray(obj_fixed), jedges, jjoint.ObjectPoseEdges(jnp.asarray(ci), jnp.asarray(oi), jnp.asarray(Ms),
                                                               jnp.ones(len(ci), bool)), prob.intr)
    got = tjoint.joint_bundle_adjustment(
        T(prob.Tcw_init), T(Tow_init), T(prob.points_init), T(cam_fixed), T(obj_fixed), t_edges(prob, edge_valid),
        tjoint.ObjectPoseEdges(T(ci), T(oi), T(Ms), torch.ones(len(ci), dtype=torch.bool)), t_intr(prob.intr))
    return got, ref


class TestJointBA:
    """tests/test_joint_ba.py on the port, each against the reference's
    result (poses 2e-3, inlier masks differing on at most 0.5% of edges at
    the chi2 threshold)."""

    def test_objects_and_cameras_converge(self, rng):
        prob = make_ba_problem(num_cams=8, num_points=400, outlier_frac=0.02, seed=9)
        Tow_gt = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(np.concatenate(
            [rng.uniform(-1, 1, 3), rng.uniform(-0.5, 0.5, 3)]), jnp.float32))) for _ in range(3)])
        ci, oi, Ms = _object_edges(prob, Tow_gt, rng, 0.01)
        Tow_init = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32))) @ Tow_gt[o]
                             for o in range(3)]).astype(np.float32)
        got, ref = _run_both(prob, Tow_init, np.arange(8) == 0, np.zeros(3, bool), ci, oi, Ms)
        assert cam_rmse(got.Tcw.numpy(), prob.Tcw_gt) < 0.04
        assert np.linalg.norm(got.Tow.numpy()[:, :3, 3] - Tow_gt[:, :3, 3], axis=1).max() < 0.05
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=2e-3)
        np.testing.assert_allclose(got.Tow.numpy(), np.asarray(ref.Tow), atol=2e-3)
        assert (got.inlier.numpy() != np.asarray(ref.inlier)).mean() <= 5e-3
        np.testing.assert_array_equal(got.obj_inlier.numpy(), np.asarray(ref.obj_inlier))

    def test_object_edges_constrain_free_camera(self):
        prob = make_ba_problem(num_cams=4, num_points=200, outlier_frac=0.0, seed=11)
        Tow_gt = np.asarray(jlie.exp_se3(jnp.asarray([0.5, 0.2, 0.1, 0.1, 0.2, 0.0])))[None]
        ci, oi, Ms = _object_edges(prob, Tow_gt, np.random.default_rng(0), 0.0)
        got, ref = _run_both(prob, Tow_gt.astype(np.float32), np.arange(4) == 0, np.zeros(1, bool), ci, oi, Ms,
                             edge_valid=prob.kf_idx != 3)
        assert np.linalg.norm(got.Tcw[3].numpy() - prob.Tcw_gt[3]) < 0.05
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=2e-3)


def kitti_cli_configs(seq_dir):
    """The configuration `run_kitti` builds for a sequence at 500 features
    (the reference's and the port's), as its `main` does."""
    from qsp_slam_tpu.data.kitti import KittiSequence as JKittiSequence
    from qsp_slam_tpu.frontend.pyramid import PyramidConfig as JPyramidConfig
    from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig

    seq = JKittiSequence(str(seq_dir))
    H, W = seq.load_gray_pair(0)[0].shape
    intr = {k: float(v) for k, v in seq.intrinsics.items()}
    common = dict(width=W, height=H, baseline=seq.baseline, depth_max=60.0, local_map_budget=8192, **intr)
    return (TrackingConfig(orb=OrbConfig(num_features=500, pyramid=PyramidConfig(height=H, width=W)), **common),
            JTrackingConfig(orb=JOrbConfig(num_features=500, pyramid=JPyramidConfig(height=H, width=W)), **common))


def test_full_window_refines_early_keyframes_and_objects(stereo_seq):
    """tests/test_joint_system.py: `joint_ba_step(window=kmax)`, the global
    joint BA, refines keyframes and an object seen only by the earliest
    keyframes; the port's map and table against the reference's (poses
    2e-3, points 1e-2, the object 2e-3, edge validity on all but 0.5%).
    The configuration and capacities are those of the stereo command-line
    runs below, whose global joint BA then reuses the reference's compiled
    step."""
    rng = np.random.default_rng(5)
    cfg, jcfg = kitti_cli_configs(stereo_seq / "seq")
    K, P = 10, 300
    gt_T = [np.asarray(jlie.exp_se3(jnp.asarray([0.15 * k, 0.02 * k, 0.0, 0.0, 0.01 * k, 0.0], jnp.float32)))
            for k in range(K)]
    pts_gt = rng.uniform([-2, -2, 3.0], [2, 2, 7.0], (P, 3)).astype(np.float32)
    m = jmap.empty_map(kmax=16, nmax=4096, emax=32768)
    for k in range(K):
        noise = np.asarray(jlie.exp_se3(jnp.asarray(np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]),
                                                    jnp.float32)))
        m, _ = jmap.add_keyframe(m, jnp.asarray(gt_T[k] if k < 2 else noise @ gt_T[k]))
    m, ids = jmap.add_points(m, jnp.asarray(pts_gt + rng.normal(0, 0.02, (P, 3)).astype(np.float32)),
                             jnp.zeros((P, 256), jnp.int8), jnp.zeros(P, jnp.int32), jnp.zeros((P, 3)),
                             jnp.ones(P, bool))
    for k in range(K):
        pc = pts_gt @ gt_T[k][:3, :3].T + gt_T[k][:3, 3]
        uv = np.stack([cfg.fx * pc[:, 0] / pc[:, 2] + cfg.cx, cfg.fy * pc[:, 1] / pc[:, 2] + cfg.cy], -1)
        m = jmap.add_observations(m, jnp.int32(k), ids, jnp.asarray(uv + rng.normal(0, 0.3, (P, 2)), jnp.float32),
                                  jnp.full(P, -1.0), jnp.zeros(P, jnp.int32))
    objects = jobj.empty_objects(32)
    e_gt = jnp.asarray([0.5, 0.3, 5.0, 0.0, 0.0, 0.0, 0.3, 0.3, 0.3])
    e_init = e_gt.at[0:3].add(jnp.asarray([0.15, -0.1, 0.2]))
    objects = objects._replace(ellipsoid=objects.ellipsoid.at[0].set(e_init), valid=objects.valid.at[0].set(True),
                               num_objects=jnp.int32(1))
    T_wo = np.asarray(jlie.rt_to_se3(jq.euler_to_rotmat(e_gt[3:6]), e_gt[0:3]))
    for k in range(4):
        objects = objects._replace(
            pm_Toc=objects.pm_Toc.at[0, k].set(jnp.asarray(np.linalg.inv(T_wo) @ np.linalg.inv(gt_T[k]), jnp.float32)),
            pm_kf=objects.pm_kf.at[0, k].set(k), pm_next=objects.pm_next.at[0].set(k + 1))
    ref_m, ref_o = jjoint_ba_step(m, objects, jcfg, window=16)
    tm = convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}, device="cpu")
    to = convert.object_table_from_numpy({k: np.asarray(v) for k, v in objects._asdict().items()}, device="cpu")
    got_m, got_o = joint_ba_step(tm, to, cfg, window=16)

    def err(kf_Tcw, ks):
        return float(np.mean([np.linalg.norm(kf_Tcw[k][:3, 3] - gt_T[k][:3, 3]) for k in ks]))

    early = [2, 3, 4]
    assert err(got_m.kf_Tcw.numpy(), early) < 0.5 * err(np.asarray(m.kf_Tcw), early)
    d_init = np.linalg.norm(np.asarray(e_init[:3] - e_gt[:3]))
    assert np.linalg.norm(got_o.ellipsoid[0, :3].numpy() - np.asarray(e_gt[:3])) < 0.5 * d_init
    np.testing.assert_allclose(got_m.kf_Tcw.numpy(), np.asarray(ref_m.kf_Tcw), atol=2e-3)
    np.testing.assert_allclose(got_m.pt_xyz.numpy(), np.asarray(ref_m.pt_xyz), atol=1e-2)
    np.testing.assert_allclose(got_o.ellipsoid.numpy(), np.asarray(ref_o.ellipsoid), atol=2e-3)
    assert (got_m.ob_valid.numpy() != np.asarray(ref_m.ob_valid)).mean() <= 5e-3


# -- the stereo object step through the facade -----------------------------------------------


@pytest.fixture(scope="module")
def stereo_frames():
    """tests/test_joint_system.py's stereo scene: rendered pairs (baseline
    0.12 m), the left depth and the renderer's detections, from the
    reference package."""
    jcfg = JTrackingConfig(orb=JOrbConfig(num_features=500), baseline=BASELINE)
    scene = jrender.make_scene(num_objects=3, seed=2)
    base = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.44, 0, 0], jnp.float32))
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -BASELINE
    out = []
    for i in range(N_FRAMES):
        Tcw = np.asarray(jlie.exp_se3(jnp.asarray([0.045 * i, 0, 0, 0, 0, 0], jnp.float32)) @ base, np.float32)
        gl, depth, _ = jrender.render_scene(scene, jnp.asarray(Tcw), jcfg.intr)
        gr, _, _ = jrender.render_scene(scene, jnp.asarray(shift @ Tcw), jcfg.intr)
        det = jrender.gt_detections(scene, jnp.asarray(Tcw), jcfg.intr)
        out.append((np.asarray(gl), np.asarray(gr), {k: np.asarray(v) for k, v in det.items()}, Tcw,
                    np.asarray(depth)))
    return scene, out


@pytest.fixture(scope="module")
def stereo_seq(stereo_frames, tmp_path_factory):
    """The stereo scene written in the KITTI layout `make_kitti` writes (PNG
    pairs, calib with the TUM intrinsics and the 0.12 m baseline, times,
    velodyne scans backprojected from the left depth), with the ground-truth
    poses and the renderer's detections as per-frame caches.  Both command
    lines below run on it with the same configuration, so the reference
    compiles its stereo system once for the module."""
    from PIL import Image

    from qsp_slam_tpu.core.camera import backproject as jbackproject
    from qsp_slam_tpu.data.io import save_detection_cache
    from qsp_slam_tpu.data.make_kitti import TR_VELO_TO_CAM

    root = tmp_path_factory.mktemp("stereo_seq")
    seq = root / "seq"
    for sub in ("image_0", "image_1", "velodyne", "detections"):
        (seq / sub).mkdir(parents=True)
    intr = JTrackingConfig().intr
    fx, fy, cx, cy = (float(v) for v in intr)
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * BASELINE
    lines = [n + ": " + " ".join(f"{v:.9e}" for v in P.ravel()) for n, P in (("P0", P0), ("P1", P1), ("P2", P0),
                                                                                ("P3", P1))]
    (seq / "calib.txt").write_text("\n".join(lines + ["Tr: " + " ".join(f"{v:.9e}" for v in TR_VELO_TO_CAM.ravel())])
                                   + "\n")
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(N_FRAMES)))
    Tr = np.eye(4, dtype=np.float32)
    Tr[:3] = TR_VELO_TO_CAM
    ys, xs = np.mgrid[0:480:2, 0:640:2]
    uv = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    poses = []
    for i, (gl, gr, det, Tcw, depth) in enumerate(stereo_frames[1]):
        for sub, g in (("image_0", gl), ("image_1", gr)):
            Image.fromarray(g.astype(np.uint8)).save(seq / sub / f"{i:06d}.png")
        save_detection_cache(str(seq / "detections" / f"{i}.npz"), det)
        z = depth[::2, ::2].ravel()
        ok = (z > 0.5) & (z < 80.0)
        pc = np.asarray(jbackproject(jnp.asarray(uv[ok]), jnp.asarray(z[ok]), intr))
        velo = np.concatenate([pc, np.ones((len(pc), 1), np.float32)], -1) @ np.linalg.inv(Tr).T
        np.concatenate([velo[:, :3], np.zeros((len(pc), 1))], -1).astype(np.float32).tofile(
            seq / "velodyne" / f"{i:06d}.bin")
        poses.append(np.linalg.inv(Tcw)[:3].ravel())
    np.savetxt(root / "poses.txt", np.stack(poses), fmt="%.6e")
    return root


CLI = ["--num-features", "500", "--kmax", "16", "--nmax", "4096", "--emax", "32768", "--cpu"]


class Captured:
    """Each package's `SlamSystem.run_global_ba` wrapped: the system and
    its map and objects before the global BA are kept."""

    def __init__(self):
        from qsp_slam_tpu.slam import system as jsystem_mod

        self.classes = {"jax": jsystem_mod.SlamSystem, "port": SlamSystem}
        self.saved = {k: c.run_global_ba for k, c in self.classes.items()}
        self.systems, self.before = {}, {}

    def __enter__(self):
        for name, cls in self.classes.items():
            def wrapped(sysm, *a, _name=name, **k):
                self.systems[_name] = sysm
                self.before[_name] = (sysm.map_state, sysm.objects)
                return self.saved[_name](sysm, *a, **k)
            cls.run_global_ba = wrapped
        return self

    def __exit__(self, *exc):
        for name, cls in self.classes.items():
            cls.run_global_ba = self.saved[name]


@pytest.fixture(scope="module")
def stereo_e2e(stereo_seq):
    """Both packages' `run_kitti --detections --global-ba` on the stereo
    scene (local joint BA at keyframes), then one global BA each; the port
    on the reference's ground-plane draws."""
    from qsp_slam_tpu import run_kitti as jrun
    from qsp_slam_tpu_torch import run_kitti as trun

    flags = [str(stereo_seq / "seq"), "--poses", str(stereo_seq / "poses.txt"), "--detections",
             str(stereo_seq / "seq" / "detections"), "--global-ba", *CLI]
    calls = []
    saved = {k: getattr(system_mod, k) for k in ("estimate_ground_plane_points", "joint_ba_step")}

    def counted(*a, **k):
        calls.append(k.get("window", a[3] if len(a) > 3 else None))
        return saved["joint_ba_step"](*a, **k)

    try:
        system_mod.estimate_ground_plane_points = functools.partial(tgp.estimate_ground_plane_points,
                                                                    draw=jax_plane_draw)
        system_mod.joint_ba_step = counted
        with Captured() as cap:
            jrun.main(flags)
            trun.main(flags)
    finally:
        for k, v in saved.items():
            setattr(system_mod, k, v)
    js, ts = cap.systems["jax"], cap.systems["port"]
    return js, ts, calls, (*cap.before["port"], *cap.before["jax"])


def test_track_stereo_with_detections_matches_the_reference(stereo_e2e):
    js, ts, calls, (tm, to, jm, jo) = stereo_e2e
    assert ts.stats["kf_frames"] == js.stats["kf_frames"] and len(ts.stats["kf_frames"]) >= 3
    for name in ("valid", "label", "obs_count", "pm_kf"):
        np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)), name)
    assert int(to.valid.sum()) >= 1 and int((to.pm_kf >= 0).sum()) >= 2
    np.testing.assert_allclose(np.stack(ts.trajectory), np.stack(js.trajectory), atol=1e-3)
    valid = to.valid.numpy()
    np.testing.assert_allclose(to.ellipsoid.numpy()[valid, :3], np.asarray(jo.ellipsoid)[valid, :3], atol=0.02)
    np.testing.assert_allclose(ts.ground_plane, js.ground_plane, atol=1e-4)
    assert ts._gp_count == js._gp_count


def test_joint_ba_runs_locally_and_globally(stereo_e2e, stereo_frames):
    """The local joint BA ran at keyframes with objects (the command line's
    window, 8) and the global BA went joint (window kmax); the map after it
    matches the reference's (poses 2e-3 m, object centres 0.02 m), and an
    object lies within 0.35 m of the truth (tests/test_joint_system.py's
    bound)."""
    js, ts, calls, _ = stereo_e2e
    assert ts.ba_window in calls and calls[-1] == ts.kmax == 16
    n = int(ts.map_state.num_kfs)
    np.testing.assert_allclose(ts.map_state.kf_Tcw[:n].numpy(), np.asarray(js.map_state.kf_Tcw)[:n], atol=2e-3)
    valid = ts.objects.valid.numpy()
    np.testing.assert_allclose(ts.objects.ellipsoid.numpy()[valid, :3], np.asarray(js.objects.ellipsoid)[valid, :3],
                               atol=0.02)
    scene, frames = stereo_frames
    est = [tlie.transform_points(tlie.inv_se3(T(frames[0][3])), e[None, :3])[0].numpy()
           for e in ts.objects.ellipsoid[ts.objects.valid]]
    gt = np.asarray(scene.ellipsoids)[:, :3]
    assert min(np.linalg.norm(gt - e, axis=1).min() for e in est) < 0.35


# -- LiDAR proposals and the KITTI command line ----------------------------------------------

KITTI_INTR = Intrinsics(718.0, 718.0, 607.0, 185.0)


def _car_scan(rng, with_car=True):
    g = np.stack([rng.uniform(-15, 15, 3000), np.full(3000, 1.7), rng.uniform(2, 40, 3000)], -1)
    car = np.stack([rng.uniform(2.0, 3.8, 500), rng.uniform(0.3, 1.6, 500), rng.uniform(9.0, 13.0, 500)], -1)
    scan = np.concatenate([g, car] if with_car else [g]).astype(np.float32)
    return (scan + rng.normal(0, 0.01, scan.shape)).astype(np.float32), car


def test_voxel_cluster(rng):
    a = rng.normal(0, 0.3, (200, 3)) + [0, 0, 5]
    b = rng.normal(0, 0.3, (200, 3)) + [6, 0, 5]
    pts = np.concatenate([a, b])
    labels = tlidar._voxel_cluster(pts)
    la, lb = labels[:200], labels[200:]
    assert len(np.unique(la)) <= 2 and np.bincount(la).argmax() != np.bincount(lb).argmax()
    np.testing.assert_array_equal(labels, jlidar._voxel_cluster(pts))


@pytest.mark.parametrize("with_car", [True, False])
def test_lidar_detections(rng, with_car):
    """tests/test_lidar_detect.py on the port (the car's centre in its box;
    a ground-only scan gives nothing), and the reference's dict on the
    reference's ground draws: boxes 1e-3 px, the rest exact."""
    scan, car = _car_scan(rng, with_car)
    got = tlidar.lidar_detections(scan, KITTI_INTR, 1241, 376, device="cpu", draw=jax_plane_draw)
    from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics

    ref = jlidar.lidar_detections(scan, JIntrinsics(*(jnp.float32(v) for v in KITTI_INTR)), 1241, 376)
    for k in ("label", "prob", "valid"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["bbox"], ref["bbox"], atol=1e-3)
    if not with_car:
        assert got["valid"].sum() == 0
        return
    b = got["bbox"][got["valid"]][0]
    c = car.mean(0)
    u, v = 718.0 * c[0] / c[2] + 607.0, 718.0 * c[1] / c[2] + 185.0
    assert b[0] <= u <= b[2] and b[1] <= v <= b[3]


def test_make_kitti_and_run_kitti_with_lidar_detections(stereo_seq, stereo_e2e, tmp_path):
    """The stereo scene in `make_kitti`'s layout (its first 6 frames, at the
    configuration of `stereo_e2e`, which compiled the reference's system)
    into both command lines with `--lidar-detections --global-ba`: the
    same summary (the port on the reference's ground draws), the LiDAR
    provider called at keyframes only, its time in the report."""
    import json

    from qsp_slam_tpu import run_kitti as jrun
    from qsp_slam_tpu_torch import run_kitti as trun

    root = stereo_seq / "seq"
    flags = ["--poses", str(stereo_seq / "poses.txt"), "--lidar-detections", "--global-ba", "--max-frames", "6", *CLI]
    ref = jrun.main([str(root), *flags])
    saved = system_mod.estimate_ground_plane_points, tlidar.lidar_detections
    try:
        system_mod.estimate_ground_plane_points = functools.partial(tgp.estimate_ground_plane_points,
                                                                    draw=jax_plane_draw)
        tlidar.lidar_detections = functools.partial(saved[1], draw=jax_plane_draw)
        got = trun.main([str(root), *flags, "--save-dir", str(tmp_path / "out")])
    finally:
        system_mod.estimate_ground_plane_points, tlidar.lidar_detections = saved
    for key in ("frames", "keyframes", "num_points", "num_objects", "global_ba"):
        assert got[key] == ref[key], key
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) < 1e-3
    report = json.loads((tmp_path / "out" / "report.json").read_text())
    assert report["det_keyframes"] == got["keyframes"] and report["det_ms_median"] > 0

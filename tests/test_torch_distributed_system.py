"""Parity of the port's sharded global BA inside the system with the JAX
package (`tests/test_distributed_system.py`'s scenes): `global_ba_sharded`
on a system map and on a map after `correct_loop`, `global_joint_ba_sharded`
with a measured object, `SlamSystem.run_global_ba` on a mesh of two ranks
and of one, and `run_tum --mesh 2 --global-ba` as a command.

The port's side runs on two gloo ranks on the CPU, started once for the
module (`parallel.replay`); the reference's on a two-device mesh of
conftest's virtual CPU devices, its sharded solvers under `jax.jit` (the
eager `shard_map` takes minutes on the CPU).

Tolerances: poses 1e-4 and points 1e-3 absolute against the reference's
sharded path (sums in another order than `psum`'s, f32); both ranks the
same bits; the reference test's own bars for convergence and for the
sharded path against the single-device one (0.05 m, the same keyframe ATE
within 20% or 1 mm).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.data.synthetic import make_ba_problem
from qsp_slam_tpu.eval.ate import ate_rmse
from qsp_slam_tpu.parallel import map_sharded_ba as jmsb
from qsp_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from qsp_slam_tpu.slam import distributed_mapping as jdm
from qsp_slam_tpu.slam import map as jmap
from qsp_slam_tpu.slam.local_mapping import global_ba_step as jglobal_ba_step
from qsp_slam_tpu.slam.loop_closing import LoopDetection, correct_loop
from qsp_slam_tpu.slam.objects import empty_objects
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu_torch.convert import map_state_from_numpy
from qsp_slam_tpu_torch.parallel.mesh import make_mesh
from qsp_slam_tpu_torch.parallel.multihost import spawn_ranks
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(1)
JCFG = JTrackingConfig()  # its intrinsics are data.synthetic.TUM_INTR
CAP = dict(kmax=16, nmax=256, emax=4096)


def map_from_problem(prob):
    """A SyntheticBA packed into the reference's MapState
    (`tests/test_distributed_system.py`'s helper)."""
    K, N = prob.Tcw_init.shape[0], prob.points_init.shape[0]
    m = jmap.empty_map(**CAP)
    for k in range(K):
        m, _ = jmap.add_keyframe(m, jnp.asarray(prob.Tcw_init[k]))
    m, ids = jmap.add_points(m, jnp.asarray(prob.points_init), jnp.zeros((N, 256), jnp.int8),
                             jnp.zeros(N, jnp.int32), jnp.zeros((N, 3), jnp.float32), jnp.ones(N, bool))
    idmap = np.asarray(ids)
    for k in range(K):
        sel = prob.kf_idx == k
        pt_ids = np.full(N, -1, np.int32)
        uv = np.zeros((N, 2), np.float32)
        ur = np.full(N, -1.0, np.float32)
        pt_ids[: sel.sum()] = idmap[prob.pt_idx[sel]]
        uv[: sel.sum()] = prob.uv[sel]
        ur[: sel.sum()] = prob.u_right[sel]
        m = jmap.add_observations(m, jnp.int32(k), jnp.asarray(pt_ids), jnp.asarray(uv), jnp.asarray(ur),
                                  jnp.zeros(N, jnp.int32))
    return m


def as_np(t) -> dict:
    return {k: np.asarray(v) for k, v in t._asdict().items()}


def kf_center_rmse(kf_Tcw, Tcw_gt):
    K = Tcw_gt.shape[0]
    Ta = np.asarray(kf_Tcw[:K])
    ca = -np.einsum("kji,kj->ki", Ta[:, :3, :3], Ta[:, :3, 3])
    cg = -np.einsum("kji,kj->ki", Tcw_gt[:, :3, :3], Tcw_gt[:, :3, 3])
    return float(np.sqrt(np.mean(np.sum((ca - cg) ** 2, -1))))


def system_problem():
    return make_ba_problem(num_cams=8, num_points=200, obs_per_point=4, outlier_frac=0.0, seed=11)


def loop_problem():
    """`test_loop_closure_e2e_mesh_vs_single`'s drifted chain and its loop."""
    prob = make_ba_problem(num_cams=10, num_points=200, obs_per_point=4, pix_noise=0.1, outlier_frac=0.0,
                           pose_noise=0.0, point_noise=0.0, seed=5)
    drifted = prob.Tcw_init.copy()
    for k in range(10):
        xi = jnp.asarray([0.02 * k, 0.015 * k, 0.0, 0.0, 0.004 * k, 0.0])
        drifted[k] = np.asarray(jlie.exp_se3(xi)) @ prob.Tcw_gt[k]
    prob = prob._replace(Tcw_init=drifted)
    m = map_from_problem(prob)
    det = LoopDetection(found=jnp.asarray(True), match_kf=jnp.int32(0),
                        T_cur_match=jnp.asarray(prob.Tcw_gt[9] @ np.linalg.inv(prob.Tcw_gt[0]), jnp.float32),
                        num_inliers=jnp.int32(50), score=jnp.asarray(0.9))
    m_corr, _ = correct_loop(m, empty_objects(4), jnp.int32(9), det)
    return prob, m, m_corr


def joint_scene():
    """`test_joint_objects_move_with_the_map`'s stereo map and object."""
    prob = make_ba_problem(num_cams=6, num_points=150, obs_per_point=4, outlier_frac=0.0, stereo=True, seed=9)
    m = map_from_problem(prob)
    objects = empty_objects(4)
    T_wo_gt = np.eye(4, dtype=np.float32)
    T_wo_gt[:3, 3] = [0.5, 0.0, 1.0]
    pm_Toc, pm_kf = np.array(objects.pm_Toc), np.array(objects.pm_kf)
    for j, k in enumerate([1, 3, 5]):
        pm_Toc[0, j] = np.linalg.inv(T_wo_gt) @ np.linalg.inv(np.asarray(prob.Tcw_gt[k]))
        pm_kf[0, j] = k
    e0 = np.zeros(9, np.float32)
    e0[:3] = T_wo_gt[:3, 3] + np.asarray([0.2, -0.1, 0.15])
    e0[6:9] = 0.3
    objects = objects._replace(valid=objects.valid.at[0].set(True), ellipsoid=objects.ellipsoid.at[0].set(e0),
                               pm_Toc=jnp.asarray(pm_Toc), pm_kf=jnp.asarray(pm_kf))
    return prob, m, objects, T_wo_gt


def run_problem():
    return make_ba_problem(num_cams=6, num_points=150, obs_per_point=4, outlier_frac=0.0, seed=3)


@pytest.fixture(scope="module")
def jax_sharded():
    """The reference's sharded solvers under `jax.jit` (the mesh and the
    shape options static), patched into its distributed_mapping."""
    with pytest.MonkeyPatch.context() as mp:
        opts = ("iters", "axis", "pre_padded")
        mp.setattr(jdm, "map_sharded_ba", jax.jit(jmsb.map_sharded_ba, static_argnums=0,
                                                  static_argnames=opts + ("use_huber",)))
        mp.setattr(jdm, "map_sharded_joint_ba", jax.jit(jmsb.map_sharded_joint_ba, static_argnums=0,
                                                        static_argnames=opts))
        yield jmake_mesh(2, axis="map")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on two gloo ranks, one spawn -> [rank 0's, rank 1's]
    outputs and JSON lines."""
    tmp = tmp_path_factory.mktemp("ranks")
    z, cases = {}, []

    def add(name, kind, m, objs=None, **opt):
        z.update({f"{name}/{k}": v for k, v in as_np(m).items()})
        z.update({f"{name}/intr": np.zeros(4, np.float32), f"{name}/bf": np.float32(0)})
        if objs is not None:
            z.update({f"{name}/obj/{k}": v for k, v in as_np(objs).items()})
        cases.append({"name": name, "kind": kind, "prefix": name, **opt})

    add("system_map", "global_ba", map_from_problem(system_problem()), iters=10)
    add("loop", "global_ba", loop_problem()[2], iters=10)
    _, m, objs, _ = joint_scene()
    add("joint", "global_joint_ba", m, objs, iters=8)
    add("run", "system_global_ba", map_from_problem(run_problem()), iters=10, capacity=[16, 256, 4096])
    add("parted", "system_global_ba", map_from_problem(run_problem()), iters=10, capacity=[16, 256, 4096],
        diverge=True)
    add("parted_loop", "system_global_ba", map_from_problem(run_problem()), capacity=[16, 256, 4096],
        diverge=True, loop_on_rank0=5)
    np.savez(tmp / "problems.npz", cases=np.array(json.dumps(cases)), **z)
    res = spawn_ranks(2, [str(tmp / "problems.npz"), str(tmp / "out"), "--cpu"],
                      target="qsp_slam_tpu_torch.parallel.replay:main", cpu=True, timeout=300)
    outs = [dict(np.load(tmp / "out" / f"rank{r}.npz")) for r in range(2)]
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=f"rank 1 {k}")
    return outs[0], [r.json() for r in res]


def close(got, ref, atol):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


class TestGlobalBASharded:
    def test_matches_the_reference_on_a_system_map(self, ranks, jax_sharded):
        prob = system_problem()
        m = map_from_problem(prob)
        ref = jdm.global_ba_sharded(m, JCFG, jax_sharded, iters=10)
        got = ranks[0]
        close(got["system_map/kf_Tcw"], ref.kf_Tcw, 1e-4)
        close(got["system_map/pt_xyz"], ref.pt_xyz, 1e-3)
        # The reference test's bars: converged, and at the single-device
        # program's optimum within noise.
        single = jglobal_ba_step(m, JCFG, iters=10)
        e_init, e_single = kf_center_rmse(m.kf_Tcw, prob.Tcw_gt), kf_center_rmse(single.kf_Tcw, prob.Tcw_gt)
        e_shard = kf_center_rmse(got["system_map/kf_Tcw"], prob.Tcw_gt)
        assert e_shard < 0.3 * e_init and abs(e_shard - e_single) < max(0.02, 0.5 * e_single)
        close(got["system_map/kf_Tcw"][:8, :3, 3], single.kf_Tcw[:8, :3, 3], 0.05)

    def test_loop_closure_map_matches_the_reference(self, ranks, jax_sharded):
        """The map after `correct_loop`: the sharded BA on two ranks against
        the reference's on two devices, and the loop's drift corrected as
        well as by the single-device program (keyframe ATE, Sim(3)-aligned
        for the monocular gauge)."""
        prob, m, m_corr = loop_problem()
        ref = jdm.global_ba_sharded(m_corr, JCFG, jax_sharded, iters=10)
        got = ranks[0]
        close(got["loop/kf_Tcw"], ref.kf_Tcw, 1e-4)
        close(got["loop/pt_xyz"], ref.pt_xyz, 1e-3)

        def kf_ate(kf_Tcw):
            return ate_rmse(np.asarray(kf_Tcw[:10]), prob.Tcw_gt, with_scale=True)

        e_before, e_shard = kf_ate(m.kf_Tcw), kf_ate(got["loop/kf_Tcw"])
        e_single = kf_ate(jglobal_ba_step(m_corr, JCFG, iters=10).kf_Tcw)
        assert e_shard < 0.3 * e_before and abs(e_shard - e_single) < max(1e-3, 0.2 * e_single)

    def test_joint_objects_move_with_the_map(self, ranks, jax_sharded):
        _, m, objs, T_wo_gt = joint_scene()
        ref_m, ref_o = jdm.global_joint_ba_sharded(m, objs, JCFG, jax_sharded, iters=8)
        got = ranks[0]
        close(got["joint/kf_Tcw"], ref_m.kf_Tcw, 1e-4)
        close(got["joint/pt_xyz"], ref_m.pt_xyz, 1e-3)
        close(got["joint/ellipsoid"], ref_o.ellipsoid, 1e-4)
        e0 = np.asarray(objs.ellipsoid[0])
        err_before = np.linalg.norm(e0[:3] - T_wo_gt[:3, 3])
        assert np.linalg.norm(got["joint/ellipsoid"][0, :3] - T_wo_gt[:3, 3]) < 0.5 * err_before
        np.testing.assert_allclose(got["joint/ellipsoid"][0, 6:9], 0.3, atol=1e-6)


class TestSystemMesh:
    def test_two_ranks_take_the_sharded_branch(self, ranks, jax_sharded):
        """`run_global_ba` on a mesh of two ranks runs the sharded point BA
        (`stats["global_ba"]`) and lands on the reference system's map on
        its two-device mesh, and adopts the newest keyframe's pose."""
        from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem

        got, lines = ranks
        assert all(ln["cases"]["run"]["global_ba"] == ["point-sharded"] for ln in lines)
        ref = JSlamSystem(JCFG, enable_objects=False, mesh=jax_sharded, **CAP)
        ref.map_state = map_from_problem(run_problem())
        ref.initialized = True
        ref.run_global_ba()
        close(got["run/kf_Tcw"], ref.map_state.kf_Tcw, 1e-4)
        close(got["run/pt_xyz"], ref.map_state.pt_xyz, 1e-3)
        np.testing.assert_allclose(got["run/Tcw"], got["run/kf_Tcw"][5], atol=1e-6)

    @pytest.mark.parametrize("case", ["parted", "parted_loop"])
    def test_ranks_that_parted_take_rank_0s_decisions(self, ranks, case):
        """Rank 1 holds an empty map of twice the capacity: on its own it
        would skip the BA (fewer than 2 keyframes) or broadcast other
        shapes.  `run_global_ba`, and the end of a frame in which rank 0
        alone closed a loop at keyframe 5, make both ranks run rank 0's
        sharded BA from rank 0's state, and both end with the map of the
        case where the ranks agreed, bit for bit (the fixture checks the
        ranks against each other); after the loop the pose is keyframe
        5's, in the frame's trajectory entry too."""
        got, lines = ranks
        facts = [ln["cases"][case] for ln in lines]
        assert all(f["global_ba"] == ["point-sharded"] for f in facts)
        assert facts[0]["map_digest"] == facts[1]["map_digest"]
        for k in ("kf_Tcw", "pt_xyz"):
            np.testing.assert_array_equal(got[f"{case}/{k}"], got[f"run/{k}"])
        if case == "parted_loop":
            assert [f["loops_closed"] for f in facts] == [1, 1]
            np.testing.assert_array_equal(got["parted_loop/Tcw"], got["run/kf_Tcw"][5])
            np.testing.assert_array_equal(got["parted_loop/trajectory_last"], got["parted_loop/Tcw"])

    def test_a_size_one_mesh_takes_the_single_device_branch(self):
        """A mesh of one rank needs no process group and runs
        `global_ba_step`, as the system without a mesh (the reference:
        `_multi_device` is False for a one-device mesh)."""
        m = as_np(map_from_problem(run_problem()))
        runs = {}
        for name, mesh in (("mesh1", make_mesh(1, axis="map", device="cpu")), ("none", None)):
            s = SlamSystem(TrackingConfig(), enable_objects=False, mesh=mesh, device="cpu", **CAP)
            s.map_state = map_state_from_numpy(m, device="cpu")
            s.initialized = True
            s.run_global_ba()
            runs[name] = s
        assert runs["mesh1"].stats["global_ba"] == ["point"] == runs["none"].stats["global_ba"]
        np.testing.assert_array_equal(runs["mesh1"].map_state.kf_Tcw.numpy(), runs["none"].map_state.kf_Tcw.numpy())
        with pytest.raises(TypeError, match="mesh"):
            SlamSystem(TrackingConfig(), mesh=object(), device="cpu", **CAP)


def test_run_tum_mesh_two(tmp_path):
    """`run_tum --mesh 2 --global-ba` as a command: it runs itself as two
    gloo ranks and exits 0; rank 0 alone prints and writes, and the
    trajectory written is the one rank 0 printed the ATE of; both ranks
    end with the same map, bit for bit (their SHA-256 on stderr); the frame
    history (global BA corrects the map, not it) is the single-device
    run's."""
    from qsp_slam_tpu_torch import run_tum
    from qsp_slam_tpu_torch.data import io as tio
    from qsp_slam_tpu_torch.data import make_tum
    from qsp_slam_tpu_torch.data.tum import TumSequence
    from qsp_slam_tpu_torch.eval.ate import ate_rmse as tate

    seq = tmp_path / "seq"
    make_tum.main([str(seq), "--frames", "8", "--cpu"])
    (tmp_path / "c.yaml").write_text("ORBextractor.nFeatures: 500\n")
    common = [str(seq), "--config", str(tmp_path / "c.yaml"), "--global-ba", "--cpu"]
    p = subprocess.run([sys.executable, "-m", "qsp_slam_tpu_torch.run_tum", *common, "--mesh", "2",
                        "--save-dir", str(tmp_path / "out")],
                       capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["mesh"] == {"size": 2, "backend": "gloo"} and out["global_ba"]
    assert "[rank 0/2] torch.distributed backend gloo" in p.stderr and "[rank 1/2]" in p.stderr
    digests = [ln.split("] map ")[1] for ln in p.stderr.splitlines() if "] map " in ln]
    assert len(digests) == 2 and digests[0] == digests[1]
    ts, Tcw = tio.load_trajectory_tum(str(tmp_path / "out" / "CameraTrajectory.txt"))
    gt = np.stack([np.linalg.inv(f[3]) for f in TumSequence(str(seq)).frames])
    assert len(ts) == 8 and abs(tate(Tcw, gt) - out["ate_rmse_m"]) < 1e-5
    single = run_tum.main(common)
    assert "mesh" not in single and (single["keyframes"], single["frames"]) == (out["keyframes"], out["frames"])
    assert abs(single["ate_rmse_m"] - out["ate_rmse_m"]) < 1e-4

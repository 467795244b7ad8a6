"""Parity of the port's distribution layer with the JAX package: the
synthetic BA problem, the edge- and map-sharded solvers on gloo ranks
against `shard_map` on meshes of the same size, the launcher, the
multi-process worker and the dry run.

The port's ranks are processes started by `spawn_ranks` on the CPU (gloo);
one spawn per world size runs every solver case (`parallel.replay`), and
the JAX runs use conftest's virtual CPU devices.

Tolerances: the problem's numpy draws bitwise, its f32 `exp_se3` starting
poses within 1e-6 (an ulp or two at 6 m); padding and slot layouts
exactly; `global_bundle_adjustment` poses 1e-3 and points 1e-2 absolute
after its ten Huber trips and the chi2 gate, the gate parting the
packages only within 1% of its threshold, the cost 2e-3 relative after
those edges; the sharded solvers (sums in another order than
`psum`'s) cost 1e-4 relative, poses 1e-4 and points 1e-3 absolute; every
rank returns the same bits; the worker's world sizes 1 and 2 agree to
rtol 1e-4, as the reference's two-process test.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.data.synthetic import ba_edges as jba_edges
from qsp_slam_tpu.data.synthetic import make_ba_problem as jmake_ba_problem
from qsp_slam_tpu.opt.joint_ba import ObjectPoseEdges as JObjectPoseEdges
from qsp_slam_tpu.opt.local_ba import global_bundle_adjustment as jglobal_ba
from qsp_slam_tpu.parallel import map_sharded_ba as jmsb
from qsp_slam_tpu.parallel import sharded_ba as jsb
from qsp_slam_tpu_torch.data.synthetic import ba_edges, make_ba_problem
from qsp_slam_tpu_torch.opt.local_ba import global_bundle_adjustment
from qsp_slam_tpu_torch.opt.reproj import edge_chi2, residuals_and_jacobians
from qsp_slam_tpu_torch.opt.robust import CHI2_MONO
from qsp_slam_tpu_torch.parallel import map_sharded_ba as tmsb
from qsp_slam_tpu_torch.parallel import sharded_ba as tsb
from qsp_slam_tpu_torch.parallel.dryrun import dryrun_multichip
from qsp_slam_tpu_torch.parallel.mesh import make_mesh
from qsp_slam_tpu_torch.parallel.multihost import orchestrate, spawn_ranks
from qsp_slam_tpu_torch.parallel.replay import problem_arrays, save_problems

torch.set_num_threads(1)
REPLAY = "qsp_slam_tpu_torch.parallel.replay:main"
EDGE_FIELDS = ("kf_idx", "pt_idx", "uv", "u_right", "inv_sigma2", "valid")
WORLDS = (2, 4)


def T(x):
    return torch.from_numpy(np.array(x))


def joint_problem():
    """The stereo problem with two objects: object 0 measured from
    keyframes 1, 3 and 5 (its start 0.2 m off), object 1 once (fixed)."""
    prob = jmake_ba_problem(num_cams=6, num_points=150, obs_per_point=4, outlier_frac=0.0, stereo=True, seed=9)
    M = 4
    T_wo = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T_wo[0, :3, 3] = [0.5, 0.0, 1.0]
    T_wo[1, :3, 3] = [-0.5, 0.3, 0.2]
    T_oc = np.tile(np.eye(4, dtype=np.float32), (2, M, 1, 1))
    kf = np.full((2, M), -1, np.int32)
    for j, k in enumerate([1, 3, 5]):
        T_oc[0, j] = np.linalg.inv(T_wo[0]) @ np.linalg.inv(prob.Tcw_gt[k])
        kf[0, j] = k
    T_oc[1, 0] = np.linalg.inv(T_wo[1]) @ np.linalg.inv(prob.Tcw_gt[2])
    kf[1, 0] = 2
    T_wo_init = T_wo.copy()
    T_wo_init[0, :3, 3] += [0.2, -0.1, 0.15]
    return prob, {
        "Tow": np.linalg.inv(T_wo_init).astype(np.float32), "obj_fixed": np.array([False, True]),
        "obj_cam_idx": np.clip(kf, 0, None).reshape(-1), "obj_obj_idx": np.repeat(np.arange(2, dtype=np.int32), M),
        "obj_T_oc": T_oc.reshape(-1, 4, 4), "obj_valid": (kf >= 0).reshape(-1),
    }


ITERS = 8
MONO = jmake_ba_problem(num_cams=6, num_points=300, outlier_frac=0.0, seed=7)
STEREO, OBJ = joint_problem()
STEREO_BF = 0.08 * float(STEREO.intr.fx)


@functools.lru_cache(maxsize=None)
def jax_results(world: int) -> dict:
    """The reference's sharded solvers on a `world`-device mesh, each under
    one `jax.jit` (its eager `shard_map` takes minutes on the CPU)."""
    cf = jnp.zeros(6, bool).at[0].set(True)
    out = {}
    T, p, c = jax.jit(lambda T0, p0: jsb.sharded_local_ba(jsb.make_edge_mesh(world), T0, p0, cf, jba_edges(MONO),
                                                          MONO.intr, iters=ITERS))(MONO.Tcw_init, MONO.points_init)
    out["edge"] = {"Tcw": T, "points": p, "cost": c}
    slots = jmsb.edges_to_slots(jba_edges(MONO), 300, slots=8)
    T, p, c = jax.jit(lambda T0, p0: jmsb.map_sharded_ba(jmsb.make_map_mesh(world), T0, p0, cf, slots, MONO.intr,
                                                         iters=ITERS))(MONO.Tcw_init, MONO.points_init)
    out["map"] = {"Tcw": T, "points": p, "cost": c}
    oe = JObjectPoseEdges(*(jnp.asarray(OBJ[f"obj_{f}"]) for f in JObjectPoseEdges._fields))
    slots = jmsb.edges_to_slots(jba_edges(STEREO), 150)
    T, Tw, p, c = jax.jit(lambda T0, Tw0, p0: jmsb.map_sharded_joint_ba(
        jmsb.make_map_mesh(world), T0, Tw0, p0, cf, jnp.asarray(OBJ["obj_fixed"]), slots, oe, STEREO.intr,
        baseline_fx=STEREO_BF, iters=ITERS))(STEREO.Tcw_init, OBJ["Tow"], STEREO.points_init)
    out["joint"] = {"Tcw": T, "Tow": Tw, "points": p, "cost": c}
    return {k: {f: np.asarray(v) for f, v in d.items()} for k, d in out.items()}


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    """Every solver case at world sizes 2 and 4: one spawn of gloo ranks per
    world size -> {world: [rank outputs]}."""
    tmp = tmp_path_factory.mktemp("ranks")
    save_problems(tmp / "problems.npz", [
        {"name": "edge", "kind": "edge_ba", "prefix": "mono", "iters": ITERS},
        {"name": "map", "kind": "map_ba", "prefix": "mono", "iters": ITERS, "slots": 8},
        {"name": "joint", "kind": "map_joint_ba", "prefix": "stereo", "iters": ITERS},
    ], {"mono": problem_arrays(MONO), "stereo": {**problem_arrays(STEREO, STEREO_BF), **OBJ}})
    outs = {}
    for world in WORLDS:
        res = spawn_ranks(world, [str(tmp / "problems.npz"), str(tmp / f"w{world}"), "--cpu"], target=REPLAY,
                          cpu=True, timeout=300)
        lines = [r.json() for r in res]
        assert [ln["rank"] for ln in lines] == list(range(world))
        assert all(ln["world"] == world and ln["backend"] == "gloo" for ln in lines)
        outs[world] = [dict(np.load(tmp / f"w{world}" / f"rank{r}.npz")) for r in range(world)]
    return outs


class TestProblem:
    @pytest.mark.parametrize("seed", [0, 3, 7])
    def test_make_ba_problem_and_edges_match_the_reference(self, seed):
        kw = dict(num_cams=6, num_points=300, obs_per_point=5, outlier_frac=0.1, stereo=seed == 3, seed=seed)
        ref, got = jmake_ba_problem(**kw), make_ba_problem(**kw)
        assert got.intr == ref.intr
        for f in ref._fields:
            if f == "intr":
                continue
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            if f == "Tcw_init":  # through each package's f32 exp_se3
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
        for f, a, b in zip(EDGE_FIELDS, ba_edges(got, "cpu"), jba_edges(ref)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)

    def test_padding_and_slots_are_exact(self):
        prob = jmake_ba_problem(num_cams=6, num_points=37, obs_per_point=5, seed=1)
        je, te = jba_edges(prob), ba_edges(make_ba_problem(num_cams=6, num_points=37, obs_per_point=5, seed=1),
                                            "cpu")
        for shards in (2, 4, 8):
            for a, b in zip(tsb.pad_edges_for_mesh(te, shards), jsb.pad_edges_for_mesh(je, shards)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        need = jmsb.required_slots(je, 37)
        assert tmsb.required_slots(te, 37) == need >= 2
        for cap in (None, need, 8):
            ts, js = tmsb.edges_to_slots(te, 37, cap), jmsb.edges_to_slots(je, 37, cap)
            for f, a, b in zip(tmsb.SlotEdges._fields, ts, js):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
            pts = torch.from_numpy(prob.points_init)
            tp, tps = tmsb.pad_points_for_mesh(pts, ts, 8)
            jp, jps = jmsb.pad_points_for_mesh(jnp.asarray(prob.points_init), js, 8)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            for a, b in zip(tps, jps):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for mod, edges in ((tmsb, te), (jmsb, je)):
            with pytest.raises(ValueError, match="slot capacity"):
                mod.edges_to_slots(edges, 37, slots=need - 1)

    def test_global_bundle_adjustment_matches_the_reference(self):
        """With 3% outliers: the poses and points within tolerance; the chi2
        gate may part the packages only on edges whose chi2 lies within 1%
        of the threshold (f32 rounding of the solution moves them across),
        and, those edges' chi2 taken off, the plain costs agree within 2e-3
        (the other edges' share of the solutions' 1e-3 m gap)."""
        prob = jmake_ba_problem(num_cams=8, num_points=500, outlier_frac=0.03, seed=2)
        ref = jax.jit(lambda T0, p0: jglobal_ba(T0, p0, jba_edges(prob), prob.intr))(prob.Tcw_init, prob.points_init)
        te = ba_edges(prob, "cpu")
        got = global_bundle_adjustment(T(prob.Tcw_init), T(prob.points_init), te, prob.intr)
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), rtol=0, atol=1e-2)
        r, _, _, rm, _ = residuals_and_jacobians(T(ref.Tcw), T(ref.points), te, prob.intr, with_jacobians=False)
        chi2 = edge_chi2(r, rm, te.inv_sigma2).numpy()
        inl, ref_inl = got.inlier.numpy(), np.asarray(ref.inlier)
        parted = inl != ref_inl
        assert parted.sum() <= 5 and np.all(np.abs(chi2[parted] - CHI2_MONO) < 0.01 * CHI2_MONO), chi2[parted]
        assert int(got.num_inliers) == int(inl.sum())
        moved = float(chi2[parted & inl].sum() - chi2[parted & ref_inl].sum())
        np.testing.assert_allclose(float(got.cost), float(ref.cost) + moved, rtol=2e-3)


class TestShardedSolvers:
    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("case", ["edge", "map", "joint"])
    def test_ranks_match_the_reference_mesh(self, rank_outputs, world, case):
        """Each solver over `world` gloo ranks against `shard_map` on a
        `world`-device mesh; every rank returns the same bits."""
        ranks = rank_outputs[world]
        ref = jax_results(world)[case]
        for r in range(1, world):
            for k in ranks[0]:
                if k.startswith(case + "/"):
                    np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r} {k}")
        got = {f: ranks[0][f"{case}/{f}"] for f in ref}
        np.testing.assert_allclose(got["cost"], ref["cost"], rtol=1e-4)
        np.testing.assert_allclose(got["Tcw"], ref["Tcw"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["points"], ref["points"], rtol=0, atol=1e-3)
        if case == "joint":
            np.testing.assert_allclose(got["Tow"], ref["Tow"], rtol=0, atol=1e-4)
            # The measured object moves back toward its true place.
            c0 = np.linalg.inv(OBJ["Tow"][0])[:3, 3]
            c1 = np.linalg.inv(got["Tow"][0])[:3, 3]
            assert np.linalg.norm(c1 - [0.5, 0.0, 1.0]) < 0.5 * np.linalg.norm(c0 - [0.5, 0.0, 1.0])

    def test_world_sizes_agree(self, rank_outputs):
        """World sizes 2 and 4 solve one problem: the same answer within the
        sharded tolerance."""
        for k in rank_outputs[2][0]:
            a, b = rank_outputs[2][0][k], rank_outputs[4][0][k]
            if k.endswith("/cost"):
                np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=k)


class TestMeshAndLauncher:
    def test_make_mesh_without_a_group(self):
        m = make_mesh(device="cpu")
        assert (m.size, m.rank, m.backend, m.group, m.axis_names) == (1, 0, None, None, ("devices",))
        assert make_mesh(1, axis="map", device="cpu").shape == {"map": 1}
        with pytest.raises(ValueError, match="process group"):
            make_mesh(2, device="cpu")

    def test_worker_two_ranks_agree_with_one(self):
        """The multihost worker over tcp at world size 2 against 1 (the
        reference's `test_two_process_sharded_ba_agrees`), and against the
        reference's edge-sharded solve of the same problem."""
        res = orchestrate(2, cpu=True)
        assert res["backend"] == "gloo" and res["cost_agrees"]
        two = [r.json() for r in spawn_ranks(2, [], cpu=True, timeout=300)]
        assert {o["process_id"] for o in two} == {0, 1}
        assert all(o["process_count"] == 2 and o["global_devices"] == 2 for o in two)
        assert two[0]["cost"] == two[1]["cost"] and np.isfinite(two[0]["cost"])
        prob = jmake_ba_problem(num_cams=6, num_points=200, obs_per_point=4, seed=3)
        _, _, cost = jax.jit(lambda T0, p0: jsb.sharded_local_ba(
            jsb.make_edge_mesh(2), T0, p0, jnp.zeros(6, bool).at[0].set(True), jba_edges(prob), prob.intr,
            iters=6))(prob.Tcw_init, prob.points_init)
        np.testing.assert_allclose(two[0]["cost"], float(cost), rtol=1e-4)

    def test_dryrun_two_ranks(self):
        out = dryrun_multichip(2, cpu=True, reps=1, timeout=300)
        assert out["ranks"] == 2 and out["backend"] == "gloo"
        assert np.isfinite(out["edge_cost"]) and np.isfinite(out["map_cost"]) and out["global_dT"] > 1e-6
        assert out["scaling"]["t1_ms"] > 0 and out["scaling"]["tn_ms"] > 0

    def test_a_failed_rank_stops_its_siblings(self, tmp_path):
        """Rank 1 finds no input and exits; rank 0 waits in the first
        broadcast for it.  The launcher raises at once with rank 1's error
        (well inside its timeout) and kills rank 0; a run past its timeout
        raises too."""
        save_problems(tmp_path / "in_0.npz", [{"name": "edge", "kind": "edge_ba", "prefix": "p", "iters": 1}],
                      {"p": problem_arrays(MONO)})
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="in_1.npz"):
            spawn_ranks(2, [str(tmp_path / "in_{rank}.npz"), str(tmp_path / "out"), "--cpu"], target=REPLAY,
                        cpu=True, timeout=120)
        assert time.monotonic() - t0 < 60
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="still running"):
            dryrun_multichip(2, cpu=True, reps=50, timeout=2)
        assert time.monotonic() - t0 < 30

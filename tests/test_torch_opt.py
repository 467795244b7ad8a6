"""Parity of the PyTorch port's optimizers against the JAX package.

Stated tolerances: `optimize_pose` Tcw atol 1e-4 with identical inlier
masks; `local_bundle_adjustment` cost within rel 1e-3, the same inlier
count, fixed cameras bit-unchanged; the Schur pieces to f32 accuracy
relative to each block's scale; the slot table exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.data.synthetic import ba_edges, make_ba_problem
from qsp_slam_tpu.opt import schur as jschur
from qsp_slam_tpu.opt.local_ba import local_bundle_adjustment as j_lba
from qsp_slam_tpu.opt.pose_opt import optimize_pose as j_optimize_pose
from qsp_slam_tpu.opt.reproj import residuals_and_jacobians as j_res
from qsp_slam_tpu_torch.core.camera import Intrinsics
from qsp_slam_tpu_torch.opt import schur as tschur
from qsp_slam_tpu_torch.opt.local_ba import local_bundle_adjustment as t_lba
from qsp_slam_tpu_torch.opt.pose_opt import optimize_pose as t_optimize_pose
from qsp_slam_tpu_torch.opt.pose_opt import solve_or_nan
from qsp_slam_tpu_torch.opt.reproj import ReprojEdges, residuals_and_jacobians

torch.set_num_threads(1)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def t_edges(prob, valid=None, inv_sigma2=None) -> ReprojEdges:
    return ReprojEdges(
        T(prob.kf_idx).long(), T(prob.pt_idx).long(), T(prob.uv), T(prob.u_right),
        T(prob.inv_sigma2 if inv_sigma2 is None else inv_sigma2),
        T(prob.valid if valid is None else valid),
    )


def t_intr(prob) -> Intrinsics:
    return Intrinsics(*(float(v) for v in prob.intr))


class TestPoseOpt:
    def test_recovers_pose_with_outliers(self, rng):
        """The case of `tests/test_ba.py::TestPoseOpt::test_recovers_pose_with_outliers`."""
        prob = make_ba_problem(num_cams=1, num_points=300, obs_per_point=1,
                               outlier_frac=0.15, pose_noise=0.0, seed=6)
        xi = jnp.asarray(rng.normal(0, 1, 6) * jnp.array([0.1, 0.1, 0.1, 0.03, 0.03, 0.03]),
                         dtype=jnp.float32)
        Tcw0 = np.asarray(jlie.exp_se3(xi) @ jnp.asarray(prob.Tcw_gt[0]))
        ref = jax.jit(lambda Tc, p: j_optimize_pose(Tc, p, ba_edges(prob), prob.intr))(
            jnp.asarray(Tcw0), jnp.asarray(prob.points_gt))
        got = t_optimize_pose(T(Tcw0), T(prob.points_gt), t_edges(prob), t_intr(prob))
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
        np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
        assert int(got.num_inliers) == int(ref.num_inliers)
        inl = got.inlier.numpy()
        assert inl[prob.is_outlier].mean() < 0.05
        assert inl[~prob.is_outlier].mean() > 0.97

    def test_stereo_rows_octaves_and_invalid_edges(self, rng):
        prob = make_ba_problem(num_cams=1, num_points=250, obs_per_point=1, outlier_frac=0.1,
                               pose_noise=0.0, stereo=True, seed=8)
        E = len(prob.kf_idx)
        valid = rng.random(E) < 0.9
        u_right = np.where(rng.random(E) < 0.6, prob.u_right, -1.0).astype(np.float32)
        prob = prob._replace(u_right=u_right)
        inv_s2 = (1.0 / 1.44) ** rng.integers(0, 8, E).astype(np.float32)
        xi = (rng.normal(0, 1, 6) * np.array([0.05, 0.05, 0.05, 0.02, 0.02, 0.02])).astype(np.float32)
        Tcw0 = np.asarray(jlie.exp_se3(jnp.asarray(xi)) @ jnp.asarray(prob.Tcw_gt[0]))
        bf = 0.08 * float(prob.intr.fx)
        jedges = ba_edges(prob)._replace(valid=jnp.asarray(valid), inv_sigma2=jnp.asarray(inv_s2))
        ref = jax.jit(lambda Tc, p: j_optimize_pose(Tc, p, jedges, prob.intr, baseline_fx=bf))(
            jnp.asarray(Tcw0), jnp.asarray(prob.points_gt))
        got = t_optimize_pose(T(Tcw0), T(prob.points_gt), t_edges(prob, valid, inv_s2),
                              t_intr(prob), baseline_fx=bf)
        np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
        np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))

    def test_singular_system_gives_nan_not_error(self):
        """`jnp.linalg.solve` returns non-finite values on a singular
        matrix and the LM accept test rejects the step; the port keeps
        that behaviour instead of raising."""
        A = torch.zeros(6, 6)
        b = torch.ones(6)
        assert torch.isnan(solve_or_nan(A, b)).all()
        ref = np.asarray(jnp.linalg.solve(jnp.zeros((6, 6)), jnp.ones(6)))
        assert not np.isfinite(ref).all()
        L_bad = torch.diag(torch.tensor([1.0, -1.0, 1.0]))
        assert torch.isnan(tschur.cholesky_solve_or_nan(L_bad, torch.ones(3))).all()


class TestSchur:
    @pytest.fixture(scope="class")
    def blocks(self):
        prob = make_ba_problem(num_cams=5, num_points=120, obs_per_point=3, outlier_frac=0.05, seed=9)
        E = len(prob.kf_idx)
        valid = np.arange(E) % 11 != 0
        jedges = ba_edges(prob)._replace(valid=jnp.asarray(valid))
        tedges = t_edges(prob, valid)
        N, K = 120, 5
        cam_fixed = np.array([True, False, False, True, False])
        w_edge = np.linspace(0.5, 1.5, E, dtype=np.float32)

        @jax.jit
        def reference(Tc, p):
            r, Jc, Jp, row_mask, _ = j_res(Tc, p, jedges, prob.intr)
            jst = jschur.point_slot_table(jedges.pt_idx, jedges.valid, N, 4)
            w = row_mask * w_edge[:, None]
            return jst, w, jschur.build_normal_blocks_fast(r, Jc, Jp, w, jedges.kf_idx, jst, K,
                                                           jnp.asarray(cam_fixed))

        jst, w, jb = reference(jnp.asarray(prob.Tcw_init), jnp.asarray(prob.points_init))
        w = np.asarray(w)
        tst = tschur.point_slot_table(tedges.pt_idx, tedges.valid, N, 4)
        tr = residuals_and_jacobians(T(prob.Tcw_init), T(prob.points_init), tedges, t_intr(prob))
        tb = tschur.build_normal_blocks_fast(tr[0], tr[1], tr[2], T(w), tedges.kf_idx, tst, K,
                                             T(cam_fixed))
        return dict(jst=jst, tst=tst, jb=jb, tb=tb, cam_fixed=cam_fixed)

    def test_slot_table(self, blocks):
        np.testing.assert_array_equal(blocks["tst"].numpy(), np.asarray(blocks["jst"]))

    def test_normal_blocks(self, blocks):
        for g, r in zip(blocks["tb"], blocks["jb"]):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1.0))

    def test_solve_schur(self, blocks):
        lam = 1e-3
        jdc, jdp = jax.jit(jschur.solve_schur)(blocks["jb"], jnp.float32(lam),
                                               jnp.asarray(blocks["cam_fixed"]))
        tdc, tdp = tschur.solve_schur(blocks["tb"], torch.tensor(lam), T(blocks["cam_fixed"]))
        np.testing.assert_allclose(tdc.numpy(), np.asarray(jdc), atol=1e-4)
        np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), atol=1e-3)
        assert (tdc.numpy()[blocks["cam_fixed"]] == 0).all()


class TestLocalBA:
    def test_matches_jax(self):
        prob = make_ba_problem(num_cams=8, num_points=300, obs_per_point=4, outlier_frac=0.05, seed=2)
        cam_fixed = np.zeros(8, bool)
        cam_fixed[[0, 1]] = True
        jres = jax.jit(lambda Tc, p: j_lba(Tc, p, jnp.asarray(cam_fixed), ba_edges(prob), prob.intr))(
            jnp.asarray(prob.Tcw_init), jnp.asarray(prob.points_init)
        )
        tres = t_lba(T(prob.Tcw_init), T(prob.points_init), T(cam_fixed), t_edges(prob), t_intr(prob))
        jc, tc = float(jres.cost), float(tres.cost)
        assert abs(tc - jc) <= 1e-3 * jc, (tc, jc)
        assert int(tres.num_inliers) == int(jres.num_inliers)
        # Fixed cameras stay bit-unchanged; free ones move as the reference's.
        for k in (0, 1):
            np.testing.assert_array_equal(tres.Tcw[k].numpy(), prob.Tcw_init[k])
        np.testing.assert_allclose(tres.Tcw.numpy(), np.asarray(jres.Tcw), atol=1e-4)
        inl = tres.inlier.numpy()
        assert inl[prob.is_outlier].mean() < 0.1
        assert inl[~prob.is_outlier].mean() > 0.9

"""Parity of the PyTorch port's core math against the JAX package.

Same numpy inputs (from a seed) go through the JAX function on the CPU and
its counterpart in `qsp_slam_tpu_torch` on `device="cpu"`.  Stated
tolerance for lie, camera, robust and reprojection: atol 1e-5 on values of
order 1; pixel-scale outputs (hundreds of px, f32 spacing ~3e-5) are held
to the same 1e-5 relative to their scale.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qsp_slam_tpu_torch as qt
from qsp_slam_tpu.core import camera as jcam
from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.opt import reproj as jreproj
from qsp_slam_tpu.opt import robust as jrobust
from qsp_slam_tpu_torch.core import camera as tcam
from qsp_slam_tpu_torch.core import lie as tlie
from qsp_slam_tpu_torch.opt import reproj as treproj
from qsp_slam_tpu_torch.opt import robust as trobust

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(got: torch.Tensor, ref, atol=ATOL, scale=1.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol * scale)


def _tangents(rng, n=64):
    """Rotation tangents: random, zero, tiny (Taylor branch) and near pi."""
    w = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-6, -2e-6, 5e-7]
    axis = w[2] / np.linalg.norm(w[2])
    w[2] = axis * (np.pi - 1e-3)
    w[3] = np.array([0.0, 0.0, np.pi - 2e-3], np.float32)
    return w


class TestPackage:
    def test_imports_no_jax_and_no_reference_package(self):
        """Importing every module of the port loads no `jax` module, nothing
        of `qsp_slam_tpu` and no PIL (checked in a fresh interpreter)."""
        code = (
            "import importlib, json, pkgutil, sys\n"
            "import qsp_slam_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'jaxlib' or m == 'qsp_slam_tpu' or m.startswith('qsp_slam_tpu.') or m == 'PIL']\n"
            "print(json.dumps({'n': len(mods), 'bad': bad, 'mods': mods}))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
            timeout=120, check=True,
        )
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["n"] >= 25, got
        assert got["bad"] == [], got["bad"]
        for m in ("perception.detector2d", "perception.detector3d", "train_detector2d", "train_detector3d",
                  "data.synthetic", "parallel.mesh", "parallel.multihost", "parallel.sharded_ba",
                  "parallel.map_sharded_ba", "parallel.replay", "parallel.dryrun", "slam.distributed_mapping",
                  "viz.export", "viz.frame_draw", "utils.tracing", "perception.dense_builder", "extract_objects",
                  "visualize_map", "label_tool"):
            assert f"qsp_slam_tpu_torch.{m}" in got["mods"], m

    def test_no_source_imports_reference(self):
        """No module of the port, nor `chip_smoke.py`, names `jax` or
        `qsp_slam_tpu` in an import; the tools and `chip_smoke.py` name no
        PIL either (they draw and write PNGs without it)."""
        tools = {"viz/export.py", "viz/frame_draw.py", "utils/tracing.py", "perception/dense_builder.py",
                 "extract_objects.py", "visualize_map.py", "label_tool.py", "run_tum.py"}
        offenders = []
        for path in [*(REPO / "qsp_slam_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
            rel = path.relative_to(REPO / "qsp_slam_tpu_torch").as_posix() if path.name != "chip_smoke.py" else ""
            banned = ("jax", "jaxlib", "qsp_slam_tpu") + (("PIL",) if rel in tools or not rel else ())
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    root = n.split(".")[0]
                    if root in banned:
                        offenders.append(f"{path.name}: {n}")
        assert offenders == []

    def test_precision_pin(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"

    def test_entry_points_need_cuda_unless_cpu_is_named(self):
        assert qt.resolve_device("cpu") == torch.device("cpu")
        if torch.cuda.is_available():
            assert qt.resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                qt.resolve_device()
            from qsp_slam_tpu_torch.slam.map import empty_map

            with pytest.raises(RuntimeError):
                empty_map(4, 8, 16)

    def test_seeded_tables_bit_identical(self):
        from qsp_slam_tpu.frontend import orb as jorb
        from qsp_slam_tpu.slam import place_recognition as jpr
        from qsp_slam_tpu_torch.frontend import orb as torb
        from qsp_slam_tpu_torch.slam import place_recognition as tpr

        for got, ref in (
            (torb._PATTERN, jorb._PATTERN),
            (tpr._VOCAB, jpr._VOCAB),
            (tpr._LSH_SUBSETS, jpr._LSH_SUBSETS),
            (torb._CIRC, jorb._CIRC),
        ):
            assert got.dtype == np.asarray(ref).dtype
            assert got.tobytes() == np.asarray(ref).tobytes()


class TestLie:
    def test_hat_vee(self, rng):
        w = rng.normal(size=(10, 3)).astype(np.float32)
        close(tlie.hat(T(w)), jlie.hat(jnp.asarray(w)))
        np.testing.assert_array_equal(tlie.vee(tlie.hat(T(w))).numpy(), w)

    def test_exp_log_so3(self, rng):
        w = _tangents(rng)
        R_t, R_j = tlie.exp_so3(T(w)), jlie.exp_so3(jnp.asarray(w))
        close(R_t, R_j)
        close(tlie.log_so3(R_t), jlie.log_so3(R_j))

    def test_exp_log_se3(self, rng):
        xi = np.concatenate(
            [rng.normal(0, 2.0, (64, 3)).astype(np.float32), _tangents(rng)], axis=1
        )
        T_t, T_j = tlie.exp_se3(T(xi)), jlie.exp_se3(jnp.asarray(xi))
        close(T_t, T_j)
        close(tlie.log_se3(T_t), jlie.log_se3(T_j))
        # Zero and tiny tangents round-trip without NaN.
        assert torch.isfinite(tlie.log_se3(T_t[:2])).all()
        close(tlie.log_se3(T_t[:2]), xi[:2], scale=10.0)

    def test_inverse_and_transform(self, rng):
        xi = rng.normal(0, 0.7, (16, 6)).astype(np.float32)
        Tm = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
        pts = rng.normal(0, 3.0, (16, 50, 3)).astype(np.float32)
        close(tlie.inv_se3(T(Tm)), jlie.inv_se3(jnp.asarray(Tm)))
        close(
            tlie.transform_points(T(Tm), T(pts)),
            jlie.transform_points(jnp.asarray(Tm), jnp.asarray(pts)),
            scale=10.0,
        )


class TestCamera:
    intr_vals = (520.9, 521.0, 325.1, 249.7)

    def _intr(self):
        j = jcam.Intrinsics(*(jnp.float32(v) for v in self.intr_vals))
        t = tcam.Intrinsics(*(float(np.float32(v)) for v in self.intr_vals))
        return j, t

    def test_project_backproject(self, rng):
        jintr, tintr = self._intr()
        p = rng.uniform([-2, -2, 0.3], [2, 2, 8], (500, 3)).astype(np.float32)
        p[0, 2] = 0.0  # the z guard
        uv_t, z_t = tcam.project(T(p), tintr)
        uv_j, z_j = jcam.project(jnp.asarray(p), jintr)
        close(uv_t[1:], np.asarray(uv_j)[1:], scale=np.abs(np.asarray(uv_j)[1:]).max())
        assert torch.isfinite(uv_t[0]).all()
        close(z_t, z_j)
        d = p[:, 2] + 0.5
        close(tcam.backproject(uv_t[1:], T(d[1:]), tintr),
              jcam.backproject(uv_j[1:], jnp.asarray(d[1:]), jintr), scale=10.0)
        np.testing.assert_array_equal(
            tcam.in_image(uv_t, 640, 480, border=-20).numpy(),
            np.asarray(jcam.in_image(uv_j, 640, 480, border=-20)),
        )

    def test_undistort(self, rng):
        jintr, tintr = self._intr()
        dist = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)  # TUM fr1
        uv = rng.uniform([0, 0], [640, 480], (300, 2)).astype(np.float32)
        close(tcam.undistort_points(T(uv), tintr, dist),
              jcam.undistort_points(jnp.asarray(uv), jintr, dist), scale=640.0)


class TestRobust:
    def test_huber(self, rng):
        chi2 = np.concatenate([rng.uniform(0, 30, 200), [0.0, 5.991, 7.815]]).astype(np.float32)
        d2 = np.where(rng.random(chi2.shape) < 0.5, 5.991, 7.815).astype(np.float32)
        close(trobust.huber_weight(T(chi2), T(d2)), jrobust.huber_weight(jnp.asarray(chi2), jnp.asarray(d2)))
        close(trobust.huber_rho(T(chi2), T(d2)), jrobust.huber_rho(jnp.asarray(chi2), jnp.asarray(d2)), scale=30.0)
        assert (trobust.CHI2_MONO, trobust.CHI2_STEREO) == (jrobust.CHI2_MONO, jrobust.CHI2_STEREO)


class TestReproj:
    @pytest.mark.parametrize("stereo", [False, True])
    def test_residuals_and_jacobians(self, stereo):
        from qsp_slam_tpu.data.synthetic import make_ba_problem

        prob = make_ba_problem(num_cams=4, num_points=80, obs_per_point=3,
                               outlier_frac=0.1, stereo=stereo, seed=3)
        bf = 0.08 * float(prob.intr.fx) if stereo else 0.0
        valid = np.ones(len(prob.kf_idx), bool)
        valid[::7] = False
        inv_s2 = (1.0 / 1.44) ** (np.arange(len(valid)) % 3).astype(np.float32)
        je = jreproj.ReprojEdges(
            jnp.asarray(prob.kf_idx), jnp.asarray(prob.pt_idx), jnp.asarray(prob.uv),
            jnp.asarray(prob.u_right), jnp.asarray(inv_s2), jnp.asarray(valid),
        )
        te = treproj.ReprojEdges(
            T(prob.kf_idx).long(), T(prob.pt_idx).long(), T(prob.uv), T(prob.u_right),
            T(inv_s2), T(valid),
        )
        tintr = tcam.Intrinsics(*(float(v) for v in prob.intr))
        got = treproj.residuals_and_jacobians(T(prob.Tcw_init), T(prob.points_init), te, tintr, bf)
        ref = jreproj.residuals_and_jacobians(
            jnp.asarray(prob.Tcw_init), jnp.asarray(prob.points_init), je, prob.intr, bf
        )
        r_scale = np.abs(np.asarray(ref[0])).max()
        close(got[0], ref[0], scale=max(r_scale, 1.0) * 10)  # residual: u - u_meas, u ~ 640 px
        for g, r in zip(got[1:], ref[1:]):
            close(g, r, scale=max(np.abs(np.asarray(r)).max(), 1.0))
        close(treproj.edge_chi2(got[0], got[3], te.inv_sigma2),
              jreproj.edge_chi2(ref[0], ref[3], je.inv_sigma2),
              scale=max(float(np.asarray(jreproj.edge_chi2(ref[0], ref[3], je.inv_sigma2)).max()), 1.0))
        # The no-Jacobian form returns the same residuals.
        r_only = treproj.residuals_and_jacobians(
            T(prob.Tcw_init), T(prob.points_init), te, tintr, bf, with_jacobians=False
        )
        assert r_only[1] is None and torch.equal(r_only[0], got[0])

"""Parity of the port's DeepSDF shape modules with the JAX package on the
CPU: the decoder and its checkpoints, the residuals, the joint pose +
code LM with its flip search, the pose-only fit, the shape inputs of a
keyframe, the due-only reconstruction, meshes, the object renderer, the
model-side JSON and the toy trainer.

The same seeded numpy inputs go through both packages, with the JAX
decoder's parameters carried over by `deepsdf_params_from_numpy` and the
reference's `jax.random` pixel draws fed through `draw`.  Tolerances:
decoder outputs and residuals 1e-5 (f32 products summed in another
order), the LM results 1e-4 after one or two trips and after three
within the median of the reference's own spread over one-ulp changes of
the start (later trips amplify f32 rounding in both packages), the shape
inputs' points, rays and depths 1e-5 and their masks exact, the SDF grid
1e-5 and marching cubes exact; rendered depth 1e-4 where both packages hit, with at most 0.5% of
the pixels hit by one package only (the hit tests threshold f32 values at
silhouettes).  The card's reverse-mode Jacobian runs here too: held to
the CPU's forward-mode one within 2e-6 of J's largest entry, and its LM
to the reference's twelve-trip outcome.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.core import lie as jlie
from qsp_slam_tpu.core import quadric as jquadric
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.data import render as jrender
from qsp_slam_tpu.models import deepsdf as jsdf
from qsp_slam_tpu.models import losses as jloss
from qsp_slam_tpu.models import mesh as jmesh
from qsp_slam_tpu.models import shape_opt as jopt
from qsp_slam_tpu.slam import config as jconfig
from qsp_slam_tpu.slam import objects as jobj
from qsp_slam_tpu.slam import shape_mapping as jmap
from qsp_slam_tpu.viz import object_render as jviz
from qsp_slam_tpu_torch.convert import deepsdf_params_from_numpy, object_table_from_numpy
from qsp_slam_tpu_torch.core import quadric as tquadric
from qsp_slam_tpu_torch.core.camera import Intrinsics, intrinsic_matrix
from qsp_slam_tpu_torch.models import deepsdf as tsdf
from qsp_slam_tpu_torch.models import losses as tloss
from qsp_slam_tpu_torch.models import mesh as tmesh
from qsp_slam_tpu_torch.models import shape_opt as topt
from qsp_slam_tpu_torch.perception.ellipsoid_fit import _scaled
from qsp_slam_tpu_torch.slam import config as tconfig
from qsp_slam_tpu_torch.slam import shape_mapping as tmap
from qsp_slam_tpu_torch.viz import object_render as tviz

torch.set_num_threads(2)

TOY = tsdf.DeepSDFConfig(code_dim=16, hidden=96, num_layers=6, latent_in=(3,))
JTOY = jsdf.DeepSDFConfig(code_dim=16, hidden=96, num_layers=6, latent_in=(3,))
INTR = Intrinsics(*(float(np.float32(v)) for v in (520.9, 521.0, 325.1, 249.7)))
JINTR = JIntrinsics(*(jnp.float32(v) for v in INTR))


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port(jparams) -> dict:
    return deepsdf_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


def jax_shape_draw(gen, num_obj, num_samples):
    """The reference's shape-sample draws of PRNGKey(generator seed): u from
    fold_in(key, o), v from fold_in(fold_in(key, o), 1)."""
    key = jax.random.PRNGKey(gen.initial_seed())
    ks = [jax.random.fold_in(key, o) for o in range(num_obj)]
    u = jnp.stack([jax.random.uniform(k, (num_samples,)) for k in ks])
    v = jnp.stack([jax.random.uniform(jax.random.fold_in(k, 1), (num_samples,)) for k in ks])
    return T(jnp.stack([u, v], -1))


# -- fixtures ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy():
    """tests/test_shape.py's toy decoder, trained by the reference."""
    jparams, codes, halves = jsdf.train_toy_decoder(jax.random.PRNGKey(0), JTOY, num_shapes=6, steps=500, batch=512)
    return jparams, port(jparams), np.asarray(codes), np.asarray(halves)


@pytest.fixture(scope="module")
def problem(toy):
    """tests/test_shape.py:65's problem: shape 1's surface 1.8 m ahead,
    yawed, at scale 0.35, with rays and depths from the same points, and
    a perturbed initial frame."""
    _, _, _, halves = toy
    T_co_rigid = jlie.exp_se3(jnp.asarray([0.1, -0.05, 1.8, 0.0, 0.5, 0.0]))
    key = jax.random.PRNGKey(2)
    d = jax.random.normal(key, (256, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    pts = (d * halves[1]) @ (T_co_rigid[:3, :3] * 0.35).T + T_co_rigid[:3, 3]
    pts = pts + 0.002 * jax.random.normal(jax.random.fold_in(key, 1), pts.shape)
    T_oc_gt = jlie.inv_sim3(T_co_rigid.at[:3, :3].multiply(0.35))
    T_init = jlie.exp_sim3(jnp.asarray([0.06, -0.04, 0.08, 0.05, -0.08, 0.04, 0.1])) @ T_oc_gt
    depth = pts[:, 2]
    return tuple(np.asarray(x) for x in (T_init, pts, pts / depth[:, None], depth, T_oc_gt))


@pytest.fixture(scope="module")
def scene_frame():
    """The seed-2 scene 25 degrees down, with instance masks."""
    scene = jrender.make_scene(num_objects=3, seed=2)
    T_cw = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.44, 0, 0], jnp.float32))
    _, depth, inst = jrender.render_scene(scene, T_cw, JINTR)
    det = jrender.gt_detections(scene, T_cw, JINTR, instance=inst)
    return scene, np.asarray(T_cw), np.asarray(depth), {k: np.asarray(v) for k, v in det.items()}


def _table(scene):
    """Four slots: 0 and 2 due (2 and 4 observations), 1 live but not due
    (3 observations), 3 empty; slots 0-2 hold the scene's objects."""
    t = jobj.empty_objects(omax=4, code_dim=16)
    e = jnp.asarray(scene.ellipsoids)
    return t._replace(
        ellipsoid=t.ellipsoid.at[:3].set(e), valid=t.valid.at[:3].set(True),
        obs_count=t.obs_count.at[:3].set(jnp.asarray([2, 3, 4], jnp.int32)),
        label=t.label.at[:3].set(jnp.asarray(scene.labels)), num_objects=jnp.int32(3),
        code=t.code.at[2].set(0.05 * jnp.arange(16, dtype=jnp.float32) / 16),
    )


# -- the decoder --------------------------------------------------------------------


@pytest.mark.parametrize("width", ["toy", "full"])
def test_decode_sdf_matches_the_reference(width, rng):
    tcfg, jcfg = ((TOY, JTOY) if width == "toy" else (tsdf.DeepSDFConfig(), jsdf.DeepSDFConfig()))
    assert tsdf._layer_dims(tcfg) == jsdf._layer_dims(jcfg)
    jparams = jsdf.init_decoder(jax.random.PRNGKey(1), jcfg)
    params = port(jparams)
    codes = rng.normal(0, 0.3, (2, tcfg.code_dim)).astype(np.float32)
    xyz = rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32)
    ref = [np.asarray(jsdf.decode_sdf(jparams, jcfg, jnp.asarray(c), jnp.asarray(x))) for c, x in zip(codes, xyz)]
    for b in range(2):
        close(tsdf.decode_sdf(params, tcfg, T(codes[b]), T(xyz[b])), ref[b], 1e-5)
    close(tsdf.decode_sdf(params, tcfg, T(codes), T(xyz)), np.stack(ref), 1e-5)  # the hypothesis batch
    close(tsdf.DeepSDFDecoder(tcfg, params)(T(codes[0]), T(xyz[0])).detach(), ref[0], 1e-5)


def test_checkpoints_load_across_packages(tmp_path, rng):
    """The port's module state dict loads through the reference's loader,
    and a reference-format (DataParallel-prefixed) one through the port's."""
    cfg = tsdf.DeepSDFConfig(code_dim=8, hidden=32, num_layers=4, latent_in=(2,))
    jcfg = jsdf.DeepSDFConfig(code_dim=8, hidden=32, num_layers=4, latent_in=(2,))
    params = tsdf.init_decoder(torch.Generator().manual_seed(3), cfg, device="cpu")
    sd = tsdf.DeepSDFDecoder(cfg, params).state_dict()
    assert sorted(sd) == sorted(f"lin{i}.{k}" for i in range(4) for k in ("weight_v", "weight_g", "bias"))
    assert sd["lin0.weight_g"].shape == (32, 1) and sd["lin1.weight_g"].shape == (21, 1)
    torch.save({"model_state_dict": sd, "epoch": 2000}, tmp_path / "port.pth")
    code = rng.normal(size=8).astype(np.float32)
    xyz = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    ref = tsdf.decode_sdf(params, cfg, T(code), T(xyz))
    jloaded = jsdf.load_torch_checkpoint(str(tmp_path / "port.pth"), jcfg)
    close(jsdf.decode_sdf(jloaded, jcfg, jnp.asarray(code), jnp.asarray(xyz)), ref, 1e-6)

    jparams = jsdf.init_decoder(jax.random.PRNGKey(4), jcfg)
    sd = {}
    for i in range(4):
        p = jparams[f"lin{i}"]
        sd[f"module.lin{i}.weight_v"] = T(p["v"])
        sd[f"module.lin{i}.weight_g"] = T(np.asarray(p["g"]).reshape(-1, 1))
        sd[f"module.lin{i}.bias"] = T(p["b"])
    torch.save({"model_state_dict": sd}, tmp_path / "ref.pth")
    loaded = tsdf.load_torch_checkpoint(str(tmp_path / "ref.pth"), cfg, device="cpu")
    close(tsdf.decode_sdf(loaded, cfg, T(code), T(xyz)),
          jsdf.decode_sdf(jparams, jcfg, jnp.asarray(code), jnp.asarray(xyz)), 1e-6)
    with pytest.raises(KeyError):
        tsdf.params_from_state_dict({}, cfg, device="cpu")


def test_ellipsoid_sdf_and_toy_trainer():
    """The analytic family equals the reference's; the port's trainer fits
    it to tests/test_shape.py:53's bound."""
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    half = np.array([0.3, 0.5, 0.4], np.float32)
    close(tsdf.ellipsoid_sdf(T(xyz), T(half)), jsdf.ellipsoid_sdf(jnp.asarray(xyz), jnp.asarray(half)), 1e-6)
    params, codes, halves = tsdf.train_toy_decoder(0, TOY, num_shapes=6, steps=500, batch=512, device="cpu")
    errs = [float(torch.mean(torch.abs(tsdf.decode_sdf(params, TOY, codes[i], T(xyz))
                                       - torch.clamp(tsdf.ellipsoid_sdf(T(xyz), halves[i]), -0.3, 0.3))))
            for i in range(6)]
    assert np.mean(errs) < 0.03, errs


# -- residuals and the LM ----------------------------------------------------------------


def test_residuals_match_the_reference(toy, problem):
    jparams, params, codes, _ = toy
    T_init, pts, rays, depth, _ = problem
    xi = np.array([0.01, -0.02, 0.03, 0.02, -0.01, 0.03, 0.05], np.float32)
    valid = np.arange(256) % 7 != 3
    code = codes[2]
    j = dict(params=jparams, cfg=JTOY, xi=jnp.asarray(xi), code=jnp.asarray(code), T_oc_init=jnp.asarray(T_init))
    t = dict(params=params, cfg=TOY, xi=T(xi), code=T(code), T_oc_init=T(T_init))
    r_sdf = tloss.sdf_residuals(**t, pts_cam=T(pts), valid=T(valid))
    r_ren = tloss.render_residuals(**t, rays_cam=T(rays), depth_obs=T(depth), valid=T(valid))
    close(r_sdf, jloss.sdf_residuals(**j, pts_cam=jnp.asarray(pts), valid=jnp.asarray(valid)), 1e-5)
    close(r_ren, jloss.render_residuals(**j, rays_cam=jnp.asarray(rays), depth_obs=jnp.asarray(depth),
                                        valid=jnp.asarray(valid)), 1e-5)
    assert float(r_ren.abs().max()) > 1e-3 and not bool(r_sdf[~T(valid)].any())
    a, b = tloss.joint_residuals(params, TOY, T(xi), T(code), T(T_init), T(pts), T(valid), T(rays), T(depth),
                                 T(valid))
    close(a, r_sdf, 1e-6)
    close(b, r_ren, 1e-6)
    close(tloss.rotation_residual(T(xi)), xi[3:5], 0)
    close(tloss.scale_residual(T(xi)), xi[6:7], 0)


def _run_both(toy, T_init, code, pts, pv, rays, depth, rv, iters, flips=False):
    jparams, params, _, _ = toy
    jfn, tfn = ((jopt.reconstruct_object_flips, topt.reconstruct_object_flips) if flips
                else (jopt.reconstruct_object, topt.reconstruct_object))
    ref = jfn(jparams, JTOY, *(jnp.asarray(x) for x in (T_init, code, pts, pv, rays, depth, rv)),
              jopt.ShapeOptConfig(iters=iters))
    got = tfn(params, TOY, *(T(x) for x in (T_init, code, pts, pv, rays, depth, rv)),
              topt.ShapeOptConfig(iters=iters))
    return got, ref


@pytest.mark.parametrize("iters", [1, 2])
def test_reconstruct_object_trips_match_the_reference(toy, problem, iters):
    """The first LM trips from the same start agree to 1e-4.  Later trips
    amplify f32 rounding alike in both packages: over twenty one-ulp
    changes of the initial frame the reference's own code moves by a
    median 2.4e-4 after 3 trips and 2.6e-3 after 4 (the port's 3.9e-4 and
    3.0e-3), so the third trip is held to that spread (next test) and
    deeper runs to their outcome."""
    T_init, pts, rays, depth, _ = problem
    valid = np.ones(256, bool)
    got, ref = _run_both(toy, T_init, np.zeros(16, np.float32), pts, valid, rays, depth, valid, iters)
    close(got.T_oc, ref.T_oc, 1e-4)
    close(got.code, ref.code, 1e-4)
    close(got.cost, ref.cost, 1e-4 * float(ref.cost))
    assert bool(got.is_good) == bool(ref.is_good)


ULP_SHIFTS = [(i, j, s) for i, j in [(0, 3), (1, 3), (2, 3), (0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0), (1, 0)]
              for s in (1, -1)]


def test_reconstruct_object_three_trips_within_the_reference_spread(toy, problem):
    """Three trips: the port's code and frame lie within the median of the
    reference's own spread over one-ulp changes of the initial frame (each
    entry of the 3 x 4 block that the changes touch, up and down)."""
    jparams, _, _, _ = toy
    T_init, pts, rays, depth, _ = problem
    valid = np.ones(256, bool)
    got, ref = _run_both(toy, T_init, np.zeros(16, np.float32), pts, valid, rays, depth, valid, 3)
    spread = {"code": [], "T_oc": []}
    for i, j, sign in ULP_SHIFTS:
        T_shift = T_init.copy()
        T_shift[i, j] = np.nextafter(T_shift[i, j], np.float32(sign * 100))
        alt = jopt.reconstruct_object(jparams, JTOY, *(jnp.asarray(x) for x in (T_shift, np.zeros(16, np.float32), pts,
                                                                                   valid, rays, depth, valid)),
                                      jopt.ShapeOptConfig(iters=3))
        for k in spread:
            spread[k].append(float(np.abs(np.asarray(getattr(alt, k)) - np.asarray(getattr(ref, k))).max()))
    for k in spread:
        gap = float(np.abs(getattr(got, k).numpy() - np.asarray(getattr(ref, k))).max())
        assert gap <= np.median(spread[k]), (k, gap, sorted(spread[k]))
    assert bool(got.is_good) == bool(ref.is_good)


def test_reconstruct_object_outcome_matches_the_reference(toy, problem):
    """Twelve trips (tests/test_shape.py's run): both converge, to costs
    within 2%, and the port passes the reference test's surface checks."""
    jparams, params, _, _ = toy
    T_init, pts, rays, depth, _ = problem
    valid, none = np.ones(256, bool), np.zeros(256, bool)
    got, ref = _run_both(toy, T_init, np.zeros(16, np.float32), pts, valid, rays, depth, valid, 12)
    assert bool(ref.is_good) and bool(got.is_good)
    assert abs(float(got.cost) - float(ref.cost)) < 0.02 * float(ref.cost)
    sdf_est = tsdf.decode_sdf(params, TOY, got.code, topt.lie.transform_points(got.T_oc, T(pts)))
    sdf_init = tsdf.decode_sdf(params, TOY, torch.zeros(16), topt.lie.transform_points(T(T_init), T(pts)))
    assert float(sdf_est.abs().mean()) < min(0.05, 0.5 * float(sdf_init.abs().mean()))
    # A batch runs each row on its own: two trips of this problem beside a
    # row with no data (not good, cost 0).
    two = [np.stack([x, x]) for x in (T_init, pts, rays, depth)]
    one, _ = _run_both(toy, T_init, np.zeros(16, np.float32), pts, valid, rays, depth, valid, 2)
    bat = topt.reconstruct_object(params, TOY, T(two[0]), torch.zeros(2, 16), T(two[1]), T(np.stack([valid, none])),
                                  T(two[2]), T(two[3]), T(np.stack([valid, none])), topt.ShapeOptConfig(iters=2))
    assert bat.is_good.tolist() == [bool(one.is_good), False] and float(bat.cost[1]) == 0.0
    close(bat.T_oc[0], one.T_oc, 1e-4)


def _reverse_lm(params, cfg, opt_cfg, *args):
    """`reconstruct_object` through the card's `reverse_jacobian`, run on
    the CPU (numpy arguments)."""
    return topt._batched(lambda *a: topt._reconstruct(params, cfg, opt_cfg, *a, jacobian=topt.reverse_jacobian),
                         *(T(x) for x in args))


def test_reconstruct_object_outcome_through_the_reverse_jacobian_matches_the_reference(toy, problem):
    """The card's path (`reverse_jacobian`) on the CPU over the twelve
    trips of the test above: both converge, the port's final cost is no
    more than 2% above the reference's and is the reference's own cost at
    the port's result (to 1e-5), the port passes the surface checks, and a
    batch row with no data stays not good at cost 0 (over one trip: the
    second carries the batch's other GEMM blocking to 2e-3 on this
    problem).  The cost is held from above only: J's rounding differs from
    `jacfwd`'s by about 1e-6, and twelve trips carry that as far as
    one-ulp changes of the start carry the reference's own cost
    (2.59-2.85 about its 2.71); on this problem the reverse path ends
    lower, at 2.58-2.70 with the thread count."""
    jparams, params, _, _ = toy
    T_init, pts, rays, depth, _ = problem
    valid, none, zero = np.ones(256, bool), np.zeros(256, bool), np.zeros(16, np.float32)
    ref = jopt.reconstruct_object(jparams, JTOY, *(jnp.asarray(x) for x in (T_init, zero, pts, valid, rays, depth, valid)),
                                  jopt.ShapeOptConfig(iters=12))
    got = _reverse_lm(params, TOY, topt.ShapeOptConfig(iters=12), T_init, zero, pts, valid, rays, depth, valid)
    assert bool(ref.is_good) and bool(got.is_good)
    assert float(got.cost) < 1.02 * float(ref.cost)
    at_got = jopt.reconstruct_object(jparams, JTOY, *(jnp.asarray(x) for x in (got.T_oc.numpy(), got.code.numpy(), pts,
                                                                                 valid, rays, depth, valid)),
                                     jopt.ShapeOptConfig(iters=0))
    close(got.cost, at_got.cost, 1e-5 * float(at_got.cost))
    sdf_est = tsdf.decode_sdf(params, TOY, got.code, topt.lie.transform_points(got.T_oc, T(pts)))
    sdf_init = tsdf.decode_sdf(params, TOY, torch.zeros(16), topt.lie.transform_points(T(T_init), T(pts)))
    assert float(sdf_est.abs().mean()) < min(0.05, 0.5 * float(sdf_init.abs().mean()))
    two = [np.stack([x, x]) for x in (T_init, zero, pts, valid, rays, depth, valid)]
    two[3][1] = two[6][1] = none
    one = _reverse_lm(params, TOY, topt.ShapeOptConfig(iters=1), T_init, zero, pts, valid, rays, depth, valid)
    bat = _reverse_lm(params, TOY, topt.ShapeOptConfig(iters=1), *two)
    assert bat.is_good.tolist() == [bool(one.is_good), False] and float(bat.cost[1]) == 0.0
    close(bat.T_oc[0], one.T_oc, 1e-4)


REVERSE_WIDTHS = {"toy": (TOY, 256), "64/512x9": (tsdf.DeepSDFConfig(64, 512, 9, (4,)), 32)}


@pytest.mark.parametrize("width", list(REVERSE_WIDTHS))
def test_reverse_jacobian_matches_the_forward_one(toy, problem, width):
    """`reverse_jacobian` (the card's path, called under `no_grad`) against
    `forward_jacobian` (`vmap(jvp)`, the CPU's) on three hypotheses, one
    with no valid surface point and one with no valid ray, the others
    masked in part: the trained toy decoder on the problem's 256 points
    and rays, and the benchmark's 64/512 x 9 decoder (random weights) on
    32 of them.  r within 1e-6, J within f32 rounding (2e-6 of its largest
    entry), and the masked rows zero in both."""
    cfg, n = REVERSE_WIDTHS[width]
    T_init, pts, rays, depth, _ = problem
    if width == "toy":
        params, code = toy[1], T(toy[2][:3])
    else:
        params = tsdf.init_decoder(torch.Generator().manual_seed(7), cfg, device="cpu")
        code = 0.1 * torch.randn(3, cfg.code_dim, generator=torch.Generator().manual_seed(8))
    i = np.arange(n)
    pv, rv = T(np.stack([i % 4 != 0, i < 0, i % 3 != 1])), T(np.stack([i % 5 != 2, i % 2 == 0, i < 0]))
    args = (params, cfg, tsdf.weights(params, cfg), code, topt.flip_hypotheses(T(T_init), 3),
            *(T(x[:n]).expand((3,) + x[:n].shape) for x in (pts,)), pv,
            *(T(x[:n]).expand((3,) + x[:n].shape) for x in (rays, depth)), rv)
    r_fwd, J_fwd = topt.forward_jacobian(*args)
    with torch.no_grad():
        r_rev, J_rev = topt.reverse_jacobian(*args)
    assert J_rev.shape == J_fwd.shape == (3, 2 * n, 7 + cfg.code_dim)
    close(r_rev, r_fwd, 1e-6)
    close(J_rev, J_fwd, 2e-6 * float(J_fwd.abs().max()))
    masked = torch.cat([~pv, ~rv], dim=-1)
    assert not bool(J_rev[masked].any() | J_fwd[masked].any() | r_rev[masked].any())
    assert float(J_fwd[~masked].abs().amax(0).min()) > 0  # every column is exercised


FOG_SDF = 0.05971  # the constant SDF whose occupancy puts a ray's expected depth on its observation


def test_a_fog_with_no_inside_costs_less_than_the_true_shape_as_in_the_reference(toy, problem, rng):
    """A reference fault the port keeps (ROADMAP queue C): the render term
    samples each ray at its observed depth +- 0.6 m, so a uniform fog, an
    SDF of 0.0597 everywhere and no inside, puts every ray's expected depth
    on its observation whatever the depth.  Both packages then see zero
    render residuals, and the surface points pay only the Huber's linear
    part, so the fog costs less than the reference's own twelve-trip fit of
    the true shape.  At the reference's width the LM reaches such shapes
    from a keyframe's inputs (PERF.md section 6)."""
    jparams, _, _, _ = toy
    T_init, pts, rays, depth, T_gt = problem
    last = f"lin{JTOY.num_layers - 1}"
    fog_j = {k: {"v": p["v"], "g": jnp.zeros_like(p["g"]),
                 "b": jnp.full_like(p["b"], np.arctanh(FOG_SDF) if k == last else 0.0)} for k, p in jparams.items()}
    fog = port(fog_j)
    valid, zero = np.ones(256, bool), np.zeros(16, np.float32)
    any_depth = (depth + rng.uniform(-0.8, 0.8, 256)).astype(np.float32)  # 0.7-2.7 m, samples above the 0.05 clamp
    for d in (depth, any_depth):
        r = tloss.render_residuals(fog, TOY, torch.zeros(7), T(zero), T(T_gt), T(rays), T(d), T(valid))
        jr = jloss.render_residuals(fog_j, JTOY, jnp.zeros(7), jnp.asarray(zero), jnp.asarray(T_gt), jnp.asarray(rays),
                                    jnp.asarray(d), jnp.asarray(valid))
        assert float(r.abs().max()) < 1e-4 and float(jnp.abs(jr).max()) < 1e-4
    assert float(tsdf.decode_sdf(fog, TOY, T(zero), T(rng.uniform(-1, 1, (512, 3)).astype(np.float32))).min()) > 0.05
    got, ref = _run_both((fog_j, fog, None, None), T_gt, zero, pts, valid, rays, depth, valid, 0)
    fit = jopt.reconstruct_object(jparams, JTOY, *(jnp.asarray(x) for x in (T_init, zero, pts, valid, rays, depth, valid)),
                                  jopt.ShapeOptConfig(iters=12))
    close(got.cost, ref.cost, 1e-4)
    assert bool(fit.is_good) and float(ref.cost) < 0.5 * float(fit.cost)


def test_flip_search_matches_the_reference(toy, problem):
    """The initial frame turned a half turn about the up axis: after two
    trips the four hypotheses' winner and result are the reference's."""
    T_init, pts, rays, depth, _ = problem
    half_turn = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32) @ T_init
    valid = np.ones(256, bool)
    close(topt.flip_hypotheses(T(half_turn), 4), jopt.flip_hypotheses(jnp.asarray(half_turn), 4), 1e-6)
    (got, pick), (ref, jpick) = _run_both(toy, half_turn, np.zeros(16, np.float32), pts, valid, rays, depth, valid, 2,
                                          flips=True)
    assert int(pick) == int(jpick) and bool(got.is_good) == bool(ref.is_good)
    close(got.T_oc, ref.T_oc, 1e-4)
    close(got.code, ref.code, 1e-4)


def test_flip_search_recovers_a_half_turn_as_the_reference():
    """tests/test_flip_search.py's asymmetric shape (two fused spheres), its
    decoder trained by the reference, initialised a half turn off: over
    twelve trips both packages pick the half-turn hypothesis, and the
    port's fit lies on the surface in the true orientation."""
    from test_flip_search import CFG as JASYM, train_asym_decoder, surface_points

    jparams, _ = train_asym_decoder(jax.random.PRNGKey(3))
    pts_obj, ok = surface_points(jax.random.PRNGKey(4))
    T_true = np.eye(4, dtype=np.float32)
    T_true[2, 3] = -2.0
    pts = (np.asarray(pts_obj) + [0.0, 0.0, 2.0]).astype(np.float32)
    T_bad = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32) @ T_true
    args = (T_bad, np.zeros(8, np.float32), pts, np.asarray(ok), np.zeros((8, 3), np.float32),
            np.zeros(8, np.float32), np.zeros(8, bool))
    kw = dict(iters=12, w_render=0.0, num_flips=4, w_code=3.0)
    ref, jpick = jopt.reconstruct_object_flips(jparams, JASYM, *(jnp.asarray(x) for x in args),
                                               jopt.ShapeOptConfig(**kw))
    acfg = tsdf.DeepSDFConfig(*JASYM)
    got, pick = topt.reconstruct_object_flips(port(jparams), acfg, *(T(x) for x in args), topt.ShapeOptConfig(**kw))
    assert int(pick) == int(jpick) == 2 and bool(got.is_good) and bool(ref.is_good)
    sdf = tsdf.decode_sdf(port(jparams), acfg, got.code, topt.lie.transform_points(got.T_oc, T(pts)))
    assert float(torch.median(torch.where(T(np.asarray(ok)), sdf, 0.0).abs())) < 0.05
    R = got.T_oc[:3, :3].numpy() / np.cbrt(np.linalg.det(got.T_oc[:3, :3].numpy()))
    assert np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))) < 30.0


def test_reconstruct_object_at_full_width(rng):
    """Two LM trips of the reference-width decoder (random weights) on 32
    points and 8 rays."""
    jcfg = jsdf.DeepSDFConfig()
    jparams = jsdf.init_decoder(jax.random.PRNGKey(7), jcfg)
    pts = (rng.normal(0, 0.3, (32, 3)) + [0, 0, 2.0]).astype(np.float32)
    rays = np.concatenate([rng.normal(0, 0.1, (8, 2)), np.ones((8, 1))], 1).astype(np.float32)
    depth = rng.uniform(1.8, 2.2, 8).astype(np.float32)
    T_init = np.diag([2.5, 2.5, 2.5, 1.0]).astype(np.float32)  # an object of scale 0.4, 2 m ahead
    T_init[2, 3] = -5.0
    code = rng.normal(0, 0.1, 64).astype(np.float32)
    pv, rv = np.arange(32) % 5 != 0, np.ones(8, bool)
    ref = jopt.reconstruct_object(jparams, jcfg, jnp.asarray(T_init), jnp.asarray(code), jnp.asarray(pts),
                                  jnp.asarray(pv), jnp.asarray(rays), jnp.asarray(depth), jnp.asarray(rv),
                                  jopt.ShapeOptConfig(iters=2))
    got = topt.reconstruct_object(port(jparams), tsdf.DeepSDFConfig(), T(T_init), T(code), T(pts), T(pv), T(rays),
                                  T(depth), T(rv), topt.ShapeOptConfig(iters=2))
    close(got.T_oc, ref.T_oc, 1e-4)
    close(got.code, ref.code, 1e-4)
    assert bool(got.is_good) == bool(ref.is_good)


def test_estimate_pose_cam_obj_matches_the_reference(toy):
    """tests/test_shape.py's pose-only problem (shape 2 at scale 0.3)."""
    jparams, params, codes, halves = toy
    T_co_rigid = jlie.exp_se3(jnp.asarray([0.0, 0.0, 1.5, 0.0, 0.3, 0.0]))
    key = jax.random.PRNGKey(3)
    d = jax.random.normal(key, (256, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    pts = (d * halves[2]) @ (T_co_rigid[:3, :3] * 0.3).T + T_co_rigid[:3, 3]
    T_gt = jlie.inv_sim3(T_co_rigid.at[:3, :3].multiply(0.3))
    T_init = jlie.exp_se3(jnp.asarray([0.08, 0.05, -0.06, 0.04, 0.05, -0.03])) @ T_gt
    valid = jnp.ones(256, bool)
    ref_T, ref_c = jopt.estimate_pose_cam_obj(jparams, JTOY, T_init, jnp.asarray(codes[2]), pts, valid, iters=8)
    got_T, got_c = topt.estimate_pose_cam_obj(params, TOY, T(T_init), T(codes[2]), T(pts), T(valid), iters=8)
    close(got_T, ref_T, 1e-4)
    close(got_c, ref_c, 1e-4)
    sdf = tsdf.decode_sdf(params, TOY, T(codes[2]), topt.lie.transform_points(got_T, T(pts)))
    assert float(sdf.abs().mean()) < 0.03


# -- the keyframe's shape inputs and the due-only reconstruction ---------------------------


def _pixels(inp):
    """Sampled pixel coordinates, recovered from the rays."""
    r = np.asarray(inp.rays)
    return np.round(r[..., 0] * INTR.fx + INTR.cx), np.round(r[..., 1] * INTR.fy + INTR.cy)


@pytest.mark.parametrize("masks", [False, True])
def test_gather_shape_inputs_matches_the_reference(scene_frame, masks):
    """Each object's box comes from projecting its ellipsoid, which the two
    packages round differently (boxes under 1e-3 px apart), so a draw that
    lands within that gap of a rounding boundary can pick the next pixel:
    only such samples may pick another pixel than the reference's, and the
    others' points, rays and depths agree to 1e-5 with equal masks."""
    scene, T_cw, depth, det = scene_frame
    jt = _table(scene)
    tt = object_table_from_numpy({k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    ground = np.array([0.0, -1.0, 0.0, 10.0], np.float32)  # a far plane: no ground cut
    # Detection 2 also claims object 0's pixels: the later detection wins.
    m = det["mask"].copy()
    m[2] |= m[0]
    assoc = np.array([0, -1, 2], np.int32)
    jkw = dict(det_masks=jnp.asarray(m), det_assoc=jnp.asarray(assoc)) if masks else {}
    tkw = dict(det_masks=T(m), det_assoc=T(assoc)) if masks else {}
    ref = jmap.gather_shape_inputs(jt, jnp.asarray(T_cw), jnp.asarray(depth), jnp.asarray(ground), JINTR,
                                   jax.random.PRNGKey(5003), **jkw)
    got = tmap.gather_shape_inputs(tt, T(T_cw), T(depth), T(ground), INTR, torch.Generator().manual_seed(5003),
                                   draw=jax_shape_draw, **tkw)
    (gu, gv), (ru, rv) = _pixels(got), _pixels(ref)
    same = (gu == ru) & (gv == rv)
    e_cam = tquadric.transform_ellipsoid(tt.ellipsoid, T(T_cw)[None])
    box = tquadric.project_bbox(e_cam, torch.eye(4), intrinsic_matrix(INTR))
    jbox = jquadric.project_bbox(jquadric.transform_ellipsoid(jt.ellipsoid, jnp.asarray(T_cw)[None]),
                                 jnp.eye(4), JINTR.K)
    live = np.isfinite(np.asarray(jbox)).all(1)  # the empty slot projects to NaN in both
    gap = float(np.abs(box.numpy() - np.asarray(jbox))[live].max())
    assert gap < 1e-3
    unit = jax_shape_draw(torch.Generator().manual_seed(5003), 4, 256)
    u = _scaled(unit[..., 0], box[:, 0:1], box[:, 2:3]).numpy()
    v = _scaled(unit[..., 1], box[:, 1:2], box[:, 3:4]).numpy()
    near = lambda x: np.abs(x - np.floor(x) - 0.5) < gap + 1e-4  # noqa: E731  (+ f32 spacing at 640 px)
    assert live.sum() == 3 and not (~same & ~(near(u) | near(v)))[live].any()
    np.testing.assert_array_equal(got.due.numpy(), np.asarray(ref.due))
    for name in ("pts_ok", "rays_ok"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[same], np.asarray(getattr(ref, name))[same], name)
    for name in ("pts_cam", "rays", "depth_obs"):
        close(getattr(got, name).numpy()[same], np.asarray(getattr(ref, name))[same], 1e-5)
    close(got.T_oc_init, ref.T_oc_init, 1e-5)
    assert got.due.tolist() == [True, False, True, False]
    assert not bool(got.pts_ok[1].any() | got.rays_ok[1].any() | got.pts_ok[3].any())
    assert int(got.pts_ok[2].sum()) >= 20
    if masks:  # object 0's pixels belong to detection 2; its samples stay render rays
        assert int(got.pts_ok[0].sum()) == 0 and int(got.rays_ok[0].sum()) >= 100
        assert int(got.pts_ok[2].sum()) < int(got.rays_ok[2].sum())
    else:
        assert int(got.pts_ok[0].sum()) >= 20


def test_reconstruct_due_objects_computes_only_the_due_slots(toy, scene_frame, monkeypatch):
    """The reference computes all four slots x four flips; the port only
    the two due ones, in chunks, and the tables agree (the reference's
    inputs fed to both; one LM trip, whose result the two packages share
    to 1e-4 while later trips part, see above)."""
    jparams, params, _, _ = toy
    scene, T_cw, depth, det = scene_frame
    jt = _table(scene)
    tt = object_table_from_numpy({k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    ground = np.array([0.0, -1.0, 0.0, 10.0], np.float32)
    jin = jmap.gather_shape_inputs(jt, jnp.asarray(T_cw), jnp.asarray(depth), jnp.asarray(ground), JINTR,
                                   jax.random.PRNGKey(5001))
    tin = tmap.ShapeInputs(*(T(x) for x in jin))
    ref = jmap.reconstruct_due_objects(jt, jin, jparams, JTOY, jnp.asarray(T_cw), jopt.ShapeOptConfig(iters=1))
    seen = []
    real = tmap.reconstruct_object
    monkeypatch.setattr(tmap, "reconstruct_object", lambda *a: seen.append(a[2].shape[0]) or real(*a))
    monkeypatch.setattr(tmap, "chunk_size", lambda *a: 3)  # chunks of 3, 3 and 2 hypotheses
    got = tmap.reconstruct_due_objects(tt, tin, params, TOY, T(T_cw), topt.ShapeOptConfig(iters=1))
    assert seen == [3, 3, 2]
    np.testing.assert_array_equal(got.shape_ok.numpy(), np.asarray(ref.shape_ok))
    assert not bool(got.shape_ok[1] | got.shape_ok[3]) and bool(got.shape_ok.any())
    close(got.code, ref.code, 1e-4)
    close(got.Tow_shape, ref.Tow_shape, 1e-4)
    # Nothing due: the table comes back as it was, with no LM call.
    seen.clear()
    idle = tmap.reconstruct_due_objects(tt, tin._replace(due=torch.zeros(4, dtype=torch.bool)), params, TOY,
                                        T(T_cw))
    assert idle is tt and seen == []


def test_chunks_fit_the_budget():
    full = tsdf.DeepSDFConfig()
    per = tmap.hypothesis_bytes(full, 256, 256)
    assert per == int(tmap.WORKING_SET * (256 + 256 * 32) * 72 * 512 * 4)
    assert 3.91e9 < per < 1.05 * 3.91e9  # the H100's peak per hypothesis at this size, with 5% to spare
    assert tmap.chunk_size(full, 256, 256, torch.device("cpu")) == max(1, tmap.CPU_BUDGET_BYTES // per)
    assert tmap.chunk_size(TOY, 256, 256, torch.device("cpu")) >= 8


def test_card_chunks_follow_the_reverse_path(monkeypatch):
    """On a card each chunk is sized from the reverse path's bytes: at the
    benchmark's 64/512 x 9 with 256 points and rays, an 80 GB card takes
    the cell's 12 hypotheses (3 objects x 4 flips) in one chunk, while the
    CPU keeps the forward path's estimate."""
    full = tsdf.DeepSDFConfig(64, 512, 9, (4,))
    per = tmap.reverse_hypothesis_bytes(full, 256, 256)
    assert per == int(tmap.REVERSE_WORKING_SET * (256 + 256 * 32) * (9 * 512 + 71) * 4)
    assert 0.1788e9 < per < 1.1 * 0.1788e9  # the H100's largest peak per hypothesis at this size, 10% to spare
    card = SimpleNamespace(total_memory=80 * 10**9)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: card)
    assert tmap.chunk_size(full, 256, 256, torch.device("cuda")) == card.total_memory // 2 // per >= 12
    forward = tmap.hypothesis_bytes(full, 256, 256)
    assert tmap.chunk_size(full, 256, 256, torch.device("cpu")) == max(1, tmap.CPU_BUDGET_BYTES // forward)


# -- meshes, rendering, configuration -------------------------------------------------------------


def test_marching_cubes_and_mesh_match_the_reference(toy):
    g = np.linspace(-1.0, 1.0, 24, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    grid = np.sqrt(x * x + y * y + (z / 0.8) ** 2) - 0.6
    got, ref = tmesh.marching_cubes(grid), jmesh.marching_cubes(grid)
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)
    assert len(got.faces) > 100
    jparams, params, codes, _ = toy
    tg = tmesh.sdf_grid_from_code(params, TOY, T(codes[0]), resolution=20, chunk=1000)
    jg = jmesh.sdf_grid_from_code(jparams, JTOY, jnp.asarray(codes[0]), resolution=20, chunk=1000)
    close(tg, jg, 1e-5)
    m = tmesh.extract_mesh_from_code(params, TOY, T(codes[0]), resolution=20)
    assert len(m.faces) > 50 and np.abs(m.vertices).max() <= 1.0
    with pytest.raises(ValueError):
        tmesh.marching_cubes(grid[0])


def _hits_agree(got_depth, ref_depth, atol=1e-4):
    got, ref = np.asarray(got_depth), np.asarray(ref_depth)
    both = np.isfinite(got) & np.isfinite(ref)
    assert np.mean(np.isfinite(got) != np.isfinite(ref)) <= 0.005
    assert both.sum() > 0
    close(got[both], ref[both], atol)
    return both


def test_render_ellipsoids_matches_the_reference(scene_frame):
    scene, T_cw, _, _ = scene_frame
    e = np.asarray(scene.ellipsoids)
    valid = np.array([True, True, False])
    label = np.array([0, 5, -1], np.int32)
    intr = Intrinsics(*(float(np.float32(v / 4)) for v in INTR))  # the camera at 160x120
    jintr = JIntrinsics(*(jnp.float32(v) for v in intr))
    ref = jviz.render_ellipsoids(jnp.asarray(e), jnp.asarray(valid), jnp.asarray(label), jnp.asarray(T_cw), jintr,
                                 120, 160)
    got = tviz.render_ellipsoids(T(e), T(valid), T(label), T(T_cw), intr, 120, 160)
    both = _hits_agree(got[0], ref[0])
    # Colour follows the normal, which grazing rays resolve to ~1e-4.
    close(got[1].numpy()[both], np.asarray(ref[1])[both], 1e-3)


def test_render_shape_crop_and_png_match_the_reference(toy, tmp_path):
    """tests/test_object_render.py's sphere-traced shape, then the whole
    composited PNG (written by the port's encoder, read back by PIL)."""
    from PIL import Image

    jparams, params, codes, _ = toy
    intr = Intrinsics(120.0, 120.0, 80.0, 60.0)
    jintr = JIntrinsics(*(jnp.float32(v) for v in intr))
    Tow = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    Tow[2, 3] = -6.0
    bbox = np.array([40.0, 20.0, 120.0, 100.0], np.float32)
    ref = jviz.render_shape_crop(jparams, JTOY, jnp.asarray(codes[0]), jnp.asarray(Tow), jnp.eye(4), jintr,
                                 jnp.asarray(bbox), jnp.int32(1), res=48, steps=32)
    got = tviz.render_shape_crop(params, TOY, T(codes[0]), T(Tow), torch.eye(4), intr, T(bbox),
                                 torch.tensor(1, dtype=torch.int32), res=48, steps=32)
    close(got[0], ref[0], 1e-5)
    _hits_agree(got[1], ref[1])

    jt = jobj.empty_objects(4, code_dim=16)
    jt = jt._replace(ellipsoid=jt.ellipsoid.at[0].set(jnp.asarray([0.0, 0.0, 3.0, 0, 0, 0, 0.25, 0.25, 0.25])),
                     valid=jt.valid.at[0].set(True), label=jt.label.at[0].set(1),
                     code=jt.code.at[0].set(jnp.asarray(codes[0])), Tow_shape=jt.Tow_shape.at[0].set(Tow),
                     shape_ok=jt.shape_ok.at[0].set(True))
    tt = object_table_from_numpy({k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    gray = np.full((120, 160), 128, np.uint8)
    ref_img = jviz.render_objects_png(None, jt, np.eye(4, dtype=np.float32), jintr, 120, 160, gray=gray,
                                      shape_prior=(jparams, JTOY))
    img = tviz.render_objects_png(str(tmp_path / "o.png"), tt, np.eye(4, dtype=np.float32), intr, 120, 160,
                                  gray=gray, shape_prior=(params, TOY))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png").convert("RGB")), img)
    assert np.mean(np.any(img != np.asarray(ref_img), axis=-1)) <= 0.005
    assert (img != 128).any()


def test_shape_config_from_json(tmp_path):
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"optimizer": {"num_iterations": 10, "k1": 2.0, "k2": 0.5, "k3": 0.1, "k4": 0.02,
                                           "scale_damping": 5.0, "b1": 0.04, "b2": 0.2, "other": 1}}))
    assert tuple(tconfig.shape_config_from_json(str(p))) == tuple(jconfig.shape_config_from_json(str(p)))
    p.write_text(json.dumps({"k1": 3.0}))
    got = tconfig.shape_config_from_json(str(p))
    assert tuple(got) == tuple(jconfig.shape_config_from_json(str(p))) and got.w_sdf == 3.0 and got.iters == 8

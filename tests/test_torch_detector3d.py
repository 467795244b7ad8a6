"""Parity of the port's learned 3D detector (slice 8) with the JAX package
on the CPU, at a small size (grid 32, 8 pillar channels, widths (8, 12)):
the pillar canvas's scatter-max (out-of-range, invalid and tied points),
the forward pass, the decode and its tie order, the box-to-ellipsoid
conversion, the training targets (duplicate centre cells), the loss and
its gradients through tied maxima, `synth_scan`'s deterministic rest on
the reference's draws, three Adam steps against optax, the detection dict
of a scan and the npz files both ways.

The JAX params come through `convert.detector3d_params_from_numpy`.
Tolerances: canvas and forward 1e-5; decoded boxes 1e-4, labels and
`valid` exact; targets 1e-6; loss and gradients 1e-4 relative; scans
1e-5; three training steps 1e-4 relative; the detection dict's boxes
1e-3 px and ellipsoids 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qsp_slam_tpu  # noqa: F401  (matmul precision)
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.perception import detector3d as J
from qsp_slam_tpu_torch.convert import detector3d_params_from_numpy
from qsp_slam_tpu_torch.core.camera import Intrinsics
from qsp_slam_tpu_torch.perception import detector3d as T

torch.set_num_threads(2)

JCFG = J.Detector3DConfig(grid=32, channels=8, widths=(8, 12))
TCFG = T.Detector3DConfig(grid=32, channels=8, widths=(8, 12))
SCAN = dict(max_boxes=4, pts_per_box=96, ground_pts=1024, clutter_pts=256)


def as_np(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def port(jparams) -> dict:
    return detector3d_params_from_numpy(as_np(jparams), device="cpu")


def T_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12))


def jax_scan_draw(key):
    """`synth_scan`'s draws of `key`, as the reference takes them: unit
    uniforms and standard normals of the same keys and shapes."""
    def draw(gen, max_boxes, pts_per_box, ground_pts, clutter_pts):
        ks = jax.random.split(key, 10)
        W, cp = T.CLUTTER, clutter_pts // T.CLUTTER
        n = max_boxes * pts_per_box + ground_pts + W * cp
        d = {name: T_(jax.random.uniform(ks[i], (max_boxes,)))
             for i, name in enumerate(("cx", "cz", "length", "width", "height", "theta", "bvalid"))}
        d["cube"] = T_(jax.random.uniform(ks[7], (max_boxes, pts_per_box, 3)))
        d["gx"] = T_(jax.random.uniform(ks[8], (ground_pts,)))
        d["gz"] = T_(jax.random.uniform(jax.random.fold_in(ks[8], 1), (ground_pts,)))
        d["gy"] = T_(jax.random.normal(jax.random.fold_in(ks[8], 2), (ground_pts,)))
        kc = jax.random.split(ks[9], 8)
        d.update({name: T_(jax.random.uniform(kc[i], (W,))) for i, name in enumerate(("wx", "wz", "is_wall", "sx",
                                                                                          "sy"))})
        d["off"] = T_(jax.random.uniform(kc[5], (W, cp, 3)))
        d["noise"] = T_(jax.random.normal(jax.random.fold_in(key, 99), (n, 3)))
        return d
    return draw


@pytest.fixture(scope="module")
def params():
    jp = J.init_detector3d(jax.random.PRNGKey(0), JCFG)
    jp = {k: (v + 0.05 * jax.random.normal(jax.random.PRNGKey(i), v.shape) if k.endswith("_b") else v)
          for i, (k, v) in enumerate(sorted(jp.items()))}
    # Two pillar channels that ReLU keeps at zero for every point: their
    # maxima tie with the empty canvas.
    jp["p2_b"] = jp["p2_b"].at[:2].set(-50.0)
    return jp, port(jp)


@pytest.fixture(scope="module")
def scan():
    """A scan of the reference at SCAN's size, with tied points: its first
    64 points repeated, and 3 points out of range."""
    pts, valid, gt = J.synth_scan(jax.random.PRNGKey(11), JCFG, **SCAN)
    pts, valid = np.asarray(pts), np.asarray(valid)
    odd = np.array([[JCFG.x_min - 1.0, 0.0, 5.0], [0.0, JCFG.y_range[1] + 1.0, 5.0],
                    [0.0, 0.0, JCFG.z_min + JCFG.grid * JCFG.cell + 2.0]], np.float32)
    return (np.concatenate([pts, pts[:64], odd]), np.concatenate([valid, valid[:64], np.ones(3, bool)]),
            {k: np.asarray(v) for k, v in gt.items()})


def test_pillar_canvas_matches_the_reference(params, scan):
    jp, tp = params
    pts, valid, _ = scan
    valid = valid.copy()
    valid[5] = False  # an invalid point inside the grid
    ref = np.asarray(J.pillar_canvas(jp, JCFG, jnp.asarray(pts), jnp.asarray(valid)))
    got = T.pillar_canvas(tp, TCFG, torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (ref[..., :2] == 0).all() and (ref[..., 2:] > 0).any()


def test_pillar_canvas_drops_out_of_range_and_invalid(params):
    _, tp = params
    cfg = TCFG
    pts = torch.tensor([[cfg.x_min - 1.0, 0.0, 5.0], [0.0, cfg.y_range[1] + 1.0, 5.0],
                        [0.0, 0.0, cfg.z_min + cfg.grid * cfg.cell + 2.0],
                        [cfg.x_min + 10.5 * cfg.cell, 0.5, cfg.z_min + 20.5 * cfg.cell]])
    assert float(T.pillar_canvas(tp, cfg, pts[:3], torch.ones(3, dtype=torch.bool)).sum()) == 0.0
    occ = T.pillar_canvas(tp, cfg, pts, torch.tensor([True, True, True, True])).sum(-1) > 0
    assert occ[20, 10] and int(occ.sum()) == 1
    assert float(T.pillar_canvas(tp, cfg, pts, torch.tensor([True, True, True, False])).sum()) == 0.0


def test_forward_matches_the_reference(params, scan):
    jp, tp = params
    pts, valid, _ = scan
    ref = J.forward(jp, JCFG, jnp.asarray(pts), jnp.asarray(valid))
    got = T.forward(tp, TCFG, torch.from_numpy(pts), torch.from_numpy(valid))
    for name, r, g in zip(T.HEADS, ref, got):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("max_det", [8, 200])
def test_detect_objects_3d_matches_the_reference(params, scan, max_det):
    """With the heatmap bias raised many peaks pass; 200 rows exceed them,
    so zero-score rows follow in the reference's index order."""
    jp, _ = params
    jp = {**jp, "hm_b": jnp.full(1, 1.5)}
    pts, valid, _ = scan
    ref = J.detect_objects_3d(jp, JCFG._replace(max_det=max_det), jnp.asarray(pts), jnp.asarray(valid))
    got = T.detect_objects_3d(port(jp), TCFG._replace(max_det=max_det), torch.from_numpy(pts),
                              torch.from_numpy(valid))
    for name in ("center", "size", "yaw"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(ref.prob), atol=1e-6)
    for name in ("label", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), name)
    assert got.valid.any()
    if max_det == 200:
        assert int((got.prob == 0).sum()) > 0


def test_boxes_to_ellipsoids_match_the_reference():
    rng = np.random.default_rng(2)
    n = 16
    fields = dict(center=rng.uniform(-5, 20, (n, 3)), size=rng.uniform(1, 5, (n, 3)),
                  yaw=rng.uniform(-np.pi, np.pi, n))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    extra = dict(label=np.zeros(n, np.int32), prob=np.ones(n, np.float32), valid=np.ones(n, bool))
    ref = J.boxes_to_ellipsoids(J.Boxes3D(**{k: jnp.asarray(v) for k, v in {**fields, **extra}.items()}))
    got = T.boxes_to_ellipsoids(T.Boxes3D(**{k: torch.from_numpy(v) for k, v in {**fields, **extra}.items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def boxes():
    """Four boxes: 0 and 1 share a centre cell (1 invalid: its 0 must not
    overwrite 0's 1), 2 lies in the next cell, 3 past the grid (clipped)."""
    center = np.array([[-18.0, 1.0, 4.0], [-18.0, 1.0, 4.0], [-17.4, 0.9, 4.1], [-5.0, 1.0, 30.0]], np.float32)
    size = np.array([[4.0, 1.5, 1.8], [3.5, 1.6, 1.7], [4.2, 1.4, 1.9], [3.9, 1.5, 1.8]], np.float32)
    return center, size, np.array([0.3, 1.2, 2.9, 0.1], np.float32), np.array([True, False, True, True])


def test_targets_match_the_reference():
    ref_hm, ref_reg = J._targets(JCFG, *(jnp.asarray(x) for x in boxes()))
    hm, reg = T._targets(TCFG, *(torch.from_numpy(x) for x in boxes()))
    np.testing.assert_allclose(hm.numpy(), np.asarray(ref_hm), atol=1e-6)
    assert hm[int(reg[0][0]), int(reg[1][0]), 0] == 1.0
    for g, r in zip(reg, ref_reg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_loss_and_every_gradient_match_the_reference(params, scan):
    """Through the scatter-max with tied maxima (repeated points; channels
    tied with the empty canvas), as `jax`'s scatter-max splits them."""
    jp, _ = params
    pts, valid, _ = scan
    args = (pts, valid, *boxes())
    ref_loss, ref_grads = jax.value_and_grad(J.detector3d_loss)(jp, JCFG, *(jnp.asarray(x) for x in args))
    tp = {k: v.requires_grad_() for k, v in port(jp).items()}
    loss = T.detector3d_loss(tp, TCFG, *(torch.from_numpy(x) for x in args))
    loss.backward()
    assert rel_err(loss.item(), ref_loss) < 1e-4
    for k, g in port(ref_grads).items():
        assert rel_err(tp[k].grad.numpy(), g.numpy()) < 1e-4, k


def test_synth_scan_rest_matches_the_reference_on_its_draws():
    key = jax.random.PRNGKey(21)
    ref_pts, ref_valid, ref_gt = J.synth_scan(key, JCFG)
    pts, valid, gt = T.synth_scan(None, TCFG, device="cpu", draw=jax_scan_draw(key))
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    for k, v in ref_gt.items():
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(v), atol=1e-6, err_msg=k)
    # The port's own draws come from a CPU generator: the same numbers for a seed.
    a = T.synth_scan(torch.Generator().manual_seed(3), TCFG, device="cpu")[0]
    b = T.synth_scan(torch.Generator().manual_seed(3), TCFG, device="cpu")[0]
    assert torch.equal(a, b) and a.shape == pts.shape


def test_three_training_steps_match_optax():
    """`train_detector3d` from the reference's init on the reference's
    scans (`fold_in(key, step)`): three Adam updates under the cosine
    schedule, losses and params within 1e-4."""
    key = jax.random.PRNGKey(4)
    ref, ref_losses = J.train_detector3d(key, JCFG, steps=3)
    keys = iter(jax.random.fold_in(key, i) for i in range(3))
    got, losses = T.train_detector3d(0, TCFG, steps=3, device="cpu", params=port(J.init_detector3d(key, JCFG)),
                                     draw=lambda gen, *shape: jax_scan_draw(next(keys))(gen, *shape))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for k, v in port(ref).items():
        assert rel_err(got[k].numpy(), v.numpy()) < 1e-4, k


def test_lidar_detections_learned_matches_the_reference(params):
    """A scan of the grid centred ahead of the camera (x from -5.2 m) and a
    1241x1000 image, so that the random head's boxes (low centres) project
    into it."""
    jp, _ = params
    jp = {**jp, "hm_b": jnp.full(1, 1.5)}
    jcfg, tcfg = JCFG._replace(x_min=-5.2), TCFG._replace(x_min=-5.2)
    pts, valid, _ = J.synth_scan(jax.random.PRNGKey(12), jcfg, **SCAN)
    pts = np.asarray(pts)[np.asarray(valid)]
    jintr = JIntrinsics(*(jnp.float32(v) for v in (718.0, 718.0, 607.0, 185.0)))
    ref = J.lidar_detections_learned(jp, jcfg, pts, jintr, 1241, 1000, budget=4096)
    got = T.lidar_detections_learned(port(jp), tcfg, pts, Intrinsics(718.0, 718.0, 607.0, 185.0), 1241, 1000,
                                     budget=4096)
    assert set(got) == set(ref)
    for k in ("label", "valid", "fit_ok"):
        np.testing.assert_array_equal(got[k], ref[k], k)
        assert got[k].dtype == ref[k].dtype
    np.testing.assert_allclose(got["bbox"], ref["bbox"], atol=1e-3)
    np.testing.assert_allclose(got["ellipsoid_cam"], ref["ellipsoid_cam"], atol=1e-4)
    np.testing.assert_allclose(got["prob"], ref["prob"], atol=1e-6)
    assert got["valid"].any()


def test_npz_files_load_in_both_packages(params, tmp_path):
    jp, tp = params
    J.save_detector3d(str(tmp_path / "jax.npz"), jp, JCFG)
    got, cfg = T.load_detector3d(str(tmp_path / "jax.npz"), device="cpu")
    assert tuple(cfg) == tuple(JCFG)
    for k, v in tp.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    T.save_detector3d(str(tmp_path / "port.npz"), tp, cfg)
    back, jcfg = J.load_detector3d(str(tmp_path / "port.npz"))
    assert jcfg == JCFG
    for k, v in jp.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), k)


def test_train_detector3d_cli_writes_weights_the_reference_loads(tmp_path, capsys):
    """`python -m qsp_slam_tpu_torch.train_detector3d --out ... --cpu`: the
    JAX command line's JSON keys, `backend` cpu, and an npz the JAX
    package loads at the default configuration."""
    import json

    from qsp_slam_tpu_torch import train_detector3d

    out = train_detector3d.main(["--out", str(tmp_path / "d3d.npz"), "--steps", "2", "--cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert set(out) == {"out", "steps", "final_loss", "backend"} and out["backend"] == "cpu"
    params, cfg = J.load_detector3d(str(tmp_path / "d3d.npz"))
    assert cfg == J.Detector3DConfig() and params["c1_w"].shape == (3, 3, 32, 32)
    assert np.isfinite(out["final_loss"])

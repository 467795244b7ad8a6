"""Parity of the port's shape slice as a whole with the JAX package on the
CPU: `SlamSystem(shape_prior=...)` through `track_rgbd` with instance
masks, its checkpoints, the stereo keypoint depth image through
`track_stereo`, and `run_synthetic --objects`.

Both packages get the same rendered frames and a decoder the reference
trained; the port runs on the reference's draws (ground plane, Manhattan
rounds, fit pixels and shape pixels, patched into the facade with
`functools.partial(..., draw=...)`).  Tolerances: keyframes, object slots,
labels and `shape_ok` slots exact; trajectories 1e-4.  Each keyframe's
shape inputs are held to the reference's as in `tests/test_torch_shape.py`
(the boxes come from projecting ellipsoids that the two packages refine to
1e-4 of each other, so only samples that lie within the boxes' gap of a
rounding boundary may pick another pixel),
and the port's LM then runs on the reference's inputs, two trips per
step: codes and `Tow_shape` within 1e-3.  Run on its own inputs, one trip
per step already parts the codes by 3e-3 and `Tow_shape` by 4e-2 here (a
few samples on another pixel of a depth edge), and eight trips by 0.1 and
1.0: the LM amplifies f32 rounding, the reference's as much as the
port's (`tests/test_torch_shape.py` holds three trips to the reference's
own one-ulp spread), so the default depth is held to its outcome, shapes
reconstructed, by `run_synthetic`.
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
from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from qsp_slam_tpu.models import deepsdf as jsdf
from qsp_slam_tpu.models.shape_opt import ShapeOptConfig as JShapeOptConfig
from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem
from qsp_slam_tpu.slam.tracking import TrackingConfig as JTrackingConfig
from qsp_slam_tpu_torch.convert import deepsdf_params_from_numpy
from qsp_slam_tpu_torch.core import quadric as tq
from qsp_slam_tpu_torch.core.camera import intrinsic_matrix
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.models import deepsdf as tsdf
from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig
from qsp_slam_tpu_torch.perception import ellipsoid_fit as tfit
from qsp_slam_tpu_torch.perception import groundplane as tgp
from qsp_slam_tpu_torch.perception import manhattan as tman
from qsp_slam_tpu_torch.slam import shape_mapping as tmap
from qsp_slam_tpu_torch.slam import system as system_mod
from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint, save_checkpoint
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(2)

DEC = tsdf.DeepSDFConfig(code_dim=8, hidden=32, num_layers=4, latent_in=(2,))
JDEC = jsdf.DeepSDFConfig(code_dim=8, hidden=32, num_layers=4, latent_in=(2,))
N_FRAMES = 10
SYS = dict(kmax=16, nmax=2048, emax=16384, ba_window=6, omax=8, enable_loop_closing=False)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- the reference's draws, fed to the port ----------------------------------------


def jax_plane_draw(gen, num_hyp):
    key = jax.random.PRNGKey(gen.initial_seed())
    return T(jax.random.uniform(key, (num_hyp, 3))), T(jax.random.uniform(jax.random.fold_in(key, 1), (num_hyp,)))


class JaxRoundDraws:
    """Manhattan rounds: one more split of the seed's key per call."""

    def __init__(self):
        self.gen, self.key = None, None

    def __call__(self, gen, num_hyp):
        if gen is not self.gen:
            self.gen, self.key = gen, jax.random.PRNGKey(gen.initial_seed())
        self.key, k = jax.random.split(self.key)
        return T(jax.random.uniform(k, (num_hyp, 3))), T(jax.random.uniform(jax.random.fold_in(k, 1), (num_hyp,)))


def jax_bbox_draw(gen, num_det, num_samples):
    keys = jax.random.split(jax.random.PRNGKey(gen.initial_seed()), num_det)
    u = jax.vmap(lambda k: jax.random.uniform(k, (num_samples,)))(keys)
    v = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (num_samples,)))(keys)
    return T(jnp.stack([u, v], -1))


def jax_shape_draw(gen, num_obj, num_samples):
    key = jax.random.PRNGKey(gen.initial_seed())
    ks = [jax.random.fold_in(key, o) for o in range(num_obj)]
    u = jnp.stack([jax.random.uniform(k, (num_samples,)) for k in ks])
    v = jnp.stack([jax.random.uniform(jax.random.fold_in(k, 1), (num_samples,)) for k in ks])
    return T(jnp.stack([u, v], -1))


class patched:
    """The facade's module names replaced for a block."""

    def __init__(self, patches):
        self.patches, self.saved = patches, {k: getattr(system_mod, k) for k in patches}

    def __enter__(self):
        for k, v in self.patches.items():
            setattr(system_mod, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(system_mod, k, v)


def reference_draws():
    return {"estimate_ground_plane": functools.partial(tgp.estimate_ground_plane, draw=jax_plane_draw),
            "estimate_ground_plane_points": functools.partial(tgp.estimate_ground_plane_points, draw=jax_plane_draw),
            "extract_manhattan_planes": functools.partial(tman.extract_manhattan_planes, draw=JaxRoundDraws()),
            "sample_bbox_depth_points": functools.partial(tfit.sample_bbox_depth_points, draw=jax_bbox_draw),
            "gather_shape_inputs": functools.partial(tmap.gather_shape_inputs, draw=jax_shape_draw)}


# -- fixtures ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder():
    jparams, _, _ = jsdf.train_toy_decoder(jax.random.PRNGKey(0), JDEC, num_shapes=8, steps=400, batch=512)
    return jparams, deepsdf_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def frames():
    """tests/test_shape_mapping.py's scene and lateral track (the seed-2
    scene 25 degrees down, 4 cm per frame), with instance masks."""
    scene = jrender.make_scene(num_objects=3, seed=2)
    jcfg = JTrackingConfig()
    base = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.44, 0, 0], jnp.float32))
    out = []
    for i in range(N_FRAMES):
        Tcw = jlie.exp_se3(jnp.asarray([0.04 * i, 0, 0, 0, 0, 0], jnp.float32)) @ base
        g, d, inst = jrender.render_scene(scene, Tcw, jcfg.intr)
        det = jrender.gt_detections(scene, Tcw, jcfg.intr, instance=inst)
        out.append((np.asarray(g), np.asarray(d), {k: np.asarray(v) for k, v in det.items()}))
    return scene, np.asarray(base), out


@pytest.fixture(scope="module")
def two_trips(decoder, frames):
    """Both packages through the scene, two LM trips per shape step; each
    step's shape inputs of both packages are kept, and the port's LM runs
    on the reference's."""
    import qsp_slam_tpu.slam.shape_mapping as jmap

    jparams, params = decoder
    js = JSlamSystem(JTrackingConfig(orb=JOrbConfig(num_features=500)),
                     shape_prior=(jparams, JDEC, JShapeOptConfig(iters=2)), **SYS)
    ts = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=500)), shape_prior=(params, DEC, ShapeOptConfig(iters=2)),
                    device="cpu", **SYS)
    steps = []
    real_j = jmap.gather_shape_inputs
    real_t = functools.partial(tmap.gather_shape_inputs, draw=jax_shape_draw)

    def j_gather(*a, **k):
        steps.append({"ref": real_j(*a, **k), "jbox": jq.project_bbox(
            jq.transform_ellipsoid(a[0].ellipsoid, a[1][None]), jnp.eye(4), a[4].K)})
        return steps[-1]["ref"]

    def t_gather(table, Tcw, depth, ground, intr, gen, **k):
        got = steps[-1]["got"] = real_t(table, Tcw, depth, ground, intr, gen, **k)
        # The port's boxes and its draws' unrounded pixel coordinates.
        box = tq.project_bbox(tq.transform_ellipsoid(table.ellipsoid, Tcw[None]), torch.eye(4),
                              intrinsic_matrix(intr))
        unit = jax_shape_draw(gen, box.shape[0], got.rays.shape[1])
        steps[-1].update(box=box, u=tfit._scaled(unit[..., 0], box[:, 0:1], box[:, 2:3]),
                         v=tfit._scaled(unit[..., 1], box[:, 1:2], box[:, 3:4]))
        return tmap.ShapeInputs(*(T(x) for x in steps[-1]["ref"]))

    jmap.gather_shape_inputs = j_gather
    try:
        with patched(reference_draws() | {"gather_shape_inputs": t_gather}):
            for g, d, det in frames[2]:
                js.track_rgbd(g, d, det)
                ts.track_rgbd(g, d, det)
    finally:
        jmap.gather_shape_inputs = real_j
    return js, ts, steps


def test_track_rgbd_with_a_shape_prior_matches_the_reference(two_trips):
    js, ts, steps = two_trips
    assert ts.stats["kf_frames"] == js.stats["kf_frames"] and len(ts.stats["kf_frames"]) >= 3
    np.testing.assert_allclose(np.stack(ts.trajectory), np.stack(js.trajectory), rtol=0, atol=1e-4)
    for name in ("valid", "label", "obs_count", "shape_ok"):
        np.testing.assert_array_equal(getattr(ts.objects, name).numpy(), np.asarray(getattr(js.objects, name)), name)
    assert ts.objects.code.shape == (8, DEC.code_dim) and int(ts.objects.shape_ok.sum()) >= 2
    np.testing.assert_allclose(ts.objects.code.numpy(), np.asarray(js.objects.code), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.objects.Tow_shape.numpy(), np.asarray(js.objects.Tow_shape), rtol=0, atol=1e-3)


def test_shape_inputs_of_each_keyframe_match_the_reference(two_trips):
    """One gather per keyframe in both packages, with the detections'
    instance masks: the same due slots; a sample may pick another pixel
    than the reference's only where its coordinate lies within the two
    packages' box gap (under 1e-3 px) of a rounding boundary; on the
    others, equal masks and points within 1e-5."""
    js, ts, steps = two_trips
    assert len(steps) == len(ts.stats["kf_frames"]) and sum(int(s["got"].due.sum()) for s in steps) >= 2
    fx, fy, cx, cy = ts.cfg.intr
    for s in steps:
        got, ref = s["got"], s["ref"]
        np.testing.assert_array_equal(got.due.numpy(), np.asarray(ref.due))
        if not got.due.any():
            continue
        r, q = got.rays.numpy(), np.asarray(ref.rays)
        same = ((np.round(r[..., 0] * fx + cx) == np.round(q[..., 0] * fx + cx))
                & (np.round(r[..., 1] * fy + cy) == np.round(q[..., 1] * fy + cy)))
        due = got.due.numpy()
        gap = float(np.abs(s["box"].numpy() - np.asarray(s["jbox"]))[due].max())
        near = lambda x: np.abs(x - np.floor(x) - 0.5) < gap + 1e-4  # noqa: E731  (+ f32 spacing at 640 px)
        assert gap < 1e-3 and not (~same & ~(near(s["u"].numpy()) | near(s["v"].numpy())))[due].any()
        for name in ("pts_ok", "rays_ok"):
            np.testing.assert_array_equal(getattr(got, name).numpy()[same], np.asarray(getattr(ref, name))[same])
        np.testing.assert_allclose(got.pts_cam.numpy()[same], np.asarray(ref.pts_cam)[same], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.T_oc_init.numpy()[due], np.asarray(ref.T_oc_init)[due], rtol=0, atol=1e-3)
    # Masks separate surface points from render rays.
    due_rows = np.concatenate([s["got"].due.numpy() for s in steps])
    pts_ok = np.concatenate([s["got"].pts_ok.numpy() for s in steps])[due_rows]
    rays_ok = np.concatenate([s["got"].rays_ok.numpy() for s in steps])[due_rows]
    assert (pts_ok.sum(1) >= 20).all() and (pts_ok & ~rays_ok).sum() == 0 and rays_ok.sum() > pts_ok.sum()


def test_shape_session_round_trips_and_resumes_from_the_reference(two_trips, decoder, tmp_path):
    """A checkpoint keeps the codes at the prior's width, `Tow_shape` and
    `shape_ok`; the reference's checkpoint of its run resumes in the port."""
    from qsp_slam_tpu.slam.checkpoint import save_checkpoint as jsave

    js, ts, _ = two_trips
    save_checkpoint(str(tmp_path / "t.npz"), ts)
    jsave(str(tmp_path / "j.npz"), js)
    for path, src in (("t.npz", ts.objects), ("j.npz", js.objects)):
        port = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=500)), shape_prior=(decoder[1], DEC),
                          device="cpu", **SYS)
        load_checkpoint(str(tmp_path / path), port)
        for name in ("code", "Tow_shape", "shape_ok"):
            np.testing.assert_array_equal(getattr(port.objects, name).numpy(), np.asarray(getattr(src, name)), name)


def test_stereo_shape_step_reads_the_reference_keypoint_image(frames, decoder):
    """Stereo keyframes scatter their keypoint depths into an image (the
    last keypoint wins a shared pixel, as the reference's `.at[].set` on
    XLA:CPU) and sample the shapes from it: every image the facade builds
    on this 6-frame stereo run equals the reference's formula on the same
    keypoints, and the due objects' LM runs on it."""
    scene = jrender.make_scene(num_objects=3, seed=2)
    base = jlie.exp_se3(jnp.asarray([0, 0, 0, 0.44, 0, 0], jnp.float32))
    cfg = TrackingConfig(orb=OrbConfig(num_features=500), baseline=0.12)
    jintr = JTrackingConfig().intr
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -0.12
    images, lm_calls = [], []
    real_image, real_lm = system_mod.keypoint_depth_image, system_mod.reconstruct_due_objects

    def image(xy, depth, H, W):
        img = real_image(xy, depth, H, W)
        xi = jnp.clip(jnp.round(jnp.asarray(xy[:, 0].numpy())).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.round(jnp.asarray(xy[:, 1].numpy())).astype(jnp.int32), 0, H - 1)
        images.append((img.numpy(), np.asarray(jnp.zeros((H, W), jnp.float32).at[yi, xi].set(depth.numpy()))))
        return img

    def lm(table, inputs, *a):
        lm_calls.append(int(inputs.due.sum()))
        return real_lm(table, inputs, *a)

    ts = SlamSystem(cfg, shape_prior=(decoder[1], DEC, ShapeOptConfig(iters=2)), device="cpu", **SYS)
    with patched({"keypoint_depth_image": image, "reconstruct_due_objects": lm}):
        for i in range(6):
            Tcw = jlie.exp_se3(jnp.asarray([0.045 * i, 0, 0, 0, 0, 0], jnp.float32)) @ base
            gl, _, _ = jrender.render_scene(scene, Tcw, jintr)
            gr, _, _ = jrender.render_scene(scene, jnp.asarray(shift) @ Tcw, jintr)
            det = {k: np.asarray(v) for k, v in jrender.gt_detections(scene, Tcw, jintr).items()}
            det["ellipsoid_cam"] = np.asarray(jq.transform_ellipsoid(scene.ellipsoids, Tcw[None]))
            det["fit_ok"] = det["valid"]
            ts.track_stereo(np.asarray(gl), np.asarray(gr), det)
    assert len(images) >= 2 and len(images) == len(lm_calls) and max(lm_calls) >= 1
    for got, ref in images:
        np.testing.assert_array_equal(got, ref)
        assert (got > 0).sum() >= 100
    assert bool(torch.isfinite(ts.objects.code).all())


def test_keypoint_depth_image_last_keypoint_wins():
    xy = T(np.array([[3.2, 1.0], [3.4, 0.9], [0.0, 0.0], [9.7, 4.6]], np.float32))
    img = tmap.keypoint_depth_image(xy, T(np.array([1.0, 2.0, 3.0, 4.0], np.float32)), 5, 8)
    assert img[1, 3] == 2.0 and img[0, 0] == 3.0 and img[4, 7] == 4.0 and int((img > 0).sum()) == 3


def test_run_synthetic_objects_on_the_cpu(capsys):
    """`run_synthetic 4 --objects --cpu`: the JAX command line's keys, a
    tracked orbit and reconstructed shapes (`--detector`:
    `tests/test_torch_detector2d.py`).  (Two LM trips per shape step keep the CPU run short; the card runs the
    command at its defaults.)"""
    from qsp_slam_tpu_torch import run_synthetic

    real = system_mod.reconstruct_due_objects
    with patched({"reconstruct_due_objects": lambda t, i, p, c, T_, o: real(t, i, p, c, T_, o._replace(iters=2))}):
        out = run_synthetic.main(["4", "--objects", "--cpu"])
    for key in ("frames", "keyframes", "ate_rmse_m", "rpe_trans_rmse", "backend", "obj_precision", "obj_recall",
                "obj_mean_iou", "obj_center_err_m", "shapes_reconstructed"):
        assert key in out, key
    assert out["backend"] == "cpu" and out["ate_rmse_m"] < 0.05 and out["shapes_reconstructed"] >= 1
    assert capsys.readouterr().out.strip().startswith("{")


def test_shape_entry_points_need_cuda_unless_cpu_is_named(decoder):
    """Without a card, a shape-prior system and `run_synthetic --objects`
    raise unless the CPU is named (both run on CUDA by default)."""
    if torch.cuda.is_available():
        assert SlamSystem(TrackingConfig(), shape_prior=(decoder[1], DEC)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(TrackingConfig(), shape_prior=(decoder[1], DEC))
    from qsp_slam_tpu_torch import run_synthetic

    with pytest.raises(RuntimeError, match="CUDA"):
        run_synthetic.main(["2", "--objects"])

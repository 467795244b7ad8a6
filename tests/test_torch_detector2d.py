"""Parity of the port's learned 2D detector (slice 8) with the JAX package
on the CPU, at small widths (8, 12, 16) and small inputs: the forward pass
with XLA's "SAME" padding, the decode (peak NMS, the top-k's tie order,
the mean-pooled `ds > 1` path and its nearest-upsampled masks), the
training targets (duplicate centre cells), the loss and its gradients,
three Adam steps under the cosine schedule against optax, the npz files
both ways, the `detector` field of `SlamSystem`, `run_tum --detector` and
`run_synthetic --detector`.  (Detect-online through both systems is
tested in `tests/test_torch_structures.py`, beside the RGB-D object run
whose compiled reference functions it reuses.)

The JAX params come through `convert.detector2d_params_from_numpy`.
Tolerances: forward 1e-5; boxes 1e-4 px, labels, `valid`, row order and
masks exact; targets 1e-6; loss and gradients 1e-4 relative; three
training steps 1e-4 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the reference's optimizer; train_detector imports it)
import pytest
import torch
import torch.nn.functional as F

import qsp_slam_tpu  # noqa: F401  (matmul precision)
from qsp_slam_tpu.core.camera import Intrinsics as JIntrinsics
from qsp_slam_tpu.perception import detector2d as J
from qsp_slam_tpu_torch.convert import detector2d_params_from_numpy
from qsp_slam_tpu_torch.core.camera import Intrinsics
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.perception import detector2d as T
from qsp_slam_tpu_torch.slam import system as system_mod
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

torch.set_num_threads(2)

WIDTHS = (8, 12, 16)
HW = (64, 80)
JCFG = J.DetectorConfig(widths=WIDTHS, input_hw=HW)
TCFG = T.DetectorConfig(widths=WIDTHS, input_hw=HW)


def as_np(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def port(jparams) -> dict:
    return detector2d_params_from_numpy(as_np(jparams), device="cpu")


def firing(jparams, bias: float = 2.0):
    """The JAX params with the heatmap bias raised, so that random weights
    give many peaks above the score threshold."""
    return {**jparams, "hm_b": jnp.full_like(jparams["hm_b"], bias)}


def rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def params():
    jp = J.init_detector(jax.random.PRNGKey(0), JCFG)
    # Non-zero biases, so that every bias moves the outputs.
    jp = {k: (v + 0.05 * jax.random.normal(jax.random.PRNGKey(i), v.shape) if k.endswith("_b") else v)
          for i, (k, v) in enumerate(sorted(jp.items()))}
    return jp, port(jp)


# -- forward and decode -------------------------------------------------------------


def test_stride_two_same_padding_is_xla_s():
    """XLA pads a stride-2 3x3 "SAME" conv of an even input by (0, 1);
    PyTorch's padding=1 pads (1, 1) and gives another result."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 20, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                                  dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt, wt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1)
    got = T.same_conv(xt, wt, torch.zeros(4), stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    naive = F.conv2d(xt, wt, padding=1, stride=2).permute(0, 2, 3, 1).numpy()
    assert np.abs(naive - ref).max() > 0.1


@pytest.mark.parametrize("hw", [HW, (63, 81)])
def test_forward_matches_the_reference(params, hw):
    jp, tp = params
    gray = np.random.default_rng(1).integers(0, 256, hw).astype(np.uint8)
    ref = J.forward(jp, JCFG, jnp.asarray(gray))
    got = T.forward(tp, TCFG, torch.from_numpy(gray))
    for name, r, g in zip(T.HEADS, ref, got):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=name)


def test_top_k_ties_go_to_the_lower_index():
    """After peak NMS, equal scores come out in index order, as
    `jax.lax.top_k` orders them (`torch.topk` does not promise it)."""
    hm = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 2.0, 0.0])[None, :, None]
    scores, cls, iy, ix = T.peak_topk(hm, 6)
    p = jax.nn.sigmoid(jnp.asarray(hm.numpy()))
    keep = p == jax.lax.reduce_window(p, -jnp.inf, jax.lax.max, (3, 3, 1), (1, 1, 1), "SAME")
    ref_scores, ref_flat = jax.lax.top_k(jnp.where(keep, p, 0.0).reshape(-1), 6)
    assert ix.tolist() == np.asarray(ref_flat).tolist() == [6, 1, 3, 0, 2, 4]
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-7)
    assert iy.tolist() == [0] * 6 and cls.tolist() == [0] * 6


@pytest.mark.parametrize("ds", [1, 2])
@pytest.mark.parametrize("max_det", [8, 400])
def test_detect_objects_matches_the_reference(params, ds, max_det):
    """Boxes, labels, scores, `valid` and masks row for row, at the input
    size (masks upsampled 4x) and at twice it (mean-pooled, boxes scaled,
    masks 8x); 400 rows exceed the peaks, so zero-score ties are ordered."""
    jp, _ = params
    jp = firing(jp)
    gray = np.random.default_rng(2 + ds).integers(0, 256, (HW[0] * ds, HW[1] * ds)).astype(np.uint8)
    ref = J.detect_objects(jp, JCFG._replace(max_det=max_det), jnp.asarray(gray))
    got = T.detect_objects(port(jp), TCFG._replace(max_det=max_det), torch.from_numpy(gray))
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["bbox"].numpy(), np.asarray(ref["bbox"]), atol=1e-4)
    np.testing.assert_allclose(got["prob"].numpy(), np.asarray(ref["prob"]), atol=1e-6)
    for k in ("label", "valid", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    assert got["mask"].shape == (max_det, HW[0] * ds, HW[1] * ds) and got["valid"].any()
    if max_det == 400:
        assert (got["prob"] == 0).sum() > 0  # zero-score rows, in the reference's order


def test_frame_must_be_a_multiple_of_the_input():
    with pytest.raises(ValueError, match="multiple"):
        T.detect_objects(port(J.init_detector(jax.random.PRNGKey(0), JCFG)), TCFG, torch.zeros(70, 80))


# -- targets, loss, gradients ------------------------------------------------------------


def detections(rng):
    """Five boxes: 0 and 1 share a centre cell and label (1 invalid: its
    0 must not overwrite 0's 1), 2 the same cell with another label, 3 a
    box elsewhere, 4 a box past the border (its cell clipped)."""
    bbox = np.array([[10, 12, 30, 28], [10, 12, 30, 28], [11, 13, 29, 27], [40, 30, 72, 60], [70, 50, 95, 70]],
                    np.float32)
    return (bbox, np.array([1, 1, 2, 0, 1], np.int32), np.array([True, False, True, True, True]),
            rng.integers(-1, 3, HW).astype(np.int32))


def test_targets_match_the_reference():
    bbox, label, valid, inst = detections(np.random.default_rng(3))
    ref_hm, ref_reg, ref_seg = J._targets(JCFG, jnp.asarray(bbox), jnp.asarray(label), jnp.asarray(valid),
                                          jnp.asarray(inst))
    hm, reg, seg = T._targets(TCFG, torch.from_numpy(bbox), torch.from_numpy(label), torch.from_numpy(valid),
                              torch.from_numpy(inst))
    np.testing.assert_allclose(hm.numpy(), np.asarray(ref_hm), atol=1e-6)
    iy, ix = int(reg[0][0]), int(reg[1][0])
    assert hm[iy, ix, 1] == 1.0 and hm[iy, ix, 2] == 1.0  # the invalid duplicate kept valid's 1
    for g, r in zip(reg, ref_reg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(ref_seg))


def test_loss_and_every_gradient_match_the_reference(params):
    jp, _ = params
    rng = np.random.default_rng(4)
    bbox, label, valid, inst = detections(rng)
    gray = rng.integers(0, 256, HW).astype(np.uint8)
    jargs = [jnp.asarray(x) for x in (gray, bbox, label, valid, inst)]
    ref_loss, ref_grads = jax.value_and_grad(J.detector_loss)(jp, JCFG, *jargs)
    tp = {k: v.requires_grad_() for k, v in port(jp).items()}
    loss = T.detector_loss(tp, TCFG, *(torch.from_numpy(x) for x in (gray, bbox, label, valid, inst)))
    loss.backward()
    assert rel_err(loss.item(), ref_loss) < 1e-4
    for k, g in port(ref_grads).items():
        assert rel_err(tp[k].grad.numpy(), g.numpy()) < 1e-4, k


# -- weights on disk, training ------------------------------------------------------------


def test_npz_files_load_in_both_packages(params, tmp_path):
    jp, tp = params
    cfg = J.DetectorConfig(widths=WIDTHS, input_hw=HW, max_det=6, score_thr=0.25)
    J.save_detector2d(str(tmp_path / "jax.npz"), jp, cfg)
    got, tcfg = T.load_detector2d(str(tmp_path / "jax.npz"), device="cpu")
    assert tuple(tcfg) == tuple(cfg)
    for k, v in port(jp).items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    T.save_detector2d(str(tmp_path / "port.npz"), tp, tcfg)
    back, jcfg = J.load_detector2d(str(tmp_path / "port.npz"))
    assert jcfg == cfg
    for k, v in jp.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), k)
        assert back[k].shape == v.shape


def test_cosine_schedule_is_optax_s():
    ref = optax.cosine_decay_schedule(2e-3, 50, alpha=0.1)
    f = T.cosine_lr(2e-3, 50)
    np.testing.assert_allclose([2e-3 * f(t) for t in range(60)], [float(ref(t)) for t in range(60)], rtol=1e-6)


def test_three_training_steps_match_optax():
    """`train_detector` from the reference's init and schedule seed: the
    same rendered views (numpy's pose schedule), three Adam updates under
    the cosine schedule, losses and params within 1e-4."""
    cfg = J.DetectorConfig(widths=WIDTHS, input_hw=(96, 128))
    scale = 0.2  # the TUM intrinsics at 128 x 96
    jintr = JIntrinsics(*(jnp.float32(v * scale) for v in (520.9, 521.0, 325.1, 249.7)))
    key = jax.random.PRNGKey(5)
    ref, ref_losses = J.train_detector(key, cfg, steps=3, scenes=2, lr=2e-3, intr=jintr)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got, losses = T.train_detector(seed, T.DetectorConfig(widths=WIDTHS, input_hw=(96, 128)), steps=3, scenes=2,
                                   lr=2e-3, intr=Intrinsics(*(float(v) for v in jintr)), device="cpu",
                                   params=port(J.init_detector(key, cfg)))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for k, v in port(ref).items():
        assert rel_err(got[k].numpy(), v.numpy()) < 1e-4, k


# -- detect-online through the system and the command lines --------------------------------


class patched:
    """Replace names of a module (the system facade by default)."""

    def __init__(self, patches, module=system_mod):
        self.module, self.patches = module, patches
        self.saved = {k: getattr(module, k) for k in patches}

    def __enter__(self):
        for k, v in self.patches.items():
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


class Recorded:
    """A function that keeps every result it returns."""

    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.out.append({key: np.asarray(v) for key, v in out.items()})
        return out


SYS = dict(kmax=16, nmax=2048, emax=16384, ba_window=6, omax=8, enable_loop_closing=False)
HALF = (240, 320)


def test_detector_field_builds_a_detecting_system():
    """`detector=(params, cfg)` is taken (once refused as slice 8): the
    params move to the system's device, and a frame tracked without
    detections keeps its gray image for the keyframe's detector."""
    params = T.init_detector(torch.Generator().manual_seed(0), T.DetectorConfig(widths=WIDTHS, input_hw=HALF),
                             device="cpu")
    sysm = SlamSystem(TrackingConfig(orb=OrbConfig(num_features=300)), detector=(params, TCFG), device="cpu",
                      enable_objects=False, **SYS)
    assert not hasattr(system_mod, "_LATER") and sysm.detector[0]["c1_w"].device.type == "cpu"
    gray = np.zeros((480, 640), np.uint8)
    sysm.track_rgbd(gray, np.ones((480, 640), np.float32), None)
    assert sysm._pending_gray is not None and tuple(sysm._pending_gray.shape) == (480, 640)
    sysm.track_rgbd(gray, np.ones((480, 640), np.float32), {"bbox": np.zeros((1, 4))})
    assert sysm._pending_gray is None


def test_run_tum_detector_detects_at_keyframes(tmp_path, capsys):
    """`run_tum --detector PARAMS_NPZ` on a fabricated sequence: the
    weights (written by the JAX package) load, and the detector runs once
    per keyframe on the 480x640 frames."""
    from qsp_slam_tpu_torch import run_tum
    from qsp_slam_tpu_torch.data import make_tum

    make_tum.main([str(tmp_path / "seq"), "--frames", "4", "--cpu"])
    conf = tmp_path / "c.yaml"
    conf.write_text("ORBextractor.nFeatures: 300\n")
    jcfg = J.DetectorConfig(widths=WIDTHS, input_hw=HALF)
    J.save_detector2d(str(tmp_path / "d2d.npz"), firing(J.init_detector(jax.random.PRNGKey(0), jcfg)), jcfg)
    det = Recorded(T.detect_objects)
    with patched({"detect_objects": det}):
        out = run_tum.main([str(tmp_path / "seq"), "--config", str(conf), "--detector", str(tmp_path / "d2d.npz"),
                            "--cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["frames"] == out["frames"] and out["keyframes"] >= 1
    assert len(det.out) == out["keyframes"] and all(d["mask"].shape == (8, 480, 640) for d in det.out)


def test_run_synthetic_detector_on_the_cpu(capsys):
    """`run_synthetic --detector --cpu` trains the detector with the JAX
    command line's recipe (DetectorConfig(), 3000 steps, 8 scenes, lr
    2e-3, seed 7; replaced here by the firing init) and tracks without
    detections: the detector supplies them at keyframes.  The shape step
    is left out (tests/test_torch_shape_system.py runs it)."""
    from qsp_slam_tpu_torch import run_synthetic

    asked = []

    def train(seed, cfg, steps, scenes, lr, device):
        asked.append((seed, cfg, steps, scenes, lr, device.type))
        params = T.init_detector(torch.Generator().manual_seed(seed), cfg, device)
        params["hm_b"] = torch.full_like(params["hm_b"], 1.0)
        return params, []

    det = Recorded(T.detect_objects)
    with patched({"train_detector": train}, T), patched({"detect_objects": det,
                                                          "reconstruct_due_objects": lambda t, *a: t}):
        out = run_synthetic.main(["3", "--detector", "--cpu"])
    assert asked == [(7, T.DetectorConfig(), 3000, 8, 2e-3, "cpu")]
    assert out["backend"] == "cpu" and out["num_frames"] == 3 and "shapes_reconstructed" in out
    assert len(det.out) == out["keyframes"] >= 1
    assert capsys.readouterr().out.strip().startswith("{")


def test_train_detector2d_cli_writes_weights_the_reference_loads(tmp_path, capsys):
    """`python -m qsp_slam_tpu_torch.train_detector2d --out ... --half
    --cpu`: the JAX command line's JSON keys, `backend` cpu, and an npz
    the JAX package loads at 240x320."""
    from qsp_slam_tpu_torch import train_detector2d

    out = train_detector2d.main(["--out", str(tmp_path / "d2d.npz"), "--steps", "2", "--scenes", "1", "--half",
                                 "--cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert set(out) == {"out", "steps", "final_loss", "backend"} and out["backend"] == "cpu"
    params, cfg = J.load_detector2d(str(tmp_path / "d2d.npz"))
    assert cfg == J.DetectorConfig(input_hw=(240, 320)) and params["c1_w"].shape == (3, 3, 1, 16)
    assert np.isfinite(out["final_loss"])

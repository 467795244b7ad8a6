"""Parity of the port's stereo path with the JAX package on the CPU.

Same inputs (seeded numpy, or one rendered pair's port features handed to
both packages) go through the JAX function and the port's.  Tolerances:
the pair extractor bitwise equal to two `extract_features` calls; stereo
valid masks equal and `u_right` within 1e-4 px (the SADs of the f32 renders
are sums in different orders), bitwise on integer images; the median prune
exact; depths 1e-6 relative; the 10-frame stereo system run (the setup of
`tests/test_stereo_e2e.py` cut to 10 frames) within 1 cm of the JAX run's
camera centres, with the same keyframes; a JAX stereo checkpoint with a
closed loop and a gate history, resumed in the port, tracks within 1 cm
of the resumed JAX session.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsp_slam_tpu.frontend import stereo as jstereo
from qsp_slam_tpu.frontend.orb import Features as JFeatures
from qsp_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from qsp_slam_tpu.slam import tracking as jtracking
from qsp_slam_tpu.slam.system import SlamSystem as JSlamSystem
from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.eval.ate import ate_rmse, positions_from_Tcw
from qsp_slam_tpu_torch.frontend import stereo as tstereo
from qsp_slam_tpu_torch.frontend.orb import OrbConfig, extract_features, extract_features_pair
from qsp_slam_tpu_torch.ops.fast_nms import fast_score_nms_pyramid
from qsp_slam_tpu_torch.slam import tracking as ttracking
from qsp_slam_tpu_torch.slam.system import SlamSystem

torch.set_num_threads(1)

BASELINE = 0.12
CFG = ttracking.TrackingConfig(orb=OrbConfig(num_features=400))
BF = BASELINE * float(CFG.intr.fx)
# The stereo system runs' configuration (`tests/test_stereo_e2e.py`).
SYS_CFG = ttracking.TrackingConfig(orb=OrbConfig(num_features=500), baseline=BASELINE)
JSYS_CFG = jtracking.TrackingConfig(orb=JOrbConfig(num_features=500), baseline=BASELINE)


def jfeat(f):
    """Port features as the JAX Features (bits as uint32)."""
    return JFeatures(*(jnp.asarray(x.numpy().view(np.uint32) if name == "desc_bits" else x.numpy())
                       for name, x in zip(f._fields, f)))


@pytest.fixture(scope="module")
def pair():
    """The rendered pair of `tests/test_mono_stereo.py`: the right camera
    0.12 m along +x of the left one."""
    room = make_room(device="cpu")
    T_r = np.eye(4, dtype=np.float32)
    T_r[0, 3] = -BASELINE
    gl, dl = render_frame(room, np.eye(4, dtype=np.float32), CFG.intr)
    gr, _ = render_frame(room, T_r, CFG.intr)
    fl, fr = extract_features_pair(gl, gr, CFG.orb)
    return gl, gr, dl, fl, fr


def test_pair_extractor_is_two_extractions_in_one_launch(pair):
    gl, gr, _, fl, fr = pair
    before = fast_score_nms_pyramid.launches
    got = extract_features_pair(gl, gr, CFG.orb)
    # On the CPU the wrapper runs the plain version, which counts nothing;
    # the launch count is the card test's.  Here: bitwise equality.
    assert fast_score_nms_pyramid.launches == before
    for one, ref in zip(got, (extract_features(gl, CFG.orb), extract_features(gr, CFG.orb))):
        for name, a, b in zip(one._fields, one, ref):
            assert torch.equal(a, b), name


def test_pair_extractor_more_than_16_levels():
    """Past 16 levels per pair the pair extractor launches per image; the
    tables stay those of `extract_features`."""
    from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig

    orb = OrbConfig(num_features=300, pyramid=PyramidConfig(num_levels=9, height=240, width=320))
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.integers(0, 255, (240, 320)).astype(np.float32)) for _ in range(2)]
    for one, img in zip(extract_features_pair(*imgs, orb), imgs):
        ref = extract_features(img, orb)
        assert all(torch.equal(a, b) for a, b in zip(one, ref))


@pytest.mark.parametrize("refined", [False, True])
def test_match_stereo(pair, refined):
    gl, gr, dl, fl, fr = pair
    kw = dict(gray_left=gl, gray_right=gr) if refined else {}
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    got = tstereo.match_stereo(fl, fr, BF, **kw).numpy()
    ref = np.asarray(jstereo.match_stereo(jfeat(fl), jfeat(fr), BF, **jkw))
    np.testing.assert_array_equal(got >= 0, ref >= 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (got >= 0).sum() > 150
    # The JAX test's depth bound holds on the port's depths.
    depth = tstereo.depth_from_u_right(fl.xy[:, 0], torch.from_numpy(got), BF).numpy()
    ok = depth > 0
    xi = np.clip(np.round(fl.xy[:, 0].numpy()).astype(int), 0, 639)
    yi = np.clip(np.round(fl.xy[:, 1].numpy()).astype(int), 0, 479)
    d_gt = dl.numpy()[yi, xi]
    assert np.median(np.abs(depth[ok] - d_gt[ok]) / d_gt[ok]) < 0.05


def test_match_stereo_integer_images_bitwise(pair):
    """uint8-valued images: the SADs are exact, so `u_right` is equal."""
    gl, gr = (torch.round(g).clamp(0, 255) for g in pair[:2])
    fl, fr = extract_features_pair(gl, gr, CFG.orb)
    got = tstereo.match_stereo(fl, fr, BF, gray_left=gl, gray_right=gr).numpy()
    ref = np.asarray(jstereo.match_stereo(jfeat(fl), jfeat(fr), BF, gray_left=jnp.asarray(gl.numpy()),
                                          gray_right=jnp.asarray(gr.numpy())))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("vals", [[3.0, 1.0, np.nan, 7.5, 2.3, 10.1, np.nan, 0.7],  # even: 2.3 | 3.0
                                  [4.0, np.nan, 1.5, 9.0, 2.0],  # odd
                                  [np.nan, np.nan]])
def test_median_prune_matches_nanmedian(vals):
    """`jnp.nanmedian` averages the two middle values of an even count,
    where `torch.nanmedian` takes the lower one."""
    x = np.asarray(vals, np.float32)
    got = float(tstereo.nanmedian_mean(torch.from_numpy(x)))
    ref = float(jnp.nanmedian(jnp.asarray(x)))
    assert (np.isnan(got) and np.isnan(ref)) or got == ref
    if len(vals) == 8:
        assert got == np.float32(2.65) and float(torch.nanmedian(torch.from_numpy(x))) == np.float32(2.3)


def test_depth_from_u_right(rng):
    u = rng.uniform(0, 640, 64).astype(np.float32)
    ur = (u - rng.uniform(-1, 40, 64)).astype(np.float32)
    ur[::7] = -1.0
    got = tstereo.depth_from_u_right(torch.from_numpy(u), torch.from_numpy(ur), BF).numpy()
    ref = np.asarray(jstereo.depth_from_u_right(jnp.asarray(u), jnp.asarray(ur), BF))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert (got[::7] == 0).all()


def test_process_frame_stereo(pair):
    """On integer images (as a camera gives them) at the system run's
    configuration, so the JAX program compiles once for both."""
    gl, gr = (torch.round(g).clamp(0, 255) for g in pair[:2])
    got = ttracking.process_frame_stereo(gl, gr, SYS_CFG)
    ref = jtracking.process_frame_stereo(jnp.asarray(gl.numpy()), jnp.asarray(gr.numpy()), JSYS_CFG)
    np.testing.assert_array_equal(got.feats.xy.numpy(), np.asarray(ref.feats.xy))
    np.testing.assert_array_equal(got.feats.desc_bits.numpy().view(np.uint32), np.asarray(ref.feats.desc_bits))
    np.testing.assert_array_equal(got.u_right.numpy(), np.asarray(ref.u_right))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=1e-6, atol=0)
    assert int((got.depth > 0).sum()) > 150
    # uint8 input is cast on the way in.
    got8 = ttracking.process_frame_stereo(gl.to(torch.uint8), gr.to(torch.uint8), SYS_CFG)
    assert torch.equal(got8.u_right, got.u_right)


NUM_FRAMES = 10
CAPACITY = dict(kmax=16, nmax=2048, emax=16384, ba_window=6)


@pytest.fixture(scope="module")
def stereo_runs():
    cfg = SYS_CFG
    room = make_room(device="cpu")
    traj = orbit_trajectory(NUM_FRAMES)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -BASELINE
    frames = [(render_frame(room, traj[i], cfg.intr)[0].numpy(),
               render_frame(room, shift @ traj[i], cfg.intr)[0].numpy()) for i in range(NUM_FRAMES)]
    port = SlamSystem(cfg, device="cpu", **CAPACITY)
    ref = JSlamSystem(JSYS_CFG, enable_objects=False, **CAPACITY)
    for gl, gr in frames:
        port.track_stereo(gl, gr)
        ref.track_stereo(gl, gr)
    return port, ref, traj


def test_stereo_system_follows_jax(stereo_runs):
    port, ref, traj = stereo_runs
    p_port = positions_from_Tcw(np.stack(port.trajectory).astype(np.float64))
    p_ref = positions_from_Tcw(np.stack(ref.trajectory).astype(np.float64))
    assert np.linalg.norm(p_port - p_ref, axis=1).max() < 0.01
    assert port.stats["kf_frames"] == ref.stats["kf_frames"]
    assert port._sensor == "stereo"


def test_stereo_system_bounds(stereo_runs):
    """`tests/test_stereo_e2e.py`'s bounds at 10 frames."""
    port, _, traj = stereo_runs
    assert ate_rmse(np.stack(port.trajectory), traj) < 0.06
    assert port.summary()["keyframes"] >= 2


def test_jax_stereo_checkpoint_resumes_in_the_port(stereo_runs, tmp_path):
    """The JAX stereo session, given a closed loop and a gate history,
    resumes in the port: sensor, loop count, gate history and capacities
    carried, and the next frames track within 1 cm of the resumed JAX
    session; the port's own checkpoint round-trips them."""
    from qsp_slam_tpu.slam.checkpoint import load_checkpoint as jload
    from qsp_slam_tpu.slam.checkpoint import save_checkpoint as jsave
    from qsp_slam_tpu.slam.loop_closing import ConsistencyGate as JGate
    from qsp_slam_tpu_torch.slam.checkpoint import load_checkpoint, save_checkpoint

    port, ref, _ = stereo_runs
    ref.loops_closed = 1
    ref._loop_gate = JGate()
    ref._loop_gate.history = [[1, 2], [2], [0, 3]]
    ckpt = str(tmp_path / "jax.npz")
    jsave(ckpt, ref)
    resumed = JSlamSystem(ref.cfg, enable_objects=False, **CAPACITY)
    jload(ckpt, resumed)
    got = SlamSystem(port.cfg, kmax=2, nmax=512, emax=1024, ba_window=6, device="cpu")
    load_checkpoint(ckpt, got)
    assert (got.kmax, got.nmax, got.emax) == (16, 2048, 16384)
    assert got._sensor == "stereo" and got.loops_closed == 1 and got.summary()["loops_closed"] == 1
    assert got._loop_gate.history == [[1, 2], [2], [0, 3]]
    room = make_room(device="cpu")
    traj = orbit_trajectory(NUM_FRAMES + 2)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -BASELINE
    for i in (NUM_FRAMES, NUM_FRAMES + 1):
        gl, gr = (render_frame(room, T, port.cfg.intr)[0].numpy() for T in (traj[i], shift @ traj[i]))
        c = positions_from_Tcw(np.stack([resumed.track_stereo(gl, gr), got.track_stereo(gl, gr)]).astype(np.float64))
        assert np.linalg.norm(c[0] - c[1]) < 0.01
    save_checkpoint(str(tmp_path / "port.npz"), got)
    again = SlamSystem(port.cfg, device="cpu")
    load_checkpoint(str(tmp_path / "port.npz"), again)
    assert again._sensor == "stereo" and again.loops_closed == 1
    assert again._loop_gate.history == got._loop_gate.history
    np.testing.assert_array_equal(again.Tcw, got.Tcw)

"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions.  Every test here needs an NVIDIA GPU and skips without
one; this file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 bitwise equal to its plain version (single image and whole
pyramid), one launch per call; K2 exact, including rows at distance 0 and
256, also at the recovery shapes; a short tracking run on the card keeps
every camera centre within 1 cm of the same run on the CPU (a monocular
run: the same bootstrap and keyframes, centres within 0.005 gauge units,
the same objects); relocalization
on the card picks the CPU run's winner on the same hypothesis draws (inlier
rows agree but for a few at the chi2 threshold), pose within 1e-3 m; the
Sim(3) loop closer's poses and objects within 1e-3 of the CPU's; short
RGB-D and stereo object runs: the same keyframes, object slots, labels
(and Manhattan plane slots), object centres within 1 cm; the joint BA's
dense pose solve within 1e-4 of the CPU's, relative; the DeepSDF decoder
at the reference's width within 1e-5 of the CPU, two joint pose + code LM
trips at that width within 1e-3 (deeper runs part along the code's weak
directions on any two machines), the card's reverse-mode shape Jacobian
within 1e-5 (relative) of the CPU's forward-mode one at the benchmark's
width, a shape step's peak memory under the chunking's estimate, the
package's marching-cubes build on a sphere, and the map-sharded BA as two
gloo ranks on the card against one NCCL rank (costs 1e-4 relative, poses
1e-4, points 1e-3, both ranks bitwise equal).
"""

import numpy as np
import pytest
import torch

from qsp_slam_tpu_torch.data.render import make_room, orbit_trajectory, render_frame
from qsp_slam_tpu_torch.frontend.matcher import pack_pm
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig, build_pyramid
from qsp_slam_tpu_torch.ops.fast_nms import (
    fast_score_nms,
    fast_score_nms_plain,
    fast_score_nms_pyramid,
    fast_score_nms_pyramid_plain,
)
from qsp_slam_tpu_torch.ops.hamming import hamming_packed, hamming_packed_plain
from qsp_slam_tpu_torch.core.camera import backproject
from qsp_slam_tpu_torch.frontend.pnp import pnp_sample
from qsp_slam_tpu_torch.slam.loop_closing import empty_loop_state, snapshot_keyframe
from qsp_slam_tpu_torch.slam.relocalization import relocalize
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig, process_frame

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


ODD_SHAPES = ((8, 8), (7, 300), (37, 53), (250, 33))


def _rendered_pyramid():
    cfg = TrackingConfig()
    g, _ = render_frame(make_room(device="cuda"), orbit_trajectory(4)[3], cfg.intr)
    return build_pyramid(torch.round(g).clamp(0, 255), PyramidConfig())


def test_fast_nms_kernel_matches_plain(gen):
    images = _rendered_pyramid()
    images += [torch.randint(0, 256, s, generator=gen, device="cuda").float() for s in ODD_SHAPES]
    before = fast_score_nms_pyramid.launches
    for img in images:
        for t in (20.0, 7.0):
            got, ref = fast_score_nms(img, t), fast_score_nms_plain(img, t)
            torch.cuda.synchronize()
            assert torch.equal(got > 0, ref > 0), (tuple(img.shape), t)
            assert torch.equal(got, ref), (tuple(img.shape), t)
    assert fast_score_nms_pyramid.launches == before + 2 * len(images)


@pytest.mark.parametrize("which", ["pyramid", "odd_shapes"])
def test_fast_nms_pyramid_kernel_matches_plain(gen, which):
    """All levels x both thresholds in one launch; the odd shapes mixed into
    one call with a pyramid level."""
    if which == "pyramid":
        images = _rendered_pyramid()
    else:
        images = [torch.randint(0, 256, s, generator=gen, device="cuda").float() for s in ODD_SHAPES]
        images.insert(2, _rendered_pyramid()[6])
    ths = (20.0, 7.0)
    before = fast_score_nms_pyramid.launches
    got = fast_score_nms_pyramid(images, ths)
    torch.cuda.synchronize()
    assert fast_score_nms_pyramid.launches == before + 1
    for img, maps, refs in zip(images, got, fast_score_nms_pyramid_plain(images, ths)):
        for t, m, r in zip(ths, maps, refs):
            assert m.shape == img.shape
            assert torch.equal(m > 0, r > 0), (tuple(img.shape), t)
            assert torch.equal(m, r), (tuple(img.shape), t)


HAMMING_SHAPES = ((8192, 4000), (2048, 2048), (70, 130), (1, 1), (513, 127), (129, 4001), (4000, 3),
                  (4000, 384), (1536, 4000), (1000, 1000), (384, 1000), (8192, 1000))


def test_hamming_kernel_matches_plain(gen):
    for A, B in HAMMING_SHAPES:
        a = torch.randint(-2**31, 2**31, (A, 8), generator=gen, device="cuda", dtype=torch.int64)
        b = torch.randint(-2**31, 2**31, (B, 8), generator=gen, device="cuda", dtype=torch.int64)
        a, b = a.to(torch.int32), b.to(torch.int32)
        got = hamming_packed(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, hamming_packed_plain(a, b)), (A, B)


def test_hamming_kernel_at_distance_0_and_256(gen):
    """Rows equal to a B row and rows that are its complement: the dot
    product reaches +256 and -256, the ends of the int8 -> int32 range."""
    for A, B in HAMMING_SHAPES:
        a = torch.randint(-2**31, 2**31, (A, 8), generator=gen, device="cuda", dtype=torch.int64)
        b = torch.randint(-2**31, 2**31, (B, 8), generator=gen, device="cuda", dtype=torch.int64)
        a, b = a.to(torch.int32), b.to(torch.int32)
        rows = torch.arange(A, device="cuda")
        src = b[rows % B]
        a = torch.where((rows % 2 == 0)[:, None], src, ~src)
        got = hamming_packed(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, hamming_packed_plain(a, b)), (A, B)
        d = got[rows, rows % B]
        assert torch.equal(d, torch.where(rows % 2 == 0, 0, 256).to(torch.int32)), (A, B)


def test_hamming_kernel_equals_pm_product(gen):
    pa = torch.where(torch.rand(300, 256, generator=gen, device="cuda") < 0.5, 1, -1).to(torch.int8)
    pb = torch.where(torch.rand(200, 256, generator=gen, device="cuda") < 0.5, 1, -1).to(torch.int8)
    ref = ((256 - pa.float() @ pb.float().T) // 2).to(torch.int32)
    assert torch.equal(hamming_packed(pack_pm(pa), pack_pm(pb)), ref)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    img = torch.rand(64, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        fast_score_nms(img.t(), 20.0)
    for levels in ([img, img.cpu()], [img, img.t()], [img] * 17):
        with pytest.raises(ValueError):
            fast_score_nms_pyramid(levels, (20.0, 7.0))
    a = torch.zeros(16, 8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        hamming_packed(a, a.cpu())


def test_short_run_matches_cpu(gen):
    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    room = make_room(device="cpu")
    Tcw_gt = orbit_trajectory(8)
    frames = [tuple(x.numpy() for x in render_frame(room, Tcw_gt[i], cfg.intr)) for i in range(8)]
    runs = {}
    for dev in ("cuda", "cpu"):
        s = SlamSystem(cfg, kmax=16, nmax=2048, emax=16384, ba_window=6, device=dev)
        for f in frames:
            s.track_rgbd(*f)
        runs[dev] = s
    p = {d: -np.einsum("kji,kj->ki", np.stack(s.trajectory)[:, :3, :3].astype(np.float64),
                       np.stack(s.trajectory)[:, :3, 3].astype(np.float64)) for d, s in runs.items()}
    assert np.linalg.norm(p["cuda"] - p["cpu"], axis=1).max() < 0.01
    assert runs["cuda"].stats["kf_frames"] == runs["cpu"].stats["kf_frames"]


def test_short_mono_run_matches_cpu(gen):
    """Ten frames of an object scene through `track_mono` with the
    renderer's detections, on the card and on the CPU (the RANSAC draws come
    from CPU generators on both): the same bootstrap, keyframes and object
    slots, centres within 0.005 gauge units (the unit is the bootstrap's
    median depth, ~2 m), and K2 at (500, 500) for the bootstrap."""
    from qsp_slam_tpu_torch.data.render import gt_detections, make_scene, render_scene

    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    scene = make_scene(num_objects=3, seed=2, device="cpu")
    Tcw_gt = orbit_trajectory(10, step=0.025, pitch=0.4)
    frames = [(render_scene(scene, Tcw_gt[i], cfg.intr)[0].numpy(),
               {k: v.numpy() for k, v in gt_detections(scene, Tcw_gt[i], cfg.intr).items()}) for i in range(10)]
    runs = {}
    hamming_packed.shapes.clear()
    for dev in ("cuda", "cpu"):
        s = SlamSystem(cfg, kmax=16, nmax=2048, emax=16384, ba_window=6, enable_objects=True, device=dev)
        for g, d in frames:
            s.track_mono(g, d)
        runs[dev] = s
    assert hamming_packed.shapes[(500, 500)] >= 1
    p = {d: -np.einsum("kji,kj->ki", np.stack(s.trajectory)[:, :3, :3].astype(np.float64),
                       np.stack(s.trajectory)[:, :3, 3].astype(np.float64)) for d, s in runs.items()}
    assert runs["cuda"].initialized and runs["cuda"].stats["kf_frames"] == runs["cpu"].stats["kf_frames"]
    assert np.linalg.norm(p["cuda"] - p["cpu"], axis=1).max() < 0.005
    assert torch.equal(runs["cuda"].objects.valid.cpu(), runs["cpu"].objects.valid)
    assert torch.equal(runs["cuda"].objects.label.cpu(), runs["cpu"].objects.label)


def test_relocalize_matches_cpu(gen):
    """Three keyframe snapshots and a query frame between them; the card and
    the CPU run on the same hypothesis indices (drawn on the CPU: the two
    devices' generators give different streams for one seed)."""
    cfg = TrackingConfig(orb=OrbConfig(num_features=2000))
    traj = orbit_trajectory(14)
    res = {}
    for dev in ("cpu", "cuda"):
        room = make_room(device=dev)
        ls = empty_loop_state(8, device=dev)
        for i in (0, 6, 12):
            f = process_frame(*render_frame(room, traj[i], cfg.intr), cfg)
            ls = snapshot_keyframe(ls, f.feats.desc_pm, f.feats.valid,
                                   backproject(f.feats.xy, f.depth, cfg.intr), f.depth > 0, f.feats.xy)
        kf = torch.eye(4, device=dev).repeat(8, 1, 1)
        kf[:3] = torch.from_numpy(traj[[0, 6, 12]]).to(dev)
        query = process_frame(*render_frame(room, traj[7], cfg.intr), cfg)
        cpu_gen = torch.Generator().manual_seed(907)

        def draw(valid, _gen, num_hyp, cpu_gen=cpu_gen):
            return [x.to(valid.device) for x in pnp_sample(valid.cpu(), cpu_gen, num_hyp)]

        res[dev] = relocalize(ls, kf, query, cfg, None, draw=draw)
    cpu, card = res["cpu"], res["cuda"]
    assert bool(cpu.ok) and bool(card.ok)
    # The same winner: its snapshot rows are the inliers of both runs (a
    # row at the chi2 threshold may fall either way).
    assert abs(int(card.num_inliers) - int(cpu.num_inliers)) <= 2
    assert (card.inliers.cpu() == cpu.inliers).float().mean() > 0.98
    c = [-(r.Tcw[:3, :3].T @ r.Tcw[:3, 3]).cpu().double() for r in (cpu, card)]
    assert float(torch.linalg.vector_norm(c[0] - c[1])) < 1e-3


def test_stereo_pair_extractor_one_launch(gen):
    """A stereo pair's two 8-level pyramids go through K1 in one launch, and
    the stereo frame on the card equals the CPU's (K1 and K2 are exact, the
    SADs of integer images too), but for depths within 1e-5 relative."""
    from qsp_slam_tpu_torch.frontend.orb import extract_features, extract_features_pair
    from qsp_slam_tpu_torch.slam.tracking import process_frame_stereo

    cfg = TrackingConfig(orb=OrbConfig(num_features=1000), baseline=0.12)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -0.12
    T = orbit_trajectory(4)[2]
    room = make_room(device="cuda")
    gl, gr = (torch.round(render_frame(room, P, cfg.intr)[0]).clamp(0, 255) for P in (T, shift @ T))
    before = fast_score_nms_pyramid.launches
    pair = extract_features_pair(gl, gr, cfg.orb)
    torch.cuda.synchronize()
    assert fast_score_nms_pyramid.launches == before + 1
    for one, img in zip(pair, (gl, gr)):
        assert all(torch.equal(a, b) for a, b in zip(one, extract_features(img, cfg.orb)))
    card = process_frame_stereo(gl, gr, cfg)
    cpu = process_frame_stereo(gl.cpu(), gr.cpu(), cfg)
    assert torch.equal(card.u_right.cpu(), cpu.u_right)
    torch.testing.assert_close(card.depth.cpu(), cpu.depth, rtol=1e-5, atol=0)
    assert int((cpu.depth > 0).sum()) > 200


def test_sim3_loop_closer_matches_cpu(gen):
    """tests/test_torch_mono.py's 12-keyframe circle with 2% scale drift per
    keyframe, closed by `correct_loop(fix_scale=False)` with objects on the
    card and on the CPU: keyframe poses (similarities) within 1e-3, object
    ellipsoids within 1e-3, the same validity (25 pose-graph trips, each an
    f32 Cholesky of a Jacobi-scaled 84x84 system, reduced in another order
    on the card)."""
    from qsp_slam_tpu_torch.core import lie
    from qsp_slam_tpu_torch.slam import map as tmap
    from qsp_slam_tpu_torch.slam.loop_closing import LoopDetection, correct_loop
    from qsp_slam_tpu_torch.slam.objects import empty_objects

    K = 12
    gt = [lie.exp_se3(torch.tensor([np.sin(2 * np.pi * k / K), 0, 1 - np.cos(2 * np.pi * k / K), 0, 0, 0],
                                   dtype=torch.float32)) for k in range(K)]
    res = {}
    for dev in ("cpu", "cuda"):
        m = tmap.empty_map(kmax=16, nmax=64, emax=256, device=dev)
        for k in range(K):
            E = gt[k].clone()
            E[:3, 3] *= 1.02 ** k
            m, _ = tmap.add_keyframe(m, E.to(dev))
        o = empty_objects(4, device=dev)
        ell = o.ellipsoid.clone()
        ell[:3] = torch.tensor([[0.5, 0.2, 1.0, 0.1, 0.2, 0.3, 0.2, 0.3, 0.4],
                                [-0.5, 0.1, 1.5, 0.0, 0.1, 0.0, 0.3, 0.2, 0.2],
                                [0.2, 0.2, 0.2, 0.0, 0.0, 0.5, 0.1, 0.1, 0.1]], device=dev)
        obs = o.obs_Tcw.clone()
        obs[0, 0], obs[1, 0], obs[2, 0] = m.kf_Tcw[3], m.kf_Tcw[11], gt[5].to(dev)
        valid = torch.zeros(4, dtype=torch.bool, device=dev)
        valid[:3] = True
        o = o._replace(ellipsoid=ell, valid=valid, obs_Tcw=obs,
                       label=torch.tensor([0, 1, 1, -1], dtype=torch.int32, device=dev),
                       obs_count=torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev),
                       obs_next=torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev))
        det = LoopDetection(found=torch.tensor(True, device=dev), match_kf=torch.tensor(0, dtype=torch.int32,
                                                                                        device=dev),
                            T_cur_match=(gt[K - 1] @ torch.linalg.inv(gt[0])).to(dev),
                            num_inliers=torch.tensor(50, device=dev), score=torch.tensor(0.9, device=dev))
        res[dev] = correct_loop(m, o, K - 1, det, fix_scale=False, iters=25)
    (cm, co), (gm, go) = res["cpu"], res["cuda"]
    torch.testing.assert_close(gm.kf_Tcw.cpu(), cm.kf_Tcw, atol=1e-3, rtol=0)
    torch.testing.assert_close(go.ellipsoid.cpu(), co.ellipsoid, atol=1e-3, rtol=0)
    assert torch.equal(go.valid.cpu(), co.valid)
    err_after = float(torch.linalg.vector_norm(gm.kf_Tcw[K - 1, :3, 3].cpu() - gt[K - 1][:3, 3]))
    assert err_after < 0.5 * float(torch.linalg.vector_norm(gt[K - 1][:3, 3] * (1.02 ** (K - 1) - 1)))


def test_short_rgbd_objects_run_matches_cpu(gen):
    """Eight RGB-D frames of the table scene with the renderer's detections
    on the card and on the CPU: the same keyframes, object slots and labels
    and Manhattan plane slots, object centres within 1 cm."""
    from qsp_slam_tpu_torch.core import lie
    from qsp_slam_tpu_torch.data.render import gt_detections, make_scene, render_scene

    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    scene = make_scene(num_objects=3, seed=2, num_tables=1, device="cpu")
    base = lie.exp_se3(torch.tensor([0, 0, 0, 0.35, 0, 0.0]))
    frames = []
    for i in range(8):
        Tcw = lie.exp_se3(torch.tensor([0.04 * i, 0, 0, 0, 0, 0.0])) @ base
        g, d, _ = render_scene(scene, Tcw, cfg.intr)
        frames.append((g.numpy(), d.numpy(), {k: v.numpy() for k, v in gt_detections(scene, Tcw, cfg.intr).items()}))
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = SlamSystem(cfg, kmax=16, nmax=2048, emax=16384, ba_window=6, omax=8, device=dev)
        for g, d, det in frames:
            runs[dev].track_rgbd(g, d, det)
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.stats["kf_frames"] == cpu.stats["kf_frames"]
    assert torch.equal(card.objects.valid.cpu(), cpu.objects.valid) and int(cpu.objects.valid.sum()) >= 1
    assert torch.equal(card.objects.label.cpu(), cpu.objects.label)
    assert torch.equal(card.plane_set.valid.cpu(), cpu.plane_set.valid)
    live = cpu.objects.valid
    assert float((card.objects.ellipsoid.cpu()[live, :3] - cpu.objects.ellipsoid[live, :3]).norm(dim=-1).max()) < 0.01


def test_short_stereo_joint_run_matches_cpu(gen):
    """Ten stereo frames of the object scene with detections (local joint BA
    at keyframes), then the global joint BA, on the card and on the CPU:
    the same keyframes and object slots, keyframe centres and object
    centres within 1 cm."""
    from qsp_slam_tpu_torch.core import lie
    from qsp_slam_tpu_torch.data.render import gt_detections, make_scene, render_scene

    cfg = TrackingConfig(orb=OrbConfig(num_features=500), baseline=0.12)
    scene = make_scene(num_objects=3, seed=2, device="cpu")
    base = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0.0]))
    shift = torch.eye(4)
    shift[0, 3] = -0.12
    frames = []
    for i in range(10):
        Tcw = lie.exp_se3(torch.tensor([0.045 * i, 0, 0, 0, 0, 0.0])) @ base
        frames.append((render_scene(scene, Tcw, cfg.intr)[0].numpy(),
                       render_scene(scene, shift @ Tcw, cfg.intr)[0].numpy(),
                       {k: v.numpy() for k, v in gt_detections(scene, Tcw, cfg.intr).items()}))
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = SlamSystem(cfg, kmax=16, nmax=2048, emax=16384, ba_window=6, omax=8, enable_loop_closing=False,
                               device=dev)
        for gl, gr, det in frames:
            runs[dev].track_stereo(gl, gr, det)
        runs[dev].run_global_ba()
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.stats["kf_frames"] == cpu.stats["kf_frames"]
    assert torch.equal(card.objects.valid.cpu(), cpu.objects.valid) and int((cpu.objects.pm_kf >= 0).sum()) >= 2
    n = int(cpu.map_state.num_kfs)
    c = {d: -(r.map_state.kf_Tcw[:n, :3, :3].transpose(1, 2) @ r.map_state.kf_Tcw[:n, :3, 3:]).cpu()[..., 0]
         for d, r in runs.items()}
    assert float((c["cuda"] - c["cpu"]).norm(dim=-1).max()) < 0.01
    live = cpu.objects.valid
    assert float((card.objects.ellipsoid.cpu()[live, :3] - cpu.objects.ellipsoid[live, :3]).norm(dim=-1).max()) < 0.01


def test_solve_dense_pose_system_matches_cpu(gen):
    """The joint BA's dense solve at the global size of the KITTI path
    (128 keyframes + 32 objects: 960 unknowns), two vertices fixed: the
    card's Cholesky against the CPU's, 1e-4 relative to the solution's
    scale; an indefinite system gives NaN on both."""
    from qsp_slam_tpu_torch.opt.schur import solve_dense_pose_system

    V = 160
    g = torch.Generator().manual_seed(3)
    A = torch.randn(6 * V, 6 * V, generator=g)
    S = A @ A.T / (6 * V) + torch.diag(torch.rand(6 * V, generator=g) * 10 + 0.1)
    rhs = torch.randn(V, 6, generator=g)
    fixed = torch.zeros(V, dtype=torch.bool)
    fixed[[0, 1]] = True
    cpu = solve_dense_pose_system(S.reshape(V, 6, V, 6), rhs, fixed)
    card = solve_dense_pose_system(S.cuda().reshape(V, 6, V, 6), rhs.cuda(), fixed.cuda()).cpu()
    assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())
    assert float(card[fixed].abs().max()) == 0.0
    bad = solve_dense_pose_system(-S.cuda().reshape(V, 6, V, 6), rhs.cuda(), fixed.cuda())
    assert bool(torch.isnan(bad).all())


def _full_width_decoder():
    from qsp_slam_tpu_torch.models.deepsdf import DeepSDFConfig, init_decoder

    cfg = DeepSDFConfig()
    return cfg, init_decoder(torch.Generator().manual_seed(7), cfg, device="cpu")


def test_full_width_decode_matches_cpu(gen):
    from qsp_slam_tpu_torch.models.deepsdf import decode_sdf

    cfg, params = _full_width_decoder()
    g = torch.Generator().manual_seed(1)
    code, xyz = 0.3 * torch.randn(4, 64, generator=g), 2.0 * torch.rand(4, 8448, 3, generator=g) - 1.0
    card = {k: {n: t.cuda() for n, t in p.items()} for k, p in params.items()}
    got = decode_sdf(card, cfg, code.cuda(), xyz.cuda()).cpu()
    assert float((got - decode_sdf(params, cfg, code, xyz)).abs().max()) < 1e-5


def test_full_width_reconstruct_object_matches_cpu(gen):
    """Two LM trips of four flip hypotheses at full width, card vs CPU: the
    toy decoder trained on the card, tests/test_shape.py:65's problem
    (a family shape's surface 1.8 m ahead at scale 0.35, rays and depths
    from the same points, the frame perturbed)."""
    from qsp_slam_tpu_torch.core import lie
    from qsp_slam_tpu_torch.models.deepsdf import DeepSDFConfig, train_toy_decoder
    from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig, flip_hypotheses, reconstruct_object

    cfg = DeepSDFConfig()
    card_params, _, halves = train_toy_decoder(0, cfg, device="cuda")
    params = {k: {n: t.cpu() for n, t in p.items()} for k, p in card_params.items()}
    g = torch.Generator().manual_seed(2)
    d = torch.randn(256, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    T_co = lie.exp_se3(torch.tensor([0.1, -0.05, 1.8, 0.0, 0.5, 0.0]))
    pts = (d * halves[1].cpu()) @ (0.35 * T_co[:3, :3]).T + T_co[:3, 3]
    T_co[:3, :3] *= 0.35
    T0 = lie.exp_sim3(torch.tensor([0.06, -0.04, 0.08, 0.05, -0.08, 0.04, 0.1])) @ lie.inv_sim3(T_co)
    ok = torch.ones(4, 256, dtype=torch.bool)
    args = [flip_hypotheses(T0, 4), torch.zeros(4, 64), pts.expand(4, -1, -1), ok, (pts / pts[:, 2:]).expand(4, -1, -1),
            pts[:, 2].expand(4, -1), ok]
    cpu = reconstruct_object(params, cfg, *args, ShapeOptConfig(iters=2))
    card = reconstruct_object(card_params, cfg, *(a.cuda() for a in args), ShapeOptConfig(iters=2))
    assert float((card.T_oc.cpu() - cpu.T_oc).abs().max()) < 1e-3
    assert float((card.code.cpu() - cpu.code).abs().max()) < 1e-3
    assert torch.equal(card.is_good.cpu(), cpu.is_good)


def _benchmark_width_problem(B: int, P: int, R: int):
    """The benchmark's decoder (64/512 x 9, latent_in 4; He-normal weights
    from a CPU generator) and B flip hypotheses of an object 2 m ahead at
    scale 0.4 with P surface points and R rays, a fifth of the points and
    a seventh of the rays masked.  -> (cfg, params, LM arguments), on the
    CPU."""
    from qsp_slam_tpu_torch.models.deepsdf import DeepSDFConfig, init_decoder
    from qsp_slam_tpu_torch.models.shape_opt import flip_hypotheses

    cfg = DeepSDFConfig(64, 512, 9, (4,))
    g = torch.Generator().manual_seed(7)
    params = init_decoder(g, cfg, device="cpu")
    pts = torch.randn(P, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, 2.0])
    rays = torch.cat([torch.randn(R, 2, generator=g) * 0.1, torch.ones(R, 1)], dim=-1)
    depth = 1.8 + 0.4 * torch.rand(R, generator=g)
    T0 = torch.diag(torch.tensor([2.5, 2.5, 2.5, 1.0]))
    T0[2, 3] = -5.0
    code = 0.1 * torch.randn(B, 64, generator=g)
    pv = (torch.arange(P) + torch.arange(B)[:, None]) % 5 != 0
    rv = (torch.arange(R) + torch.arange(B)[:, None]) % 7 != 3
    return cfg, params, [flip_hypotheses(T0, B), code, pts.expand(B, -1, -1), pv, rays.expand(B, -1, -1),
                         depth.expand(B, -1), rv]


def test_card_reverse_jacobian_matches_cpu_forward_jacobian(gen):
    """One Jacobian at the benchmark's width, no trips: the card's
    `reverse_jacobian` (its LM's path) against the CPU's `forward_jacobian`
    (`vmap(jvp)`, held to the JAX package's `jacfwd`) on 2 hypotheses of
    64 points and 32 rays: r within 1e-5, J within 1e-5 of its largest
    entry."""
    from qsp_slam_tpu_torch.models.deepsdf import weights
    from qsp_slam_tpu_torch.models.shape_opt import forward_jacobian, reverse_jacobian

    cfg, params, (T, code, pts, pv, rays, depth, rv) = _benchmark_width_problem(2, 64, 32)
    card = {k: {n: t.cuda() for n, t in p.items()} for k, p in params.items()}
    args = (code, T, pts, pv, rays, depth, rv)
    r_cpu, J_cpu = forward_jacobian(params, cfg, weights(params, cfg), *args)
    with torch.no_grad():
        r, J = reverse_jacobian(card, cfg, weights(card, cfg), *(a.cuda() for a in args))
    assert J.shape == J_cpu.shape == (2, 96, 71)
    assert float((r.cpu() - r_cpu).abs().max()) < 1e-5
    assert float((J.cpu() - J_cpu).abs().max()) < 1e-5 * float(J_cpu.abs().max())


def test_card_shape_step_memory_within_the_reverse_estimate(gen):
    """The cell's shape step at the benchmark's width (12 hypotheses of 256
    points and 256 rays, 5 trips) runs as one chunk on the card, and its
    peak device memory above what was allocated before it stays under
    the chunking's estimate (`reverse_hypothesis_bytes`), as
    `chip_smoke.py` phase 16 holds it."""
    from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig, reconstruct_object
    from qsp_slam_tpu_torch.slam.shape_mapping import chunk_size, reverse_hypothesis_bytes

    cfg, params, args = _benchmark_width_problem(12, 256, 256)
    assert chunk_size(cfg, 256, 256, torch.device("cuda")) >= 12
    card = {k: {n: t.cuda() for n, t in p.items()} for k, p in params.items()}
    args = [a.cuda() for a in args]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = reconstruct_object(card, cfg, *args, ShapeOptConfig(iters=5))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert bool(torch.isfinite(res.cost).all())
    assert peak <= 12 * reverse_hypothesis_bytes(cfg, 256, 256), (peak, reverse_hypothesis_bytes(cfg, 256, 256))


def test_marching_cubes_build(gen):
    """The package's own build of native/marching_cubes.cpp on a sphere:
    every vertex within half a voxel of the radius."""
    from qsp_slam_tpu_torch.models.mesh import marching_cubes

    g = np.linspace(-1.0, 1.0, 40, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    mesh = marching_cubes(np.sqrt(x * x + y * y + z * z) - 0.6)
    r = np.linalg.norm(mesh.vertices * (2.0 / 39) - 1.0, axis=1)
    assert len(mesh.faces) > 1000 and np.abs(r - 0.6).max() < 1.0 / 39


def test_sharded_ba_two_gloo_ranks_on_the_card_match_one_nccl_rank(gen, tmp_path):
    """The map-sharded point and joint BA on the card as two ranks sharing
    it (gloo, the sums staged through the host) against one rank (NCCL):
    costs within 1e-4 relative, poses 1e-4, points 1e-3, both ranks the
    same bits, the backends by `mesh.choose_backend`'s rule."""
    from qsp_slam_tpu_torch.data.synthetic import make_ba_problem
    from qsp_slam_tpu_torch.parallel.mesh import choose_backend
    from qsp_slam_tpu_torch.parallel.multihost import spawn_ranks
    from qsp_slam_tpu_torch.parallel.replay import problem_arrays, save_problems

    prob = make_ba_problem(num_cams=12, num_points=2000, obs_per_point=5, stereo=True, seed=4)
    M = 4
    T_oc = np.tile(np.eye(4, dtype=np.float32), (2, M, 1, 1))
    kf = np.full((2, M), -1, np.int32)
    for j, k in enumerate([2, 6, 9]):
        T_oc[0, j] = np.linalg.inv(prob.Tcw_gt[k])
        kf[0, j] = k
    objects = {"Tow": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)), "obj_fixed": np.array([False, True]),
               "obj_cam_idx": np.clip(kf, 0, None).reshape(-1),
               "obj_obj_idx": np.repeat(np.arange(2, dtype=np.int32), M),
               "obj_T_oc": T_oc.reshape(-1, 4, 4), "obj_valid": (kf >= 0).reshape(-1)}
    objects["Tow"][0, :3, 3] = [0.1, -0.05, 0.08]
    save_problems(tmp_path / "p.npz", [{"name": "map", "kind": "map_ba", "prefix": "p", "iters": 6},
                                       {"name": "joint", "kind": "map_joint_ba", "prefix": "p", "iters": 6}],
                  {"p": {**problem_arrays(prob, 0.08 * prob.intr.fx), **objects}})
    outs = {}
    for world in (1, 2):
        lines = [r.json() for r in spawn_ranks(world, [str(tmp_path / "p.npz"), str(tmp_path / f"w{world}")],
                                               target="qsp_slam_tpu_torch.parallel.replay:main", timeout=300)]
        assert all(ln["backend"] == choose_backend(world, "cuda") and ln["device"].startswith("cuda")
                   for ln in lines)
        outs[world] = [dict(np.load(tmp_path / f"w{world}" / f"rank{r}.npz")) for r in range(world)]
    for k, v in outs[2][0].items():
        np.testing.assert_array_equal(outs[2][1][k], v, err_msg=k)
        if k.endswith("/cost"):
            np.testing.assert_allclose(v, outs[1][0][k], rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(v, outs[1][0][k], rtol=0, atol=1e-3 if k.endswith("/points") else 1e-4,
                                       err_msg=k)


def test_frame_info_on_the_card_matches_cpu(gen):
    """`keep_frame_info` on the card and on the CPU over 8 frames: every
    tracked frame's keypoints within 1e-3 px and the tracked flags equal on
    >= 99% of all keypoints."""
    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    room = make_room(device="cpu")
    Tcw_gt = orbit_trajectory(8)
    frames = [tuple(x.numpy() for x in render_frame(room, Tcw_gt[i], cfg.intr)) for i in range(8)]
    infos = {}
    for dev in ("cuda", "cpu"):
        s = SlamSystem(cfg, kmax=16, nmax=2048, emax=16384, ba_window=6, keep_frame_info=True, device=dev)
        infos[dev] = []
        for f in frames:
            s.track_rgbd(*f)
            infos[dev].append(s.last_frame_info)
    assert infos["cuda"][0] is None and infos["cpu"][0] is None
    agree = total = 0
    for a, b in zip(infos["cpu"][1:], infos["cuda"][1:]):
        np.testing.assert_allclose(b["kp_xy"], a["kp_xy"], atol=1e-3)
        agree += int((a["kp_tracked"] == b["kp_tracked"]).sum())
        total += len(a["kp_tracked"])
        assert b["kp_tracked"].sum() > 50
    assert agree >= 0.99 * total


def test_dense_builder_on_the_card_matches_cpu(gen):
    """Three room views through `DenseBuilder` on the card and on the CPU:
    >= 99.9% of the voxel keys shared (a one-ulp unprojection difference
    can move a point across a voxel face, and then a voxel's first point
    too) and >= 99.9% of the shared voxels' first points within 1e-4 m."""
    from qsp_slam_tpu_torch.perception.dense_builder import DenseBuilder

    cfg = TrackingConfig()
    room = make_room(device="cpu")
    Tcw_gt = orbit_trajectory(7, step=0.05)
    frames = [(*(x.numpy() for x in render_frame(room, Tcw_gt[i], cfg.intr)), Tcw_gt[i]) for i in (0, 3, 6)]
    built = {}
    for dev in ("cuda", "cpu"):
        b = DenseBuilder(cfg.intr, voxel=0.1, device=dev)
        for gray, depth, T in frames:
            b.process_frame(gray, depth, T)
        built[dev] = b
    kc, kp = built["cuda"]._keys, built["cpu"]._keys
    shared, ic, ip = np.intersect1d(kc, kp, return_indices=True)
    assert len(shared) >= 0.999 * max(len(kc), len(kp)) and len(shared) > 1000
    gap = np.abs(built["cuda"].cloud()[0][ic] - built["cpu"].cloud()[0][ip]).max(axis=1)
    assert np.mean(gap <= 1e-4) >= 0.999

"""The plain reference at toy sizes against brute force."""

import numpy as np
import torch

from port_bench.reference import geometry as geo
from port_bench.reference import kernels as refk
from port_bench.reference import shape as refs


def _fast_brute(img: np.ndarray, t: float) -> np.ndarray:
    H, W = img.shape
    score = np.zeros((H, W), np.float32)
    for y in range(3, H - 3):
        for x in range(3, W - 3):
            c = img[y, x]
            ring = np.array([img[y + dy, x + dx] for dy, dx in refk.CIRCLE], np.float32)
            best = np.float32(0)
            for sign in (1, -1):
                on = (ring > c + t) if sign > 0 else (ring < c - t)
                arc = any(all(on[(s + k) % 16] for k in range(9)) for s in range(16))
                if arc:
                    acc = np.float32(0)
                    for k in range(16):
                        if on[k]:
                            acc = np.float32(acc + np.float32(np.float32(abs(ring[k] - c)) - np.float32(t)))
                    best = max(best, acc)
            score[y, x] = best
    pad = np.pad(score, 1)
    m = np.max([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W] for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
    return np.where(score >= m, score, 0).astype(np.float32)


def test_fast_nms_matches_brute_force():
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 4, (24, 28)) * 60).astype(np.float32)
    for t in (20.0, 7.0):
        got = refk.fast_nms(torch.from_numpy(img), t).numpy()
        assert np.array_equal(got, _fast_brute(img, t))
        assert (got > 0).any()


def test_hamming_matches_python_popcount():
    rng = np.random.default_rng(1)
    a = rng.integers(-2**31, 2**31, (7, 8), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (5, 8), dtype=np.int64).astype(np.int32)
    got = refk.hamming(torch.from_numpy(a), torch.from_numpy(b), rows=3).numpy()
    want = [[sum(bin((int(x) ^ int(y)) & 0xFFFFFFFF).count("1") for x, y in zip(ra, rb)) for rb in b] for ra in a]
    assert np.array_equal(got, want)


def test_pyramid_keeps_a_constant_image_and_its_shapes():
    shapes = refk.level_shapes(48, 64, 4, 1.2)
    levels = refk.pyramid(torch.full((48, 64), 77.0), shapes)
    assert [tuple(lv.shape) for lv in levels] == shapes
    assert all(torch.allclose(lv, torch.tensor(77.0), atol=1e-3) for lv in levels)
    w = refk.resize_weights(64, 53)
    assert np.allclose(w.sum(0), 1.0, atol=1e-6)


def test_flips_turn_about_the_object_up_axis():
    T = torch.eye(4, dtype=torch.float64)[None]
    F = refs.flips(T, 4)[0]
    assert torch.allclose(F[1, :3, :3], torch.tensor([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]], dtype=torch.float64),
                          atol=1e-12)
    assert torch.allclose(F[2, :3, :3], torch.diag(torch.tensor([-1.0, 1, -1], dtype=torch.float64)), atol=1e-12)


def _decoder(gen):
    dims = refs.layer_dims(2, 8, 3, (2,))
    raw = []
    for din, dout in dims:
        v = torch.randn(dout, din, generator=gen, dtype=torch.float64)
        raw.append((v, torch.rand(dout, generator=gen, dtype=torch.float64) + 0.5,
                    torch.randn(dout, generator=gen, dtype=torch.float64) * 0.1))
    return raw


def test_sdf_and_cost_against_a_direct_evaluation():
    gen = torch.Generator().manual_seed(3)
    raw = _decoder(gen)
    wb = refs.decoder_weights(raw)
    code = torch.randn(1, 2, generator=gen, dtype=torch.float64)
    xyz = torch.randn(1, 4, 3, generator=gen, dtype=torch.float64)

    def direct(p):  # one point, loops and numpy
        inp = np.concatenate([code[0].numpy(), p])
        x = inp
        for i, (v, g, b) in enumerate(raw):
            if i == 2:
                x = np.concatenate([x, inp])
            W = v.numpy() * (g.numpy() / np.linalg.norm(v.numpy(), axis=1))[:, None]
            x = W @ x + b.numpy()
            if i < 2:
                x = np.maximum(x, 0)
        return np.tanh(x[0])

    got = refs.sdf(wb, (2,), code, xyz)[0].numpy()
    assert np.allclose(got, [direct(p) for p in xyz[0].numpy()], atol=1e-12)

    # With nothing valid the cost is the code prior alone.
    w = {"w_sdf": 1.0, "w_render": 1.0, "w_code": 0.03, "huber_sdf": 0.05, "huber_render": 0.15}
    T = torch.eye(4, dtype=torch.float64)[None]
    pts, rays = xyz, torch.ones(1, 4, 3, dtype=torch.float64)
    depth = torch.full((1, 4), 2.0, dtype=torch.float64)
    none = torch.zeros(1, 4, dtype=torch.bool)
    c = refs.cost(wb, (2,), w, T, code, pts, none, rays, depth, none)
    assert torch.allclose(c, 0.03 * (code * code).sum(-1))
    # One valid surface point: its Huber-weighted squared SDF joins the prior.
    one = none.clone()
    one[0, 1] = True
    r = refs.sdf(wb, (2,), code, xyz)[0, 1]
    hw = 1.0 if abs(r) <= 0.05 else 0.05 / abs(r)
    c1 = refs.cost(wb, (2,), w, T, code, pts, one, rays, depth, none)
    assert torch.allclose(c1 - c, hw * r * r)


def test_project_bbox_of_a_sphere_ahead():
    e = torch.tensor([0.0, 0.0, 4.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0], dtype=torch.float64)
    K = geo.intrinsic_matrix(500.0, 500.0, 320.0, 240.0, dtype=torch.float64)
    box = geo.project_bbox(e, torch.eye(4, dtype=torch.float64), K)
    half = 500.0 * 1.0 / np.sqrt(16.0 - 1.0)  # tangent cone of a unit sphere at distance 4
    assert torch.allclose(box, torch.tensor([320 - half, 240 - half, 320 + half, 240 + half], dtype=torch.float64))


def _lm_problem(seed=5, B=3, P=40, C=8):
    gen = torch.Generator().manual_seed(seed)
    raw = []
    for din, dout in refs.layer_dims(C, 32, 4, (2,)):
        v = torch.randn(dout, din, generator=gen, dtype=torch.float64) * (2.0 / din) ** 0.5
        raw.append((v, torch.linalg.vector_norm(v, dim=1), torch.zeros(dout, dtype=torch.float64)))
    pts = torch.randn(B, P, 3, generator=gen, dtype=torch.float64) * 0.3
    pts[..., 2] += 2.0
    depth = pts[..., 2].clone()
    T = torch.eye(4, dtype=torch.float64).repeat(B, 1, 1)
    T[:, :3, :3] *= 1.3
    T[:, 2, 3] = -2.6
    code = torch.randn(B, C, generator=gen, dtype=torch.float64) * 0.1
    return (raw, T, code, pts, torch.rand(B, P, generator=gen) > 0.3, pts / depth[..., None], depth,
            torch.rand(B, P, generator=gen) > 0.2)


LM = {"iters": 5, "num_flips": 1, "w_sdf": 1.0, "w_render": 1.0, "w_rot": 0.3, "w_code": 0.03, "w_scale": 10.0,
      "huber_sdf": 0.05, "huber_render": 0.15, "lm_lambda0": 0.01}


def test_exp_sim3_is_the_matrix_exponential_of_its_generator():
    xi = torch.tensor([0.1, -0.2, 0.3, 0.2, -0.1, 0.4, 0.25], dtype=torch.float64)
    T = refs.exp_sim3(xi)
    sR = T[:3, :3]
    s = torch.linalg.det(sR) ** (1.0 / 3.0)
    assert torch.allclose(s, torch.exp(torch.tensor(0.25, dtype=torch.float64)))
    assert torch.allclose(sR.T @ sR / s**2, torch.eye(3, dtype=torch.float64), atol=1e-12)
    assert torch.allclose(refs.exp_sim3(torch.zeros(7, dtype=torch.float64)), torch.eye(4, dtype=torch.float64))


def test_the_lm_jacobian_against_finite_differences():
    raw, T, code, pts, pok, rays, depth, rok = _lm_problem()
    wb = refs.decoder_weights(raw)
    _, J = refs._residuals(wb, (2,), T, code, pts, pok, rays, depth, rok, jacobian=True)

    def res(theta, b):
        Tb = refs.exp_sim3(theta[:7]) @ T[b]
        return refs._residuals(wb, (2,), Tb[None], theta[None, 7:], pts[b:b + 1], pok[b:b + 1], rays[b:b + 1],
                               depth[b:b + 1], rok[b:b + 1], jacobian=False)[0][0]

    for b in range(T.shape[0]):
        th = torch.cat([torch.zeros(7, dtype=torch.float64), code[b]])
        Jn = torch.stack([(res(th + e, b) - res(th - e, b)) / 2e-6 for e in torch.eye(th.shape[0]) * 1e-6], -1)
        # A residual whose point sits on a ReLU or Huber kink differs from its central difference.
        close = torch.isclose(Jn, J[b], rtol=1e-5, atol=1e-7).all(-1)
        assert close.float().mean() > 0.95 and close[:pts.shape[1]].any() and close[pts.shape[1]:].any()


def test_the_reference_lm_follows_the_programs_in_float64():
    """The program's LM run in float64 at a toy width reaches the
    reference's states; they differ only by the program's float32 render
    sample offsets."""
    from qsp_slam_tpu_torch.models.deepsdf import DeepSDFConfig
    from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig, reconstruct_object

    raw, T, code, pts, pok, rays, depth, rok = _lm_problem()
    params = {f"lin{i}": {"v": v, "g": g, "b": b} for i, (v, g, b) in enumerate(raw)}
    dec = DeepSDFConfig(code_dim=8, hidden=32, num_layers=4, latent_in=(2,))
    for iters in (1, 5):
        opt = dict(LM, iters=iters)
        prog = reconstruct_object(params, dec, T, code, pts, pok, rays, depth, rok, ShapeOptConfig(**opt))
        T_r, code_r, cost_r, good_r = refs.lm(refs.decoder_weights(raw), (2,), opt, T, code, pts, pok, rays, depth, rok)
        assert torch.allclose(prog.T_oc, T_r, atol=1e-4) and torch.allclose(prog.code, code_r, atol=1e-4)
        assert torch.allclose(prog.cost, cost_r, rtol=1e-5) and torch.equal(prog.is_good, good_r)
    start = refs.cost(refs.decoder_weights(raw), (2,), LM, T, code, pts, pok, rays, depth, rok)
    assert (cost_r < 0.9 * start).all()  # five trips lower every hypothesis's cost

"""Plain PyTorch reference of the shape step's arithmetic in float64: the
DeepSDF decoder, the joint SDF + render cost of a hypothesis, and the
choice among an object's flip hypotheses.  It imports nothing of the
program; the decoder's weights come from the benchmark's own generator
(`harness/weights.py`), and everything the program derived is worked out
again here.

The decoder (DeepSDF, as DSP-SLAM's): linear layers with weight
normalisation W = g v / |v| (per output row), ReLU between them, the
(code, xyz) input concatenated again before each `latent_in` layer (the
layer before it narrows so the width stays `hidden`), tanh on the single
output.

The cost of a hypothesis (T_oc, code) on its surface points p and rays
(unit-depth direction r, observed depth z):
  r_sdf  = SDF(code, T_oc p) on the valid surface points, 0 elsewhere;
  r_ren  = E[d] - z on the valid rays, with 32 samples d_j = max(z + s_j,
           0.05), s_j evenly from -0.6 to 0.6, occupancies
           o_j = sigmoid(-SDF(code, T_oc r d_j) / 0.02), weights
           w_j = o_j prod_{k<j} (1 - o_k + 1e-7) and
           E[d] = sum w_j d_j + (1 - sum w_j) (z + 0.6);
  cost   = w_sdf sum h(r_sdf, 0.05) r_sdf^2 + w_ren sum h(r_ren, 0.15) r_ren^2
           + w_code |code|^2,   h(r, delta) = 1 if |r| <= delta else delta / |r|.
"""

from __future__ import annotations

import torch

RENDER_SAMPLES = 32
DEPTH_RANGE = 0.6
SIGMA = 0.02


def layer_dims(code_dim: int, hidden: int, num_layers: int, latent_in) -> list[tuple[int, int]]:
    """(in, out) of each linear layer."""
    dims, d_in = [], code_dim + 3
    for i in range(num_layers):
        din = d_in if i == 0 else hidden
        dout = 1 if i == num_layers - 1 else (hidden - d_in if (i + 1) in latent_in else hidden)
        dims.append((din, dout))
    return dims


def decoder_weights(raw: list, dtype=torch.float64) -> list:
    """(W, b) per layer from the raw (v, g, b) tensors."""
    out = []
    for v, g, b in raw:
        v = v.to(dtype)
        out.append((v * (g.to(dtype) / torch.linalg.vector_norm(v, dim=1))[:, None], b.to(dtype)))
    return out


def sdf(wb: list, latent_in, code: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """code (B, C), xyz (B, N, 3) -> (B, N)."""
    inp = torch.cat([code[:, None, :].expand(xyz.shape[:-1] + (code.shape[-1],)), xyz], dim=-1)
    x = inp
    for i, (W, b) in enumerate(wb):
        if i in latent_in and i > 0:
            x = torch.cat([x, inp], dim=-1)
        x = x @ W.T + b
        if i < len(wb) - 1:
            x = torch.relu(x)
    return torch.tanh(x[..., 0])


def _huber_w(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-300))


def cost(wb, latent_in, weights: dict, T_oc, code, pts, pts_ok, rays, depth, rays_ok) -> torch.Tensor:
    """The cost of each hypothesis (B,), everything in float64."""
    f64 = torch.float64
    T_oc, code, pts, rays, depth = (x.to(f64) for x in (T_oc, code, pts, rays, depth))
    s = torch.linspace(-DEPTH_RANGE, DEPTH_RANGE, RENDER_SAMPLES, dtype=f64, device=pts.device)
    d = torch.clamp(depth[..., None] + s, min=0.05)  # (B, R, S)
    samples = (rays[..., None, :] * d[..., None]).reshape(rays.shape[0], -1, 3)
    allp = torch.cat([pts, samples], dim=1)
    p_obj = allp @ T_oc[:, :3, :3].transpose(-1, -2) + T_oc[:, None, :3, 3]
    f = sdf(wb, latent_in, code, p_obj)
    P = pts.shape[1]
    r_sdf = torch.where(pts_ok, f[:, :P], 0.0)
    occ = torch.sigmoid(-f[:, P:].reshape(d.shape) / SIGMA)
    trans = torch.cumprod(1.0 - occ + 1e-7, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = occ * trans
    d_exp = torch.sum(w * d, dim=-1) + (1.0 - torch.sum(w, dim=-1)) * (depth + DEPTH_RANGE)
    r_ren = torch.where(rays_ok, d_exp - depth, 0.0)
    return (weights["w_sdf"] * torch.sum(_huber_w(r_sdf, weights["huber_sdf"]) * r_sdf * r_sdf, dim=-1)
            + weights["w_render"] * torch.sum(_huber_w(r_ren, weights["huber_render"]) * r_ren * r_ren, dim=-1)
            + weights["w_code"] * torch.sum(code * code, dim=-1))


def pick(cost: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    """Per object (rows of (n, F)): the lowest-cost good hypothesis, else 0."""
    c = torch.where(good, cost, torch.inf)
    return torch.where(good.any(-1), torch.argmin(c, dim=-1), 0)


def flips(T: torch.Tensor, num: int) -> torch.Tensor:
    """(n, F, 4, 4): each frame turned about its object-frame up (y) axis
    by 2 pi f / F, applied on the object side."""
    a = 2.0 * torch.pi * torch.arange(num, dtype=torch.float64, device=T.device) / num
    c, s = torch.cos(a), torch.sin(a)
    R = torch.zeros((num, 4, 4), dtype=torch.float64, device=T.device)
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2], R[:, 3, 3] = c, s, 1.0, -s, c, 1.0
    return R @ T.to(torch.float64)[:, None]


def exp_sim3(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential of xi = [v, w, s] (..., 7): the matrix exponential
    of [[s I + hat(w), v], [0, 0]], so the top-left block is exp(s) R."""
    v, w, s = xi[..., :3], xi[..., 3:6], xi[..., 6]
    A = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    A[..., 0, 1], A[..., 0, 2], A[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    A[..., 1, 0], A[..., 2, 0], A[..., 2, 1] = w[..., 2], -w[..., 1], w[..., 0]
    for i in range(3):
        A[..., i, i] = s
    A[..., :3, 3] = v
    return torch.linalg.matrix_exp(A)


def _residuals(wb, latent_in, T_oc, code, pts, pts_ok, rays, depth, rays_ok, jacobian: bool):
    """The residuals r (B, P + R) of each hypothesis at (T_oc, code) and,
    with `jacobian`, their Jacobian (B, P + R, 7 + C) with respect to
    (sim(3) increment xi applied as exp(xi) T_oc, code), from one reverse
    pass: every decoder evaluation is a scalar of its own (xyz, code)
    input, and d(exp(xi) q)/dxi at 0 is [I, -hat(q), q]."""
    B, P, C = pts.shape[0], pts.shape[1], code.shape[-1]
    s = torch.linspace(-DEPTH_RANGE, DEPTH_RANGE, RENDER_SAMPLES, dtype=torch.float64, device=pts.device)
    d = torch.clamp(depth[..., None] + s, min=0.05)  # (B, R, S)
    allp = torch.cat([pts, (rays[..., None, :] * d[..., None]).reshape(B, -1, 3)], dim=1)
    q = allp @ T_oc[:, :3, :3].transpose(-1, -2) + T_oc[:, None, :3, 3]
    codes = code[:, None, :].expand(B, q.shape[1], C)
    with torch.enable_grad():
        q_leaf, c_leaf = q.detach().requires_grad_(jacobian), codes.detach().requires_grad_(jacobian)
        x = inp = torch.cat([c_leaf, q_leaf], dim=-1)
        for i, (W, b) in enumerate(wb):
            if i in latent_in and i > 0:
                x = torch.cat([x, inp], dim=-1)
            x = x @ W.T + b
            if i < len(wb) - 1:
                x = torch.relu(x)
        f = torch.tanh(x[..., 0])
        grads = torch.autograd.grad(f.sum(), (q_leaf, c_leaf)) if jacobian else None
        f_leaf = f.detach().requires_grad_(jacobian)
        occ = torch.sigmoid(-f_leaf[:, P:].reshape(d.shape) / SIGMA)
        trans = torch.cumprod(1.0 - occ + 1e-7, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
        w = occ * trans
        d_exp = torch.sum(w * d, dim=-1) + (1.0 - torch.sum(w, dim=-1)) * (depth + DEPTH_RANGE)
        r_ren = torch.where(rays_ok, d_exp - depth, 0.0)
        # Each ray's residual depends on its own samples only, so one pass gives every d r_k / d f_kj.
        a = torch.autograd.grad(r_ren.sum(), f_leaf)[0][:, P:].reshape(d.shape) if jacobian else None
    r = torch.cat([torch.where(pts_ok, f[:, :P].detach(), 0.0), r_ren.detach()], dim=-1)
    if not jacobian:
        return r, None
    g_q, g_c = grads
    J_pt = torch.cat([g_q, torch.cross(q, g_q, dim=-1), (g_q * q).sum(-1, keepdim=True), g_c], dim=-1)
    J_sdf = torch.where(pts_ok[..., None], J_pt[:, :P], 0.0)
    J_ren = torch.einsum("brs,brsd->brd", a, J_pt[:, P:].reshape(d.shape + (7 + C,)))
    return r, torch.cat([J_sdf, J_ren], dim=1)


def lm(wb, latent_in, opt: dict, T_oc, code, pts, pts_ok, rays, depth, rays_ok):
    """The shape step's joint pose + code Levenberg-Marquardt in float64,
    for a batch of hypotheses, over `opt["iters"]` trips:

      theta = (xi (7), code); the Huber weights W of the residuals at the
      trip's start; H = J^T W J + diag(prior), prior = w_rot on xi's x/y
      rotation, w_scale on its scale, w_code on the code;
      g = -J^T W r - prior * theta;  delta = (H + lambda diag(H) + 1e-8 I)^-1 g;
      trial (exp(delta_xi) T_oc, code + delta_code), kept where its cost is
      lower (lambda * 0.33, else * 3, within [1e-7, 1e6]; lambda starts at
      `lm_lambda0`).

    -> (T_oc, code, cost, is_good): is_good where the cost fell below the
    start's and under 0.05 per active residual, with a finite frame."""
    f64 = torch.float64
    T_oc, code, pts, rays, depth = (x.to(f64) for x in (T_oc, code, pts, rays, depth))
    B, C = code.shape
    D = 7 + C
    eye = torch.eye(D, dtype=f64, device=code.device)
    prior = torch.zeros(D, dtype=f64, device=code.device)
    prior[3:5], prior[6], prior[7:] = opt["w_rot"], opt["w_scale"], opt["w_code"]
    args = (pts, pts_ok, rays, depth, rays_ok)

    def cost_at(T, c):
        return cost(wb, latent_in, opt, T, c, *args)

    lmbda = torch.full((B,), float(opt["lm_lambda0"]), dtype=f64, device=code.device)
    c_now = c0 = cost_at(T_oc, code)
    P = pts.shape[1]
    for _ in range(int(opt["iters"])):
        r, J = _residuals(wb, latent_in, T_oc, code, *args, jacobian=True)
        w = torch.cat([_huber_w(r[:, :P], opt["huber_sdf"]) * pts_ok * opt["w_sdf"],
                       _huber_w(r[:, P:], opt["huber_render"]) * rays_ok * opt["w_render"]], dim=-1)
        H = J.transpose(-1, -2) @ (J * w[..., None]) + torch.diag(prior)
        theta = torch.cat([torch.zeros((B, 7), dtype=f64, device=code.device), code], dim=-1)
        g = -(J.transpose(-1, -2) @ (w * r)[..., None])[..., 0] - prior * theta
        A = H + lmbda[:, None, None] * H * eye + 1e-8 * eye
        delta, info = torch.linalg.solve_ex(A, g)
        delta = torch.where(info[:, None] == 0, delta, torch.nan)
        T_try = exp_sim3(delta[:, :7]) @ T_oc
        code_try = code + delta[:, 7:]
        c_try = cost_at(T_try, code_try)
        accept = c_try < c_now
        T_oc = torch.where(accept[:, None, None], T_try, T_oc)
        code = torch.where(accept[:, None], code_try, code)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        c_now = torch.where(accept, c_try, c_now)
    n_act = pts_ok.sum(-1) + rays_ok.sum(-1)
    good = (c_now < c0) & (c_now / n_act.clamp(min=1) < 0.05) & torch.isfinite(T_oc).all(-1).all(-1)
    return T_oc, code, c_now, good

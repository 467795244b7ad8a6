"""Joint pose + latent-code Gauss-Newton, the orientation (flip) search
and the pose-only fit against a fixed shape (counterpart of
`qsp_slam_tpu/models/shape_opt.py`).

Each LM trip builds the Jacobian of the SDF and render residuals with
respect to theta = (sim(3) increment xi, code), then solves the damped
normal equations with the tilt, scale and code priors on the diagonal.
Two paths build the same (r, J) and share no logic, chosen by the device
of the inputs: on the CPU `forward_jacobian`, `jvp`s under `vmap` over the
7 + C tangent basis, whose rounding follows the reference's `jacfwd` (the
parity tests hold later trips to it, and the LM's ReLU pattern makes them
chaotic); on CUDA `reverse_jacobian`, one decoder pass and one input-only
backward pass, about 3 decoder passes where the basis takes 7 + C + 1.
Everything is batched over a leading hypothesis axis; the reference's
`lax.scan` becomes a Python loop whose accepts are `torch.where`
selections, and a singular system gives a NaN step that the accept test
rejects (`solve_or_nan`), so a trip never reads the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..core import lie
from ..opt.pose_opt import solve_or_nan
from ..utils.tracing import HOST_READS, TRACER, count
from . import losses
from .deepsdf import DeepSDFConfig, decode_sdf, weights

REVERSE_JACOBIANS = "shape_reverse_jacobians"  # TRACER counter: one per `reverse_jacobian` call


class ShapeOptConfig(NamedTuple):
    iters: int = 8
    w_sdf: float = 1.0
    w_render: float = 1.0
    w_rot: float = 0.3
    w_code: float = 0.03
    w_scale: float = 10.0
    huber_sdf: float = 0.05
    huber_render: float = 0.15
    lm_lambda0: float = 1e-2
    # Up-axis rotation hypotheses per object, optimised together; the
    # lowest converged cost wins (the reference's `flip_sample_num`).
    num_flips: int = 4


class ShapeOptResult(NamedTuple):
    T_oc: torch.Tensor  # (..., 4, 4) refined camera -> object similarity
    code: torch.Tensor  # (..., C)
    cost: torch.Tensor  # (...) final robust cost
    is_good: torch.Tensor  # (...) bool: lowered the cost to a sane level, finite


def _huber_w(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def _batched(fn, T_oc_init, *args):
    """Run the batched `fn` on one hypothesis (T (4, 4)) or a batch."""
    if T_oc_init.dim() == 3:
        return fn(T_oc_init, *args)
    res = fn(T_oc_init[None], *(a[None] for a in args))
    return type(res)(*(x[0] for x in res))


def reconstruct_object(params, dec_cfg: DeepSDFConfig, T_oc_init, code_init, pts_cam, pts_valid, rays_cam,
                       depth_obs, rays_valid, opt_cfg: ShapeOptConfig = ShapeOptConfig()) -> ShapeOptResult:
    """LM over (sim(3) xi, code) with the reference's terms, for one
    hypothesis (T_oc_init (4, 4), code (C,), points (P, 3), ...) or a
    batch of them (a leading B on every argument)."""
    return _batched(lambda *a: _reconstruct(params, dec_cfg, opt_cfg, *a), T_oc_init, code_init, pts_cam,
                    pts_valid, rays_cam, depth_obs, rays_valid)


def forward_jacobian(params, dec_cfg, wb, code, T_base, pts_cam, pts_valid, rays_cam, depth_obs, rays_valid):
    """(r (B, M), J (B, M, 7 + C)) of the joint residuals at theta =
    (xi = 0, code): `jvp`s under `vmap` over the 7 + C tangent basis, a
    decoder pass per column (forward mode: far fewer parameters than
    residuals)."""
    B, C = code.shape
    D = 7 + C
    theta = torch.cat([torch.zeros((B, 7), dtype=code.dtype, device=code.device), code], dim=-1)

    def residuals(t):
        return torch.cat(losses.joint_residuals(params, dec_cfg, t[:, :7], t[:, 7:], T_base, pts_cam, pts_valid,
                                                rays_cam, depth_obs, rays_valid, wb), dim=-1)

    eye = torch.eye(D, dtype=code.dtype, device=code.device)
    r, J = vmap(lambda v: jvp(residuals, (theta,), (v.expand(B, D),)))(eye)
    return r[0], J.permute(1, 2, 0)


def reverse_jacobian(params, dec_cfg, wb, code, T_base, pts_cam, pts_valid, rays_cam, depth_obs, rays_valid):
    """`forward_jacobian`'s (r, J) from one decoder pass and one backward
    pass to the decoder's input rows (no weight gradients).  Each SDF
    value depends only on its own row (code, y), y = T_base p, so the
    backward of the summed SDF gives every row's g_code and g_y; at xi = 0
    `exp_sim3`'s [v, w, s] move y by v + w x y + s y, so the row's pose
    columns are g_y, y x g_y and g_y . y.  A ray's residual depends only on
    its own samples: its row is theirs weighted by d r / d sdf, from one
    backward through `losses.render_from_sdf`."""
    count(REVERSE_JACOBIANS)
    B, C = code.shape
    P, R = pts_cam.shape[1], rays_cam.shape[1]
    zeros7 = torch.zeros((B, 7), dtype=code.dtype, device=code.device)
    d, samples = losses.render_samples(rays_cam, depth_obs)
    y = lie.transform_points(lie.exp_sim3(zeros7) @ T_base, torch.cat([pts_cam, samples], dim=-2))
    with torch.enable_grad():
        xyz = y.detach().requires_grad_()
        rows = code.detach()[:, None, :].expand(B, y.shape[1], C).requires_grad_()
        sdf = decode_sdf(params, dec_cfg, rows, xyz, [(W.detach(), b.detach()) for W, b in wb])
        g_code, g_y = torch.autograd.grad(sdf.sum(), (rows, xyz))
        sdf_ren = sdf.detach()[:, P:].reshape(d.shape).requires_grad_()
        r_ren = losses.render_from_sdf(sdf_ren, d, depth_obs, rays_valid)
        (w_ren,) = torch.autograd.grad(r_ren.sum(), sdf_ren)
    J_rows = torch.cat([g_y, torch.linalg.cross(y, g_y, dim=-1), torch.sum(g_y * y, dim=-1, keepdim=True), g_code],
                       dim=-1)
    r = torch.cat([torch.where(pts_valid, sdf.detach()[:, :P], 0.0), r_ren.detach()], dim=-1)
    J_ren = torch.einsum("brs,brsd->brd", w_ren, J_rows[:, P:].reshape(B, R, d.shape[-1], -1))
    return r, torch.cat([torch.where(pts_valid[..., None], J_rows[:, :P], 0.0), J_ren], dim=1)


def _reconstruct(params, dec_cfg, opt_cfg, T_oc_init, code_init, pts_cam, pts_valid, rays_cam, depth_obs,
                 rays_valid, jacobian=None) -> ShapeOptResult:
    """The batched LM.  `jacobian` builds each trip's (r, J); by default
    `reverse_jacobian` on CUDA and `forward_jacobian` elsewhere."""
    B, C = code_init.shape
    D = 7 + C
    dev, f32 = code_init.device, code_init.dtype
    wb = weights(params, dec_cfg)
    if jacobian is None:
        jacobian = reverse_jacobian if dev.type == "cuda" else forward_jacobian
    zeros7 = torch.zeros((B, 7), dtype=f32, device=dev)
    eye = torch.eye(D, dtype=f32, device=dev)
    prior = torch.zeros(D, dtype=f32, device=dev)
    count(HOST_READS)  # `prior[6] =` copies its scalar from host memory, which waits for the card
    prior[3:5], prior[6], prior[7:] = opt_cfg.w_rot, opt_cfg.w_scale, opt_cfg.w_code
    pv, rv = pts_valid.to(f32), rays_valid.to(f32)

    def residuals(theta, T_base):
        return torch.cat(losses.joint_residuals(params, dec_cfg, theta[:, :7], theta[:, 7:], T_base, pts_cam,
                                                pts_valid, rays_cam, depth_obs, rays_valid, wb), dim=-1)

    def robust_weights(r_sdf, r_ren):
        return (_huber_w(r_sdf, opt_cfg.huber_sdf) * pv * opt_cfg.w_sdf,
                _huber_w(r_ren, opt_cfg.huber_render) * rv * opt_cfg.w_render)

    def cost_at(code, T_base):
        r = residuals(torch.cat([zeros7, code], dim=-1), T_base)
        r_sdf, r_ren = r[:, :pts_cam.shape[1]], r[:, pts_cam.shape[1]:]
        c_sdf = torch.sum(_huber_w(r_sdf, opt_cfg.huber_sdf) * r_sdf * r_sdf * pv, dim=-1)
        c_ren = torch.sum(_huber_w(r_ren, opt_cfg.huber_render) * r_ren * r_ren * rv, dim=-1)
        return opt_cfg.w_sdf * c_sdf + opt_cfg.w_render * c_ren + opt_cfg.w_code * torch.sum(code * code, dim=-1)

    T_base, code = T_oc_init, code_init
    lmbda = torch.full((B,), opt_cfg.lm_lambda0, dtype=f32, device=dev)
    cost = cost0 = cost_at(code, T_base)
    for _ in range(opt_cfg.iters):
        with TRACER.span("shapes.trip"):
            theta = torch.cat([zeros7, code], dim=-1)
            with TRACER.span("shapes.jacobian"):
                r, J = jacobian(params, dec_cfg, wb, code, T_base, pts_cam, pts_valid, rays_cam, depth_obs,
                                rays_valid)  # (B, M), (B, M, D)
            w = torch.cat(robust_weights(r[:, :pts_cam.shape[1]], r[:, pts_cam.shape[1]:]), dim=-1)
            Jw = J * w[..., None]
            H = J.transpose(-1, -2) @ Jw + torch.diag(prior)
            g = -(Jw.transpose(-1, -2) @ r[..., None])[..., 0] - prior * theta
            delta = solve_or_nan(H + lmbda[:, None, None] * H * eye + 1e-8 * eye, g)
            T_try = lie.exp_sim3(delta[:, :7]) @ T_base
            code_try = code + delta[:, 7:]
            c_try = cost_at(code_try, T_try)
            accept = c_try < cost
            T_base = torch.where(accept[:, None, None], T_try, T_base)
            code = torch.where(accept[:, None], code_try, code)
            lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
            cost = torch.where(accept, c_try, cost)
    n_act = torch.sum(pv, dim=-1) + torch.sum(rv, dim=-1)
    is_good = (cost < cost0) & (cost / torch.clamp(n_act, min=1.0) < 0.05) & torch.isfinite(T_base).all(-1).all(-1)
    return ShapeOptResult(T_oc=T_base, code=code, cost=cost, is_good=is_good)


def _rot_y_h(angle: torch.Tensor) -> torch.Tensor:
    """Homogeneous rotations about the object-frame up (y) axis. (..., 4, 4)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s, z], -1), torch.stack([z, o, z, z], -1),
                        torch.stack([-s, z, c, z], -1), torch.stack([z, z, z, o], -1)], -2)


def flip_hypotheses(T_oc_init: torch.Tensor, num_flips: int) -> torch.Tensor:
    """(..., F, 4, 4): the object frame turned about its up axis by
    2 pi f / F (p_o' = R p_o, so T_o'c = R_h T_oc)."""
    F = max(1, num_flips)
    angles = (2.0 * math.pi) * torch.arange(F, dtype=torch.float32, device=T_oc_init.device) / F
    return _rot_y_h(angles) @ T_oc_init[..., None, :, :]


def pick_flips(res: ShapeOptResult) -> torch.Tensor:
    """Per row of (..., F) results: the lowest-cost converged hypothesis,
    else 0. -> (...) int64."""
    costs = torch.where(res.is_good, res.cost, torch.inf)
    return torch.where(res.is_good.any(-1), torch.argmin(costs, dim=-1), 0)


def reconstruct_object_flips(params, dec_cfg: DeepSDFConfig, T_oc_init, code_init, pts_cam, pts_valid, rays_cam,
                             depth_obs, rays_valid, opt_cfg: ShapeOptConfig = ShapeOptConfig()):
    """The orientation search for one object: `opt_cfg.num_flips` up-axis
    turns of the initial frame optimised as one batch; the lowest final
    cost among the converged ones wins. -> (result, chosen flip index)."""
    T_hyp = flip_hypotheses(T_oc_init, opt_cfg.num_flips)
    F = T_hyp.shape[0]
    rep = [x.expand((F,) + x.shape) for x in (code_init, pts_cam, pts_valid, rays_cam, depth_obs, rays_valid)]
    res = reconstruct_object(params, dec_cfg, T_hyp, *rep, opt_cfg)
    pick = pick_flips(res)
    return ShapeOptResult(*(x[pick] for x in res)), pick


def estimate_pose_cam_obj(params, dec_cfg: DeepSDFConfig, T_oc_init, code, pts_cam, pts_valid, iters: int = 5,
                          huber: float = 0.05) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose-only SE(3) LM against a fixed shape -> (T_oc (4, 4), final
    cost): re-localises an already reconstructed object.  (Computed as a
    batch of one: the Lie maps' forward-mode tangents keep f32 only with a
    batch axis.)"""
    wb = weights(params, dec_cfg)
    f32, dev = T_oc_init.dtype, T_oc_init.device
    eye = torch.eye(6, dtype=f32, device=dev)
    xi0, no_scale = torch.zeros((1, 6), dtype=f32, device=dev), torch.zeros((1, 1), dtype=f32, device=dev)
    code, pts_cam, pts_valid = code[None], pts_cam[None], pts_valid[None]

    def f(xi, T_base):
        return losses.sdf_residuals(params, dec_cfg, torch.cat([xi, no_scale], dim=-1), code, T_base, pts_cam,
                                    pts_valid, wb)

    T_base, lmbda = T_oc_init[None], torch.tensor(1e-2, dtype=f32, device=dev)
    r0 = f(xi0, T_base)
    cost = torch.sum(_huber_w(r0, huber) * r0 * r0)
    for _ in range(iters):
        r, J = vmap(lambda v: jvp(lambda x: f(x, T_base), (xi0,), (v[None],)))(eye)
        r, J = r[0, 0], J[:, 0].T  # (P,), (P, 6)
        w = _huber_w(r, huber) * pts_valid[0]
        H = J.T @ (J * w[:, None])
        g = -(J.T @ (w * r))
        delta = solve_or_nan(H + lmbda * H * eye + 1e-8 * eye, g)
        T_try = lie.exp_se3(delta) @ T_base
        r_try = f(xi0, T_try)
        c_try = torch.sum(_huber_w(r_try, huber) * r_try * r_try)
        accept = c_try < cost
        T_base = torch.where(accept, T_try, T_base)
        lmbda = torch.clamp(torch.where(accept, lmbda * 0.33, lmbda * 3.0), 1e-7, 1e6)
        cost = torch.where(accept, c_try, cost)
    return T_base[0], cost

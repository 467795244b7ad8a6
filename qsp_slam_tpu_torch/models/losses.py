"""Shape-optimisation residuals (counterpart of
`qsp_slam_tpu/models/losses.py`): the SDF surface term, the depth-render
term with cumprod transmittance, and the rotation, scale and code priors.

Every function takes an optional leading hypothesis batch: xi (B, 7),
code (B, C), T (B, 4, 4), points (B, P, 3), ...  `joint_residuals`
evaluates the decoder once over the surface points and the render
samples together, which is what the Gauss-Newton step differentiates.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..perception.ellipsoid_fit import jax_linspace
from .deepsdf import DeepSDFConfig, decode_sdf


def object_frame_points(T_ow: torch.Tensor, pts_w: torch.Tensor) -> torch.Tensor:
    """World points -> normalized object frame through T_ow (its sR block)."""
    return lie.transform_points(T_ow, pts_w)


def sdf_residuals(params, cfg: DeepSDFConfig, xi, code, T_oc_init, pts_cam, valid, wb=None) -> torch.Tensor:
    """r_i = SDF(exp(xi) T_oc p_i, code), 0 where not valid. (..., P)."""
    p_obj = lie.transform_points(lie.exp_sim3(xi) @ T_oc_init, pts_cam)
    return torch.where(valid, decode_sdf(params, cfg, code, p_obj, wb), 0.0)


def render_samples(rays_cam, depth_obs, num_samples: int = 32, depth_range: float = 0.6):
    """Sample depths around each observation (at least 0.05) and their
    camera points: -> d (..., R, S), pts (..., R * S, 3)."""
    ts = jax_linspace(-depth_range, depth_range, num_samples).to(depth_obs.device)
    d = torch.clamp(depth_obs[..., None] + ts, min=0.05)
    pts = rays_cam[..., None, :] * d[..., None]
    return d, pts.reshape(pts.shape[:-3] + (-1, 3))


def render_from_sdf(sdf, d, depth_obs, valid, depth_range: float = 0.6, sigma: float = 0.02) -> torch.Tensor:
    """Expected-termination-depth residuals from the SDF at the samples
    (..., R, S): occupancy o = sigmoid(-sdf / sigma), weights
    w_j = o_j prod_{k<j} (1 - o_k + 1e-7), E[d] = sum w d + (1 - sum w) d_far."""
    occ = torch.sigmoid(-sdf / sigma)
    trans = torch.cumprod(1.0 - occ + 1e-7, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = occ * trans
    d_exp = torch.sum(w * d, dim=-1) + (1.0 - torch.sum(w, dim=-1)) * (depth_obs + depth_range)
    return torch.where(valid, d_exp - depth_obs, 0.0)


def render_residuals(params, cfg: DeepSDFConfig, xi, code, T_oc_init, rays_cam, depth_obs, valid,
                     num_samples: int = 32, depth_range: float = 0.6, sigma: float = 0.02, wb=None) -> torch.Tensor:
    """Expected-termination-depth residual per ray. (..., R)."""
    d, pts = render_samples(rays_cam, depth_obs, num_samples, depth_range)
    p_obj = lie.transform_points(lie.exp_sim3(xi) @ T_oc_init, pts)
    sdf = decode_sdf(params, cfg, code, p_obj, wb).reshape(d.shape)
    return render_from_sdf(sdf, d, depth_obs, valid, depth_range, sigma)


def joint_residuals(params, cfg: DeepSDFConfig, xi, code, T_oc_init, pts_cam, pts_valid, rays_cam, depth_obs,
                    rays_valid, wb=None) -> tuple[torch.Tensor, torch.Tensor]:
    """`sdf_residuals` and `render_residuals` (default samples) from one
    decoder pass over the P surface points and the R x 32 samples."""
    d, samples = render_samples(rays_cam, depth_obs)
    P = pts_cam.shape[-2]
    p_obj = lie.transform_points(lie.exp_sim3(xi) @ T_oc_init, torch.cat([pts_cam, samples], dim=-2))
    sdf = decode_sdf(params, cfg, code, p_obj, wb)
    r_sdf = torch.where(pts_valid, sdf[..., :P], 0.0)
    return r_sdf, render_from_sdf(sdf[..., P:].reshape(d.shape), d, depth_obs, rays_valid)


def rotation_residual(xi: torch.Tensor) -> torch.Tensor:
    """Tilt prior: the x/y components of the rotation increment. (..., 2)."""
    return xi[..., 3:5]


def scale_residual(xi: torch.Tensor) -> torch.Tensor:
    """Scale damping. (..., 1)."""
    return xi[..., 6:7]


def code_residual(code: torch.Tensor) -> torch.Tensor:
    """Latent L2 prior. (..., C)."""
    return code

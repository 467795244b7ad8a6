"""SO(3)/SE(3)/Sim(3) exponential and logarithm maps, batched over
leading dims.

Counterpart of `qsp_slam_tpu/core/lie.py`.  Same conventions:
se(3) tangent xi = [v(3), w(3)], translation first; sim(3) appends the
log-scale s; rotations are 3x3 matrices, transforms (..., 4, 4); Taylor
guards are `torch.where` selections, so theta == 0 is exact and NaN-free
and the functions trace under `torch.func.jacfwd` and `vmap` (no host
reads, no branch on a value).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.tracing import HOST_READS, count

_EPS = 1e-8


def _safe_div(num, den, small):
    """num/den with den replaced by 1 where `small`."""
    return num / torch.where(small, torch.ones_like(den), den)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. W: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_coeffs(theta2):
    """(A, B, C) = sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3, Taylor-guarded."""
    small = theta2 < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, _safe_div(sin_t, theta, small))
    B = torch.where(small, 0.5 - theta2 / 24.0, _safe_div(1.0 - cos_t, theta2, small))
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        _safe_div(theta - sin_t, theta2 * theta, small),
    )
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues). w: (..., 3) -> R: (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _so3_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm. R: (..., 3, 3) -> w: (..., 3).

    atan2-based angle with separate near-0 and near-pi branches, as in the
    reference implementation.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    s2 = torch.sum(w_skew * w_skew, dim=-1)  # = 4 sin^2(theta)
    sin_t = 0.5 * torch.sqrt(s2 + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    near_0 = theta < 1e-4
    near_pi = (math.pi - theta) < 5e-3
    generic = ~(near_0 | near_pi)
    k_generic = _safe_div(theta, 2.0 * sin_t, ~generic)
    k_small = 0.5 + s2 / 48.0
    k = torch.where(generic, k_generic, k_small)
    w_gen = k[..., None] * w_skew
    # theta -> pi: axis magnitudes from the diagonal of S = R + R^T, signs
    # from S's dominant column, global sign from vee(R - R^T).
    S = R + R.transpose(-1, -2)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    denom_pi = torch.where(near_pi, 3.0 - trace, torch.ones_like(trace))[..., None]
    axis2 = torch.clamp((diag + (1.0 - trace[..., None])) / denom_pi, min=0.0)
    axis = torch.sqrt(axis2 + 1e-24)
    jmax = torch.argmax(axis2, dim=-1)
    # One-hot by comparison (F.one_hot checks its indices on the host,
    # which `torch.func.vmap` cannot trace).
    onehot = (jmax[..., None] == torch.arange(3, device=R.device)).to(R.dtype)
    M = S - (2.0 * cos_t)[..., None, None] * torch.eye(3, dtype=R.dtype, device=R.device)
    prods = torch.einsum("...ij,...j->...i", M, onehot)
    sgn = torch.where(prods < 0.0, -1.0, 1.0)
    axis_pi = axis * sgn
    nrm = torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.where(nrm == 0.0, torch.ones_like(nrm), nrm)
    dotp = torch.sum(w_skew * axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi * torch.where(dotp < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * axis_pi
    return torch.where(near_pi[..., None], w_pi, w_gen)


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _so3_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + B[..., None, None] * W + C[..., None, None] * W2


def inv_left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    cot_term = _safe_div(half * torch.cos(half), torch.sin(half), small)
    k = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0, _safe_div(1.0 - cot_term, theta2, small)
    )
    W = hat(w)
    W2 = W @ W
    return _eye3(W) - 0.5 * W + k[..., None, None] * W2


def rt_to_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from R (..., 3, 3) and t (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    if not batch:  # a scalar written into a 0-d view is copied from host memory: that waits for the card
        count(HOST_READS)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. xi = [v, w]: (..., 6) -> T: (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = exp_so3(w)
    J = left_jacobian_so3(w)
    t = torch.einsum("...ij,...j->...i", J, v)
    return rt_to_se3(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm. T: (..., 4, 4) -> xi = [v, w]: (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    v = torch.einsum("...ij,...j->...i", inv_left_jacobian_so3(w), t)
    return torch.cat([v, w], dim=-1)


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without generic matrix inversion."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_se3(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) acting on [v, w] tangents: (..., 6, 6)."""
    R = T[..., :3, :3]
    tR = hat(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Sim(3): tangent xi = [v(3), w(3), s], top-left block exp(s) R.
# ---------------------------------------------------------------------------


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, sign kept (`jnp.cbrt`)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _sim3_W(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The matrix W with t = W v: the series sum_n B^n / (n+1)! of
    B = s I + hat(w), 20 terms.  Branch-free and smooth at s = 0 and w = 0,
    where the closed form cancels catastrophically in f32."""
    B = hat(w) + s[..., None, None] * torch.eye(3, dtype=w.dtype, device=w.device)
    W = term = _eye3(B)
    for n in range(1, 20):
        term = term @ B / (n + 1)
        W = W + term
    return W


def exp_sim3(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential. xi = [v, w, s]: (..., 7) -> (..., 4, 4) with
    exp(s) R top-left."""
    v, w, s = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_W(w, s), v)
    return rt_to_se3(torch.exp(s)[..., None, None] * exp_so3(w), t)


def log_sim3(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) logarithm: (..., 4, 4) with sR top-left -> [v, w, s] (..., 7)."""
    sR = T[..., :3, :3]
    scale = _cbrt(torch.linalg.det(sR))
    s = torch.log(scale)
    w = log_so3(sR / scale[..., None, None])
    v = torch.linalg.solve(_sim3_W(w, s), T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w, s[..., None]], dim=-1)


def sim3_scale(T: torch.Tensor) -> torch.Tensor:
    """The scale of a Sim(3) matrix (..., 4, 4) -> (...)."""
    return _cbrt(torch.linalg.det(T[..., :3, :3]))


def inv_sim3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a similarity transform (sR | t); rows of sR have norm s."""
    sR = T[..., :3, :3]
    s2 = torch.sum(sR[..., 0, :] * sR[..., 0, :], dim=-1)
    inv_sR = sR.transpose(-1, -2) / s2[..., None, None]
    return rt_to_se3(inv_sR, -torch.einsum("...ij,...j->...i", inv_sR, T[..., :3, 3]))


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w convention), for the trajectory formats.
# ---------------------------------------------------------------------------


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [x, y, z, w] (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion [x, y, z, w], branch
    free: all four Shepperd candidates, the one with the largest squared
    magnitude (first on ties), sign canonicalised to w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cands = torch.stack(
        [
            torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1),
            torch.stack([qx2, m01 + m10, m02 + m20, m21 - m12], dim=-1),
            torch.stack([m01 + m10, qy2, m12 + m21, m02 - m20], dim=-1),
            torch.stack([m02 + m20, m12 + m21, qz2, m10 - m01], dim=-1),
        ],
        dim=-2,
    )  # (..., candidate, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    onehot = F.one_hot(best, 4).to(R.dtype)
    q = torch.einsum("...cd,...c->...d", cands, onehot)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0.0, -1.0, 1.0)

"""Huber IRLS weights and chi-square gates (counterpart of
`qsp_slam_tpu/opt/robust.py`)."""

from __future__ import annotations

import torch

# 95% chi-square quantiles used for outlier gating.
CHI2_MONO = 5.991  # 2 dof
CHI2_STEREO = 7.815  # 3 dof


def huber_weight(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """IRLS weight rho'(s) = min(1, delta / sqrt(s)) of the squared error."""
    s_safe = torch.clamp(chi2, min=1e-12)
    return torch.clamp(torch.sqrt(delta2 / s_safe), max=1.0)


def huber_rho(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """Huber cost of the squared error: s, or 2 delta sqrt(s) - delta^2."""
    delta = torch.sqrt(delta2)
    s = torch.clamp(chi2, min=0.0)
    return torch.where(s <= delta2, s, 2.0 * delta * torch.sqrt(s) - delta2)

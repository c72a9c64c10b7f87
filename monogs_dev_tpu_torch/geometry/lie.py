"""SO(3)/SE(3) exponential maps and the pose retraction used by tracking.

Port of `monogs_dev_tpu/geometry/lie.py`: ``tau = [rho (translation),
theta (rotation)]``, tracking retracts ``T_w2c <- exp(tau) @ T_w2c``. The
small-angle branches use the `where(small, 1, x)` guard so gradients stay
finite at theta -> 0.
"""

from __future__ import annotations

import torch

from ..utils.profiling import sync

_SMALL = 1e-8


def _hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sin_coeffs(theta: torch.Tensor):
    """(A, B, C) = (sin x / x, (1-cos x)/x^2, (x - sin x)/x^3), Taylor below _SMALL."""
    x2 = (theta * theta).sum(dim=-1)
    small = x2 < _SMALL
    x2_safe = torch.where(small, torch.ones_like(x2), x2)
    x = torch.sqrt(x2_safe)
    a = torch.where(small, 1.0 - x2 / 6.0, torch.sin(x) / x)
    b = torch.where(small, 0.5 - x2 / 24.0, (1.0 - torch.cos(x)) / x2_safe)
    c = torch.where(small, 1.0 / 6.0 - x2 / 120.0, (x - torch.sin(x)) / (x2_safe * x))
    return a, b, c


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    a, b, _ = _sin_coeffs(theta)
    k = _hat(theta)
    return _eye_like(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): (..., 3) -> (..., 3, 3)."""
    _, b, c = _sin_coeffs(theta)
    k = _hat(theta)
    return _eye_like(k) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 6) tau = [rho, theta] -> (..., 4, 4)."""
    rho, theta = tau[..., :3], tau[..., 3:]
    rot = so3_exp(theta)
    t = (so3_left_jacobian(theta) @ rho[..., None])[..., 0]
    top = torch.cat([rot, t[..., None]], dim=-1)
    with sync("se3_exp"):
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tau.dtype, device=tau.device)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_retract(tau: torch.Tensor, T_w2c: torch.Tensor) -> torch.Tensor:
    """Left retraction used by pose tracking: ``exp(tau) @ T_w2c``."""
    return se3_exp(tau) @ T_w2c

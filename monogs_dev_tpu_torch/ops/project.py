"""Gaussian projection: camera transform + EWA splatting math (port of
`monogs_dev_tpu/ops/project.py`).

3D covariance R S S^T R^T, perspective Jacobian with the 1.3x tan-FoV clamp,
cov2d = J W cov3d W^T J^T plus the +0.3 px low-pass, conic = cov2d^-1,
radius = ceil(3 sqrt(lambda_max)), pixel = f x/z + c - 0.5. Differentiable
w.r.t. `T_w2c`; pose gradients come from autograd through
``se3_exp(tau) @ T0`` at the caller.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.sh import eval_sh
from ..models.camera import Intrinsics
from ..models.gaussians import GaussianParams, activations
from ..utils.profiling import spanned, sync


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coordinates
    conic: torch.Tensor  # (N, 3) upper triangle of the inverse 2D covariance
    color: torch.Tensor  # (N, 3) view-dependent RGB (>= 0)
    opacity: torch.Tensor  # (N,) activated opacity, 0 where not valid
    depth: torch.Tensor  # (N,) camera-space z
    radii: torch.Tensor  # (N,) f32 screen radius (0 where culled)
    valid: torch.Tensor  # (N,) bool: active, in front, invertible cov


def _cov3d_components(log_scales, quats, scale_modifier):
    """3D covariance upper triangle as six (N,) tensors."""
    s0 = torch.exp(log_scales[:, 0]) * scale_modifier
    s1 = torch.exp(log_scales[:, 1]) * scale_modifier
    s2 = torch.exp(log_scales[:, 2]) * scale_modifier
    q = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    ss0, ss1, ss2 = s0 * s0, s1 * s1, s2 * s2
    c00 = r00 * r00 * ss0 + r01 * r01 * ss1 + r02 * r02 * ss2
    c01 = r00 * r10 * ss0 + r01 * r11 * ss1 + r02 * r12 * ss2
    c02 = r00 * r20 * ss0 + r01 * r21 * ss1 + r02 * r22 * ss2
    c11 = r10 * r10 * ss0 + r11 * r11 * ss1 + r12 * r12 * ss2
    c12 = r10 * r20 * ss0 + r11 * r21 * ss1 + r12 * r22 * ss2
    c22 = r20 * r20 * ss0 + r21 * r21 * ss1 + r22 * r22 * ss2
    return c00, c01, c02, c11, c12, c22


def sanitize_params(params: GaussianParams, active: torch.Tensor):
    """NaN/Inf/overflow row quarantine: such rows get inert constants and
    leave `active`, so no NaN reaches the shared pose gradients. Log-scales
    are clipped to [-20, 8] (zero gradient outside)."""
    row_ok = (
        torch.isfinite(params.xyz).all(-1)
        & torch.isfinite(params.log_scales).all(-1)
        & torch.isfinite(params.quats).all(-1)
        & torch.isfinite(params.opacity_logit)
        & torch.isfinite(params.f_dc).all(-1).all(-1)
    )
    has_rest = params.f_rest is not None and params.f_rest.numel() > 0
    if has_rest:
        row_ok = row_ok & torch.isfinite(params.f_rest).all(-1).all(-1)
    log_scales_c = torch.clamp(params.log_scales, -20.0, 8.0)
    row_ok = row_ok & (params.xyz.abs().max(dim=-1).values < 1e6)
    row_ok = row_ok & (torch.linalg.norm(params.quats, dim=-1) > 1e-3)
    ok1 = row_ok[:, None]
    with sync("sanitize"):
        unit = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=params.quats.dtype,
                            device=params.quats.device)
    zero = params.xyz.new_zeros(())
    params = params.replace(
        xyz=torch.where(ok1, params.xyz, zero),
        log_scales=torch.where(ok1, log_scales_c, zero - 10.0),
        quats=torch.where(ok1, params.quats, unit),
        opacity_logit=torch.where(row_ok, params.opacity_logit, zero - 10.0),
        f_dc=torch.where(row_ok[:, None, None], params.f_dc, zero),
        f_rest=(torch.where(row_ok[:, None, None], params.f_rest, zero)
                if has_rest else params.f_rest),
    )
    return params, active & row_ok


@spanned("project")
def project_gaussians(params: GaussianParams, active: torch.Tensor, T_w2c: torch.Tensor,
                      intr: Intrinsics, sh_degree: int, scale_modifier: float = 1.0,
                      isotropic: bool = False) -> ProjectedGaussians:
    params, active = sanitize_params(params, active)
    _, _, opacity = activations(params)
    if isotropic:
        log_scales = params.log_scales[:, :1].expand_as(params.log_scales)
    else:
        log_scales = params.log_scales

    R = T_w2c[:3, :3]
    t = T_w2c[:3, 3]
    X, Y, Z = params.xyz[:, 0], params.xyz[:, 1], params.xyz[:, 2]
    x = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + t[0]
    y = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + t[1]
    z = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + t[2]
    in_front = z > intr.znear
    z_safe = torch.where(in_front, z, torch.ones_like(z))

    fx, fy = intr.fx, intr.fy
    inv_z = 1.0 / z_safe
    means2d = torch.stack(
        [fx * x * inv_z + intr.cx - 0.5, fy * y * inv_z + intr.cy - 0.5], dim=-1
    )

    limx, limy = 1.3 * intr.tanfovx, 1.3 * intr.tanfovy
    tx = torch.clamp(x * inv_z, -limx, limx) * z_safe
    ty = torch.clamp(y * inv_z, -limy, limy) * z_safe
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    c00, c01, c02, c11, c12, c22 = _cov3d_components(log_scales, params.quats, scale_modifier)
    m00 = R[0, 0] * c00 + R[0, 1] * c01 + R[0, 2] * c02
    m01 = R[0, 0] * c01 + R[0, 1] * c11 + R[0, 2] * c12
    m02 = R[0, 0] * c02 + R[0, 1] * c12 + R[0, 2] * c22
    m10 = R[1, 0] * c00 + R[1, 1] * c01 + R[1, 2] * c02
    m11 = R[1, 0] * c01 + R[1, 1] * c11 + R[1, 2] * c12
    m12 = R[1, 0] * c02 + R[1, 1] * c12 + R[1, 2] * c22
    m20 = R[2, 0] * c00 + R[2, 1] * c01 + R[2, 2] * c02
    m21 = R[2, 0] * c01 + R[2, 1] * c11 + R[2, 2] * c12
    m22 = R[2, 0] * c02 + R[2, 1] * c12 + R[2, 2] * c22
    vw00 = m00 * R[0, 0] + m01 * R[0, 1] + m02 * R[0, 2]
    vw01 = m00 * R[1, 0] + m01 * R[1, 1] + m02 * R[1, 2]
    vw02 = m00 * R[2, 0] + m01 * R[2, 1] + m02 * R[2, 2]
    vw11 = m10 * R[1, 0] + m11 * R[1, 1] + m12 * R[1, 2]
    vw12 = m10 * R[2, 0] + m11 * R[2, 1] + m12 * R[2, 2]
    vw22 = m20 * R[2, 0] + m21 * R[2, 1] + m22 * R[2, 2]
    a = j00 * j00 * vw00 + 2.0 * j00 * j02 * vw02 + j02 * j02 * vw22
    b = j00 * j11 * vw01 + j00 * j12 * vw02 + j02 * j11 * vw12 + j02 * j12 * vw22
    c = j11 * j11 * vw11 + 2.0 * j11 * j12 * vw12 + j12 * j12 * vw22
    a = a + 0.3
    c = c + 0.3

    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    valid = active & in_front & det_ok
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    if sh_degree > 0 and params.f_rest.shape[1] > 0:
        cam_center = -R.T @ t
        dirs = params.xyz - cam_center
        # eps under the sqrt: the gradient of norm() at 0 is inf before any
        # clamp could mask it (NaN pose gradients for a row at the camera)
        n2 = (dirs * dirs).sum(dim=-1, keepdim=True)
        dirs = dirs / torch.sqrt(torch.clamp(n2, min=1e-16))
        sh = torch.cat([params.f_dc, params.f_rest], dim=1)
        color = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)
    else:
        color = torch.clamp(eval_sh(0, params.f_dc, params.xyz) + 0.5, min=0.0)

    opacity = torch.where(valid, opacity, torch.zeros_like(opacity))
    return ProjectedGaussians(means2d, conic, color, opacity, z, radius, valid)

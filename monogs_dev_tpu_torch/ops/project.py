"""Gaussian projection: camera transform + EWA splatting math (port of
`monogs_dev_tpu/ops/project.py`).

3D covariance R S S^T R^T, perspective Jacobian with the 1.3x tan-FoV clamp,
cov2d = J W cov3d W^T J^T plus the +0.3 px low-pass, conic = cov2d^-1,
radius = ceil(3 sqrt(lambda_max)), pixel = f x/z + c - 0.5. Differentiable
w.r.t. `T_w2c`; pose gradients come from autograd through
``se3_exp(tau) @ T0`` at the caller.

Two paths, chosen by the input (`uses_kernels`): on the card, where no map
field asks for a gradient and the colour is degree 0, the CUDA kernels of
`csrc/project.cu` (P1 the forward, P2 the pose gradient, in one
`torch.autograd.Function`); otherwise the eager composition
(`project_gaussians_eager`), which the kernels reproduce bit for bit. Each
call tallies `project.kernel` or `project.eager` in the active recorder.
`project_pose_vjp_plain` is P2's arithmetic in plain torch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..geometry.sh import eval_sh
from ..models.camera import Intrinsics
from ..models.gaussians import GaussianParams, activations
from ..utils.profiling import spanned, sync, tally
from . import blend as _lib

# rows a block of P1 and P2
THREADS = 256


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


class _Terms(NamedTuple):
    """The eager composition's per-row intermediates that the outputs and
    the pose gradient are made from."""

    R: torch.Tensor  # T_w2c[:3, :3]
    t: torch.Tensor  # T_w2c[:3, 3]
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    in_front: torch.Tensor
    z_safe: torch.Tensor
    inv_z: torch.Tensor
    means2d: torch.Tensor
    u: torch.Tensor  # x / z_safe, before the tan-FoV clamp
    v: torch.Tensor
    uc: torch.Tensor  # u, v clamped
    vc: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    inv_z2: torch.Tensor
    j: Tuple[torch.Tensor, ...]  # j00, j02, j11, j12
    m: Tuple[torch.Tensor, ...]  # R cov3d, row-major (9)
    vw: Tuple[torch.Tensor, ...]  # vw00, vw01, vw02, vw11, vw12, vw22
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    det: torch.Tensor
    det_ok: torch.Tensor
    det_safe: torch.Tensor
    conic: torch.Tensor


def _terms(params: GaussianParams, T_w2c: torch.Tensor, intr: Intrinsics,
           scale_modifier: float, isotropic: bool) -> _Terms:
    """The camera transform through the conic, on sanitized params. The ops
    run in the order that fixes autograd's order of accumulation."""
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
    u = x * inv_z
    uc = torch.clamp(u, -limx, limx)
    tx = uc * z_safe
    v = y * inv_z
    vc = torch.clamp(v, -limy, limy)
    ty = vc * z_safe
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
    return _Terms(R, t, x, y, z, in_front, z_safe, inv_z, means2d, u, v, uc, vc, tx, ty, inv_z2,
                  (j00, j02, j11, j12), (m00, m01, m02, m10, m11, m12, m20, m21, m22),
                  (vw00, vw01, vw02, vw11, vw12, vw22), a, b, c, det, det_ok, det_safe, conic)


def project_gaussians_eager(params: GaussianParams, active: torch.Tensor, T_w2c: torch.Tensor,
                            intr: Intrinsics, sh_degree: int, scale_modifier: float = 1.0,
                            isotropic: bool = False) -> ProjectedGaussians:
    """The projection as eager torch ops; autograd gives every gradient."""
    params, active = sanitize_params(params, active)
    _, _, opacity = activations(params)
    k = _terms(params, T_w2c, intr, scale_modifier, isotropic)
    a, c = k.a, k.c
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - k.det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    valid = active & k.in_front & k.det_ok
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    if sh_degree > 0 and params.f_rest.shape[1] > 0:
        cam_center = -k.R.T @ k.t
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
    return ProjectedGaussians(k.means2d, k.conic, color, opacity, k.z, radius, valid)


def project_pose_vjp_plain(params: GaussianParams, T_w2c: torch.Tensor, intr: Intrinsics,
                           g_means2d: Optional[torch.Tensor], g_conic: Optional[torch.Tensor],
                           g_depth: Optional[torch.Tensor], scale_modifier: float = 1.0,
                           isotropic: bool = False) -> torch.Tensor:
    """P2's arithmetic in plain torch: dL/dT_w2c (4, 4), bottom row zero,
    from the upstream gradients of means2d (N, 2), conic (N, 3) and depth
    (N,) (None: zero), as autograd of `project_gaussians_eager` gives it.
    Colour and opacity do not depend on the pose at degree 0, nor does any
    output through `active`."""
    params, _ = sanitize_params(params, torch.ones_like(params.opacity_logit, dtype=torch.bool))
    k = _terms(params, T_w2c, intr, scale_modifier, isotropic)
    zero = torch.zeros_like(k.z)
    gmx, gmy = (zero, zero) if g_means2d is None else g_means2d.unbind(-1)
    g0, g1, g2 = (zero,) * 3 if g_conic is None else g_conic.unbind(-1)
    gz = zero if g_depth is None else g_depth
    fx, fy = intr.fx, intr.fy
    limx, limy = 1.3 * intr.tanfovx, 1.3 * intr.tanfovy
    a, b, c = k.a, k.b, k.c
    j00, j02, j11, j12 = k.j
    vw00, vw01, vw02, vw11, vw12, vw22 = k.vw

    # conic = (c, -b, a) / det_safe; det_safe = det where det > 0, else 1
    ids = 1.0 / k.det_safe
    ddet = torch.where(k.det_ok, -(g0 * c - g1 * b + g2 * a) * ids * ids, zero)
    da = g2 * ids + ddet * c
    db = -g1 * ids - 2.0 * b * ddet
    dc = g0 * ids + ddet * a
    # (a, b, c) -> J entries; S = G + G^T for G the gradient of the VW entries
    dj00 = 2.0 * da * (j00 * vw00 + j02 * vw02) + db * (j11 * vw01 + j12 * vw02)
    dj02 = 2.0 * da * (j00 * vw02 + j02 * vw22) + db * (j11 * vw12 + j12 * vw22)
    dj11 = db * (j00 * vw01 + j02 * vw12) + 2.0 * dc * (j11 * vw11 + j12 * vw12)
    dj12 = db * (j00 * vw02 + j02 * vw22) + 2.0 * dc * (j11 * vw12 + j12 * vw22)
    s00 = 2.0 * da * j00 * j00
    s11 = 2.0 * dc * j11 * j11
    s22 = 2.0 * (da * j02 * j02 + db * j02 * j12 + dc * j12 * j12)
    s01 = db * j00 * j11
    s02 = 2.0 * da * j00 * j02 + db * j00 * j12
    s12 = db * j02 * j11 + 2.0 * dc * j11 * j12
    S = torch.stack([s00, s01, s02, s01, s11, s12, s02, s12, s22], -1).reshape(-1, 3, 3)
    M = torch.stack(k.m, -1).reshape(-1, 3, 3)
    dR = torch.einsum("nij,njk->ik", S, M)

    # J entries -> (x, y, z) through 1/z_safe and the clamped t_x, t_y
    diz = fx * dj00 + fy * dj11
    diz2 = -fx * k.tx * dj02 - fy * k.ty * dj12
    dtx, dty = -fx * k.inv_z2 * dj02, -fy * k.inv_z2 * dj12
    diz = diz + 2.0 * k.inv_z * diz2
    dzs = k.uc * dtx + k.vc * dty
    du = torch.where((k.u >= -limx) & (k.u <= limx), k.z_safe * dtx, zero)
    dv = torch.where((k.v >= -limy) & (k.v <= limy), k.z_safe * dty, zero)
    dx = k.inv_z * du + fx * k.inv_z * gmx
    dy = k.inv_z * dv + fy * k.inv_z * gmy
    diz = diz + k.x * du + k.y * dv + fx * k.x * gmx + fy * k.y * gmy
    dzs = dzs - k.inv_z * k.inv_z * diz
    dz = gz + torch.where(k.in_front, dzs, zero)
    dxyz = torch.stack([dx, dy, dz], -1)  # (N, 3)
    dR = dR + dxyz.T @ params.xyz
    dT = torch.zeros_like(T_w2c)
    dT[:3, :3] = dR
    dT[:3, 3] = dxyz.sum(0)
    return dT


def uses_kernels(params: GaussianParams, sh_degree: int) -> bool:
    """Whether P1/P2 compute this projection: the map on the card, no map
    field asking for a gradient (under grad mode), colour of degree 0
    (`sh_degree` 0, or no rest coefficients). The launchers raise on a
    tensor of another dtype or device."""
    if not params.xyz.is_cuda:
        return False
    if torch.is_grad_enabled() and any(f.requires_grad for f in params.values()):
        return False
    return sh_degree == 0 or params.f_rest.shape[1] == 0


def _cam_args(intr: Intrinsics, scale_modifier: float, isotropic: bool) -> tuple:
    return (float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy), float(intr.znear),
            1.3 * intr.tanfovx, 1.3 * intr.tanfovy, float(scale_modifier), int(bool(isotropic)))


def _check(x: torch.Tensor, name: str, dtype, shape, dev: torch.device) -> None:
    """`ops/blend.py`'s check of a kernel input, and the map's card."""
    _lib._check(x, name, dtype, shape)
    if x.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {x.device}")


def _row_fields(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest) -> Tuple[int, int]:
    """Check the pose and the map fields that P1 and P2 read; returns
    (rows, rest floats a row)."""
    n = xyz.shape[0]
    n_rest = f_rest.shape[1] * 3
    f32, dev = torch.float32, xyz.device
    _check(xyz, "xyz", f32, (n, 3), dev)
    _check(T_w2c, "T_w2c", f32, (4, 4), dev)
    _check(log_scales, "log_scales", f32, (n, 3), dev)
    _check(quats, "quats", f32, (n, 4), dev)
    _check(opacity_logit, "opacity_logit", f32, (n,), dev)
    _check(f_dc, "f_dc", f32, (n, 1, 3), dev)
    _check(f_rest, "f_rest", f32, (n, n_rest // 3, 3), dev)
    return n, n_rest


def _threads(threads: int) -> int:
    if threads <= 0 or threads % 32:
        raise ValueError(f"threads must be a positive multiple of 32, got {threads}")
    return threads


def project_fwd_launcher(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest, active,
                     intr: Intrinsics, scale_modifier: float = 1.0, isotropic: bool = False,
                     threads: int = THREADS) -> Tuple[Callable[[], None], ProjectedGaussians]:
    """Check P1's inputs and allocate its outputs; returns (launch,
    outputs): `launch()` runs P1 into them on the current stream through its
    C entry point and raises if the launch fails. It counts no launch."""
    n, n_rest = _row_fields(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest)
    _check(active, "active", torch.bool, (n,), xyz.device)
    fn = _lib._load().project_fwd
    dev = xyz.device
    out = ProjectedGaussians(
        means2d=torch.empty((n, 2), dtype=torch.float32, device=dev),
        conic=torch.empty((n, 3), dtype=torch.float32, device=dev),
        color=torch.empty((n, 3), dtype=torch.float32, device=dev),
        opacity=torch.empty((n,), dtype=torch.float32, device=dev),
        depth=torch.empty((n,), dtype=torch.float32, device=dev),
        radii=torch.empty((n,), dtype=torch.float32, device=dev),
        valid=torch.empty((n,), dtype=torch.bool, device=dev),
    )
    args = (T_w2c.data_ptr(), xyz.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
            opacity_logit.data_ptr(), f_dc.data_ptr(), f_rest.data_ptr(), n_rest,
            active.data_ptr(), n, *_cam_args(intr, scale_modifier, isotropic), _threads(threads),
            *(x.data_ptr() for x in out), torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> None:
        _lib._raise_on(fn(*args), "project_fwd")

    return launch, out


def project_bwd_launcher(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest,
                      g_means2d, g_conic, g_depth, intr: Intrinsics,
                      scale_modifier: float = 1.0, isotropic: bool = False,
                      threads: int = THREADS) -> Tuple[Callable[[], None], torch.Tensor]:
    """P2's counterpart of `project_fwd_launcher`: checks the inputs (each
    upstream gradient may be None: zero), allocates the partial rows and
    dL/dT_w2c (4, 4), and returns (launch, dT)."""
    n, n_rest = _row_fields(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest)
    for g, name, shape in ((g_means2d, "g_means2d", (n, 2)), (g_conic, "g_conic", (n, 3)),
                           (g_depth, "g_depth", (n,))):
        if g is not None:
            _check(g, name, torch.float32, shape, xyz.device)
    fn = _lib._load().project_bwd_pose
    dev = xyz.device
    threads = _threads(threads)
    partial = torch.empty((-(-n // threads), 12), dtype=torch.float64, device=dev)
    dT = torch.empty((4, 4), dtype=torch.float32, device=dev)
    args = (T_w2c.data_ptr(), xyz.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
            opacity_logit.data_ptr(), f_dc.data_ptr(), f_rest.data_ptr(), n_rest, n,
            *_cam_args(intr, scale_modifier, isotropic), threads,
            *(None if g is None else g.data_ptr() for g in (g_means2d, g_conic, g_depth)),
            partial.data_ptr(), dT.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> None:
        _lib._raise_on(fn(*args), "project_bwd_pose")

    return launch, dT


class _ProjectCuda(torch.autograd.Function):
    """P1 forward; the pose gradient by P2. Colour, opacity, radii and valid
    do not depend on the pose at degree 0: they are marked
    non-differentiable, and their gradients are accepted and ignored."""

    @staticmethod
    def forward(ctx, T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest, active, cam):
        intr, scale_modifier, isotropic = cam
        launch, out = project_fwd_launcher(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc,
                                       f_rest, active, intr, scale_modifier, isotropic)
        launch()
        _lib.count_launch("P1")
        ctx.save_for_backward(T_w2c, xyz, log_scales, quats, opacity_logit, f_dc, f_rest)
        ctx.cam = cam
        ctx.mark_non_differentiable(out.color, out.opacity, out.radii, out.valid)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_means2d, g_conic, g_color, g_opacity, g_depth, g_radii, g_valid):
        if g_means2d is None and g_conic is None and g_depth is None:
            return (None,) * 9
        intr, scale_modifier, isotropic = ctx.cam
        launch, dT = project_bwd_launcher(
            *ctx.saved_tensors, *(None if g is None else g.contiguous()
                                  for g in (g_means2d, g_conic, g_depth)),
            intr, scale_modifier, isotropic)
        launch()
        _lib.count_launch("P2")
        return (dT,) + (None,) * 8


def project_gaussians_cuda(params: GaussianParams, active: torch.Tensor, T_w2c: torch.Tensor,
                           intr: Intrinsics, scale_modifier: float = 1.0,
                           isotropic: bool = False) -> ProjectedGaussians:
    """P1 (P2 for the pose gradient) on card tensors; the map's fields get
    no gradient."""
    fields = [x.contiguous() for x in (T_w2c, params.xyz, params.log_scales, params.quats,
                                       params.opacity_logit, params.f_dc, params.f_rest)]
    out = _ProjectCuda.apply(*fields, active.contiguous(), (intr, scale_modifier, isotropic))
    return ProjectedGaussians(*out)


@spanned("project")
def project_gaussians(params: GaussianParams, active: torch.Tensor, T_w2c: torch.Tensor,
                      intr: Intrinsics, sh_degree: int, scale_modifier: float = 1.0,
                      isotropic: bool = False) -> ProjectedGaussians:
    if uses_kernels(params, sh_degree):
        tally("project.kernel")
        return project_gaussians_cuda(params, active, T_w2c, intr, scale_modifier, isotropic)
    tally("project.eager")
    return project_gaussians_eager(params, active, T_w2c, intr, sh_degree, scale_modifier,
                                   isotropic)

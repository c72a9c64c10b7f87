"""Gauss-Newton / Levenberg-Marquardt camera tracking (port of
`monogs_dev_tpu/core/tracking_gn.py`; the residual model and Jacobians are
derived in that module's docstring).

Each iteration renders forward only (no backward through the rasterizer),
builds the 8x8 normal equations over [rho, theta, exposure a, b] from an
image-space linearization, and takes a damped step. The JAX package's
`lax.while_loop`s are Python loops here: the stop tests read one scalar per
iteration back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..geometry.lie import se3_exp
from ..models.camera import Intrinsics
from ..ops.project import project_gaussians
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import build_binning, compact_binning, render_binned, render_tiled
from ..utils.losses import compute_grad_mask, image_gradient, median_depth, tracking_loss
from .params import StepConfig
from .tracking import TrackResult, pyramid_levels, tile_mask_of

_HUBER_RGB = 0.05
_HUBER_DEPTH = 0.05
_LM_MIN, _LM_MAX = 1e-5, 1e2


@dataclasses.dataclass
class GNLevel:
    """Per-pyramid-level constants of the tracking loop."""

    image: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W)
    mask: torch.Tensor  # (H, W) bool edge mask
    intr: Intrinsics
    max_iters: int
    tile_mask: torch.Tensor  # (n_tiles,) tiles that hold a masked pixel
    gx_obs: torch.Tensor  # observed-image gradients (ESM half)
    gy_obs: torch.Tensor
    xn: torch.Tensor  # (H, W) x/z per pixel
    yn: torch.Tensor
    rgb_base: torch.Tensor  # (H, W) bool


def make_level(image, depth, mask, intr: Intrinsics, max_iters: int,
               cfg: StepConfig, raster_cfg: RasterConfig) -> GNLevel:
    tile_mask = tile_mask_of(mask, intr, raster_cfg)
    gx_obs, gy_obs = image_gradient(image)
    vv, uu = torch.meshgrid(
        torch.arange(intr.height, dtype=torch.float32, device=image.device),
        torch.arange(intr.width, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    return GNLevel(
        image=image, depth=depth, mask=mask, intr=intr, max_iters=max_iters,
        tile_mask=tile_mask, gx_obs=gx_obs, gy_obs=gy_obs,
        xn=(uu + 0.5 - intr.cx) / intr.fx, yn=(vv + 0.5 - intr.cy) / intr.fy,
        rgb_base=(image.sum(dim=-1) > cfg.rgb_boundary_threshold) & mask,
    )


def normal_equations(lv: GNLevel, out, exp_ab: torch.Tensor, cfg: StepConfig,
                     use_depth: bool, opt_exposure: bool):
    """H (8, 8) and g (8,) of the IRLS-weighted residuals at the current render."""
    intr = lv.intr
    alpha_r = out.alpha
    z = out.depth / torch.clamp(alpha_r, min=1e-5)
    geom_ok = (alpha_r > 0.5) & (z > intr.znear)
    z_s = torch.where(geom_ok, z, torch.ones_like(z))
    inv_z = 1.0 / z_s
    xn, yn = lv.xn, lv.yn
    X = xn * z_s
    Y = yn * z_s
    fxz = intr.fx * inv_z
    fyz = intr.fy * inv_z
    ju0 = fxz
    ju2 = -fxz * xn
    ju_t0 = ju2 * Y
    ju_t1 = fxz * z_s + ju2 * (-X)
    ju_t2 = fxz * (-Y)
    jv1 = fyz
    jv2 = -fyz * yn
    jv_t0 = -fyz * z_s + jv2 * Y
    jv_t1 = jv2 * (-X)
    jv_t2 = fyz * X
    zero = torch.zeros_like(ju0)
    j_u = torch.stack([ju0, zero, ju2, ju_t0, ju_t1, ju_t2], -1)
    j_v = torch.stack([zero, jv1, jv2, jv_t0, jv_t1, jv_t2], -1)

    ea = torch.exp(exp_ab[0])
    r_rgb = ea * out.color + exp_ab[1] - lv.image
    gx_r, gy_r = image_gradient(out.color)
    gx = 0.5 * (ea * gx_r + lv.gx_obs)
    gy = 0.5 * (ea * gy_r + lv.gy_obs)
    j_pose = -(gx[..., None] * j_u[..., None, :] + gy[..., None] * j_v[..., None, :])
    if opt_exposure:
        j_a = ea * out.color
        j_b = torch.ones_like(j_a)
    else:
        j_a = torch.zeros_like(out.color)
        j_b = torch.zeros_like(out.color)
    j_rgb = torch.cat([j_pose, j_a[..., None], j_b[..., None]], dim=-1)  # (H, W, 3, 8)

    w_irls = 1.0 / torch.sqrt(1.0 + (r_rgb / _HUBER_RGB) ** 2)
    rgb_f = lv.rgb_base.to(torch.float32)
    w_rgb = (alpha_r * rgb_f * geom_ok)[..., None] * w_irls
    n_rgb = torch.clamp(rgb_f.sum() * 3.0, min=1.0)
    depth_on = use_depth and not cfg.monocular
    w_rgb = w_rgb * ((cfg.alpha if depth_on else 1.0) / n_rgb)
    jw = j_rgb * w_rgb[..., None]
    H = torch.einsum("hwci,hwcj->ij", jw, j_rgb)
    g = torch.einsum("hwci,hwc->i", jw, r_rgb)

    if depth_on:
        d_mask = (lv.depth > 0.0) & (alpha_r > 0.95) & lv.mask & geom_ok
        r_d = z - lv.depth
        gzx, gzy = image_gradient(z[..., None])
        j_zwarp = -(gzx[..., 0:1] * j_u + gzy[..., 0:1] * j_v)
        j_zmotion = torch.stack([zero, zero, torch.ones_like(X), Y, -X, zero], -1)
        j_d = torch.cat([j_zmotion + j_zwarp, torch.zeros(z.shape + (2,), device=z.device)], -1)
        # depth-discontinuity downweight (sigma = 5 cm/px)
        g2 = gzx[..., 0] ** 2 + gzy[..., 0] ** 2
        w_edge = 0.0025 / (0.0025 + g2)
        w_d = w_edge * d_mask.to(torch.float32) / torch.sqrt(1.0 + (r_d / _HUBER_DEPTH) ** 2)
        n_d = torch.clamp(d_mask.to(torch.float32).sum(), min=1.0)
        w_d = w_d * ((1.0 - cfg.alpha) / n_d)
        jwd = j_d * w_d[..., None]
        H = H + torch.einsum("hwi,hwj->ij", jwd, j_d)
        g = g + torch.einsum("hwi,hw->i", jwd, r_d)
    return H, g


def track_frame_gn(params, active, T_init, exposure_init, image, depth_gt, grad_mask,
                   bg_color, cfg: StepConfig, intr: Intrinsics, raster_cfg: RasterConfig,
                   use_depth: bool) -> TrackResult:
    """Track one frame from `T_init`; returns the best evaluated pose."""
    dev = image.device
    if grad_mask is None:
        grad_mask = compute_grad_mask(image, cfg.edge_threshold, cfg.per_block_mask)
    opt_exposure = cfg.exposure_lr > 0.0
    n = active.shape[0]

    raw_levels = pyramid_levels(image, depth_gt, grad_mask, intr, cfg)
    T = torch.as_tensor(T_init, dtype=torch.float32, device=dev)
    ab = torch.as_tensor(exposure_init, dtype=torch.float32, device=dev)
    best_T, best_ab = T, ab
    compact_dropped = 0
    n_binned = 0
    total_iters = 0
    converged = False
    eye8 = torch.eye(8, device=dev)

    with torch.no_grad():
        for img_l, dep_l, msk_l, intr_l, max_iters in raw_levels:
            lv = make_level(img_l, dep_l, msk_l, intr_l, max_iters, cfg, raster_cfg)
            lam = cfg.gn_lm_init
            itr = 0
            converged = False
            best_loss = math.inf
            best_T, best_ab = T, ab
            stall = 0
            while itr < max_iters and not converged:
                # outer: rebin (and optionally compact) at the current pose
                proj = project_gaussians(params, active, T, intr_l, cfg.sh_degree)
                binning = build_binning(proj, intr_l, raster_cfg, dilate=cfg.rebin_dilation)
                flat_slots = binning.idx_table.shape[0] * binning.idx_table.shape[1]
                n_binned = max(n_binned, int((binning.pos_table < flat_slots).any(dim=1).sum()))
                m = cfg.track_compact
                if 0 < m < n:
                    sel, binning, dropped = compact_binning(binning, n, m)
                    sel_c = torch.clamp(sel, 0, n - 1)
                    params_x = params.map(lambda x: x[sel_c])
                    active_x = active[sel_c] & (sel < n)
                    compact_dropped = max(compact_dropped, int(dropped))
                else:
                    params_x, active_x = params, active
                start_itr = itr
                while itr < max_iters and not converged and itr < start_itr + cfg.rebin_every:
                    proj = project_gaussians(params_x, active_x, T, intr_l, cfg.sh_degree)
                    out = render_binned(proj, proj.means2d, binning, intr_l, bg_color,
                                        raster_cfg, need_touched=False,
                                        tile_mask=lv.tile_mask)
                    loss = float(tracking_loss(
                        out.color, out.depth, out.alpha, lv.image,
                        lv.depth if use_depth else None, ab, lv.mask, cfg.monocular,
                        cfg.alpha, cfg.rgb_boundary_threshold,
                    ))
                    worse = loss > best_loss * (1.0 + 1e-6)
                    # revert-on-worse: back to the best state, more damping;
                    # the normal equations still come from this render
                    T_cur, ab_cur = (best_T, best_ab) if worse else (T, ab)
                    lam = min(lam * 4.0, _LM_MAX) if worse else max(lam * 0.5, _LM_MIN)
                    H, g = normal_equations(lv, out, ab_cur, cfg, use_depth, opt_exposure)
                    D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
                    step = torch.linalg.solve(H + lam * D + 1e-8 * eye8, -g)
                    if not opt_exposure:
                        step = torch.cat([step[:6], torch.zeros_like(step[6:])])
                    tau = step[:6]
                    T_new = se3_exp(tau) @ T_cur
                    ab_new = ab_cur + step[6:]
                    if loss <= best_loss:
                        best_T, best_ab = T, ab
                    improved = loss < best_loss * (1.0 - cfg.plateau_rel_tol)
                    best_loss = min(best_loss, loss)
                    converged = float(torch.linalg.norm(tau)) < cfg.convergence_threshold
                    if cfg.plateau_iters > 0:
                        stall = 0 if improved else stall + 1
                        converged = converged or stall >= cfg.plateau_iters
                    T, ab = T_new, ab_new
                    itr += 1
            total_iters += itr  # the next level starts from the last proposal

        out = render_tiled(params, active, best_T, intr, cfg.sh_degree, bg_color, raster_cfg)
        med, _, _ = median_depth(out.depth, out.alpha)
    return TrackResult(
        T_w2c=best_T, exposure_ab=best_ab, n_iters=total_iters, converged=converged,
        color=out.color, depth=out.depth, opacity=out.alpha, touched=out.n_touched > 0,
        median_depth=med, dup_overflow=out.dup_overflow, tile_overflow=out.tile_overflow,
        compact_dropped=compact_dropped, n_binned=n_binned,
    )

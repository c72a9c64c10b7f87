"""Camera tracking with Adam through the rasterizer (port of
`monogs_dev_tpu/core/tracking.py`), plus the tracking result type and the
image-pyramid helpers that the Gauss-Newton tracker shares.

Each iteration takes the gradient of the tracking loss with respect to a
pose tangent tau (at zero) and the exposure, through the composed
``se3_exp(tau) @ T``, the projection and the blend (K1 forward, K2
backward on the card); applies an Adam step in the JAX body's order
(torch.optim.Adam defaults, eps 1e-8); and retracts ``T <- exp(-step) @
T``. It stops on ``||tau|| < convergence_threshold`` or, with
`plateau_iters` > 0, on a loss plateau. The JAX package's
`lax.while_loop`s are Python loops here: the stop test reads one vector
back to the host per iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry.lie import se3_exp
from ..models.camera import Intrinsics
from ..ops.project import project_gaussians
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import build_binning, compact_binning, render_binned, render_tiled, tile_wh
from ..utils.losses import compute_grad_mask, median_depth, tracking_loss
from .params import StepConfig

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # torch.optim.Adam defaults


class TrackResult(NamedTuple):
    T_w2c: torch.Tensor  # (4, 4) final pose
    exposure_ab: torch.Tensor  # (2,)
    n_iters: int
    converged: bool
    color: torch.Tensor  # (H, W, 3) render at the final pose
    depth: torch.Tensor  # (H, W)
    opacity: torch.Tensor  # (H, W)
    touched: torch.Tensor  # (N,) bool, n_touched > 0
    median_depth: torch.Tensor  # ()
    dup_overflow: torch.Tensor  # () telemetry of the final render
    tile_overflow: torch.Tensor  # ()
    compact_dropped: int  # max working-set drop over rebinnings
    n_binned: int  # max Gaussians with tile entries over rebinnings


def _halve_image(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, (H, W, C) or (H, W)."""
    h, w = x.shape[:2]
    c = tuple(x.shape[2:])
    return x.reshape((h // 2, 2, w // 2, 2) + c).mean(dim=(1, 3))


def _halve_depth(d: torch.Tensor) -> torch.Tensor:
    """2x2 pool averaging only valid (> 0) depths."""
    h, w = d.shape
    blocks = d.reshape(h // 2, 2, w // 2, 2)
    n = (blocks > 0.0).to(d.dtype).sum(dim=(1, 3))
    return torch.where(n > 0, blocks.sum(dim=(1, 3)) / torch.clamp(n, min=1.0),
                       torch.zeros_like(n))


def _halve_mask(m: torch.Tensor) -> torch.Tensor:
    """2x2 any-pool for boolean masks."""
    h, w = m.shape
    return m.reshape(h // 2, 2, w // 2, 2).any(dim=3).any(dim=1)


def _scale_intrinsics(intr: Intrinsics, k: int) -> Intrinsics:
    """Intrinsics after k 2x halvings; with pix = f x/z + c - 0.5 a 2x2
    average pool maps exactly to (f/2, c/2)."""
    s = 1 / (1 << k)
    return Intrinsics(
        fx=intr.fx * s, fy=intr.fy * s, cx=intr.cx * s, cy=intr.cy * s,
        width=intr.width >> k, height=intr.height >> k,
        znear=intr.znear, zfar=intr.zfar,
    )


def pyramid_levels(image, depth, mask, intr: Intrinsics, cfg: StepConfig):
    """[(image, depth, mask, intr, max_iters)] from coarse to fine: the full
    frame with `tracking_max_iters`, and `pyramid_levels` exact 2x poolings
    with `pyramid_coarse_iters` each."""
    if cfg.pyramid_levels > 0:
        div = 1 << cfg.pyramid_levels
        if intr.height % div or intr.width % div:
            raise ValueError(
                f"tracking_pyramid_levels={cfg.pyramid_levels} requires image "
                f"dims divisible by {div}, got {intr.height}x{intr.width}; "
                "crop/pad the input or lower the level count"
            )
    levels = [(image, depth, mask, intr, cfg.tracking_max_iters)]
    for k in range(1, cfg.pyramid_levels + 1):
        image, depth, mask = _halve_image(image), _halve_depth(depth), _halve_mask(mask)
        levels.append((image, depth, mask, _scale_intrinsics(intr, k), cfg.pyramid_coarse_iters))
    return levels[::-1]


def tile_mask_of(mask: torch.Tensor, intr: Intrinsics, raster_cfg: RasterConfig) -> torch.Tensor:
    """(n_tiles,) bool: the tiles that hold an edge-mask pixel. The tracking
    loss reads masked pixels only, so the other tiles blend as background."""
    tw, th = tile_wh(raster_cfg)
    tx_n = -(-intr.width // tw)
    ty_n = -(-intr.height // th)
    m_pad = torch.zeros((ty_n * th, tx_n * tw), dtype=torch.bool, device=mask.device)
    m_pad[: intr.height, : intr.width] = mask
    return m_pad.reshape(ty_n, th, tx_n, tw).any(dim=3).any(dim=1).reshape(-1)


def pose_loss(tau, exp_ab, T, params, active, binning, image, depth, mask, tile_mask,
              bg_color, cfg: StepConfig, intr: Intrinsics, raster_cfg: RasterConfig,
              use_depth: bool) -> torch.Tensor:
    """The tracking loss at pose ``se3_exp(tau) @ T`` against a prebuilt
    binning (the JAX body's `loss_fn`)."""
    T_new = se3_exp(tau) @ T
    proj = project_gaussians(params, active, T_new, intr, cfg.sh_degree)
    out = render_binned(proj, proj.means2d, binning, intr, bg_color, raster_cfg,
                        need_touched=False, tile_mask=tile_mask)
    return tracking_loss(out.color, out.depth, out.alpha, image, depth if use_depth else None,
                         exp_ab, mask, cfg.monocular, cfg.alpha, cfg.rgb_boundary_threshold)


def pose_gradient(T, exp_ab, params, active, binning, image, depth, mask, tile_mask, bg_color,
                  cfg: StepConfig, intr: Intrinsics, raster_cfg: RasterConfig, use_depth: bool):
    """(loss, gradient (8,)) of `pose_loss` at tau = 0 with respect to
    [tau (6), exposure (2)]; autograd builds no gradient for the map."""
    tau = torch.zeros(6, device=T.device, requires_grad=True)
    ab = exp_ab.detach().requires_grad_(True)
    loss = pose_loss(tau, ab, T, params, active, binning, image, depth, mask, tile_mask,
                     bg_color, cfg, intr, raster_cfg, use_depth)
    return loss.detach(), torch.cat(torch.autograd.grad(loss, (tau, ab)))


def track_frame(params, active, T_init, exposure_init, image, depth_gt, grad_mask,
                bg_color, cfg: StepConfig, intr: Intrinsics, raster_cfg: RasterConfig,
                use_depth: bool) -> TrackResult:
    """Track one frame from `T_init` with Adam on the pose tangent and the
    exposure; returns the last pose, as the JAX package does."""
    dev = image.device
    if grad_mask is None:
        grad_mask = compute_grad_mask(image, cfg.edge_threshold, cfg.per_block_mask)
    lr = torch.tensor([cfg.cam_trans_lr] * 3 + [cfg.cam_rot_lr] * 3 + [cfg.exposure_lr] * 2,
                      device=dev)
    b1 = torch.tensor(_ADAM_B1, device=dev)
    b2 = torch.tensor(_ADAM_B2, device=dev)
    n = active.shape[0]
    T = torch.as_tensor(T_init, dtype=torch.float32, device=dev)
    exp_ab = torch.as_tensor(exposure_init, dtype=torch.float32, device=dev)
    compact_dropped = n_binned = total_iters = 0
    converged = False

    for img_l, dep_l, msk_l, intr_l, max_iters in pyramid_levels(image, depth_gt, grad_mask,
                                                                 intr, cfg):
        tile_mask = tile_mask_of(msk_l, intr_l, raster_cfg)
        # fresh optimizer state and iteration budget per level
        mu = torch.zeros(8, device=dev)
        nu = torch.zeros(8, device=dev)
        itr = 0
        converged = False
        best_loss, stall = math.inf, 0
        while itr < max_iters and not converged:
            # rebin at the current pose with a drift margin, then run up to
            # rebin_every iterations against the fixed binning
            with torch.no_grad():
                proj = project_gaussians(params, active, T, intr_l, cfg.sh_degree)
                binning = build_binning(proj, intr_l, raster_cfg, dilate=cfg.rebin_dilation)
                flat_slots = binning.idx_table.shape[0] * binning.idx_table.shape[1]
                n_binned = max(n_binned,
                               int((binning.pos_table < flat_slots).any(dim=1).sum()))
                m = cfg.track_compact
                if 0 < m < n:
                    # the iteration working set: the <= m Gaussians with tile
                    # entries (exact when nothing is dropped; drops counted)
                    sel, binning, dropped = compact_binning(binning, n, m)
                    sel_c = torch.clamp(sel, 0, n - 1)
                    params_x = params.map(lambda x: x[sel_c])
                    active_x = active[sel_c] & (sel < n)
                    compact_dropped = max(compact_dropped, int(dropped))
                else:
                    params_x, active_x = params, active
            start_itr = itr
            while itr < max_iters and not converged and itr < start_itr + cfg.rebin_every:
                loss, g = pose_gradient(T, exp_ab, params_x, active_x, binning, img_l, dep_l,
                                        msk_l, tile_mask, bg_color, cfg, intr_l, raster_cfg,
                                        use_depth)
                with torch.no_grad():
                    itr += 1
                    mu = _ADAM_B1 * mu + (1.0 - _ADAM_B1) * g
                    nu = _ADAM_B2 * nu + (1.0 - _ADAM_B2) * g * g
                    c1 = 1.0 - b1 ** itr
                    c2 = 1.0 - b2 ** itr
                    step = lr * (mu / c1) / (torch.sqrt(nu / c2) + _ADAM_EPS)
                    tau_new = -step[:6]
                    exp_ab = exp_ab - step[6:]
                    T = se3_exp(tau_new) @ T
                    # the one host read of the iteration: the stop tests
                    tau_norm, loss_v = torch.stack([torch.linalg.norm(tau_new), loss]).tolist()
                converged = tau_norm < cfg.convergence_threshold
                if cfg.plateau_iters > 0:
                    # loss-plateau exit (plateau_iters = 0 keeps the
                    # reference's ||tau|| test alone)
                    stall = 0 if loss_v < best_loss * (1.0 - cfg.plateau_rel_tol) else stall + 1
                    best_loss = min(best_loss, loss_v)
                    converged = converged or stall >= cfg.plateau_iters
        total_iters += itr

    with torch.no_grad():
        out = render_tiled(params, active, T, intr, cfg.sh_degree, bg_color, raster_cfg)
        med, _, _ = median_depth(out.depth, out.alpha)
    return TrackResult(
        T_w2c=T, exposure_ab=exp_ab, n_iters=total_iters, converged=converged,
        color=out.color, depth=out.depth, opacity=out.alpha, touched=out.n_touched > 0,
        median_depth=med, dup_overflow=out.dup_overflow, tile_overflow=out.tile_overflow,
        compact_dropped=compact_dropped, n_binned=n_binned,
    )

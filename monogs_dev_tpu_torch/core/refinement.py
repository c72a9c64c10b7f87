"""Post-hoc photometric colour refinement, run in eval mode only (port of
`monogs_dev_tpu/core/refinement.py`).

Classic 3DGS refinement over the keyframes: one random keyframe per
iteration, loss (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM), Adam on the
map only (no pose, no densify), the xyz learning rate scheduled by the
refinement-local iteration. The host draws the keyframes in chunks from
`np.random.default_rng(0)`, as the JAX package does, so both packages
refine on the same frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.camera import Intrinsics
from ..models.gaussians import GaussianMap, GaussianParams, adam_step, exponential_lr
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_tiled
from ..utils.logging import Log
from ..utils.losses import l1_loss, ssim
from .params import MapOptConfig, StepConfig


def refine_chunk(gmap: GaussianMap, images: torch.Tensor, poses: torch.Tensor, start_iter: int,
                 bg_color: torch.Tensor, cfg: StepConfig, opt_cfg: MapOptConfig,
                 intr: Intrinsics, raster_cfg: RasterConfig) -> Tuple[GaussianMap, int]:
    """One refinement iteration per frame of `images` (K, H, W, 3) at
    `poses` (K, 4, 4); returns the map and the refinement-local iteration."""
    it = start_iter
    for img, T in zip(images, poses):
        it += 1
        params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
        out = render_tiled(params, gmap.aux.active, T, intr, cfg.sh_degree, bg_color,
                           raster_cfg, need_touched=False)
        loss = (1.0 - opt_cfg.lambda_dssim) * l1_loss(out.color, img) + opt_cfg.lambda_dssim * (
            1.0 - ssim(out.color, img))
        leaves = params.values()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = GaussianParams(*[torch.zeros_like(x) if g is None else g
                                 for x, g in zip(leaves, grads)])
        with torch.no_grad():
            xyz_lr = exponential_lr(
                it,
                opt_cfg.position_lr_init * opt_cfg.spatial_lr_scale,
                opt_cfg.position_lr_final * opt_cfg.spatial_lr_scale,
                lr_delay_mult=opt_cfg.position_lr_delay_mult,
                max_steps=opt_cfg.position_lr_max_steps,
            )
            lrs = GaussianParams(xyz_lr, opt_cfg.feature_lr, opt_cfg.feature_lr / 20.0,
                                 opt_cfg.scaling_lr, opt_cfg.rotation_lr, opt_cfg.opacity_lr)
            new_params, moments = adam_step(gmap.params, grads, gmap.moments, lrs,
                                            gmap.aux.active)
        gmap = GaussianMap(new_params, gmap.aux, moments)
    return gmap, it


def run_color_refinement(engine, iterations: int = 26000, chunk: int = 25):
    """Refine `engine.gmap` over `iterations` random keyframes of
    `engine.viewpoints`; returns (map, the engine's iteration count)."""
    kf_ids = list(engine.viewpoints)
    if not kf_ids:
        return engine.gmap, engine.iteration_count
    Log(f"Starting color refinement ({iterations} iterations)")
    rng = np.random.default_rng(0)
    gmap = engine.gmap
    local_iter = 0
    done = 0
    dev = engine.device
    while done < iterations:
        k = min(chunk, iterations - done)
        picks = rng.integers(0, len(kf_ids), size=k)
        images = torch.stack([engine.viewpoints[kf_ids[i]].image for i in picks])
        poses = torch.stack([torch.as_tensor(engine.viewpoints[kf_ids[i]].T_w2c,
                                             dtype=torch.float32, device=dev) for i in picks])
        gmap, local_iter = refine_chunk(gmap, images, poses, local_iter, engine.bg_color,
                                        engine.cfg, engine.opt_cfg, engine.intr,
                                        engine.raster_cfg)
        done += k
    Log("Map refinement done")
    return gmap, engine.iteration_count

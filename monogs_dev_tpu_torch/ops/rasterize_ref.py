"""Brute-force differentiable rasterizer, the correctness oracle (port of
`monogs_dev_tpu/ops/rasterize_ref.py`).

O(N * H * W): every active Gaussian is alpha-composited into every pixel in
global depth order, with no tile binning or truncation. Plain torch,
differentiable by autograd. Tests hold `rasterize.render_tiled` (and K1/K2 on
the card) against it on small scenes; nothing on the SLAM path calls it.

Early termination: the CUDA reference stops blending a pixel once its
transmittance drops below 1e-4. Here blending runs to the end, but a
Gaussian's contribution is zeroed once the incoming transmittance is below
`transmittance_min` (contributions past that point are <= 1e-4 anyway).
`n_touched` counts the pixels where alpha >= alpha_min and the incoming
transmittance is >= transmittance_min, the visibility the SLAM logic reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.camera import Intrinsics
from ..models.gaussians import GaussianParams
from .project import project_gaussians
from .raster_types import RasterConfig, RenderOutput


def render_reference(
    params: GaussianParams,
    active: torch.Tensor,
    T_w2c: torch.Tensor,
    intr: Intrinsics,
    sh_degree: int,
    bg_color: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    means2d_probe: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    isotropic: bool = False,
) -> RenderOutput:
    proj = project_gaussians(params, active, T_w2c, intr, sh_degree, scale_modifier, isotropic)
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe  # the densification-gradient probe

    n = means2d.shape[0]
    h, w = intr.height, intr.width
    dev = means2d.device
    if bg_color is None:
        bg_color = means2d.new_zeros((3,))

    # global front-to-back order (stable, as jnp.argsort)
    sort_depth = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(sort_depth, stable=True)
    mu = means2d[order]
    con = proj.conic[order]
    col = proj.color[order]
    opa = proj.opacity[order]
    z = proj.depth[order]

    py, px = torch.meshgrid(torch.arange(h, dtype=means2d.dtype, device=dev),
                            torch.arange(w, dtype=means2d.dtype, device=dev), indexing="ij")
    dx = px[None] - mu[:, 0, None, None]  # (N, H, W)
    dy = py[None] - mu[:, 1, None, None]
    power = (-0.5 * (con[:, 0, None, None] * dx * dx + con[:, 2, None, None] * dy * dy)
             - con[:, 1, None, None] * dx * dy)
    alpha = torch.clamp(opa[:, None, None] * torch.exp(power), max=config.alpha_clamp)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(power > 0.0, zero, alpha)  # CUDA skips positive power
    alpha = torch.where(alpha < config.alpha_min, zero, alpha)

    log_one_minus = torch.log1p(-alpha)
    log_t_incl = torch.cumsum(log_one_minus, dim=0)
    t_in = torch.exp(log_t_incl - log_one_minus)  # exclusive transmittance
    contributing = t_in >= config.transmittance_min
    weight = torch.where(contributing, alpha * t_in, zero)

    color = torch.einsum("nhw,nc->hwc", weight, col)
    depth = torch.einsum("nhw,n->hw", weight, z)
    alpha_out = weight.sum(dim=0)
    color = color + (1.0 - alpha_out[..., None]) * bg_color

    touched_sorted = ((alpha >= config.alpha_min) & contributing).sum(dim=(1, 2))
    n_touched = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_touched[order] = touched_sorted.to(torch.int32)

    return RenderOutput(
        color=color,
        depth=depth,
        alpha=alpha_out,
        n_touched=n_touched,
        radii=proj.radii,
        visible=proj.radii > 0.0,
        dup_overflow=torch.zeros((), dtype=torch.int32, device=dev),
        tile_overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )

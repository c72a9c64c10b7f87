"""Keyframe -> new Gaussians, on the device (port of
`monogs_dev_tpu/core/insertion.py`).

Back-projection with the rasterizer's pixel convention
(``x = (u + 0.5 - cx) z / fx``), a 1/downsample random subsample of the
valid-depth pixels, kNN scale init, SH colour init, opacity 0.5; and the
monocular depth a keyframe is inserted with: the bootstrap sheet before any
map exists, the noisy pseudo-depth from the render after.

Random draws come from a `torch.Generator`, or are passed in (the tests
replay the JAX package's draws).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..geometry.sh import num_sh_coeffs, rgb_to_sh
from ..models.camera import Intrinsics
from ..models.gaussians import GaussianParams
from ..ops.knn import mean_sq_dist_knn3
from ..utils.losses import _median
from ..utils.profiling import spanned, sync


def _normal(draws: Union[torch.Generator, torch.Tensor, np.ndarray], shape, device) -> torch.Tensor:
    """Standard normal draws of `shape`: drawn from a Generator, or given."""
    if isinstance(draws, torch.Generator):
        with sync("insert_draws"):
            return torch.randn(shape, generator=draws, device=draws.device).to(device)
    with sync("insert_draws"):
        out = torch.as_tensor(np.array(draws), dtype=torch.float32, device=device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"draws of shape {tuple(out.shape)}, need {tuple(shape)}")
    return out


@spanned("insert")
def new_points_from_frame(draws: Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]],
                          image: torch.Tensor, depth_map: torch.Tensor,
                          exposure_ab, T_w2c, intr: Intrinsics, sh_degree: int,
                          budget: int, downsample: int, point_size: float,
                          adaptive_pointsize: bool) -> Tuple[GaussianParams, torch.Tensor]:
    """Up to `budget` new Gaussians from one keyframe.

    `draws` is a pair of (H, W) uniform [0, 1) draws (the keep test and the
    selection priority), or a Generator to draw them from.
    Returns (params (budget, ...), valid (budget,))."""
    dev = image.device
    h, w = depth_map.shape
    u = []
    for k in range(2):
        with sync("insert_draws"):
            if isinstance(draws, torch.Generator):
                u.append(torch.rand((h, w), generator=draws, device=draws.device).to(dev))
            else:
                u.append(torch.as_tensor(np.array(draws[k]), dtype=torch.float32, device=dev))
    u1, u2 = u
    with sync("insert"):
        exposure_ab = torch.as_tensor(exposure_ab, dtype=torch.float32, device=dev)
    with sync("insert"):
        T_w2c = torch.as_tensor(T_w2c, dtype=torch.float32, device=dev)

    image_ab = torch.clamp(torch.exp(exposure_ab[0]) * image + exposure_ab[1], 0.0, 1.0)
    valid = depth_map > 0.0
    keep = valid & (u1 < (1.0 / downsample))
    priority = torch.where(keep, u2, torch.full_like(u2, -1.0)).reshape(-1)
    order = torch.sort(priority, descending=True, stable=True).indices[:budget]
    scores = priority[order]
    sel_valid = scores > 0.0
    vv = torch.div(order, w, rounding_mode="floor").to(torch.float32)
    uu = (order % w).to(torch.float32)
    z = depth_map.reshape(-1)[order]

    x = (uu + 0.5 - intr.cx) * z / intr.fx
    y = (vv + 0.5 - intr.cy) * z / intr.fy
    p_cam = torch.stack([x, y, z], dim=-1)
    R = T_w2c[:3, :3]
    t = T_w2c[:3, 3]
    p_world = (p_cam - t) @ R  # R^T (p - t)
    rgb = image_ab.reshape(-1, 3)[order]

    if adaptive_pointsize:
        with sync("insert"):
            valid_depth = depth_map[valid]
        with sync("insert"):
            ps = min(0.05, point_size * float(_median(valid_depth)))
    else:
        ps = point_size
    dist2 = torch.clamp(mean_sq_dist_knn3(p_world, sel_valid), min=1e-7) * ps
    log_scales = (0.5 * torch.log(dist2))[:, None].expand(budget, 3).contiguous()

    k = num_sh_coeffs(sh_degree)
    with sync("insert"):
        unit = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
    params = GaussianParams(
        xyz=p_world,
        f_dc=rgb_to_sh(rgb)[:, None, :],
        f_rest=torch.zeros((budget, max(k - 1, 0), 3), device=dev),
        log_scales=log_scales,
        quats=unit.repeat(budget, 1),
        opacity_logit=torch.zeros((budget,), device=dev),
    )
    return params, sel_valid


def pseudo_depth_map(draws, render_depth: torch.Tensor, render_opacity: torch.Tensor,
                     gt_image: torch.Tensor, fallback_depth: float = 2.0,
                     rgb_boundary_threshold: float = 0.01) -> torch.Tensor:
    """Monocular keyframe pseudo-depth from the render at the new keyframe.

    Outlier depths (|d - median| > std, or invalid) are replaced by the
    median; noise sigma is 0.5 std there and 0.2 std elsewhere; pixels of
    invalid RGB are zero. When no pixel is valid (opacity never reaches
    0.95, as right after a bootstrap reset) the median is `fallback_depth`
    and the std 5% of it: a noisy constant sheet. `draws`: a Generator or
    (H, W) standard normal draws."""
    dev = render_depth.device
    valid_rgb = gt_image.sum(dim=-1) > rgb_boundary_threshold
    valid = (render_depth > 0.0) & (render_opacity > 0.95) & valid_rgb
    with sync("pseudo_depth"):
        n = int(valid.sum())
    if n:
        with sync("pseudo_depth"):
            median = _median(render_depth[valid])
        mean = torch.where(valid, render_depth, torch.zeros_like(render_depth)).sum() / n
        dev2 = torch.where(valid, render_depth - mean, torch.zeros_like(render_depth)) ** 2
        std = torch.sqrt(dev2.sum() / n)
    else:
        with sync("pseudo_depth"):
            median = torch.tensor(float(fallback_depth), device=dev)
        std = 0.05 * median
    invalid = (render_depth > median + std) | (render_depth < median - std) | ~valid
    depth = torch.where(invalid, median, render_depth)
    noise = _normal(draws, render_depth.shape, dev)
    depth = depth + noise * torch.where(invalid, std * 0.5, std * 0.2)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    return torch.where(valid_rgb, depth, torch.zeros_like(depth))


def mono_bootstrap_depth(draws, height: int, width: int, init: bool, device,
                         scale: float = 2.0) -> torch.Tensor:
    """Depth used when no estimate exists yet: the first keyframe's
    2 +- 0.3 sheet (init=True), else the map model's
    (1 + (u - 0.5) 0.05) scale fallback. `draws`: a Generator or (H, W)
    standard normal draws."""
    noise = _normal(draws, (height, width), device)
    if init:
        return 2.0 * torch.ones((height, width), device=device) + noise * 0.3
    return (torch.ones((height, width), device=device) + (noise - 0.5) * 0.05) * scale

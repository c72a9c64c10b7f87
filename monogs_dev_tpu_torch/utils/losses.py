"""Losses, metrics and image operators on channel-last (H, W, C) tensors
(port of `monogs_dev_tpu/utils/losses.py`).

Masked reductions are sum(x*m)/sum(m), as in the JAX package. The depthwise
filters run as fp32 `conv2d` with zero SAME padding; TF32 is switched off by
`SLAM.__init__` so cuDNN keeps them exact.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _filter2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D cross-correlation with SAME zero padding; img (H, W, C)."""
    c = img.shape[-1]
    kh, kw = kernel.shape
    x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    w = kernel.to(img.dtype).expand(c, 1, kh, kw)
    return F.conv2d(x, w, groups=c)[0].permute(1, 2, 0)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """PSNR; with a mask, the MSE is averaged over masked pixels only."""
    se = (img1 - img2) ** 2
    if mask is None:
        mse = se.mean()
    else:
        mse = _masked_mean(se, mask)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM with an 11x11 sigma-1.5 Gaussian window, mean over the image."""
    w = _gaussian_window(11, 1.5, img1.device)
    mu1 = _filter2d_same(img1, w)
    mu2 = _filter2d_same(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_same(img1 * img1, w) - mu1_sq
    sigma2_sq = _filter2d_same(img2 * img2, w) - mu2_sq
    sigma12 = _filter2d_same(img1 * img2, w) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def image_gradient(image: torch.Tensor):
    """Normalized 3x3 Scharr gradients of an (H, W, C) image -> (gx, gy)."""
    kx = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                      device=image.device) / 32.0
    return _filter2d_same(image, kx), _filter2d_same(image, kx.T.contiguous())


def image_gradient_mask(image: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    """Validity mask eroded by a 3x3 all-ones filter."""
    valid = (image.sum(dim=-1, keepdim=True) > eps).to(torch.float32)
    eroded = _filter2d_same(valid, torch.ones((3, 3), device=image.device))
    return (eroded >= 9.0 - 1e-3)[..., 0]


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median semantics: the mean of the two middle values for even counts."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def compute_grad_mask(image: torch.Tensor, edge_threshold: float, per_block: bool) -> torch.Tensor:
    """Scharr edge mask used by the tracking loss (global or per-32x32-block median)."""
    gx, gy = image_gradient(image.mean(dim=-1, keepdim=True))
    mag = torch.sqrt(gx ** 2 + gy ** 2)[..., 0]
    mag = mag * image_gradient_mask(image)
    if not per_block:
        return mag > _median(mag) * edge_threshold
    h, w = mag.shape
    bs = 32
    hb, wb = h // bs, w // bs
    core = mag[: hb * bs, : wb * bs].reshape(hb, bs, wb, bs).permute(0, 2, 1, 3).reshape(hb, wb, -1)
    s = torch.sort(core, dim=-1).values
    n = s.shape[-1]
    med = 0.5 * (s[..., n // 2 - 1] + s[..., n // 2])
    th = (med * edge_threshold).repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    out = torch.zeros_like(mag, dtype=torch.bool)
    out[: hb * bs, : wb * bs] = mag[: hb * bs, : wb * bs] > th
    return out


def apply_exposure(image: torch.Tensor, exposure_ab: torch.Tensor) -> torch.Tensor:
    """Affine exposure compensation exp(a) * I + b."""
    return torch.exp(exposure_ab[0]) * image + exposure_ab[1]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    if m.dim() == x.dim() - 1:
        m = m[..., None]
    denom = torch.clamp((torch.ones_like(x) * m).sum(), min=1.0)
    return (x * m).sum() / denom


def tracking_loss(render_color, render_depth, render_opacity, gt_image,
                  gt_depth: Optional[torch.Tensor], exposure_ab, grad_mask,
                  monocular: bool, alpha: float = 0.95,
                  rgb_boundary_threshold: float = 0.01) -> torch.Tensor:
    """Per-frame tracking loss."""
    image_ab = apply_exposure(render_color, exposure_ab)
    rgb_pixel_mask = (gt_image.sum(dim=-1) > rgb_boundary_threshold) & grad_mask
    l1_rgb = render_opacity[..., None] * (image_ab - gt_image).abs()
    if monocular or gt_depth is None:
        return _masked_mean(l1_rgb, rgb_pixel_mask)
    rgb_term = _masked_mean(l1_rgb, rgb_pixel_mask)
    depth_mask = (gt_depth > 0.0) & (render_opacity > 0.95) & grad_mask
    depth_n = render_depth / torch.clamp(render_opacity, min=1e-5)
    depth_term = _masked_mean((depth_n - gt_depth).abs(), depth_mask)
    return alpha * rgb_term + (1.0 - alpha) * depth_term


def mapping_loss(render_color, render_depth, gt_image, gt_depth, exposure_ab,
                 monocular: bool, initialization: bool = False, alpha: float = 0.95,
                 rgb_boundary_threshold: float = 0.01, render_opacity=None) -> torch.Tensor:
    """Per-frame mapping loss."""
    image_ab = render_color if initialization else apply_exposure(render_color, exposure_ab)
    rgb_pixel_mask = gt_image.sum(dim=-1) > rgb_boundary_threshold
    rgb_term = _masked_mean((image_ab - gt_image).abs(), rgb_pixel_mask)
    if monocular or gt_depth is None:
        return rgb_term
    depth_mask = gt_depth > 0.0
    if render_opacity is not None:
        render_depth = render_depth / torch.clamp(render_opacity, min=1e-5)
    depth_term = _masked_mean((render_depth - gt_depth).abs(), depth_mask)
    return alpha * rgb_term + (1.0 - alpha) * depth_term


def isotropic_regularizer(log_scales: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """10 * mean |s - mean(s)| over active Gaussians."""
    s = torch.exp(log_scales)
    m = active.to(s.dtype)[:, None]
    denom = torch.clamp(m.sum() * s.shape[-1], min=1.0)
    mean_s = (s * m).sum(dim=-1, keepdim=True) / s.shape[-1]
    return 10.0 * ((s - mean_s).abs() * m).sum() / denom


def median_depth(depth: torch.Tensor, opacity: torch.Tensor, mask=None):
    """Median (jnp.nanmedian semantics) and std of rendered depth over valid
    pixels; NaN when there are none."""
    valid = (depth > 0.0) & (opacity > 0.95)
    if mask is not None:
        valid = valid & mask
    vals = depth[valid]
    if vals.numel() == 0:
        nan = torch.tensor(math.nan, device=depth.device)
        return nan, nan, valid
    med = _median(vals)
    std = torch.sqrt(((vals - vals.mean()) ** 2).mean())
    return med, std, valid

"""The tracking loss of an RGB-D frame and its gradient with respect to the
camera pose and the affine exposure, by autograd through the plain
renderer (`render.py`), one block of pixels at a time.

The loss is MonoGS's RGB-D tracking loss: alpha times the opacity-weighted
L1 colour error after exposure exp(a) I + b, over pixels with valid colour
on the Scharr edge mask, plus (1 - alpha) times the L1 error of the
alpha-normalised depth over pixels with sensor depth, opacity above 0.95
and the edge mask, each a masked mean. The edge mask keeps pixels whose
gradient magnitude exceeds `edge_threshold` times the median (over the
image, or per 32x32 block for Replica). The gradient is taken at the pose
exp(tau) T with tau = 0, as [d/dtau (6), d/d(a, b)].
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .render import (FP32, Blend, Camera, blocks, composite_block, depth_order, project,
                     reach, se3_exp, tile_rects)


def _filter_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise cross-correlation of (H, W, C) with SAME zero padding."""
    c = img.shape[-1]
    kh, kw = kernel.shape
    x = F.pad(img.permute(2, 0, 1)[None], ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return F.conv2d(x, kernel.expand(c, 1, kh, kw), groups=c)[0].permute(1, 2, 0)


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def edge_mask(image: torch.Tensor, edge_threshold: float, per_block: bool) -> torch.Tensor:
    """(H, W) bool: Scharr gradient magnitude of the grey image, zeroed off
    the eroded valid-colour area, above edge_threshold x its median."""
    kx = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                      device=image.device) / 32.0
    grey = image.mean(dim=-1, keepdim=True)
    gx, gy = _filter_same(grey, kx), _filter_same(grey, kx.T.contiguous())
    mag = torch.sqrt(gx ** 2 + gy ** 2)[..., 0]
    valid = (image.sum(dim=-1, keepdim=True) > 0.01).to(torch.float32)
    eroded = _filter_same(valid, torch.ones((3, 3), device=image.device))
    mag = mag * (eroded >= 9.0 - 1e-3)[..., 0]
    if not per_block:
        return mag > _median(mag) * edge_threshold
    h, w = mag.shape
    bs = 32
    hb, wb = h // bs, w // bs
    core = mag[: hb * bs, : wb * bs].reshape(hb, bs, wb, bs).permute(0, 2, 1, 3).reshape(hb, wb, -1)
    s = torch.sort(core, dim=-1).values
    n = s.shape[-1]
    th = (0.5 * (s[..., n // 2 - 1] + s[..., n // 2]) * edge_threshold)
    th = th.repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    out = torch.zeros_like(mag, dtype=torch.bool)
    out[: hb * bs, : wb * bs] = mag[: hb * bs, : wb * bs] > th
    return out


def tracking_gradient(g: Dict[str, torch.Tensor], active: torch.Tensor, T: torch.Tensor,
                      exp_ab: torch.Tensor, image: torch.Tensor, depth: torch.Tensor,
                      cam: Camera, blend: Blend, *, alpha: float, rgb_threshold: float,
                      edge_threshold: float, per_block: bool,
                      mm: Callable = FP32) -> Tuple[float, torch.Tensor]:
    """(loss, gradient (8,)) of the tracking loss at exp(tau) T, tau = 0."""
    dev = T.device
    mask = edge_mask(image, edge_threshold, per_block)
    rgb_mask = (image.sum(dim=-1) > rgb_threshold) & mask
    n_rgb = torch.clamp(3.0 * rgb_mask.sum(), min=1.0)
    tau = torch.zeros(6, device=dev, requires_grad=True)
    ab = exp_ab.detach().clone().float().requires_grad_(True)
    proj = project(g, active, mm(se3_exp(tau, mm), T), cam, mm)
    order = depth_order(proj)
    rx, ry = reach(proj, blend)
    rects = tile_rects(proj, cam, blend)
    keys = ("mean", "conic", "depth")
    leaf = {k: (proj[k].detach().requires_grad_(True) if k in keys else proj[k].detach())
            for k in proj}
    boxes = list(blocks(cam, blend))
    with torch.no_grad():  # the depth term's pixel count needs every block's opacity
        d_masks, n_d = [], torch.zeros((), device=dev)
        for y0, y1, x0, x1 in boxes:
            _, _, acc = composite_block(leaf, order, rx, ry, rects, (y0, y1, x0, x1), blend, mm)
            m = (depth[y0:y1, x0:x1] > 0.0) & (acc > 0.95) & mask[y0:y1, x0:x1]
            d_masks.append(m)
            n_d += m.sum()
        n_d = torch.clamp(n_d, min=1.0)
    loss = torch.zeros((), device=dev)
    for (y0, y1, x0, x1), dm in zip(boxes, d_masks):
        c, d, acc = composite_block(leaf, order, rx, ry, rects, (y0, y1, x0, x1), blend, mm)
        gt = image[y0:y1, x0:x1]
        rm = rgb_mask[y0:y1, x0:x1]
        img_ab = torch.exp(ab[0]) * c + ab[1]
        l_rgb = (acc[..., None] * (img_ab - gt).abs() * rm[..., None]).sum() / n_rgb
        dn = d / torch.clamp(acc, min=1e-5)
        l_d = ((dn - depth[y0:y1, x0:x1]).abs() * dm).sum() / n_d
        part = alpha * l_rgb + (1.0 - alpha) * l_d
        if part.requires_grad:
            part.backward()
        loss += part.detach()
    outs = [proj[k] for k in keys if leaf[k].grad is not None]
    grads = [leaf[k].grad for k in keys if leaf[k].grad is not None]
    if outs:
        torch.autograd.backward(outs, grads)
    g_tau = tau.grad if tau.grad is not None else torch.zeros(6, device=dev)
    g_ab = ab.grad if ab.grad is not None else torch.zeros(2, device=dev)
    return float(loss), torch.cat([g_tau, g_ab]).detach()


MAP_FIELDS = ("xyz", "f_dc", "log_scales", "quats", "opacity_logit")


def isotropic(log_scales: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """MonoGS's isotropic regulariser: 10 x the mean over active rows and
    axes of |s - mean over axes of s|, s = exp(log-scale)."""
    s = torch.exp(log_scales)[active]
    return 10.0 * (s - s.mean(dim=-1, keepdim=True)).abs().sum() / max(s.numel(), 1)


def mapping_gradient(g: Dict[str, torch.Tensor], active: torch.Tensor, slots, cam: Camera,
                     blend: Blend, *, alpha: float, rgb_threshold: float,
                     mm: Callable = FP32) -> Dict[str, torch.Tensor]:
    """The gradient, by field of the map's rows, of one mapping iteration's
    loss: the isotropic regulariser plus, for each slot (T_w2c, exposure
    (a, b), image, depth), MonoGS's RGB-D mapping loss: alpha times the L1
    colour error after exposure over pixels with valid colour, plus (1 -
    alpha) times the L1 error of the alpha-normalised depth over pixels
    with sensor depth, each a masked mean."""
    leaves = {k: g[k].detach().float().clone().requires_grad_(True) for k in MAP_FIELDS}
    isotropic(leaves["log_scales"], active).backward()
    keys = ("mean", "conic", "depth", "color", "opacity")
    for T, ab, image, depth in slots:
        rgb_mask = image.sum(dim=-1) > rgb_threshold
        n_rgb = torch.clamp(3.0 * rgb_mask.sum(), min=1.0)
        d_mask = depth > 0.0
        n_d = torch.clamp(d_mask.sum().float(), min=1.0)
        proj = project(leaves, active, T, cam, mm)
        order = depth_order(proj)
        rx, ry = reach(proj, blend)
        rects = tile_rects(proj, cam, blend)
        leaf = {k: (proj[k].detach().requires_grad_(True) if k in keys else proj[k].detach())
                for k in proj}
        for y0, y1, x0, x1 in blocks(cam, blend):
            c, d, acc = composite_block(leaf, order, rx, ry, rects, (y0, y1, x0, x1), blend, mm)
            gt = image[y0:y1, x0:x1]
            img_ab = torch.exp(ab[0]) * c + ab[1]
            l_rgb = ((img_ab - gt).abs() * rgb_mask[y0:y1, x0:x1, None]).sum() / n_rgb
            dn = d / torch.clamp(acc, min=1e-5)
            l_d = ((dn - depth[y0:y1, x0:x1]).abs() * d_mask[y0:y1, x0:x1]).sum() / n_d
            part = alpha * l_rgb + (1.0 - alpha) * l_d
            if part.requires_grad:
                part.backward()
        outs = [proj[k] for k in keys if leaf[k].grad is not None]
        if outs:
            torch.autograd.backward(outs, [leaf[k].grad for k in keys if leaf[k].grad is not None])
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
            for k, v in leaves.items()}

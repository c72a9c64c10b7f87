"""Plain renderer of 3D Gaussians: the benchmark's own, for its inputs and
for the check of the port's renders and pose gradients.

Projection is the EWA splatting of 3D Gaussian Splatting (Kerbl et al.
2023): camera transform, covariance R S S^T R^T, the perspective Jacobian
with the 1.3 x tan(FoV) clamp, cov2d = J W cov3d W^T J^T plus 0.3 px, and
the pixel u = f x / z + c - 0.5. Compositing is front to back in one global
depth order, alpha = min(opacity exp(power), alpha_clamp), cut below
alpha_min or where power > 0, and a pixel takes no more once its incoming
transmittance is below t_min. Every Gaussian is composited into every
pixel; the one shortcut is a box around each Gaussian outside which its
alpha is below alpha_min, so that a block of pixels sees only the Gaussians
whose box meets it (their alpha elsewhere is 0 and changes nothing).

The configuration states two caps of its tile lists (`TPU.k_dup`,
`TPU.max_per_tile`), and the renderer keeps to them as stated: the image is
cut into square tiles; a Gaussian reaches at most the first k_dup tiles, in
row-major order, of the tile rectangle that its radius ceil(3
sqrt(lambda_max)) (plus `dilate` pixels) spans; a tile holds at most the
max_per_tile nearest of the Gaussians whose alpha reaches alpha_min
somewhere in the tile's box (grown by `dilate` pixels, and by a slack of 1
in the exponent when `dilate` is not 0). With k_dup 0 there are no tile
lists: every Gaussian reaches every pixel (the benchmark's input frames).

Every matrix product goes through the `mm` given: `FP32` (`torch.matmul` in
float32) or `TF32` (`tf32_matmul`, which rounds both operands to TF32's
10-bit mantissa as the tensor cores do), the control that the benchmark's
limits are set against. Plain torch; nothing of the port is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

C0 = 0.28209479177387814  # the degree-0 spherical harmonic
BLOCK_TILES = 20  # tiles of one row in one compositing block


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 and float32 accumulation;
    the gradient passes the rounding straight through."""
    ra = a + (tf32_round(a) - a).detach()
    rb = b + (tf32_round(b) - b).detach()
    return torch.matmul(ra, rb)


FP32, TF32 = torch.matmul, tf32_matmul


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float = 0.01


@dataclasses.dataclass(frozen=True)
class Blend:
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    t_min: float = 1e-4
    tile: int = 16
    k_dup: int = 16
    max_per_tile: int = 1024
    dilate: float = 0.0


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz, normalized here -> (N, 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def project(g: Dict[str, torch.Tensor], active: torch.Tensor, T_w2c: torch.Tensor,
            cam: Camera, mm: Callable = FP32) -> Dict[str, torch.Tensor]:
    """Screen-space Gaussians: mean (N, 2), conic (N, 3) = (A, B, C) of the
    inverse 2D covariance, cov (N, 3) = its (a, b, c), color (N, 3), opacity
    (N,) (0 where not valid), depth (N,) camera z, valid (N,). `g` holds
    xyz (N, 3), f_dc (N, 1, 3), log_scales (N, 3), quats (N, 4) wxyz and
    opacity_logit (N,). A row with a non-finite or absurd value is left out,
    and log-scales are clipped to [-20, 8]."""
    xyz, quats = g["xyz"], g["quats"]
    ok = (torch.isfinite(xyz).all(-1) & torch.isfinite(g["log_scales"]).all(-1)
          & torch.isfinite(quats).all(-1) & torch.isfinite(g["opacity_logit"])
          & torch.isfinite(g["f_dc"]).flatten(1).all(-1)
          & (xyz.abs().amax(-1) < 1e6) & (torch.linalg.norm(quats, dim=-1) > 1e-3))
    unit = torch.tensor([1.0, 0.0, 0.0, 0.0], device=xyz.device)
    xyz = torch.where(ok[:, None], xyz, torch.zeros_like(xyz))
    quats = torch.where(ok[:, None], quats, unit)
    log_s = torch.where(ok[:, None], torch.clamp(g["log_scales"], -20.0, 8.0),
                        torch.full_like(g["log_scales"], -10.0))
    R, t = T_w2c[:3, :3], T_w2c[:3, 3]
    p = mm(xyz, R.T) + t
    x, y, z = p.unbind(-1)
    in_front = z > cam.znear
    zs = torch.where(in_front, z, torch.ones_like(z))
    mean = torch.stack([cam.fx * x / zs + cam.cx - 0.5, cam.fy * y / zs + cam.cy - 0.5], -1)
    limx, limy = 1.3 * 0.5 * cam.width / cam.fx, 1.3 * 0.5 * cam.height / cam.fy
    tx = torch.clamp(x / zs, -limx, limx) * zs
    ty = torch.clamp(y / zs, -limy, limy) * zs
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([cam.fx / zs, zero, -cam.fx * tx / (zs * zs)], -1),
                     torch.stack([zero, cam.fy / zs, -cam.fy * ty / (zs * zs)], -1)], -2)
    M = quat_to_rot(quats) * torch.exp(log_s)[:, None, :]  # R_q diag(s)
    sigma = mm(M, M.transpose(1, 2))
    JW = mm(J, R.expand(J.shape[0], 3, 3))
    cov2 = mm(mm(JW, sigma), JW.transpose(1, 2))
    a, b, c = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det > 0.0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    valid = active & ok & in_front & det_ok
    opacity = torch.where(valid, torch.sigmoid(g["opacity_logit"]), torch.zeros_like(z))
    color = torch.clamp(C0 * g["f_dc"][:, 0, :] + 0.5, min=0.0)
    return {"mean": mean, "conic": torch.stack([c / det_s, -b / det_s, a / det_s], -1),
            "cov": torch.stack([a, b, c], -1), "color": color, "opacity": opacity,
            "depth": z, "valid": valid}


def reach(proj: Dict[str, torch.Tensor], blend: Blend) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-widths (rx, ry) of a box outside which a Gaussian's alpha is
    below alpha_min over every tile box it could be binned to (-1 where it
    reaches no pixel): 0.5 d^T Q d <= ln(o / alpha_min) (+ the slack) is an
    ellipse whose extent along x is sqrt(2 tau a); the box adds `dilate`."""
    op = proj["opacity"]
    tau = torch.log(torch.clamp(op, min=1e-30) / blend.alpha_min)
    live = proj["valid"] & (tau > 0.0)
    tau = torch.clamp(tau, min=0.0) + (1.0 if blend.dilate > 0 else 0.0)
    cov = proj["cov"].detach()
    pad = 1.0 + blend.dilate
    rx = 1.01 * torch.sqrt(2.0 * tau * torch.clamp(cov[:, 0], min=0.0)) + pad
    ry = 1.01 * torch.sqrt(2.0 * tau * torch.clamp(cov[:, 2], min=0.0)) + pad
    neg = torch.full_like(rx, -1.0)
    return torch.where(live, rx, neg), torch.where(live, ry, neg)


def tile_rects(proj: Dict[str, torch.Tensor], cam: Camera, blend: Blend) -> torch.Tensor:
    """(N, 4) int64 tile rectangle (tx0, tx1, ty0, ty1) of each Gaussian:
    its radius ceil(3 sqrt(lambda_max)) of the 2D covariance, the
    discriminant held at 0.1 or more, plus `dilate`, clamped to the grid."""
    cov = proj["cov"].detach()
    a, b, c = cov.unbind(-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - (a * c - b * b), min=0.1))
    r = torch.ceil(3.0 * torch.sqrt(lam)) + blend.dilate
    m = proj["mean"].detach()
    t = blend.tile
    tx_n, ty_n = -(-cam.width // t), -(-cam.height // t)

    def cell(v, n_max):
        return torch.clamp(torch.floor(v / t), 0, n_max - 1).to(torch.int64)

    return torch.stack([cell(m[:, 0] - r, tx_n), cell(m[:, 0] + r, tx_n),
                        cell(m[:, 1] - r, ty_n), cell(m[:, 1] + r, ty_n)], -1)


def _q_min(mean, conic, bx0, bx1, by0, by1):
    """Least 0.5 (A dx^2 + C dy^2) + B dx dy over each box, (n, t): 0 where
    the mean is inside, else the least over the four edges."""
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    dx0, dx1 = bx0[None, :] - mean[:, 0:1], bx1[None, :] - mean[:, 0:1]
    dy0, dy1 = by0[None, :] - mean[:, 1:2], by1[None, :] - mean[:, 1:2]

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    ca_s, cc_s = torch.clamp(ca, min=1e-12), torch.clamp(cc, min=1e-12)
    edges = torch.minimum(
        torch.minimum(q(dx0, torch.clamp(-cb * dx0 / cc_s, dy0, dy1)),
                      q(dx1, torch.clamp(-cb * dx1 / cc_s, dy0, dy1))),
        torch.minimum(q(torch.clamp(-cb * dy0 / ca_s, dx0, dx1), dy0),
                      q(torch.clamp(-cb * dy1 / ca_s, dx0, dx1), dy1)))
    inside = (dx0 <= 0.0) & (dx1 >= 0.0) & (dy0 <= 0.0) & (dy1 >= 0.0)
    return torch.where(inside, torch.zeros_like(edges), edges)


def depth_order(proj: Dict[str, torch.Tensor]) -> torch.Tensor:
    key = torch.where(proj["valid"], proj["depth"].detach(),
                      torch.full_like(proj["depth"].detach(), float("inf")))
    return torch.argsort(key, stable=True)


def blocks(cam: Camera, blend: Blend = Blend()):
    """Boxes (y0, y1, x0, x1) of one tile row and up to BLOCK_TILES tiles."""
    t = blend.tile
    for y0 in range(0, cam.height, t):
        for x0 in range(0, cam.width, t * BLOCK_TILES):
            yield y0, min(y0 + t, cam.height), x0, min(x0 + t * BLOCK_TILES, cam.width)


def composite_block(proj, order, rx, ry, rects, box, blend: Blend, mm: Callable = FP32):
    """(color (h, w, 3), depth (h, w) alpha-weighted, alpha (h, w)) of the
    pixels y0 <= y < y1, x0 <= x < x1 (one tile row) on a black
    background."""
    y0, y1, x0, x1 = box
    t = blend.tile
    dev = proj["mean"].device
    mean_d = proj["mean"].detach()
    ty = y0 // t
    tx_lo, tx_hi = x0 // t, (x1 - 1) // t
    tiled = blend.k_dup > 0
    hit = ((rx >= 0) & (mean_d[:, 0] + rx >= x0) & (mean_d[:, 0] - rx <= x1 - 1)
           & (mean_d[:, 1] + ry >= y0) & (mean_d[:, 1] - ry <= y1 - 1))
    if tiled:
        hit &= ((rects[:, 2] <= ty) & (rects[:, 3] >= ty)
                & (rects[:, 0] <= tx_hi) & (rects[:, 1] >= tx_lo))
    idx = order[hit[order]]
    h, w = y1 - y0, x1 - x0
    if idx.numel() == 0:
        z = torch.zeros((h, w), device=dev)
        return torch.zeros((h, w, 3), device=dev), z, z
    py, px = torch.meshgrid(torch.arange(y0, y1, dtype=torch.float32, device=dev),
                            torch.arange(x0, x1, dtype=torch.float32, device=dev), indexing="ij")
    mu = proj["mean"][idx]
    con = proj["conic"][idx]
    dx = px.reshape(1, -1) - mu[:, 0:1]
    dy = py.reshape(1, -1) - mu[:, 1:2]
    power = -0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy) - con[:, 1:2] * dx * dy
    alpha = torch.clamp(proj["opacity"][idx][:, None] * torch.exp(power), max=blend.alpha_clamp)
    cut = (power > 0.0) | (alpha < blend.alpha_min)
    if tiled:
        binned = _binned(proj, idx, rects, ty, tx_lo, tx_hi, blend)
        pix_tile = (torch.arange(x0, x1, device=dev) // t - tx_lo).repeat(h)
        cut |= ~binned[:, pix_tile]
    alpha = torch.where(cut, torch.zeros_like(alpha), alpha)
    t_incl = torch.cumprod(1.0 - alpha, dim=0)
    t_in = torch.cat([torch.ones_like(t_incl[:1]), t_incl[:-1]], dim=0)
    wgt = torch.where(t_in >= blend.t_min, alpha * t_in, torch.zeros_like(alpha))
    wt = wgt.T  # (P, n)
    color = mm(wt, proj["color"][idx])
    depth = mm(wt, proj["depth"][idx][:, None])[:, 0]
    acc = wgt.sum(dim=0)
    return color.reshape(h, w, 3), depth.reshape(h, w), acc.reshape(h, w)


def _binned(proj, idx, rects, ty, tx_lo, tx_hi, blend: Blend) -> torch.Tensor:
    """(n, tiles) bool: whether each of the depth-ordered Gaussians `idx` is
    in the list of each tile (ty, tx_lo..tx_hi), under both caps."""
    t = blend.tile
    dev = rects.device
    txs = torch.arange(tx_lo, tx_hi + 1, device=dev)
    rc = rects[idx]
    wrect = rc[:, 1:2] - rc[:, 0:1] + 1
    k = (ty - rc[:, 2:3]) * wrect + (txs[None, :] - rc[:, 0:1])
    binned = (txs[None, :] >= rc[:, 0:1]) & (txs[None, :] <= rc[:, 1:2]) & (k < blend.k_dup)
    bx0 = (txs * t).to(torch.float32) - blend.dilate
    bx1 = (txs * t + (t - 1)).to(torch.float32) + blend.dilate
    by0 = torch.full_like(bx0, float(ty * t) - blend.dilate)
    by1 = torch.full_like(bx0, float(ty * t + t - 1) + blend.dilate)
    mean_d = proj["mean"].detach()
    op = proj["opacity"][idx].detach()
    q_thresh = torch.log(torch.clamp(op, min=1e-12) / blend.alpha_min)[:, None]
    slack = 1.0 if blend.dilate > 0 else 0.0
    binned &= _q_min(mean_d[idx], proj["conic"][idx].detach(), bx0, bx1, by0, by1) <= q_thresh + slack
    binned &= torch.cumsum(binned.to(torch.int32), dim=0) <= blend.max_per_tile
    return binned


@torch.no_grad()
def render(g, active, T_w2c, cam: Camera, blend: Blend = Blend(), mm: Callable = FP32):
    """(color (H, W, 3), alpha-weighted depth (H, W), alpha (H, W))."""
    proj = project(g, active, T_w2c, cam, mm)
    order = depth_order(proj)
    rx, ry = reach(proj, blend)
    rects = tile_rects(proj, cam, blend)
    dev = T_w2c.device
    color = torch.zeros((cam.height, cam.width, 3), device=dev)
    depth = torch.zeros((cam.height, cam.width), device=dev)
    alpha = torch.zeros((cam.height, cam.width), device=dev)
    for box in blocks(cam, blend):
        y0, y1, x0, x1 = box
        c, d, a = composite_block(proj, order, rx, ry, rects, box, blend, mm)
        color[y0:y1, x0:x1], depth[y0:y1, x0:x1], alpha[y0:y1, x0:x1] = c, d, a
    return color, depth, alpha


def sensor_frame(g, active, T_w2c, cam: Camera):
    """A synthetic RGB-D frame: colour in [0, 1] and the alpha-normalised
    depth, 0 where alpha < 0.5; no cap on the tile lists (a sensor sees
    every Gaussian)."""
    blend = Blend(k_dup=0)
    color, depth, alpha = render(g, active, T_w2c, cam, blend, FP32)
    d = depth / torch.clamp(alpha, min=1e-6)
    return torch.clamp(color, 0.0, 1.0), torch.where(alpha < 0.5, torch.zeros_like(d), d)


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                        torch.stack([-y, x, zero])])


def se3_exp(tau: torch.Tensor, mm: Callable = FP32) -> torch.Tensor:
    """tau = [rho, theta] -> (4, 4): rotation by Rodrigues' formula and
    translation V rho, with the small-angle series below theta^2 < 1e-8."""
    rho, theta = tau[:3], tau[3:]
    x2 = (theta * theta).sum()
    small = x2 < 1e-8
    x2s = torch.where(small, torch.ones_like(x2), x2)
    x = torch.sqrt(x2s)
    a = torch.where(small, 1.0 - x2 / 6.0, torch.sin(x) / x)
    b = torch.where(small, 0.5 - x2 / 24.0, (1.0 - torch.cos(x)) / x2s)
    c = torch.where(small, 1.0 / 6.0 - x2 / 120.0, (x - torch.sin(x)) / (x2s * x))
    K = hat(theta)
    K2 = mm(K, K)
    eye = torch.eye(3, device=tau.device)
    rot = eye + a * K + b * K2
    V = eye + b * K + c * K2
    top = torch.cat([rot, mm(V, rho[:, None])], dim=1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=tau.device)], dim=0)


def rows_of(params) -> Dict[str, torch.Tensor]:
    """The fields the renderer reads, from any object with the attributes
    xyz, f_dc, log_scales, quats and opacity_logit."""
    keys = ("xyz", "f_dc", "log_scales", "quats", "opacity_logit")
    return {k: getattr(params, k).float() for k in keys}

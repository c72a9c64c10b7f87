"""The least time an H100 could take for one launch of the port's blend
kernels: a frozen copy of the arithmetic of the port's
`ops/blend_timing.py::bound`, with the card's peaks and a plain count of
the (entry, pixel) pairs that the blend multiplies in.

A kernel's roofline share is this least time over the kernel's device time
from the trace. The bound counts what the data needs, not what a kernel
reads again, so a share can reach 100% only for a kernel that does nothing
but that.
"""

from __future__ import annotations

from typing import Tuple

import torch

# NVIDIA H100 SXM (data sheet, 700 W): HBM bytes/s and fp32 (non-tensor) op/s
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# fp32 ops per (entry, pixel) pair whose alpha the blend uses, counted from
# the port's csrc/blend.cu (expf, log1pf and a division as one op each,
# compares counted; the gradients' pixel sums as one add per component)
OPS_PER_PAIR = {"K1": 29, "K3": 30, "K2": 63}
# finding those pairs: an entry's reach box (27 ops), and the box against a
# warp's 32-pixel strip (6 ops)
REACH_OPS, STRIP_OPS = 27, 6


def bound(name: str, counts: torch.Tensor, n_done: torch.Tensor, touch: torch.Tensor,
          p: int) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") of kernel `name` (K1, K3 or K2)
    on one launch over `counts.shape[0]` tiles of `p` pixels. Bytes count
    the blended entries' props (sum(counts) x 40 B) and the per-pixel
    tensors once; ops count OPS_PER_PAIR for every pair in `touch` (per
    entry, the pixels it multiplied in with alpha >= alpha_min), REACH_OPS
    per entry up to the last one its tile multiplies in, and STRIP_OPS per
    (entry, 32-pixel strip) up to the strip's last (from `n_done`, the
    entries each pixel went through)."""
    entries = float(counts.sum())
    t = counts.shape[0]
    px_bytes = 4.0 * t * p
    if name == "K2":
        nbytes = 40 * entries + 7 * px_bytes + 40 * entries  # props in, d_props out
    else:  # color, depth, alpha, t_final, n_done (+ touch)
        nbytes = 40 * entries + 4 * t + 7 * px_bytes + (4 * entries if name == "K3" else 0)
    strips = n_done.reshape(t, p // 32, 32).amax(dim=2)
    ops = (float(touch.sum()) * OPS_PER_PAIR[name]
           + REACH_OPS * float(strips.amax(dim=1).sum()) + STRIP_OPS * float(strips.sum()))
    t_bytes, t_ops = nbytes / HBM_BPS, ops / FP32_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@torch.no_grad()
def touch_counts(props: torch.Tensor, counts: torch.Tensor, tx_n: int, tile: Tuple[int, int],
                 alpha_clamp: float, alpha_min: float, t_min: float,
                 group: int = 16) -> torch.Tensor:
    """(T, L) int32: per entry of per-tile props (T, L, 10) (mean x, y;
    conic a, b, c; colour; opacity; depth), the pixels of its tile where
    it had alpha >= alpha_min while the transmittance was >= t_min. Plain
    torch, `group` tiles at a time."""
    tw, th = tile
    n_tiles, l_max, _ = props.shape
    dev = props.device
    ly, lx = torch.meshgrid(torch.arange(th, device=dev, dtype=torch.float32),
                            torch.arange(tw, device=dev, dtype=torch.float32), indexing="ij")
    lx, ly = lx.reshape(-1), ly.reshape(-1)
    slots = torch.arange(l_max, device=dev)
    out = []
    for g0 in range(0, n_tiles, group):
        g1 = min(g0 + group, n_tiles)
        pr = props[g0:g1]
        tid = torch.arange(g0, g1, device=dev)
        px = ((tid % tx_n) * tw).to(torch.float32)[:, None] + lx[None, :]
        py = ((tid // tx_n) * th).to(torch.float32)[:, None] + ly[None, :]
        live = (slots[None, :] < counts[g0:g1, None])[..., None]
        dx = px[:, None, :] - pr[..., 0:1]
        dy = py[:, None, :] - pr[..., 1:2]
        power = -0.5 * (pr[..., 2:3] * dx * dx + pr[..., 4:5] * dy * dy) - pr[..., 3:4] * dx * dy
        alpha = torch.clamp(pr[..., 8:9] * torch.exp(power), max=alpha_clamp)
        cut = (power > 0.0) | (alpha < alpha_min) | ~live
        alpha = torch.where(cut, torch.zeros_like(alpha), alpha)
        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        out.append(((alpha >= alpha_min) & (t_excl >= t_min) & live).sum(dim=2).to(torch.int32))
    return torch.cat(out, dim=0)

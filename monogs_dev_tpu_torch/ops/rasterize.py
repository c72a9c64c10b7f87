"""Tile-binned differentiable rasterizer (port of `monogs_dev_tpu/ops/rasterize.py`).

  1. project + cull (ops/project.py, differentiable incl. pose);
  2. binning (`build_binning`, integer-only): one stable depth argsort,
     duplication into <= k_dup tile entries, tight ellipse-vs-tile culling,
     one stable sort on an int64 (tile, entry) key, and three tables:
     idx_table (T, L) tile slot -> Gaussian id (sentinel N), pos_table
     (N, K) Gaussian entry -> flat slot (dummy T*L), counts (T,);
  3. per-tile property gather (`_tile_gather`, whose backward gathers
     through pos_table and sums over K);
  4. per-tile blending (ops/blend.py): CUDA kernels K1/K3 forward and K2
     backward on the card, the plain torch blend on the CPU.

A binning can be reused across nearby poses (`dilate` pixels of margin), as
the tracking and mapping loops do. Overflows are counted, never silent.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..models.camera import Intrinsics
from ..models.gaussians import GaussianParams
from .blend import blend_tiles, blend_tiles_touch
from .project import ProjectedGaussians, project_gaussians
from ..utils.profiling import spanned, sync
from .raster_types import RasterConfig, RenderOutput


class Binning(NamedTuple):
    idx_table: torch.Tensor  # (T, L) int64 Gaussian ids (sentinel N)
    pos_table: torch.Tensor  # (N, K) int64 flat slot ids (dummy T*L)
    counts: torch.Tensor  # (T,) int32
    dup_overflow: torch.Tensor  # () int64
    tile_overflow: torch.Tensor  # () int64


def tile_wh(config: RasterConfig) -> Tuple[int, int]:
    """(tile_w, tile_h); tile_h == 0 means square tiles."""
    return config.tile, config.tile_h or config.tile


def grid_dims(intr: Intrinsics, tile_w: int, tile_h: Optional[int] = None):
    th = tile_h if tile_h is not None else tile_w
    tx_n = -(-intr.width // tile_w)
    ty_n = -(-intr.height // th)
    return tx_n, ty_n, tx_n * ty_n


@spanned("bin")
@torch.no_grad()
def build_binning(proj: ProjectedGaussians, intr: Intrinsics, config: RasterConfig,
                  dilate: float = 0.0) -> Binning:
    """Bin projected Gaussians into per-tile depth-ordered lists. `dilate`
    (pixels) enlarges each tile rectangle so the binning stays valid while
    the pose drifts during a tracking or mapping loop."""
    tw, th = tile_wh(config)
    l_max = config.max_per_tile
    k_dup = config.k_dup
    tx_n, ty_n, n_tiles = grid_dims(intr, tw, th)
    n = proj.means2d.shape[0]
    dev = proj.means2d.device

    sort_depth = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, math.inf))
    order = torch.argsort(sort_depth, stable=True)
    m = proj.means2d[order]
    r = (proj.radii + dilate)[order]
    val = proj.valid[order]

    def span(lo, hi, size, n_max):
        a = torch.clamp(torch.floor(lo / size), 0, n_max - 1).to(torch.int64)
        b = torch.clamp(torch.floor(hi / size), 0, n_max - 1).to(torch.int64)
        return a, b

    tx0, tx1 = span(m[:, 0] - r, m[:, 0] + r, tw, tx_n)
    ty0, ty1 = span(m[:, 1] - r, m[:, 1] + r, th, ty_n)
    wrect = tx1 - tx0 + 1
    n_span = wrect * (ty1 - ty0 + 1)
    span_cap = torch.clamp(n_span, max=k_dup)
    dup_overflow = torch.where(val, n_span - span_cap, torch.zeros_like(n_span)).sum()

    ks = torch.arange(k_dup, device=dev)
    within = (ks[None, :] < span_cap[:, None]) & val[:, None]
    tyk = ty0[:, None] + ks[None, :] // wrect[:, None]
    txk = tx0[:, None] + ks[None, :] % wrect[:, None]
    tid = torch.where(within, tyk * tx_n + txk, torch.full_like(tyk, n_tiles))  # (N, K)

    if config.tight_cull:
        # an entry whose largest alpha over the (dilated) tile box stays
        # below alpha_min contributes nothing and is dropped exactly; a
        # constant slack under reuse absorbs conic and opacity drift
        con = proj.conic[order]
        opa = proj.opacity[order]
        bx0 = (txk * tw).to(torch.float32) - dilate
        bx1 = (txk * tw + (tw - 1)).to(torch.float32) + dilate
        by0 = (tyk * th).to(torch.float32) - dilate
        by1 = (tyk * th + (th - 1)).to(torch.float32) + dilate
        dx0 = bx0 - m[:, 0:1]
        dx1 = bx1 - m[:, 0:1]
        dy0 = by0 - m[:, 1:2]
        dy1 = by1 - m[:, 1:2]
        ca, cb, cc = con[:, 0:1], con[:, 1:2], con[:, 2:3]

        def q(dx, dy):
            return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

        ca_s = torch.clamp(ca, min=1e-12)
        cc_s = torch.clamp(cc, min=1e-12)
        q_edges = torch.minimum(
            torch.minimum(
                q(dx0, torch.clamp(-cb * dx0 / cc_s, dy0, dy1)),
                q(dx1, torch.clamp(-cb * dx1 / cc_s, dy0, dy1)),
            ),
            torch.minimum(
                q(torch.clamp(-cb * dy0 / ca_s, dx0, dx1), dy0),
                q(torch.clamp(-cb * dy1 / ca_s, dx0, dx1), dy1),
            ),
        )
        inside = (dx0 <= 0.0) & (dx1 >= 0.0) & (dy0 <= 0.0) & (dy1 >= 0.0)
        q_min = torch.where(inside, torch.zeros_like(q_edges), q_edges)
        q_thresh = torch.log(torch.clamp(opa, min=1e-12) / config.alpha_min)[:, None]
        slack = 1.0 if dilate > 0 else 0.0
        tid = torch.where(q_min <= q_thresh + slack, tid, torch.full_like(tid, n_tiles))

    nk = n * k_dup
    eid = torch.arange(nk, device=dev)
    key = torch.sort(tid.reshape(-1) * nk + eid, stable=True).values
    sorted_tid = key // nk
    sorted_eid = key % nk
    starts = torch.searchsorted(sorted_tid, torch.arange(n_tiles + 1, device=dev))
    seg_len = starts[1:] - starts[:-1]
    counts = torch.clamp(seg_len, max=l_max).to(torch.int32)
    tile_overflow = torch.clamp(seg_len - l_max, min=0).sum()

    pos = eid
    rank = pos - starts[torch.clamp(sorted_tid, 0, n_tiles - 1)]
    in_table = (sorted_tid < n_tiles) & (rank < l_max)
    slot_at_pos = torch.where(in_table, sorted_tid * l_max + rank,
                              torch.full_like(rank, n_tiles * l_max))

    offs = torch.arange(l_max, device=dev)
    gpos = starts[:-1, None] + offs[None, :]
    in_seg = offs[None, :] < counts[:, None]
    sorted_j = sorted_eid // k_dup
    idx_sorted_space = torch.where(in_seg, sorted_j[torch.clamp(gpos, 0, max(nk - 1, 0))],
                                   torch.full_like(gpos, n))
    order_pad = torch.cat([order, torch.full((1,), n, dtype=order.dtype, device=dev)])
    idx_table = order_pad[idx_sorted_space]

    pos_of_entry = torch.empty_like(sorted_eid)
    pos_of_entry[sorted_eid] = pos
    pos_table_sorted = slot_at_pos[pos_of_entry].reshape(n, k_dup)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=dev)
    pos_table = pos_table_sorted[inv_order]
    return Binning(idx_table, pos_table, counts, dup_overflow, tile_overflow)


@spanned("bin")
@torch.no_grad()
def compact_binning(binning: Binning, n: int, m: int):
    """Compact a binning to the <= m Gaussians that have tile entries and
    remap both tables to compact ids. Returns (sel (m,) with fill n,
    compact binning, n_dropped); bit-exact when n_dropped == 0."""
    t, l = binning.idx_table.shape
    flat_slots = t * l
    k = binning.pos_table.shape[1]
    dev = binning.idx_table.device
    has_entry = (binning.pos_table < flat_slots).any(dim=1)
    with sync("compact"):
        nz = torch.nonzero(has_entry).flatten()[:m]
    sel = torch.full((m,), n, dtype=torch.int64, device=dev)
    sel[: nz.numel()] = nz
    n_dropped = torch.clamp(has_entry.sum() - m, min=0)
    new_id = torch.full((n + 1,), m, dtype=torch.int64, device=dev)
    new_id[nz] = torch.arange(nz.numel(), device=dev)
    idx_table_c = new_id[binning.idx_table]
    pos_pad = torch.cat([binning.pos_table,
                         torch.full((1, k), flat_slots, dtype=torch.int64, device=dev)])
    binning_c = Binning(idx_table_c, pos_pad[sel], binning.counts,
                        binning.dup_overflow, binning.tile_overflow)
    return sel, binning_c, n_dropped


class _TileGather(torch.autograd.Function):
    """props_pad (N+1, D) -> (T, L, D) through idx_table; the backward
    gathers each Gaussian's K entries through pos_table and sums them."""

    @staticmethod
    def forward(ctx, props_pad, idx_table, pos_table):
        ctx.save_for_backward(pos_table)
        ctx.tl = idx_table.shape
        return props_pad[idx_table]

    @staticmethod
    def backward(ctx, g):
        (pos_table,) = ctx.saved_tensors
        t, l = ctx.tl
        d = g.shape[-1]
        g_flat = torch.cat([g.reshape(t * l, d), g.new_zeros((1, d))], dim=0)
        d_props = g_flat[torch.clamp(pos_table, 0, t * l)].sum(dim=1)
        return torch.cat([d_props, g.new_zeros((1, d))], dim=0), None, None


def _tile_gather(props_pad, idx_table, pos_table):
    return _TileGather.apply(props_pad, idx_table, pos_table)


@spanned("render")
def render_binned(proj: ProjectedGaussians, means2d: torch.Tensor, binning: Binning,
                  intr: Intrinsics, bg_color: torch.Tensor, config: RasterConfig,
                  need_touched: bool, tile_mask: Optional[torch.Tensor] = None) -> RenderOutput:
    """Composite with a prebuilt binning; differentiable w.r.t. the projection.
    `tile_mask` (n_tiles,) bool zeroes the entry counts of excluded tiles
    (they render as background)."""
    tw, th = tile_wh(config)
    tx_n, ty_n, n_tiles = grid_dims(intr, tw, th)
    h, w = intr.height, intr.width
    n = means2d.shape[0]
    counts = binning.counts
    if tile_mask is not None:
        counts = torch.where(tile_mask, counts, torch.zeros_like(counts))

    props = torch.cat([means2d, proj.conic, proj.color, proj.opacity[:, None],
                       proj.depth[:, None]], dim=-1)
    props_pad = torch.cat([props, props.new_zeros((1, 10))], dim=0)
    t_props = _tile_gather(props_pad, binning.idx_table, binning.pos_table)

    args = (t_props, counts, tx_n, (tw, th), config.alpha_clamp, config.alpha_min,
            config.transmittance_min, config.tile_group)
    if need_touched:
        color_t, depth_t, alpha_t, touch = blend_tiles_touch(*args)
    else:
        color_t, depth_t, alpha_t = blend_tiles(*args)
    colors = color_t.transpose(1, 2) + (1.0 - alpha_t[..., None]) * bg_color

    def tiles_to_image(x):
        c = x.shape[3:]
        img = x.reshape((ty_n, tx_n, th, tw) + c).transpose(1, 2)
        return img.reshape((ty_n * th, tx_n * tw) + c)[:h, :w]

    if need_touched:
        cnt = torch.zeros((n + 1,), dtype=torch.int32, device=means2d.device)
        cnt.index_add_(0, binning.idx_table.reshape(-1), touch.reshape(-1))
        n_touched = cnt[:n]
    else:
        n_touched = torch.zeros((n,), dtype=torch.int32, device=means2d.device)

    return RenderOutput(
        color=tiles_to_image(colors.reshape(n_tiles, th, tw, 3)),
        depth=tiles_to_image(depth_t.reshape(n_tiles, th, tw)),
        alpha=tiles_to_image(alpha_t.reshape(n_tiles, th, tw)),
        n_touched=n_touched,
        radii=proj.radii,
        visible=proj.radii > 0.0,
        dup_overflow=binning.dup_overflow,
        tile_overflow=binning.tile_overflow,
    )


def render_tiled(params: GaussianParams, active: torch.Tensor, T_w2c: torch.Tensor,
                 intr: Intrinsics, sh_degree: int, bg_color: Optional[torch.Tensor] = None,
                 config: RasterConfig = RasterConfig(),
                 means2d_probe: Optional[torch.Tensor] = None,
                 scale_modifier: float = 1.0, isotropic: bool = False,
                 need_touched: bool = True, binning: Optional[Binning] = None) -> RenderOutput:
    """Project + bin + composite (rebinning every call unless one is given)."""
    proj = project_gaussians(params, active, T_w2c, intr, sh_degree, scale_modifier, isotropic)
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    if bg_color is None:
        bg_color = means2d.new_zeros((3,))
    if binning is None:
        binning = build_binning(proj, intr, config)
    return render_binned(proj, means2d, binning, intr, bg_color, config, need_touched)


# tiles per chunk of render_median_depth: (64, L, 256) float32 tensors, ~67 MB
# each at L = 1024
MEDIAN_TILES_PER_CHUNK = 64


@torch.no_grad()
def render_median_depth(params: GaussianParams, active: torch.Tensor, T_w2c: torch.Tensor,
                        intr: Intrinsics, config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """Per-pixel median depth: the z of the Gaussian where the cumulative
    blend weight first reaches half the pixel's total weight; 0 where the
    total weight is under 1e-6 (port of the JAX package's
    `render_median_depth`).

    Offline, for sensor-like ground-truth depth in the fixture writers and
    the stereo check: the alpha-normalised expected depth blends depths
    across silhouettes, the median is the depth of a Gaussian that
    contributes. Plain torch over the port's binning and tile gather,
    MEDIAN_TILES_PER_CHUNK tiles at a time; not on the SLAM path."""
    proj = project_gaussians(params, active, T_w2c, intr, 0)
    binning = build_binning(proj, intr, config)
    tw, th = tile_wh(config)
    tx_n, ty_n, n_tiles = grid_dims(intr, tw, th)
    props = torch.cat([proj.means2d, proj.conic, proj.color, proj.opacity[:, None],
                       proj.depth[:, None]], dim=-1)
    props_pad = torch.cat([props, props.new_zeros((1, 10))], dim=0)
    dev = props.device
    t_ids = torch.arange(n_tiles, device=dev)
    origins = torch.stack([(t_ids % tx_n) * tw, (t_ids // tx_n) * th], dim=-1).to(torch.float32)
    ly, lx = torch.meshgrid(torch.arange(th, dtype=torch.float32, device=dev),
                            torch.arange(tw, dtype=torch.float32, device=dev), indexing="ij")
    local = torch.stack([lx.reshape(-1), ly.reshape(-1)], dim=-1)  # (P, 2)
    out = []
    for t0 in range(0, n_tiles, MEDIAN_TILES_PER_CHUNK):
        t1 = t0 + MEDIAN_TILES_PER_CHUNK
        t_props = props_pad[binning.idx_table[t0:t1]]  # (C, L, 10)
        pix = origins[t0:t1, None, :] + local[None]  # (C, P, 2)
        mu, con = t_props[..., 0:2], t_props[..., 2:5]
        opa, z = t_props[..., 8], t_props[..., 9]
        dx = pix[:, None, :, 0] - mu[..., 0:1]  # (C, L, P)
        dy = pix[:, None, :, 1] - mu[..., 1:2]
        power = (-0.5 * (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy)
                 - con[..., 1:2] * dx * dy)
        alpha = torch.clamp(opa[..., None] * torch.exp(power), max=config.alpha_clamp)
        alpha = torch.where((power > 0.0) | (alpha < config.alpha_min), 0.0, alpha)
        log_om = torch.log1p(-alpha)
        t_in = torch.exp(torch.cumsum(log_om, dim=1) - log_om)
        wgt = torch.where(t_in >= config.transmittance_min, alpha * t_in, 0.0)
        cum = torch.cumsum(wgt, dim=1)  # depth-ordered: the binning sorts by depth
        total = cum[:, -1]
        first = (cum >= 0.5 * total[:, None]).to(torch.uint8).argmax(dim=1)  # (C, P)
        dep = torch.gather(z, 1, first)
        out.append(torch.where(total > 1e-6, dep, 0.0))
    img = torch.cat(out).reshape(ty_n, tx_n, th, tw).transpose(1, 2)
    return img.reshape(ty_n * th, tx_n * tw)[:intr.height, :intr.width]

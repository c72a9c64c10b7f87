"""The blend-kernel lab: L1 (forward variants) and L2 (moments backward), the
CUDA kernels and their plain versions.

Counterpart of `tools/kernel_lab.py::variant_blend` and `::moments_bwd`.
The kernels live in `csrc/blend_lab.cu` (version 2) and are built with the
blend kernels into one library (ops/blend.py::build), together with their
first version (the lab's second source in `SOURCE_FLAGS`), a yardstick
reached only through `lab_forward_launcher`/`moments_launcher` with
`version=1` (which count no launch). `lab_blend` and `moments_backward` dispatch on the device of
`props`: a CUDA tensor goes to the kernel (a build or launch failure
raises), a CPU tensor to the plain version.

L1 variants (`LAB_VARIANTS`; `pairN` for N in 2, 4) compute K1's forward
(color, depth, alpha) in other arithmetic forms: the conic power directly or
as rank-6 coefficients against tile-local pixel monomials (mxu, lean),
transmittance as a running product or in log space (trimat), and the
weighted sums in registers or from weights staged in shared memory (lean,
storew). Contract: like the TPU variants they read whole 32-entry chunks
past each tile's count and mask nothing, so props past `counts` must be
zero (what the binning's gather writes). The plain version evaluates the
same power and transmittance expressions in the same order, so a variant is
held to it tightly; the accumulation form changes only the order of the
final sums.

L2 is the blend's props gradient with each chunk's per-entry pixel
reductions taken as moments against the tile-local basis [1, lx, ly, lx^2,
lx ly, ly^2, gD, gC0..2]. It reads K1's residuals (`t_final`, `n_done` per
pixel; `blend_residuals`). The plain version recovers each chunk's starting
transmittance by dividing out the chunk's product, as the TPU lab did; the
kernel divides out entry by entry, as K2 does (the same function, rounded
otherwise). The conic gradients cancel in the moments form, so the basis is
centred on the tile, the moments are summed accurately (fp32 warp sums of
fp32 products combined across warps in fp64 in the kernel, float64 sums of
the float32 products in the plain version) and combined into d_mean and
d_conic in float64.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .blend import (D_IN, LAB_ENTRIES, LAUNCHES, _check, _load, _raise_on, _tile_wh,
                    blend_forward_cuda)

CHUNK = 32
LAB_VARIANTS = ("nocond", "acc8", "trimat", "mxu", "lean", "storew", "pair2", "pair4")
# variant -> (kernel code in csrc/blend_lab.cu, rank-6 power, log-space transmittance)
_FORMS = {
    "nocond": (0, False, False), "acc8": (0, False, False), "trimat": (1, False, True),
    "mxu": (2, True, False), "lean": (3, True, False), "storew": (4, False, False),
    "pair2": (5, False, False), "pair4": (6, False, False),
}
# per-variant launches of L1 (their sum is LAUNCHES["L1"])
VARIANT_LAUNCHES: Dict[str, int] = {v: 0 for v in LAB_VARIANTS}


def _form(variant: str):
    if variant not in _FORMS:
        raise ValueError(f"unknown lab variant {variant!r}: one of {LAB_VARIANTS}")
    return _FORMS[variant]


def _tiles_per_block(variant: str) -> int:
    return int(variant[4:]) if variant.startswith("pair") else 1


def _check_tile_count(variant: str, n_tiles: int) -> None:
    n = _tiles_per_block(variant)
    if n_tiles % n:
        raise ValueError(f"{variant} needs tile count % {n} == 0, got {n_tiles} tiles")


# ------------------------------------------------------------------- L1


def lab_forward_launcher(variant, props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                         version: int = 2) -> Tuple[Callable[[], None], tuple]:
    """Check the inputs of L1 `variant` and allocate its outputs, color
    (T,3,P), depth (T,P) and alpha (T,P). Returns (launch, outputs):
    `launch()` runs the kernel of `version` (2, or the first version 1) into
    those outputs through its C entry point on the current stream and does
    no other host work, so that repeated launches time the kernel alone. It
    counts no launch."""
    code, _, _ = _form(variant)
    tw, th = _tile_wh(tile)
    p = tw * th
    if p % 32 or p > 1024:
        raise ValueError(f"tile of {p} pixels: need a multiple of 32 up to 1024")
    t, l, _ = props.shape
    _check(props, "props", torch.float32, (t, l, D_IN))
    _check(counts, "counts", torch.int32, (t,))
    _check_tile_count(variant, t)
    name = LAB_ENTRIES[version][0]
    fn = getattr(_load(), name)
    dev = props.device
    color = torch.empty((t, 3, p), dtype=torch.float32, device=dev)
    depth = torch.empty((t, p), dtype=torch.float32, device=dev)
    alpha = torch.empty((t, p), dtype=torch.float32, device=dev)
    args = (code, props.data_ptr(), counts.data_ptr(), t, l, int(tx_n), tw, th,
            float(alpha_clamp), float(alpha_min), float(t_min),
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> None:
        _raise_on(fn(*args), f"{name} ({variant})")

    return launch, (color, depth, alpha)


def lab_forward_cuda(variant, props, counts, tx_n, tile, alpha_clamp=0.99,
                     alpha_min=1.0 / 255.0, t_min=1e-4):
    """Launch L1 `variant`: color (T,3,P), depth (T,P), alpha (T,P).
    Props past each tile's count must be zero (see the module note)."""
    launch, out = lab_forward_launcher(variant, props, counts, tx_n, tile, alpha_clamp,
                                       alpha_min, t_min)
    launch()
    LAUNCHES["L1"] += 1
    VARIANT_LAUNCHES[variant] += 1
    return out


def _pixel_coords(tw: int, th: int, dev):
    ly, lx = torch.meshgrid(torch.arange(th, device=dev, dtype=torch.float32),
                            torch.arange(tw, device=dev, dtype=torch.float32), indexing="ij")
    return lx.reshape(-1), ly.reshape(-1)


def _pad_entries(props: torch.Tensor) -> torch.Tensor:
    """Zero rows up to a multiple of CHUNK entries (rows past L read as zero)."""
    pad = -props.shape[1] % CHUNK
    if pad:
        props = torch.cat([props, props.new_zeros((props.shape[0], pad, D_IN))], dim=1)
    return props


def _chunk_alpha(chunk, ox, oy, lx, ly, rank6: bool, alpha_clamp, alpha_min):
    """alpha (G, C, P) of a chunk (G, C, 10) of entries, with the kernel's
    expressions in the kernel's order."""
    mu_x, mu_y = chunk[..., 0:1], chunk[..., 1:2]
    ca, cb, cc = chunk[..., 2:3], chunk[..., 3:4], chunk[..., 4:5]
    if rank6:
        mx, my = mu_x - ox[:, None, None], mu_y - oy[:, None, None]
        c3 = -(ca * mx + cb * my)
        c4 = -(cb * mx + cc * my)
        c5 = 0.5 * ca * mx * mx + cb * mx * my + 0.5 * cc * my * my
        power = -(0.5 * ca * (lx * lx) + cb * (lx * ly) + 0.5 * cc * (ly * ly)
                  + c3 * lx + c4 * ly + c5)
    else:
        dx = (ox[:, None, None] + lx) - mu_x
        dy = (oy[:, None, None] + ly) - mu_y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.minimum(torch.full_like(power, alpha_clamp), chunk[..., 8:9] * torch.exp(power))
    return torch.where((power > 0.0) | (alpha < alpha_min), torch.zeros_like(alpha), alpha)


def lab_blend_reference(variant, props, counts, tx_n, tile=16, alpha_clamp=0.99,
                        alpha_min=1.0 / 255.0, t_min=1e-4, tile_group=60):
    """Plain torch L1: each tile blends its entries [0, 32 ceil(count / 32))
    (pairN: the largest such range of its N tiles) chunk by chunk, with no
    mask, in `variant`'s power and transmittance form."""
    _, rank6, logt = _form(variant)
    tw, th = _tile_wh(tile)
    n_tiles = props.shape[0]
    _check_tile_count(variant, n_tiles)
    dev = props.device
    props = _pad_entries(props)
    lx, ly = _pixel_coords(tw, th, dev)
    n_chunks = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    nt = _tiles_per_block(variant)
    n_chunks = n_chunks.reshape(-1, nt).amax(dim=1).repeat_interleave(nt)
    outs = []
    for g0 in range(0, n_tiles, tile_group):
        g1 = min(g0 + tile_group, n_tiles)
        tid = torch.arange(g0, g1, device=dev)
        ox = ((tid % tx_n) * tw).to(torch.float32)
        oy = ((tid // tx_n) * th).to(torch.float32)
        nc = n_chunks[g0:g1]
        t_run = torch.ones((g1 - g0, tw * th), device=dev)
        color = torch.zeros((g1 - g0, 3, tw * th), device=dev)
        depth = torch.zeros((g1 - g0, tw * th), device=dev)
        acc_w = torch.zeros((g1 - g0, tw * th), device=dev)
        for k in range(int(nc.max()) if g1 > g0 else 0):
            chunk = props[g0:g1, k * CHUNK:(k + 1) * CHUNK]
            alpha = _chunk_alpha(chunk, ox, oy, lx, ly, rank6, alpha_clamp, alpha_min)
            if logt:
                lom = torch.log1p(-alpha)
                cs = torch.cumsum(lom, dim=1)
                t_in = t_run[:, None] * torch.exp(cs - lom)
                last = torch.exp(cs[:, -1])
            else:
                incl = torch.cumprod(1.0 - alpha, dim=1)
                excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
                t_in = t_run[:, None] * excl
                last = incl[:, -1]
            live = (k < nc)[:, None, None]
            w = torch.where((t_in >= t_min) & live, alpha * t_in, torch.zeros_like(t_in))
            color += torch.einsum("gjp,gjc->gcp", w, chunk[..., 5:8])
            depth += torch.einsum("gjp,gj->gp", w, chunk[..., 9])
            acc_w += w.sum(dim=1)
            t_run = torch.where(live[:, 0], t_run * last, t_run)
        outs.append((color, depth, acc_w))
    return tuple(torch.cat(x, dim=0) for x in zip(*outs))


def lab_blend(variant, props, counts, tx_n, tile=16, alpha_clamp=0.99,
              alpha_min=1.0 / 255.0, t_min=1e-4, tile_group=60):
    """L1 `variant` of the forward blend: (color (T,3,P), depth (T,P),
    alpha (T,P)). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if props.is_cuda:
        return lab_forward_cuda(variant, props.contiguous(), counts, tx_n, tile, alpha_clamp,
                                alpha_min, t_min)
    if props.device.type != "cpu":
        raise ValueError(f"lab_blend: unsupported device {props.device}")
    return lab_blend_reference(variant, props, counts, tx_n, tile, alpha_clamp, alpha_min,
                               t_min, tile_group)


# ------------------------------------------------------------------- L2


def blend_residuals_reference(props, counts, tx_n, tile=16, alpha_clamp=0.99,
                              alpha_min=1.0 / 255.0, t_min=1e-4, tile_group=60):
    """K1's residuals in plain torch: per pixel, the number of entries it
    multiplied into its transmittance before that fell below t_min (or the
    tile's count ran out), n_done (T,P) int32, and the transmittance after
    them, t_final (T,P)."""
    tw, th = _tile_wh(tile)
    n_tiles, l_max, _ = props.shape
    dev = props.device
    lx, ly = _pixel_coords(tw, th, dev)
    slots = torch.arange(l_max, device=dev)
    t_fin, n_done = [], []
    for g0 in range(0, n_tiles, tile_group):
        g1 = min(g0 + tile_group, n_tiles)
        tid = torch.arange(g0, g1, device=dev)
        ox = ((tid % tx_n) * tw).to(torch.float32)
        oy = ((tid // tx_n) * th).to(torch.float32)
        alpha = _chunk_alpha(props[g0:g1], ox, oy, lx, ly, False, alpha_clamp, alpha_min)
        live = (slots[None, :] < counts[g0:g1, None])[..., None]
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        nd = ((t_excl >= t_min) & live).sum(dim=1)
        last = torch.gather(t_incl, 1, torch.clamp(nd - 1, min=0)[:, None, :])[:, 0]
        t_fin.append(torch.where(nd > 0, last, torch.ones_like(last)))
        n_done.append(nd.to(torch.int32))
    return torch.cat(t_fin, dim=0), torch.cat(n_done, dim=0)


def blend_residuals(props, counts, tx_n, tile=16, alpha_clamp=0.99, alpha_min=1.0 / 255.0,
                    t_min=1e-4, tile_group=60) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_final, n_done) of the forward blend: from K1 on a CUDA tensor, from
    the plain version on a CPU tensor."""
    if props.is_cuda:
        out = blend_forward_cuda(props.contiguous(), counts, tx_n, tile, alpha_clamp, alpha_min,
                                 t_min, emit_touch=False)
        return out[3], out[4]
    return blend_residuals_reference(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                                     tile_group)


def moments_launcher(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, tile,
                     alpha_clamp, alpha_min,
                     version: int = 2) -> Tuple[Callable[[], None], torch.Tensor]:
    """L2's counterpart of `lab_forward_launcher`: checks the inputs,
    allocates d_props (T, L, 10) (zero: the kernel writes the entries some
    pixel multiplied in) and returns (launch, d_props)."""
    tw, th = _tile_wh(tile)
    p = tw * th
    if p % 32 or p > 512:
        raise ValueError(f"tile of {p} pixels: L2 needs a multiple of 32 up to 512")
    t, l, _ = props.shape
    _check(props, "props", torch.float32, (t, l, D_IN))
    _check(t_final, "t_final", torch.float32, (t, p))
    _check(n_done, "n_done", torch.int32, (t, p))
    _check(g_color, "g_color", torch.float32, (t, 3, p))
    _check(g_depth, "g_depth", torch.float32, (t, p))
    _check(g_alpha, "g_alpha", torch.float32, (t, p))
    name = LAB_ENTRIES[version][1]
    fn = getattr(_load(), name)
    d_props = torch.zeros((t, l, D_IN), dtype=torch.float32, device=props.device)
    args = (props.data_ptr(), t, l, int(tx_n), tw, th, float(alpha_clamp), float(alpha_min),
            t_final.data_ptr(), n_done.data_ptr(), g_color.data_ptr(), g_depth.data_ptr(),
            g_alpha.data_ptr(), d_props.data_ptr(),
            torch.cuda.current_stream(props.device).cuda_stream)

    def launch() -> None:
        _raise_on(fn(*args), name)

    return launch, d_props


def moments_backward_cuda(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, tile,
                          alpha_clamp=0.99, alpha_min=1.0 / 255.0):
    """Launch L2: d_props (T, L, 10) from K1's residuals and the cotangents."""
    launch, d_props = moments_launcher(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n,
                                       tile, alpha_clamp, alpha_min)
    launch()
    LAUNCHES["L2"] += 1
    return d_props


def moments_backward_reference(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n,
                               tile=16, alpha_clamp=0.99, alpha_min=1.0 / 255.0,
                               tile_group=60):
    """Plain torch L2, chunk by chunk from the back, with the kernel's
    divide-out, suffix sums and moments."""
    tw, th = _tile_wh(tile)
    n_tiles, l_in, _ = props.shape
    dev = props.device
    props = _pad_entries(props)
    lx, ly = _pixel_coords(tw, th, dev)
    cx, cy = 0.5 * (tw - 1), 0.5 * (th - 1)  # the basis is centred on the tile
    bx, by = lx - cx, ly - cy
    geo = torch.stack([torch.ones_like(bx), bx, by, bx * bx, bx * by, by * by]).double()
    d_props = torch.zeros_like(props)
    slots = torch.arange(CHUNK, device=dev)
    for g0 in range(0, n_tiles, tile_group):
        g1 = min(g0 + tile_group, n_tiles)
        tid = torch.arange(g0, g1, device=dev)
        ox = ((tid % tx_n) * tw).to(torch.float32)
        oy = ((tid // tx_n) * th).to(torch.float32)
        nd = n_done[g0:g1].to(torch.int64)
        gc, gd, ga = g_color[g0:g1], g_depth[g0:g1], g_alpha[g0:g1]
        cot = torch.cat([gd[:, None], gc], dim=1).double()  # (G, 4, P): gD, gC0..2
        t_after = t_final[g0:g1]
        s_wsum = torch.zeros_like(t_after)
        for k in range((int(nd.max()) + CHUNK - 1) // CHUNK - 1, -1, -1):
            chunk = props[g0:g1, k * CHUNK:(k + 1) * CHUNK]
            used = (k * CHUNK + slots)[None, :, None] < nd[:, None, :]  # (G, C, P)
            alpha = _chunk_alpha(chunk, ox, oy, lx, ly, False, alpha_clamp, alpha_min)
            alpha = torch.where(used, alpha, torch.zeros_like(alpha))
            om = 1.0 - alpha
            incl = torch.cumprod(om, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
            t_start = t_after / incl[:, -1]
            t_in = t_start[:, None] * excl
            w = torch.where(used, alpha * t_in, torch.zeros_like(t_in))
            dl = (chunk[..., 5:6] * gc[:, 0:1] + chunk[..., 6:7] * gc[:, 1:2]
                  + chunk[..., 7:8] * gc[:, 2:3] + chunk[..., 9:10] * gd[:, None] + ga[:, None])
            wdl = w * dl
            # suffix sums over the later entries of the chunk, summed from the back
            rc = torch.flip(torch.cumsum(torch.flip(wdl, [1]), dim=1), [1])
            later = torch.cat([rc[:, 1:], torch.zeros_like(rc[:, :1])], dim=1)
            S = later + s_wsum[:, None]
            d_alpha = torch.where(used & (alpha > 0.0), t_in * dl - S / om, torch.zeros_like(om))
            opa = chunk[..., 8:9]
            G = torch.where(opa > 0.0, alpha / torch.clamp(opa, min=1e-12), torch.zeros_like(alpha))
            nc = alpha < alpha_clamp
            d_pow = torch.where(nc, d_alpha * alpha, torch.zeros_like(alpha))
            d_opa = torch.where(nc, d_alpha * G, torch.zeros_like(alpha))
            # the moments, summed and combined in float64 (the kernel's
            # compensated sums and fp64 derivation)
            Mg = torch.einsum("gjp,kp->gjk", d_pow.double(), geo)
            Mw = torch.einsum("gjp,gkp->gjk", w.double(), cot)
            S0, Sx, Sy, Sxx, Sxy, Syy = Mg.unbind(-1)
            mx = (chunk[..., 0] - (ox + cx)[:, None]).double()
            my = (chunk[..., 1] - (oy + cy)[:, None]).double()
            ca, cb, cc = (chunk[..., k].double() for k in (2, 3, 4))
            d_props[g0:g1, k * CHUNK:(k + 1) * CHUNK] = torch.stack([
                ca * (Sx - mx * S0) + cb * (Sy - my * S0),
                cc * (Sy - my * S0) + cb * (Sx - mx * S0),
                -0.5 * (Sxx - 2.0 * mx * Sx + mx * mx * S0),
                -(Sxy - my * Sx - mx * Sy + mx * my * S0),
                -0.5 * (Syy - 2.0 * my * Sy + my * my * S0),
                Mw[..., 1], Mw[..., 2], Mw[..., 3], d_opa.double().sum(dim=-1), Mw[..., 0],
            ], dim=-1).float()
            s_wsum = s_wsum + rc[:, 0]
            t_after = t_start
    return d_props[:, :l_in]


def moments_backward(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, tile=16,
                     alpha_clamp=0.99, alpha_min=1.0 / 255.0, tile_group=60):
    """L2: d_props (T, L, 10) of the blend from K1's residuals (`blend_residuals`)
    and the cotangents of color, depth and alpha. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if props.is_cuda:
        return moments_backward_cuda(props.contiguous(), t_final, n_done, g_color.contiguous(),
                                     g_depth.contiguous(), g_alpha.contiguous(), tx_n, tile,
                                     alpha_clamp, alpha_min)
    if props.device.type != "cpu":
        raise ValueError(f"moments_backward: unsupported device {props.device}")
    return moments_backward_reference(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n,
                                      tile, alpha_clamp, alpha_min, tile_group)

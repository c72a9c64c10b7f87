"""Fixed-capacity Gaussian map and its state surgery (port of
`monogs_dev_tpu/models/gaussians.py`).

The map keeps a fixed row count with an `active` mask, so rows line up one for
one with the JAX map: insertion scatters into the lowest free rows with zeroed
Adam moments, pruning clears rows, clone/split picks budgeted top-k rows.
Functions return new dataclasses and leave their inputs unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch

from ..geometry.sh import num_sh_coeffs
from ..utils.profiling import sync

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


class _Fields:
    """Field-wise helpers shared by the small tensor dataclasses."""

    def values(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def map(self, fn, *others):
        return type(self)(
            *[fn(*vs) for vs in zip(self.values(), *(o.values() for o in others))]
        )

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class GaussianParams(_Fields):
    """Optimizable parameters; leading dim = capacity C (or batch M)."""

    xyz: torch.Tensor  # (C, 3)
    f_dc: torch.Tensor  # (C, 1, 3)
    f_rest: torch.Tensor  # (C, R, 3), R possibly 0
    log_scales: torch.Tensor  # (C, 3)
    quats: torch.Tensor  # (C, 4) wxyz, normalized on use
    opacity_logit: torch.Tensor  # (C,)


@dataclasses.dataclass
class MapAux(_Fields):
    active: torch.Tensor  # (C,) bool
    n_obs: torch.Tensor  # (C,) int32
    kf_id: torch.Tensor  # (C,) int32
    grad_accum: torch.Tensor  # (C,) f32
    denom: torch.Tensor  # (C,) f32
    max_radii: torch.Tensor  # (C,) f32


@dataclasses.dataclass
class AdamMoments:
    mu: GaussianParams
    nu: GaussianParams
    count: int  # global step


@dataclasses.dataclass
class GaussianMap:
    params: GaussianParams
    aux: MapAux
    moments: AdamMoments

    def rows(self, fn) -> "GaussianMap":
        """Apply a row-wise tensor function to every per-row field."""
        return GaussianMap(
            self.params.map(fn),
            self.aux.map(fn),
            AdamMoments(self.moments.mu.map(fn), self.moments.nu.map(fn),
                        self.moments.count),
        )


def create_map(capacity: int, sh_degree: int, device,
               dtype=torch.float32) -> GaussianMap:
    k = num_sh_coeffs(sh_degree)
    kw = dict(dtype=dtype, device=device)
    with sync("create_map"):
        unit = torch.tensor([[1.0, 0.0, 0.0, 0.0]], **kw)
    params = GaussianParams(
        xyz=torch.zeros((capacity, 3), **kw),
        f_dc=torch.zeros((capacity, 1, 3), **kw),
        f_rest=torch.zeros((capacity, max(k - 1, 0), 3), **kw),
        log_scales=torch.full((capacity, 3), -10.0, **kw),
        quats=unit.repeat(capacity, 1),
        opacity_logit=torch.full((capacity,), -10.0, **kw),
    )
    ikw = dict(dtype=torch.int32, device=device)
    aux = MapAux(
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        n_obs=torch.zeros((capacity,), **ikw),
        kf_id=torch.full((capacity,), -1, **ikw),
        grad_accum=torch.zeros((capacity,), **kw),
        denom=torch.zeros((capacity,), **kw),
        max_radii=torch.zeros((capacity,), **kw),
    )
    moments = AdamMoments(params.map(torch.zeros_like), params.map(torch.zeros_like), 0)
    return GaussianMap(params, aux, moments)


def sh_degree_of(params: GaussianParams) -> int:
    return {0: 0, 3: 1, 8: 2, 15: 3}[params.f_rest.shape[1]]


def map_rows(gmap: GaussianMap) -> int:
    return gmap.aux.active.shape[0]


def resize_map(gmap: GaussianMap, rows: int) -> GaussianMap:
    """Change the row count: grow pads with `create_map` defaults, shrink
    slices the row prefix (the caller keeps every active row inside it)."""
    cur = map_rows(gmap)
    if rows == cur:
        return gmap
    if rows < cur:
        return gmap.rows(lambda x: x[:rows])
    base = create_map(rows, sh_degree_of(gmap.params), gmap.aux.active.device,
                      gmap.params.xyz.dtype)

    def put(big, small):
        big = big.clone()
        big[:cur] = small
        return big

    return GaussianMap(
        base.params.map(put, gmap.params),
        base.aux.map(put, gmap.aux),
        AdamMoments(base.moments.mu.map(put, gmap.moments.mu),
                    base.moments.nu.map(put, gmap.moments.nu),
                    gmap.moments.count),
    )


def compact_map(gmap: GaussianMap, rows: int) -> Tuple[GaussianMap, torch.Tensor]:
    """Stable-partition active rows to the front, then resize to `rows`.
    Returns (map, perm): row i of the result is old row perm[i]."""
    c = map_rows(gmap)
    order = torch.arange(c, device=gmap.aux.active.device)
    perm = torch.argsort(torch.where(gmap.aux.active, order, order + c), stable=True)
    return resize_map(gmap.rows(lambda x: x[perm]), rows), perm


def _quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def activations(params: GaussianParams):
    """(scales, normalized quats, opacity)."""
    return (torch.exp(params.log_scales), _quat_normalize(params.quats),
            torch.sigmoid(params.opacity_logit))


def build_rotation(quats: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation."""
    q = _quat_normalize(quats)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def exponential_lr(step: int, lr_init: float, lr_final: float,
                   lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
                   max_steps: int = 1_000_000) -> float:
    """Log-linear LR interpolation with optional sine delay ramp."""
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
        )
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)


def _row_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def adam_step(params: GaussianParams, grads: GaussianParams, moments: AdamMoments,
              lrs: GaussianParams, active: torch.Tensor):
    """One Adam step masked per row; `lrs` holds one scalar LR per field.
    Inactive rows receive no update."""
    count = moments.count + 1
    c1 = 1.0 - ADAM_B1 ** count
    c2 = 1.0 - ADAM_B2 ** count
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu, lr in zip(params.values(), grads.values(), moments.mu.values(),
                                moments.nu.values(), lrs.values()):
        if p.shape[1:] == (0, 3):  # degenerate f_rest at sh_degree 0
            new_p.append(p)
            new_mu.append(mu)
            new_nu.append(nu)
            continue
        mu = ADAM_B1 * mu + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * nu + (1.0 - ADAM_B2) * g * g
        step = lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
        new_p.append(p - step * _row_mask(active, p).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    return (GaussianParams(*new_p),
            AdamMoments(GaussianParams(*new_mu), GaussianParams(*new_nu), count))


# ---------------------------------------------------------------------------
# insertion


def _scatter_rows(dst: torch.Tensor, target: torch.Tensor, src) -> torch.Tensor:
    """dst with rows `target` (< len(dst)) set from src; others dropped."""
    keep = target < dst.shape[0]
    out = dst.clone()
    with sync("scatter"):
        rows = target[keep]
    if isinstance(src, torch.Tensor) and src.dim() > 0:
        with sync("scatter"):
            src = src[keep]
        out[rows] = src.to(dst.dtype)
    else:
        with sync("scatter"):  # the scalar goes to the device through the host
            out[rows] = src
    return out


def insert_points(gmap: GaussianMap, new_params: GaussianParams, valid: torch.Tensor,
                  kf_id: int) -> Tuple[GaussianMap, int]:
    """Scatter new Gaussians into the lowest free rows, with zeroed moments.
    Returns (map, n_dropped) where n_dropped counts valid points without a
    free row."""
    active = gmap.aux.active
    c = active.shape[0]
    free = ~active
    with sync("insert"):
        slots = torch.nonzero(free).flatten()  # r-th free row, ascending
    n_free = slots.numel()
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    ok = valid & (rank < n_free)
    slots_pad = torch.cat([slots, torch.full((1,), c, dtype=slots.dtype, device=slots.device)])
    target = torch.where(ok, slots_pad[torch.clamp(rank, 0, n_free)], torch.full_like(rank, c))

    params = gmap.params.map(lambda d, s: _scatter_rows(d, target, s), new_params)
    mu = gmap.moments.mu.map(lambda d: _scatter_rows(d, target, 0.0))
    nu = gmap.moments.nu.map(lambda d: _scatter_rows(d, target, 0.0))
    aux = MapAux(
        active=_scatter_rows(gmap.aux.active, target, ok),
        n_obs=_scatter_rows(gmap.aux.n_obs, target, 0),
        kf_id=_scatter_rows(gmap.aux.kf_id, target, int(kf_id)),
        grad_accum=_scatter_rows(gmap.aux.grad_accum, target, 0.0),
        denom=_scatter_rows(gmap.aux.denom, target, 0.0),
        max_radii=_scatter_rows(gmap.aux.max_radii, target, 0.0),
    )
    with sync("insert"):
        n_dropped = int((valid & ~ok).sum())
    return GaussianMap(params, aux, AdamMoments(mu, nu, gmap.moments.count)), n_dropped


def insert_points_evict(gmap: GaussianMap, new_params: GaussianParams,
                        valid: torch.Tensor, kf_id: int):
    """`insert_points` that first evicts the lowest-opacity active rows when
    the free rows cannot hold the batch. Returns (map, n_dropped, n_evicted)."""
    active = gmap.aux.active
    c = active.shape[0]
    with sync("insert"):
        n_valid = int(valid.sum())
    with sync("insert"):
        n_free = int((~active).sum())
    deficit = max(n_valid - n_free, 0)
    n_evicted = 0
    if deficit > 0:
        _, _, opacity = activations(gmap.params)
        score = torch.where(active, opacity, torch.full_like(opacity, math.inf))
        order = torch.argsort(score, stable=True)
        evict = torch.zeros((c,), dtype=torch.bool, device=active.device)
        evict[order] = torch.arange(c, device=active.device) < deficit
        evict = evict & active
        with sync("insert"):
            n_evicted = int(evict.sum())
        gmap = prune_mask_apply(gmap, evict)
    gmap, n_dropped = insert_points(gmap, new_params, valid, kf_id)
    return gmap, n_dropped, n_evicted


def prune_mask_apply(gmap: GaussianMap, prune: torch.Tensor) -> GaussianMap:
    """Deactivate rows and reset them to the `create_map` defaults."""
    keep = gmap.aux.active & ~prune
    dead = ~keep

    def clear(x):
        return torch.where(_row_mask(dead, x), torch.zeros_like(x), x)

    p = gmap.params.map(clear)
    with sync("prune"):
        unit = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=p.quats.dtype, device=p.quats.device)
    p = p.replace(
        opacity_logit=torch.where(dead, torch.full_like(p.opacity_logit, -10.0), p.opacity_logit),
        log_scales=torch.where(dead[:, None], torch.full_like(p.log_scales, -10.0), p.log_scales),
        quats=torch.where(dead[:, None], unit.expand_as(p.quats), p.quats),
    )
    a = gmap.aux
    aux = MapAux(
        active=keep,
        n_obs=torch.where(dead, torch.zeros_like(a.n_obs), a.n_obs),
        kf_id=torch.where(dead, torch.full_like(a.kf_id, -1), a.kf_id),
        grad_accum=torch.where(dead, torch.zeros_like(a.grad_accum), a.grad_accum),
        denom=torch.where(dead, torch.zeros_like(a.denom), a.denom),
        max_radii=torch.where(dead, torch.zeros_like(a.max_radii), a.max_radii),
    )
    return GaussianMap(p, aux, AdamMoments(gmap.moments.mu.map(clear),
                                           gmap.moments.nu.map(clear),
                                           gmap.moments.count))


# ---------------------------------------------------------------------------
# densification


def add_densification_stats(aux: MapAux, means2d_grad: torch.Tensor,
                            radii: torch.Tensor, visible: torch.Tensor) -> MapAux:
    """Accumulate ||dL/dmeans2d|| for visible Gaussians and track max radii."""
    norm = torch.linalg.norm(means2d_grad, dim=-1)
    vis = visible.to(norm.dtype)
    return aux.replace(
        grad_accum=aux.grad_accum + norm * vis,
        denom=aux.denom + vis,
        max_radii=torch.maximum(aux.max_radii, radii * vis),
    )


def _top_k(score: torch.Tensor, k: int):
    """Top-k by descending score, lower index first among ties."""
    order = torch.sort(score, descending=True, stable=True).indices[:k]
    return score[order], order


def densify_and_prune(gmap: GaussianMap, noise: Union[torch.Tensor, torch.Generator],
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: float, percent_dense: float = 0.01,
                      clone_budget: int = 4096, split_budget: int = 2048,
                      current_kf: int = 0) -> Tuple[GaussianMap, int]:
    """Clone + split + opacity/size prune with budgeted top-k selection.

    `noise` is the (2, split_budget, 3) standard-normal draw for the split
    children, or a Generator to draw it from. Returns (map, n_dropped)."""
    params, aux = gmap.params, gmap.aux
    capacity = aux.active.shape[0]
    clone_budget = min(clone_budget, capacity)
    split_budget = min(split_budget, capacity)
    grads = torch.where(aux.denom > 0, aux.grad_accum / torch.clamp(aux.denom, min=1.0),
                        torch.zeros_like(aux.grad_accum))
    scales, _, _ = activations(params)
    max_scale = scales.max(dim=-1).values
    hi_grad = (grads >= max_grad) & aux.active
    clone_mask = hi_grad & (max_scale <= percent_dense * extent)
    split_mask = hi_grad & (max_scale > percent_dense * extent)
    neg_inf = torch.full_like(grads, -math.inf)

    c_scores, c_idx = _top_k(torch.where(clone_mask, grads, neg_inf), clone_budget)
    c_valid = torch.isfinite(c_scores)
    clones = params.map(lambda x: x[c_idx])

    s_scores, s_idx = _top_k(torch.where(split_mask, grads, neg_inf), split_budget)
    s_valid = torch.isfinite(s_scores)
    parents = params.map(lambda x: x[s_idx])
    rot = build_rotation(parents.quats)
    p_scales = torch.exp(parents.log_scales)
    if isinstance(noise, torch.Generator):
        noise = torch.randn((2, split_budget, 3), generator=noise,
                            device=noise.device).to(params.xyz.device)
    samples = noise.to(params.xyz.dtype)
    child_xyz = parents.xyz[None] + (rot[None] @ (samples * p_scales[None])[..., None])[..., 0]
    child_log_scales = torch.log(torch.clamp(p_scales / (0.8 * 2.0), min=1e-12))

    def stack2(x):
        return torch.cat([x, x], dim=0)

    children = GaussianParams(
        xyz=child_xyz.reshape(2 * split_budget, 3),
        f_dc=stack2(parents.f_dc),
        f_rest=stack2(parents.f_rest),
        log_scales=stack2(child_log_scales),
        quats=stack2(parents.quats),
        opacity_logit=stack2(parents.opacity_logit),
    )
    new_params = clones.map(lambda a, b: torch.cat([a, b], dim=0), children)
    new_valid = torch.cat([c_valid, s_valid, s_valid], dim=0)

    parent_prune = torch.zeros_like(split_mask)
    parent_prune[s_idx] = s_valid
    gmap = prune_mask_apply(gmap, parent_prune)
    gmap, n_dropped = insert_points(gmap, new_params, new_valid, current_kf)

    scales, _, opacity = activations(gmap.params)
    prune = (opacity < min_opacity) & gmap.aux.active
    if max_screen_size > 0:
        big_screen = gmap.aux.max_radii > max_screen_size
        big_world = scales.max(dim=-1).values > 0.1 * extent
        prune = prune | ((big_screen | big_world) & gmap.aux.active)
    gmap = prune_mask_apply(gmap, prune)
    aux = gmap.aux.replace(
        grad_accum=torch.zeros_like(gmap.aux.grad_accum),
        denom=torch.zeros_like(gmap.aux.denom),
        max_radii=torch.zeros_like(gmap.aux.max_radii),
    )
    return GaussianMap(gmap.params, aux, gmap.moments), n_dropped


def reset_opacity(gmap: GaussianMap, value: float = 0.01) -> GaussianMap:
    """Global opacity reset with moment reset."""
    return _cap_opacity(gmap, gmap.aux.active, value)


def reset_opacity_nonvisible(gmap: GaussianMap, visibility: torch.Tensor,
                             value: float = 0.4) -> GaussianMap:
    """Opacity reset of the active, currently non-visible Gaussians only."""
    return _cap_opacity(gmap, gmap.aux.active & ~visibility, value)


def _cap_opacity(gmap: GaussianMap, target: torch.Tensor, value: float) -> GaussianMap:
    logit = gmap.params.opacity_logit
    cap = float(inverse_sigmoid(torch.tensor(value, dtype=torch.float32)))
    new_logit = torch.where(target, torch.clamp(logit, max=cap), logit)
    mu = gmap.moments.mu.replace(opacity_logit=torch.zeros_like(new_logit))
    nu = gmap.moments.nu.replace(opacity_logit=torch.zeros_like(new_logit))
    return GaussianMap(gmap.params.replace(opacity_logit=new_logit), gmap.aux,
                       AdamMoments(mu, nu, gmap.moments.count))

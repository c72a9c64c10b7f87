"""Mapping (windowed bundle adjustment) over a fixed-slot keyframe batch
(port of `monogs_dev_tpu/core/mapping.py`).

Each iteration renders the live slots (or a random subset of them) with
gradients w.r.t. the map, per-slot pose tangents at zero, per-slot exposure
and a per-slot means2d probe; steps the masked map Adam and the keyframe
Adam over [tau, exposure]; and runs densify/prune and opacity resets on a
fixed cadence. Per-slot binnings are reused across iterations and rebuilt
every `mapping_rebin_every` iterations and after every densify or reset.
The JAX package's `lax.fori_loop` / `lax.cond` are a Python loop and
branches here.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch

from ..geometry.lie import se3_exp
from ..models.camera import Intrinsics
from ..models.gaussians import (
    GaussianMap,
    GaussianParams,
    adam_step,
    densify_and_prune,
    exponential_lr,
    prune_mask_apply,
    reset_opacity,
    reset_opacity_nonvisible,
)
from ..ops.project import project_gaussians
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import build_binning, render_binned, render_tiled
from ..utils.losses import isotropic_regularizer, mapping_loss
from ..utils.profiling import span, sync
from .params import MapOptConfig, StepConfig

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class KeyframeBatch:
    """Fixed-slot stacked keyframe data for one mapping round."""

    images: torch.Tensor  # (B, H, W, 3)
    depths: torch.Tensor  # (B, H, W), zeros when monocular
    T_w2c: torch.Tensor  # (B, 4, 4)
    exposure: torch.Tensor  # (B, 2)
    valid: torch.Tensor  # (B,) slot in use
    optimize_pose: torch.Tensor  # (B,)
    optimize_exposure: torch.Tensor  # (B,)
    apply_exposure: torch.Tensor  # (B,) exposure used in the loss
    harvest_visibility: torch.Tensor  # (B,) window slots


@dataclasses.dataclass
class KeyframeOptState:
    mu: torch.Tensor  # (B, 8) Adam moments over [tau(6), exposure(2)]
    nu: torch.Tensor  # (B, 8)
    count: int


def make_keyframe_opt_state(n_slots: int, device) -> KeyframeOptState:
    return KeyframeOptState(torch.zeros((n_slots, 8), device=device),
                            torch.zeros((n_slots, 8), device=device), 0)


class MappingResult(NamedTuple):
    gmap: GaussianMap
    batch: KeyframeBatch  # updated poses / exposures
    kf_state: KeyframeOptState
    iteration_count: int
    last_loss: float
    n_dropped: int  # densify capacity overflow
    max_drift: float  # max |means2d moved| (px) since the last rebin
    bulk_drift: float  # its 99.5th percentile
    n_free: int  # free rows after the round


class TorchDraws:
    """The mapping loop's random draws, from one Generator. Tests pass an
    object with the same three methods that replays another package's draws."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def begin_iteration(self) -> None:
        """Called once at the start of every mapping iteration."""

    def slot_perm(self, n: int) -> torch.Tensor:
        """A permutation of range(n): the order in which slots 1.. are picked."""
        return torch.randperm(n, generator=self.gen, device=self.gen.device)

    def split_noise(self, budget: int) -> torch.Tensor:
        """(2, budget, 3) standard normals for the densify split children."""
        return torch.randn((2, budget, 3), generator=self.gen, device=self.gen.device)


class _SlotBinning(NamedTuple):
    binning: object
    means2d: torch.Tensor
    valid: torch.Tensor


def _build_binnings(params, active, T_all, valid: List[bool], cfg: StepConfig,
                    intr: Intrinsics, raster_cfg: RasterConfig) -> List[Optional[_SlotBinning]]:
    out: List[Optional[_SlotBinning]] = []
    with torch.no_grad():
        for s, live in enumerate(valid):
            if not live:
                out.append(None)
                continue
            proj = project_gaussians(params, active, T_all[s], intr, cfg.sh_degree)
            binning = build_binning(proj, intr, raster_cfg, dilate=cfg.mapping_rebin_dilation)
            out.append(_SlotBinning(binning, proj.means2d, proj.valid))
    return out


def mapping_iterations(gmap: GaussianMap, batch: KeyframeBatch, kf_state: KeyframeOptState,
                       iteration_count: int, draws, bg_color: torch.Tensor,
                       gaussian_th: float, gaussian_extent: float, cfg: StepConfig,
                       opt_cfg: MapOptConfig, intr: Intrinsics, raster_cfg: RasterConfig,
                       iters: int, update_every: int, update_offset: int,
                       reset_interval: int, size_threshold: float, use_depth: bool,
                       init_mode: bool) -> MappingResult:
    """Run `iters` mapping iterations; `draws` supplies the random slot
    subsets and densify noise (see `TorchDraws`)."""
    dev = batch.images.device
    b = batch.images.shape[0]
    n = gmap.params.xyz.shape[0]
    with sync("map_setup"):
        valid = [bool(v) for v in batch.valid.tolist()]
    with sync("map_setup"):
        app_exp = batch.apply_exposure.tolist()
    valid_t = batch.valid.to(dev)
    with sync("map_setup"):
        pose_lr = torch.tensor([cfg.cam_trans_lr * cfg.pose_lr_scale] * 3
                               + [cfg.cam_rot_lr * cfg.pose_lr_scale] * 3
                               + [cfg.exposure_lr] * 2, device=dev)
    pose_mask = (batch.optimize_pose & batch.valid)[:, None].to(dev)
    exp_mask = (batch.optimize_exposure & batch.valid)[:, None].to(dev)
    with sync("map_setup"):
        ndc_scale = torch.tensor([intr.width * 0.5, intr.height * 0.5], device=dev)

    T = batch.T_w2c
    exposure = batch.exposure
    bins = _build_binnings(gmap.params, gmap.aux.active, T, valid, cfg, intr, raster_cfg)
    last_loss = 0.0
    n_dropped = 0
    it = iteration_count
    msi = int(cfg.map_slots_per_iter)

    for k_iter in range(int(iters)):
        with span("map.iter"):
            it += 1
            draws.begin_iteration()
            if 0 < msi < b and not init_mode:
                # newest window slot always, plus a random (msi - 1) others;
                # opacity-reset iterations render every slot
                with sync("slots"):
                    perm = draws.slot_perm(b - 1).to(dev) + 1
                sub = torch.zeros((b,), dtype=torch.bool, device=dev)
                sub[0] = True
                sub[perm[: msi - 1]] = True
                if it % reset_interval == 0:
                    sub[:] = True
                with sync("slots"):
                    live = [v and bool(s) for v, s in zip(valid, sub.tolist())]
            else:
                live = list(valid)

            params = gmap.params.map(lambda x: x.detach().requires_grad_(True))
            active = gmap.aux.active
            taus = torch.zeros((b, 6), device=dev, requires_grad=True)
            exps = exposure.detach().clone().requires_grad_(True)
            probes = torch.zeros((b, n, 2), device=dev, requires_grad=True)
            radii = torch.zeros((b, n), device=dev)
            total = isotropic_regularizer(params.log_scales, active)
            for s in range(b):
                if not live[s]:
                    continue
                Ts = se3_exp(taus[s]) @ T[s]
                proj = project_gaussians(params, active, Ts, intr, cfg.sh_degree)
                out = render_binned(proj, proj.means2d + probes[s], bins[s].binning, intr,
                                    bg_color, raster_cfg, need_touched=False)
                exp_eff = exps[s] if app_exp[s] else torch.zeros_like(exps[s])
                total = total + mapping_loss(
                    out.color, out.depth, batch.images[s],
                    batch.depths[s] if use_depth else None, exp_eff, cfg.monocular,
                    initialization=False, alpha=cfg.alpha,
                    rgb_boundary_threshold=cfg.rgb_boundary_threshold,
                    render_opacity=out.alpha,
                )
                radii[s] = out.radii.detach()
            leaves = params.values() + [taus, exps, probes]
            with span("map.backward"):
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
            g_map = GaussianParams(*grads[:6])
            g_tau, g_exp, g_probe = grads[6:]
            last_loss = total.detach()

            with torch.no_grad():
                with span("map.adam"):
                    xyz_lr = exponential_lr(
                        it,
                        opt_cfg.position_lr_init * opt_cfg.spatial_lr_scale,
                        opt_cfg.position_lr_final * opt_cfg.spatial_lr_scale,
                        lr_delay_mult=opt_cfg.position_lr_delay_mult,
                        max_steps=opt_cfg.position_lr_max_steps,
                    )
                    lrs = GaussianParams(xyz_lr, opt_cfg.feature_lr, opt_cfg.feature_lr / 20.0,
                                         opt_cfg.scaling_lr, opt_cfg.rotation_lr,
                                         opt_cfg.opacity_lr)
                    new_params, moments = adam_step(gmap.params, g_map, gmap.moments, lrs,
                                                    active)

                    # densification statistics; NDC-scaled means2d grads (the
                    # densify threshold is calibrated to that unit)
                    valid_f = valid_t[:, None] & (radii > 0.0)
                    vf = valid_f.to(torch.float32)
                    grad_norm = torch.linalg.norm(g_probe * ndc_scale, dim=-1)
                    aux = gmap.aux.replace(
                        grad_accum=gmap.aux.grad_accum + (grad_norm * vf).sum(0),
                        denom=gmap.aux.denom + vf.sum(0),
                        max_radii=torch.maximum(
                            gmap.aux.max_radii,
                            torch.where(valid_f, radii, torch.zeros_like(radii)).max(dim=0).values,
                        ),
                    )
                    gmap = GaussianMap(new_params, aux, moments)

                    # keyframe pose / exposure Adam + retraction
                    g_kf = torch.cat([g_tau, g_exp], dim=-1)
                    kcount = kf_state.count + 1
                    mu = _ADAM_B1 * kf_state.mu + (1 - _ADAM_B1) * g_kf
                    nu = _ADAM_B2 * kf_state.nu + (1 - _ADAM_B2) * g_kf * g_kf
                    c1 = 1.0 - _ADAM_B1 ** kcount
                    c2 = 1.0 - _ADAM_B2 ** kcount
                    step = pose_lr[None, :] * (mu / c1) / (torch.sqrt(nu / c2) + _ADAM_EPS)
                    tau_step = torch.where(pose_mask, -step[:, :6], torch.zeros_like(step[:, :6]))
                    T = se3_exp(tau_step) @ T
                    exposure = exposure.detach() - torch.where(exp_mask, step[:, 6:],
                                                               torch.zeros_like(step[:, 6:]))
                    kf_state = KeyframeOptState(mu, nu, kcount)

                do_update = (it % update_every) == update_offset
                if do_update:
                    with span("densify"):
                        with sync("split_noise"):
                            noise = draws.split_noise(min(cfg.densify_split_budget, n)).to(dev)
                        gmap, dropped = densify_and_prune(
                            gmap, noise, max_grad=opt_cfg.densify_grad_threshold,
                            min_opacity=gaussian_th, extent=gaussian_extent,
                            max_screen_size=size_threshold, percent_dense=opt_cfg.percent_dense,
                            clone_budget=cfg.densify_clone_budget,
                            split_budget=cfg.densify_split_budget,
                        )
                    n_dropped += dropped
                if init_mode:
                    do_reset = it == reset_interval
                    if do_reset:
                        gmap = reset_opacity(gmap, 0.01)
                else:
                    do_reset = (it % reset_interval) == 0 and not do_update
                    if do_reset:
                        gmap = reset_opacity_nonvisible(gmap, valid_f.any(dim=0), 0.4)

                re_every = int(cfg.mapping_rebin_every)
                if re_every > 0 and ((k_iter + 1) % re_every == 0 or do_update or do_reset):
                    bins = _build_binnings(gmap.params, gmap.aux.active, T, valid, cfg, intr,
                                           raster_cfg)

    max_drift, bulk_drift = _drift(gmap, T, bins, valid, cfg, intr, raster_cfg)
    with sync("map_end"):
        last_loss = float(last_loss)
    with sync("map_end"):
        n_free = int((~gmap.aux.active).sum())
    return MappingResult(
        gmap=gmap,
        batch=dataclasses.replace(batch, T_w2c=T, exposure=exposure),
        kf_state=kf_state,
        iteration_count=it,
        last_loss=last_loss,
        n_dropped=n_dropped,
        max_drift=max_drift,
        bulk_drift=bulk_drift,
        n_free=n_free,
    )


@torch.no_grad()
def _drift(gmap, T, bins, valid, cfg, intr, raster_cfg):
    """How far projected means moved (px) since the per-slot binnings were
    built, over Gaussians valid then and now whose binned footprint could
    touch the screen: (max, 99.5th percentile), over slots."""
    max_d, bulk_d = 0.0, 0.0
    margin = float(raster_cfg.tile) + cfg.mapping_rebin_dilation
    for s, live in enumerate(valid):
        if not live:
            continue
        proj = project_gaussians(gmap.params, gmap.aux.active, T[s], intr, cfg.sh_degree)
        mu0 = bins[s].means2d
        d = (proj.means2d - mu0).abs().max(dim=-1).values
        onscreen = ((mu0[:, 0] > -margin) & (mu0[:, 0] < intr.width + margin)
                    & (mu0[:, 1] > -margin) & (mu0[:, 1] < intr.height + margin))
        m = bins[s].valid & proj.valid & onscreen
        with sync("drift"):
            any_m = bool(m.any())
        if any_m:
            with sync("drift"):
                sel = d[m]
            with sync("drift"):
                max_d = max(max_d, float(sel.max()))
            with sync("drift"):
                bulk_d = max(bulk_d, float(torch.quantile(sel, 0.995)))
    return max_d, bulk_d


@torch.no_grad()
def harvest_visibility(gmap: GaussianMap, batch: KeyframeBatch, bg_color,
                       cfg: StepConfig, intr: Intrinsics, raster_cfg: RasterConfig) -> torch.Tensor:
    """Occlusion-aware visibility (n_touched > 0) per window slot at the
    current poses: (B, N) bool, one touch render per harvested slot."""
    n = gmap.params.xyz.shape[0]
    b = batch.T_w2c.shape[0]
    vis = torch.zeros((b, n), dtype=torch.bool, device=gmap.aux.active.device)
    with sync("harvest"):
        valid = batch.valid.tolist()
    with sync("harvest"):
        harvest = batch.harvest_visibility.tolist()
    for s, (v, h) in enumerate(zip(valid, harvest)):
        if v and h:
            out = render_tiled(gmap.params, gmap.aux.active, batch.T_w2c[s], intr,
                               cfg.sh_degree, bg_color, raster_cfg, need_touched=True)
            vis[s] = out.n_touched > 0
    return vis


@torch.no_grad()
def visibility_prune(gmap: GaussianMap, visibility: torch.Tensor, slot_valid: torch.Tensor,
                     kf_ids: torch.Tensor, third_newest_kf: int, initialized: bool,
                     prune_mode: str, monocular: bool) -> GaussianMap:
    """Refresh `n_obs` from the window's visibility; prune by observation
    count only in monocular mode (the RGB-D path keeps every row)."""
    n_obs = (visibility & slot_valid[:, None]).sum(dim=0).to(torch.int32)
    aux = gmap.aux.replace(n_obs=torch.where(gmap.aux.active, n_obs, torch.zeros_like(n_obs)))
    gmap = GaussianMap(gmap.params, aux, gmap.moments)
    if prune_mode == "odometry":
        to_prune = (n_obs < 3) & aux.active
    elif prune_mode == "slam":
        recency = (aux.kf_id >= third_newest_kf) if initialized else aux.active
        to_prune = (n_obs <= 3) & recency & aux.active
    else:
        raise ValueError(f"unknown prune_mode {prune_mode}")
    if not monocular:
        return gmap
    return prune_mask_apply(gmap, to_prune)

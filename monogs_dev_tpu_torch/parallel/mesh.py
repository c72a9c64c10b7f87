"""Data-parallel mapping over a mesh of devices (port of
`monogs_dev_tpu/parallel/mesh.py`).

Keyframe data parallelism: the keyframe batch is split over the mesh's "kf"
axis, every shard rasterizes its own keyframes against the map, and the map
gradients and densification statistics are summed over the shards before one
map Adam step and the cadenced densify/prune. Per-slot state (pose tangents,
exposures, their Adam moments) stays with its keyframes on the shard's device.

The design is single-controller, as the JAX package's: one process and one
Python thread launch every shard's work (no `torch.distributed`). A mesh is an
ordered list of devices under one axis name. The JAX package keeps the map
replicated by giving every device the same update and the same random key;
here the map lives on the mesh's lead device (its first), is updated there,
and is copied to the other devices at the start of the next step
(`replicate`). Where a shard's device is the lead's (one card, or a mesh such
as [cuda:0, cuda:0]) the copy is the lead's own tensors. The cross-shard sum
("psum") adds the shards' partials on the lead device in shard order, and
"pmax" takes their maximum, so a result does not depend on launch timing.

Between steps nothing is read back to the host; inside one, the rasterizer's
and densify's own host reads remain (PERF.md), so on several cards the
shards' work is not yet known to overlap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..geometry.lie import se3_exp
from ..models.camera import Intrinsics
from ..models.gaussians import (
    GaussianMap,
    GaussianParams,
    adam_step,
    densify_and_prune,
    exponential_lr,
)
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_tiled
from ..utils.logging import Log
from ..utils.losses import isotropic_regularizer, l1_loss, mapping_loss, ssim
from ..core.params import MapOptConfig, StepConfig

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # torch.optim.Adam defaults

# a tensor split over the mesh: one contiguous block of the leading dim a shard
Blocks = Tuple[torch.Tensor, ...]


def device_with_index(device) -> torch.device:
    """`device` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("kf",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device that holds the map and sums the shards' partials."""
        return self.devices[0]


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device, Sequence] = "cuda", axis: str = "kf") -> Mesh:
    """A one-axis mesh. On "cuda": the first `n_devices` visible cards, or as
    many as there are (`jax.devices()[:n]`); on "cpu": `n_devices` shards on
    the CPU (for tests); or an explicit list of devices, such as
    [cuda:0, cuda:0]. A CUDA request never lands on the CPU."""
    if isinstance(device, (list, tuple)):
        devices = [device_with_index(d) for d in device]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    else:
        device = torch.device(device)
        n = 1 if n_devices is None else int(n_devices)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh was asked for and no CUDA device is visible")
            n = min(n, torch.cuda.device_count()) if n_devices is not None \
                else torch.cuda.device_count()
            devices = [torch.device("cuda", i) for i in range(n)]
        elif device.type == "cpu":
            devices = [device] * n
        else:
            raise ValueError(f"no mesh on {device}")
    if not devices or any(d.type != devices[0].type for d in devices):
        raise ValueError(f"a mesh needs devices of one type, got {devices}")
    mesh = Mesh(tuple(devices), (axis,))
    Log(f"mesh '{axis}': {mesh.size} shard(s) on {[str(d) for d in devices]}", tag="MonoGS-TPU")
    return mesh


def shard(mesh: Mesh, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> Blocks:
    """`x` split over the mesh (block d on device d); blocks pass through."""
    if isinstance(x, (tuple, list)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} blocks for a mesh of {mesh.size}")
        return tuple(b.to(d) for b, d in zip(x, mesh.devices))
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading dim {x.shape[0]} does not split over {mesh.size} shards")
    return tuple(b.to(d) for b, d in zip(x.split(x.shape[0] // mesh.size), mesh.devices))


def gather(blocks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The blocks of a sharded tensor, concatenated on `device`."""
    return torch.cat([b.to(device) for b in blocks])


def replicate(mesh: Mesh, params: GaussianParams,
              active: torch.Tensor) -> List[Tuple[GaussianParams, torch.Tensor]]:
    """The map's parameters and active mask on every shard's device, copied
    once a device (the lead's own tensors on the lead's device)."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = (params.map(lambda x: x.to(d)), active.to(d))
    return [copies[d] for d in mesh.devices]


def _psum(parts: Sequence[torch.Tensor], lead) -> torch.Tensor:
    acc = parts[0].to(lead)
    for p in parts[1:]:
        acc = acc + p.to(lead)
    return acc


def _pmax(parts: Sequence[torch.Tensor], lead) -> torch.Tensor:
    acc = parts[0].to(lead)
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(lead))
    return acc


@dataclasses.dataclass
class DPBatch:
    """Keyframe batch (leading dim B): full tensors, or after `shard_batch`
    a tuple of per-shard blocks each."""

    images: Union[torch.Tensor, Blocks]  # (B, H, W, 3)
    depths: Union[torch.Tensor, Blocks]  # (B, H, W), zeros when monocular
    T_w2c: Union[torch.Tensor, Blocks]  # (B, 4, 4)
    exposure: Union[torch.Tensor, Blocks]  # (B, 2)
    valid: Union[torch.Tensor, Blocks]  # (B,) slot in use
    optimize_pose: Union[torch.Tensor, Blocks]  # (B,)
    optimize_exposure: Union[torch.Tensor, Blocks]  # (B,)
    # `valid` read once on the host by `shard_batch`, per shard: a shard
    # skips an unused slot, where the JAX step renders it with its loss
    # weighted 0 (both give that slot no gradient)
    live: Optional[Tuple[Tuple[bool, ...], ...]] = None


@dataclasses.dataclass
class DPOptState:
    """Per-slot pose/exposure Adam moments over [tau(6), exposure(2)]: (B, 8)
    tensors, or per-shard blocks once a step has run."""

    mu: Union[torch.Tensor, Blocks]
    nu: Union[torch.Tensor, Blocks]
    count: int = 0

    @property
    def n_slots(self) -> int:
        return sum(b.shape[0] for b in self.mu) if isinstance(self.mu, tuple) \
            else self.mu.shape[0]


def make_dp_opt_state(n_slots: int, device="cpu") -> DPOptState:
    return DPOptState(torch.zeros((n_slots, 8), device=device),
                      torch.zeros((n_slots, 8), device=device), 0)


def shard_batch(mesh: Mesh, batch: DPBatch) -> DPBatch:
    """Every field split over the mesh, and the slot-use flags read once."""
    fields = {f.name: shard(mesh, getattr(batch, f.name))
              for f in dataclasses.fields(batch) if f.name != "live"}
    live = tuple(tuple(bool(v) for v in b.tolist()) for b in fields["valid"])
    return DPBatch(**fields, live=live)


def _map_lrs(opt_cfg: MapOptConfig, it: int) -> GaussianParams:
    xyz_lr = exponential_lr(
        it,
        opt_cfg.position_lr_init * opt_cfg.spatial_lr_scale,
        opt_cfg.position_lr_final * opt_cfg.spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return GaussianParams(xyz_lr, opt_cfg.feature_lr, opt_cfg.feature_lr / 20.0,
                          opt_cfg.scaling_lr, opt_cfg.rotation_lr, opt_cfg.opacity_lr)


def _leaf_grads(leaves: GaussianParams) -> List[torch.Tensor]:
    return [torch.zeros_like(x) if x.grad is None else x.grad for x in leaves.values()]


def dp_mapping_step(mesh: Mesh, cfg: StepConfig, opt_cfg: MapOptConfig, intr: Intrinsics,
                    raster_cfg: RasterConfig, use_depth: bool = True, update_every: int = 150,
                    update_offset: int = 50, size_threshold: float = 20.0):
    """The data-parallel mapping train step over `mesh`.

    Returns step(gmap, batch: DPBatch, opt: DPOptState, iteration, draws,
    gaussian_th, gaussian_extent) -> (gmap, batch, opt, loss, n_dropped):
    `iteration` is the backend's counter before the step, `draws` gives the
    densify split noise (`split_noise(budget)`, as `core/mapping.TorchDraws`),
    the map and the loss are on the lead device, batch and opt are sharded.

    Each shard renders each of its live slots with `render_tiled` and a zero
    means2d probe (K1 forward, K2 backward on the card), applies
    `mapping_loss` (initialization=False, the slot's exposure always) and
    frees the slot's graph with its backward before the next slot. It sums
    the map gradient, the probe-gradient norm over visible Gaussians and
    `denom`, and takes the max of the radii; the isotropic regularizer
    counts once, on shard 0. Then on the lead: map Adam with the xyz
    learning rate scheduled at it + 1, the densification statistics, and
    densify/prune when (it % update_every) == update_offset; on each shard:
    the slots' pose/exposure Adam under their masks and the SE(3)
    retraction."""
    lead = mesh.lead
    pose_lr = {d: torch.tensor([cfg.cam_trans_lr * cfg.pose_lr_scale] * 3
                               + [cfg.cam_rot_lr * cfg.pose_lr_scale] * 3
                               + [cfg.exposure_lr] * 2, device=d)
               for d in set(mesh.devices)}

    def local_grads(params, active, images, depths, poses, exposures, live, first):
        dev = active.device
        n = active.shape[0]
        leaves = params.map(lambda x: x.detach().requires_grad_(True))
        loss = torch.zeros((), device=dev)
        grad_norm = torch.zeros((n,), device=dev)
        denom = torch.zeros((n,), device=dev)
        rmax = torch.zeros((n,), device=dev)
        g_tau = [torch.zeros(6, device=dev) for _ in live]
        g_exp = [torch.zeros(2, device=dev) for _ in live]
        bg = torch.zeros(3, device=dev)
        for s, use in enumerate(live):
            if not use:
                continue
            tau = torch.zeros(6, device=dev, requires_grad=True)
            e = exposures[s].detach().clone().requires_grad_(True)
            probe = torch.zeros((n, 2), device=dev, requires_grad=True)
            out = render_tiled(leaves, active, se3_exp(tau) @ poses[s], intr, cfg.sh_degree, bg,
                               raster_cfg, means2d_probe=probe, need_touched=False)
            slot_loss = mapping_loss(
                out.color, out.depth, images[s], depths[s] if use_depth else None, e,
                cfg.monocular, initialization=False, alpha=cfg.alpha,
                rgb_boundary_threshold=cfg.rgb_boundary_threshold, render_opacity=out.alpha,
            )
            slot_loss.backward()
            with torch.no_grad():
                loss = slot_loss + loss
                vis = out.radii > 0.0
                zero = torch.zeros_like(out.radii)
                grad_norm = grad_norm + torch.where(vis, torch.linalg.norm(probe.grad, dim=-1),
                                                    zero)
                denom = denom + vis.to(torch.float32)
                rmax = torch.maximum(rmax, torch.where(vis, out.radii, zero))
            if tau.grad is not None:
                g_tau[s] = tau.grad
            if e.grad is not None:
                g_exp[s] = e.grad
        if first:
            reg = isotropic_regularizer(leaves.log_scales, active)
            reg.backward()
            loss = loss + reg.detach()
        return (_leaf_grads(leaves), loss, grad_norm, denom, rmax,
                torch.cat([torch.stack(g_tau), torch.stack(g_exp)], dim=-1))

    def step(gmap: GaussianMap, batch: DPBatch, opt: DPOptState, iteration: int, draws,
             gaussian_th: float, gaussian_extent: float):
        it = int(iteration) + 1
        if batch.live is None:
            batch = shard_batch(mesh, batch)
        replicas = replicate(mesh, gmap.params, gmap.aux.active)
        parts = [local_grads(p, a, batch.images[d], batch.depths[d], batch.T_w2c[d],
                             batch.exposure[d], batch.live[d], d == 0)
                 for d, (p, a) in enumerate(replicas)]
        g_map = GaussianParams(*[_psum([pt[0][k] for pt in parts], lead)
                                 for k in range(len(parts[0][0]))])
        loss = _psum([pt[1] for pt in parts], lead)
        grad_norm = _psum([pt[2] for pt in parts], lead)
        denom = _psum([pt[3] for pt in parts], lead)
        rmax = _pmax([pt[4] for pt in parts], lead)

        with torch.no_grad():
            # replicated map Adam with the scheduled xyz LR, on the lead
            params, moments = adam_step(gmap.params, g_map, gmap.moments, _map_lrs(opt_cfg, it),
                                        gmap.aux.active)
            # per-slot pose/exposure Adam + retraction, on each shard
            kcount = opt.count + 1
            c1 = 1.0 - _ADAM_B1 ** kcount
            c2 = 1.0 - _ADAM_B2 ** kcount
            mus, nus, Ts, exps = [], [], [], []
            for d, (pt, mu, nu) in enumerate(zip(parts, shard(mesh, opt.mu),
                                                 shard(mesh, opt.nu))):
                dev = mesh.devices[d]
                g_kf = pt[5]
                mu = _ADAM_B1 * mu + (1 - _ADAM_B1) * g_kf
                nu = _ADAM_B2 * nu + (1 - _ADAM_B2) * g_kf * g_kf
                adam_dir = pose_lr[dev][None, :] * (mu / c1) / (torch.sqrt(nu / c2) + _ADAM_EPS)
                pose_mask = (batch.optimize_pose[d] & batch.valid[d])[:, None]
                exp_mask = (batch.optimize_exposure[d] & batch.valid[d])[:, None]
                tau_step = torch.where(pose_mask, -adam_dir[:, :6], torch.zeros_like(mu[:, :6]))
                Ts.append(se3_exp(tau_step) @ batch.T_w2c[d])
                exps.append(batch.exposure[d] - torch.where(exp_mask, adam_dir[:, 6:],
                                                            torch.zeros_like(mu[:, 6:])))
                mus.append(mu)
                nus.append(nu)

            # densification statistics + cadenced densify/prune, on the lead
            aux = gmap.aux.replace(
                grad_accum=gmap.aux.grad_accum + grad_norm,
                denom=gmap.aux.denom + denom,
                max_radii=torch.maximum(gmap.aux.max_radii, rmax),
            )
            gmap_new = GaussianMap(params, aux, moments)
            dropped = 0
            if it % update_every == update_offset:
                n = gmap.aux.active.shape[0]
                gmap_new, dropped = densify_and_prune(
                    gmap_new, draws.split_noise(min(cfg.densify_split_budget, n)).to(lead),
                    max_grad=opt_cfg.densify_grad_threshold, min_opacity=gaussian_th,
                    extent=gaussian_extent, max_screen_size=size_threshold,
                    percent_dense=opt_cfg.percent_dense, clone_budget=cfg.densify_clone_budget,
                    split_budget=cfg.densify_split_budget,
                )
        batch_new = dataclasses.replace(batch, T_w2c=tuple(Ts), exposure=tuple(exps))
        return gmap_new, batch_new, DPOptState(tuple(mus), tuple(nus), kcount), loss, dropped

    return step


def dp_refine_step(mesh: Mesh, cfg: StepConfig, opt_cfg: MapOptConfig, intr: Intrinsics,
                   raster_cfg: RasterConfig):
    """The data-parallel colour-refinement step over `mesh`: every shard
    renders its own keyframe, the (1 - lambda) L1 + lambda (1 - SSIM)
    gradients and losses are meaned over the shards, and one Adam step on the
    lead applies the xyz learning rate scheduled at it + 1. One step takes
    one keyframe a shard (a minibatch of the reference's one-keyframe
    iterations). A library step, as in the JAX package: `color_refinement`
    does not call it.

    Returns step(gmap, images (D, H, W, 3), poses (D, 4, 4), it, bg_color)
    -> (gmap, loss, it + 1); images and poses full or sharded."""
    lead = mesh.lead
    n_dev = mesh.size

    def local_grads(params, active, image, pose, bg_color):
        leaves = params.map(lambda x: x.detach().requires_grad_(True))
        out = render_tiled(leaves, active, pose, intr, cfg.sh_degree, bg_color, raster_cfg,
                           need_touched=False)
        loss = (1.0 - opt_cfg.lambda_dssim) * l1_loss(out.color, image) + opt_cfg.lambda_dssim * (
            1.0 - ssim(out.color, image))
        loss.backward()
        return _leaf_grads(leaves), loss.detach()

    def step(gmap: GaussianMap, images, poses, it: int, bg_color: torch.Tensor):
        it = int(it) + 1
        images, poses = shard(mesh, images), shard(mesh, poses)
        parts = []
        for d, (p, a) in enumerate(replicate(mesh, gmap.params, gmap.aux.active)):
            if images[d].shape[0] != 1:
                raise ValueError("dp_refine_step takes one keyframe a shard")
            parts.append(local_grads(p, a, images[d][0], poses[d][0],
                                     bg_color.to(mesh.devices[d])))
        g = GaussianParams(*[_psum([pt[0][k] for pt in parts], lead) / n_dev
                             for k in range(len(parts[0][0]))])
        loss = _psum([pt[1] for pt in parts], lead) / n_dev
        with torch.no_grad():
            params, moments = adam_step(gmap.params, g, gmap.moments, _map_lrs(opt_cfg, it),
                                        gmap.aux.active)
        return GaussianMap(params, gmap.aux, moments), loss, it

    return step

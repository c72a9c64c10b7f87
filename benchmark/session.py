"""One session of a cell: its sequence, the port's `SLAM` on it, the set-up
(frame 0 with its initial mapping, then frame 1), the measured window
(`SLAM.run` one frame further per call, each call ending in a sync), and,
after every session's window has closed, the check of what the window
produced against the plain reference.

`run_session` runs in a process of its own (`run.py` starts one per session)
or, for the tests, in the caller's process on any device. What the window
produces and the check reads:
- every window frame's tracked pose and the render that the tracker returns
  with it (`core/tracking.py::track_frame`: projection, binning and K3 at
  the final pose), with the map and active rows it was rendered from;
- each window frame's first pose gradient (`pose_gradient`: projection,
  binning, K1 forward and K2 backward through the tracking loss), with the
  pose, exposure and frame it was taken at;
- every frame's pose from frame 0 to the window's end, for the trajectory
  error against the generated ground truth;
- the window's last mapping call of one iteration that neither densifies
  nor resets opacity (`core/mapping.py::mapping_iterations`): the map and
  its Adam state before and after, and the keyframe slots it rendered. The
  reference works the iteration's loss and its gradient out again from the
  map before, and checks the gradient that the port's Adam moments took
  in, and the step that the port applied to the map.
The port never writes a map tensor in place, so holding them costs no copy.
"""

from __future__ import annotations

import copy
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import scene as scene_mod
from . import trace as trace_mod
from .reference import ate as ref_ate
from .reference import loss as ref_loss
from .reference import render as ref_render

FORBIDDEN = {"jax", "jaxlib", "flax", "monogs_dev_tpu"}
RENDER_SAMPLES = 4  # window frames whose render is checked, the last among them
GRAD_SAMPLES = 2  # window frames whose first pose gradient is checked
FIRST_WINDOW_FRAME = 2  # frames 0 and 1 run in the set-up


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def set_path(cfg: dict, dotted: str, value) -> None:
    *head, last = dotted.split(".")
    node = cfg
    for key in head:
        node = node[key]
    node[last] = value


class _Draws:
    """The mapping call's random source, keeping the slot subsets drawn."""

    def __init__(self, draws, perms: List[torch.Tensor]):
        self.draws, self.perms = draws, perms

    def slot_perm(self, n: int) -> torch.Tensor:
        perm = self.draws.slot_perm(n)
        self.perms.append(perm)
        return perm

    def __getattr__(self, name):
        return getattr(self.draws, name)


class MapRecorder:
    """Wraps the port's `mapping_iterations` (by its module name, as the
    backend looks it up) to keep, while `on`, the last call of one plain
    iteration: not in the initial mapping, no densify, no opacity reset."""

    def __init__(self, backend_mod):
        self.mod, self.real = backend_mod, None
        self.on = False
        self.last: Optional[dict] = None

    def install(self) -> None:
        self.real = self.mod.mapping_iterations
        self.mod.mapping_iterations = self._map

    def remove(self) -> None:
        if self.real is not None:
            self.mod.mapping_iterations, self.real = self.real, None

    def _map(self, gmap, batch, kf_state, iteration_count, draws, *args, **kw):
        it = iteration_count + 1
        if not (self.on and kw["iters"] == 1 and not kw["init_mode"]
                and it % kw["update_every"] != kw["update_offset"]
                and it % kw["reset_interval"] != 0):
            return self.real(gmap, batch, kf_state, iteration_count, draws, *args, **kw)
        perms: List[torch.Tensor] = []
        res = self.real(gmap, batch, kf_state, iteration_count, _Draws(draws, perms), *args,
                        **kw)
        _bg, _th, _extent, cfg, opt_cfg, _intr, raster_cfg = args
        self.last = {"before": gmap, "after": res.gmap, "batch": batch, "it": it,
                     "perm": perms[0] if perms else None, "cfg": cfg, "opt_cfg": opt_cfg,
                     "raster": raster_cfg, "use_depth": kw["use_depth"]}
        return res


class Recorder:
    """Wraps the port's `track_frame` and `pose_gradient` (by their module
    names, as the frontend and tracker look them up) to keep what the
    window's frames produced; `on` is set for the window only."""

    def __init__(self, frontend_mod, tracking_mod, frontend):
        self.frontend_mod, self.tracking_mod, self.frontend = frontend_mod, tracking_mod, frontend
        self.track_frame = frontend_mod.track_frame
        self.pose_gradient = tracking_mod.pose_gradient
        self.on = False
        self.cur: Optional[dict] = None
        self.renders: List[dict] = []
        self.grads: List[dict] = []

    def install(self) -> None:
        self.frontend_mod.track_frame = self._track_frame
        self.tracking_mod.pose_gradient = self._pose_gradient

    def remove(self) -> None:
        self.frontend_mod.track_frame = self.track_frame
        self.tracking_mod.pose_gradient = self.pose_gradient

    def _track_frame(self, params, active, T_init, exposure_init, image, depth, grad_mask,
                     bg_color, cfg, intr, raster_cfg, use_depth):
        if not self.on:
            return self.track_frame(params, active, T_init, exposure_init, image, depth,
                                    grad_mask, bg_color, cfg, intr, raster_cfg, use_depth)
        frame = int(self.frontend.cur_frame_idx)
        self.cur = {"frame": frame, "size": tuple(image.shape[:2])}
        res = self.track_frame(params, active, T_init, exposure_init, image, depth, grad_mask,
                               bg_color, cfg, intr, raster_cfg, use_depth)
        self.renders.append({"frame": frame, "params": params, "active": active,
                             "T": res.T_w2c, "color": res.color, "raster": raster_cfg})
        first = self.cur.get("grad")
        if first is not None:
            self.grads.append(dict(first, frame=frame, params=params, active=active,
                                   image=image, depth=depth, raster=raster_cfg))
        self.cur = None
        return res

    def _pose_gradient(self, T, exp_ab, params, active, binning, image, depth, *args):
        loss, g = self.pose_gradient(T, exp_ab, params, active, binning, image, depth, *args)
        cur = self.cur
        if cur is not None and "grad" not in cur and tuple(image.shape[:2]) == cur["size"]:
            cur["grad"] = {"T": T, "exp_ab": exp_ab, "loss": loss, "g": g}
        return loss, g


def _camera(intr) -> ref_render.Camera:
    return ref_render.Camera(fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
                             width=intr.width, height=intr.height, znear=intr.znear)


def _blend(raster_cfg, dilate: float = 0.0) -> ref_render.Blend:
    """The reference's blend settings from the port's RasterConfig as the
    configuration sets it (tile, k_dup, max_per_tile, thresholds)."""
    if raster_cfg.tile_h not in (0, raster_cfg.tile):
        raise ValueError("the reference renders square tiles only")
    return ref_render.Blend(alpha_clamp=raster_cfg.alpha_clamp, alpha_min=raster_cfg.alpha_min,
                            t_min=raster_cfg.transmittance_min, tile=raster_cfg.tile,
                            k_dup=raster_cfg.k_dup, max_per_tile=raster_cfg.max_per_tile,
                            dilate=dilate)


def reference_render(rec: dict, cam, mm=ref_render.FP32) -> torch.Tensor:
    """The reference's colour render of a recorded frame's map rows at its
    pose."""
    return ref_render.render(ref_render.rows_of(rec["params"]), rec["active"],
                             rec["T"].float(), cam, _blend(rec["raster"]), mm)[0]


def reference_gradient(rec: dict, cam, step_cfg, mm=ref_render.FP32) -> torch.Tensor:
    """The reference's tracking-loss gradient (pose tangent, exposure) at a
    recorded first iteration, with the tracker's binning margin."""
    return ref_loss.tracking_gradient(
        ref_render.rows_of(rec["params"]), rec["active"], rec["T"].float(),
        rec["exp_ab"].float(), rec["image"].float(), rec["depth"].float(), cam,
        _blend(rec["raster"], step_cfg.rebin_dilation), alpha=step_cfg.alpha,
        rgb_threshold=step_cfg.rgb_boundary_threshold, edge_threshold=step_cfg.edge_threshold,
        per_block=step_cfg.per_block_mask, mm=mm)[1]


def live_slots(rec: dict) -> List[int]:
    """The slots that the recorded iteration rendered: MonoGS's choice, the
    newest window slot and (map_slots_per_iter - 1) others drawn at random,
    or every slot in use."""
    batch = rec["batch"]
    valid = batch.valid.tolist()
    msi, b = int(rec["cfg"].map_slots_per_iter), len(valid)
    if rec["perm"] is None or not 0 < msi < b:
        return [s for s in range(b) if valid[s]]
    sub = {0} | {int(p) + 1 for p in rec["perm"][: msi - 1].tolist()}
    return [s for s in range(b) if valid[s] and s in sub]


def reference_map_gradient(rec: dict, cam, mm=ref_render.FP32) -> Dict[str, torch.Tensor]:
    """The reference's gradient of the recorded mapping iteration's loss,
    at the map before it."""
    batch, cfg = rec["batch"], rec["cfg"]
    if not rec["use_depth"]:
        raise ValueError("the mapping check is of RGB-D cells")
    slots = []
    for s in live_slots(rec):
        ab = batch.exposure[s].float() if bool(batch.apply_exposure[s]) else torch.zeros(
            2, device=batch.exposure.device)
        slots.append((batch.T_w2c[s].float(), ab, batch.images[s].float(),
                      batch.depths[s].float()))
    before = rec["before"]
    return ref_loss.mapping_gradient(
        {k: getattr(before.params, k) for k in ref_loss.MAP_FIELDS}, before.aux.active, slots,
        cam, _blend(rec["raster"], cfg.mapping_rebin_dilation), alpha=cfg.alpha,
        rgb_threshold=cfg.rgb_boundary_threshold, mm=mm)


def _adam_lr(rec: dict) -> Dict[str, float]:
    """The learning rate of each field at the recorded iteration: 3DGS's
    (a log-linear decay of the position's, the others constant)."""
    o, it = rec["opt_cfg"], rec["it"]
    t = min(max(it / o.position_lr_max_steps, 0.0), 1.0)
    lr_xyz = math.exp(math.log(o.position_lr_init * o.spatial_lr_scale) * (1.0 - t)
                      + math.log(o.position_lr_final * o.spatial_lr_scale) * t)
    return {"xyz": lr_xyz, "f_dc": o.feature_lr, "log_scales": o.scaling_lr,
            "quats": o.rotation_lr, "opacity_logit": o.opacity_lr}


def map_checks(rec: Optional[dict], g_ref: Optional[Dict[str, torch.Tensor]],
               g_in_place: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, List[float]]:
    """`map_grad_rel`: the worst field's |g - g_ref| / |g_ref| over the
    active rows, g the gradient that the port's Adam moments took in, (mu
    after - 0.9 mu before) / 0.1 (or `g_in_place`, the control's);
    `map_step_rel`: the worst field's |d - d_ref| / |d_ref|, d the change
    that the port made to the rows and d_ref Adam's step from the port's
    moments after (lr mu_hat / (sqrt(nu_hat) + 1e-15), 3DGS's Adam of the
    map); `map_detail`, by field, the rows that carry most of the gradient's
    gap, for the record. No recorded iteration: neither number is read, and
    the run is not correct."""
    if rec is None:
        return {"map_grad_rel": [math.inf], "map_step_rel": [math.inf]}
    b1, b2, eps = 0.9, 0.999, 1e-15
    before, after = rec["before"], rec["after"]
    act = before.aux.active
    count = after.moments.count
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    lr = _adam_lr(rec)
    grad_rel, step_rel = 0.0, 0.0
    detail = {}
    for k in ref_loss.MAP_FIELDS:
        mu0, mu1 = getattr(before.moments.mu, k)[act], getattr(after.moments.mu, k)[act]
        nu1 = getattr(after.moments.nu, k)[act]
        g = (g_in_place[k][act] if g_in_place is not None
             else (mu1.double() - b1 * mu0.double()) / (1.0 - b1))
        ref = g_ref[k][act].double()
        err = (g.double() - ref).reshape(len(ref), -1)
        rel = float(torch.linalg.norm(err) / torch.clamp(torch.linalg.norm(ref), min=1e-30))
        grad_rel = max(grad_rel, rel)
        # where the gap lies: the rows that carry most of it
        row = (err ** 2).sum(-1)
        top = torch.argsort(row, descending=True)[:5]
        detail[k] = {"rel": rel, "top5_share": float(row[top].sum() / torch.clamp(
            row.sum(), min=1e-300)), "top5_err": row[top].sqrt().tolist(),
            "top5_ref": torch.linalg.norm(ref.reshape(len(ref), -1)[top], dim=-1).tolist(),
            "top5_scale": torch.exp(before.params.log_scales[act][top]).amax(
                -1).tolist()}
        d = getattr(after.params, k)[act].double() - getattr(before.params, k)[act].double()
        d_ref = -lr[k] * (mu1.double() / c1) / (torch.sqrt(nu1.double() / c2) + eps)
        step_rel = max(step_rel, float(torch.linalg.norm(d - d_ref)
                                       / torch.clamp(torch.linalg.norm(d_ref), min=1e-30)))
    return {"map_grad_rel": [grad_rel], "map_step_rel": [step_rel], "map_detail": detail}


def render_error(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Mean |colour difference| over the frame."""
    return float((program.float() - reference).abs().mean())


def grad_error(program: torch.Tensor, reference: torch.Tensor) -> float:
    """|g_program - g_reference| / |g_reference|."""
    return float(torch.linalg.norm(program.float() - reference)
                 / torch.clamp(torch.linalg.norm(reference), min=1e-12))


def _pick(items: List[dict], n: int, rng: np.random.Generator, keep_last: bool) -> List[dict]:
    if len(items) <= n:
        return list(items)
    if keep_last:
        rest = rng.choice(len(items) - 1, size=n - 1, replace=False)
        return [items[i] for i in sorted(rest)] + [items[-1]]
    return [items[i] for i in sorted(rng.choice(len(items), size=n, replace=False))]


def run_session(cell: dict, k: int, *, seed: int, seconds: float, trace: bool, device,
                cache_root: str, start=None, closed=None, control: bool = False,
                fault=None) -> Dict:
    """Session k of `cell` (config, traffic); `start()` is called when the
    set-up is done and returns when every session's is, `closed()` once
    this window has closed and returns when every session's has. With
    `control`, the reference at TF32 takes the port's place in the render
    and gradient checks. `fault(slam)`, if given, breaks the port for the
    window and returns what undoes it (the limits' readings; never in a
    benchmark run). Returns the session's numbers."""
    from monogs_dev_tpu_torch.core import backend as backend_mod
    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core import tracking as tracking_mod
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.utils.config import DotDict

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, traffic = cell["config"], cell["traffic"]
    t_in = time.time()
    path, gt = scene_mod.sequence(cfg, traffic, seed, k, cache_root, device)
    t_data = time.time()
    config = copy.deepcopy(cfg["config"])
    set_path(config, "Dataset.dataset_path", path)
    set_path(config, "Results.save_results", False)
    s_seed = scene_mod.session_seed(seed, traffic["sessions"], k)
    slam = SLAM(DotDict.wrap(config), device, seed=s_seed % (2 ** 31))
    t_slam = time.time()
    rec = Recorder(frontend_mod, tracking_mod, slam.frontend)
    rec.install()
    tracer = trace_mod.Tracer(device) if trace else None
    out: Dict = {"k": k}
    undo = None
    map_rec = MapRecorder(backend_mod)
    try:
        slam.run(max_frames=2)  # frame 0 with its initial mapping, then frame 1
        if cuda:
            torch.cuda.synchronize(device)
        out["setup"] = {"data_s": t_data - t_in, "slam_s": t_slam - t_data,
                        "frames01_s": time.time() - t_slam}
        n_frames = len(slam.dataset)
        snap = slam.timers.snapshot()
        engine = slam.engine
        alive0 = int(engine.gmap.aux.active.sum())
        map_iters0 = int(engine.telemetry["map_iters"])
        undo = fault(slam) if fault is not None else None
        map_rec.install()  # over the fault, if any: it records what the port did
        if tracer is not None:
            tracer.start()
        if start is not None:
            start()
        rec.on = map_rec.on = True
        t0 = time.time()
        frame_s: List[float] = []
        frame_end: List[float] = []
        i = FIRST_WINDOW_FRAME
        while i < n_frames:
            a = time.time()
            slam.run(max_frames=i + 1)  # synchronizes the device at its end
            b = time.time()
            frame_s.append(b - a)
            frame_end.append(b)
            i += 1
            if b - t0 >= seconds:
                break
        t_end = time.time()
        rec.on = map_rec.on = False
        if undo is not None:
            undo()
            undo = None
        if tracer is not None:
            tracer.stop()
        t_stop = time.time()
        timers = slam.timers.delta_summary(snap)
        out.update(t0=t0, t_end=t_end, frames=len(frame_s), frame_s=frame_s,
                   frame_end=frame_end, ran_out=i >= n_frames)
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_reserved(device)) if cuda else 0
        if closed is not None:
            closed()
        fe = slam.frontend
        est = [np.asarray(fe.cameras[j].T_est, np.float64) for j in range(i)]
        out["ate_sq"] = ref_ate.residuals(est, gt[:i]).tolist()
        # a window frame whose pose is not finite counts as failed
        out["failed_frames"] = sum(1 for T in est[FIRST_WINDOW_FRAME:]
                                   if not np.isfinite(T).all())
        new_kfs = [j for j in fe.kf_indices if j >= FIRST_WINDOW_FRAME]
        out["mapping"] = {"keyframes": len(new_kfs),
                          "alive_start": alive0, "alive_end": int(engine.gmap.aux.active.sum()),
                          "map_iters": int(engine.telemetry["map_iters"]) - map_iters0}
        out["timers"] = timers
        t_read = time.time()
        if tracer is not None:
            out["trace"] = tracer.result(t0, t_end)
        out["post"] = {"stop_s": t_stop - t_end, "trace_s": time.time() - t_read}
        cam = _camera(slam.intr)
        step_cfg = slam.step_cfg
        rng = np.random.default_rng([int(seed), k])
        renders = _pick(rec.renders, RENDER_SAMPLES, rng, keep_last=True)
        grads = _pick(rec.grads, GRAD_SAMPLES, rng, keep_last=False)
    finally:
        if undo is not None:
            undo()
        if tracer is not None:
            tracer.stop()
        map_rec.remove()
        rec.remove()
        slam.stop()
    mapped = map_rec.last
    del slam, rec, map_rec
    if cuda:
        torch.cuda.empty_cache()
    ref_r = [reference_render(r, cam) for r in renders]
    ref_g = [reference_gradient(r, cam, step_cfg) for r in grads]
    g_map = reference_map_gradient(mapped, cam) if mapped is not None else None
    checks = {"render_mae": [render_error(r["color"], c) for r, c in zip(renders, ref_r)],
              "grad_rel": [grad_error(r["g"], g) for r, g in zip(grads, ref_g)],
              **map_checks(mapped, g_map)}
    if control:
        # the reference at TF32 in the program's place; the program's own
        # readings are kept beside, for the record
        out["program_checks"] = dict(checks)
        checks = {
            "render_mae": [render_error(reference_render(r, cam, ref_render.TF32), c)
                           for r, c in zip(renders, ref_r)],
            "grad_rel": [grad_error(reference_gradient(r, cam, step_cfg, ref_render.TF32), g)
                         for r, g in zip(grads, ref_g)],
            **map_checks(mapped, g_map, reference_map_gradient(mapped, cam, ref_render.TF32)
                         if mapped is not None else None)}
    out["map_detail"] = checks.pop("map_detail", None)
    out["checks"] = checks
    out["checked_frames"] = {"render": [r["frame"] for r in renders],
                             "grad": [r["frame"] for r in grads],
                             "map_iteration": mapped["it"] if mapped is not None else None,
                             "map_slots": live_slots(mapped) if mapped is not None else []}
    out["post"]["checks_s"] = time.time() - t_read - out["post"]["trace_s"]
    out["forbidden"] = forbidden_modules()
    return out


def ate_cm(sessions: List[Dict]) -> float:
    sq = np.concatenate([np.asarray(s["ate_sq"]) for s in sessions])
    return 100.0 * math.sqrt(float(sq.mean()))

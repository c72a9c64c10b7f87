"""Tracking frontend: per-frame loop, keyframe policy, window management
(port of `monogs_dev_tpu/core/frontend.py`, RGB-D and monocular).

Tracking runs on the device with the solver `Training.tracking_solver`
names: Adam through the rasterizer (core/tracking.py, the default) or
Gauss-Newton (core/tracking_gn.py); the keyframe policy and
window bookkeeping stay host-side numpy, as in the reference. A monocular
run bootstraps from a noisy depth sheet, inserts keyframes with pseudo-depth
from the render, and counts as initialized once the window is full; a
keyframe evicted before then resets the system.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..utils.logging import Log
from .backend import BackendEngine
from .insertion import mono_bootstrap_depth, pseudo_depth_map
from .keyframe import Keyframe
from .params import StepConfig
from .tracking import TrackResult, track_frame
from .tracking_gn import track_frame_gn


@dataclasses.dataclass
class FrameInfo:
    """Host-side per-frame record (for eval and keyframe policy)."""

    idx: int
    T_est: np.ndarray  # (4, 4) W2C estimate
    T_gt: np.ndarray
    exposure: np.ndarray
    is_keyframe: bool = False


def is_keyframe_check(T_cur, T_last_kf, median_depth, cur_vis, last_kf_vis,
                      kf_translation, kf_min_translation, kf_overlap) -> bool:
    dist = np.linalg.norm((T_cur @ np.linalg.inv(T_last_kf))[0:3, 3])
    dist_check = dist > kf_translation * median_depth
    dist_check2 = dist > kf_min_translation * median_depth
    union = np.count_nonzero(cur_vis | last_kf_vis)
    intersection = np.count_nonzero(cur_vis & last_kf_vis)
    point_ratio = intersection / max(union, 1)
    return (point_ratio < kf_overlap and dist_check2) or dist_check


def add_to_window(cur_frame_idx: int, cur_vis: np.ndarray,
                  occ_aware_visibility: Dict[int, np.ndarray], window: List[int],
                  poses: Dict[int, np.ndarray], kf_cutoff: float, initialized: bool,
                  window_size: int) -> Tuple[List[int], Optional[int]]:
    n_dont_touch = 2
    window = [cur_frame_idx] + window
    removed_frame = None

    # overlap eviction (Szymkiewicz-Simpson)
    to_remove = []
    cutoff = kf_cutoff if initialized else 0.4
    for i in range(n_dont_touch, len(window)):
        kf_idx = window[i]
        vis = occ_aware_visibility[kf_idx]
        intersection = np.count_nonzero(cur_vis & vis)
        denom = max(min(np.count_nonzero(cur_vis), np.count_nonzero(vis)), 1)
        if intersection / denom <= cutoff:
            to_remove.append(kf_idx)
    if to_remove:
        window.remove(to_remove[-1])
        removed_frame = to_remove[-1]

    # inverse-distance eviction when over capacity
    if len(window) > window_size:
        T0_wc = np.linalg.inv(poses[cur_frame_idx])
        inv_dist = []
        for i in range(n_dont_touch, len(window)):
            T_i = poses[window[i]]
            inv_dists = []
            for j in range(n_dont_touch, len(window)):
                if i == j:
                    continue
                T_j_wc = np.linalg.inv(poses[window[j]])
                inv_dists.append(1.0 / (np.linalg.norm((T_i @ T_j_wc)[0:3, 3]) + 1e-6))
            k = np.sqrt(np.linalg.norm((T_i @ T0_wc)[0:3, 3]))
            inv_dist.append(k * sum(inv_dists))
        idx = int(np.argmax(inv_dist))
        removed_frame = window[n_dont_touch + idx]
        window.remove(removed_frame)

    return window, removed_frame


class FrontEnd:
    def __init__(self, config, dataset, engine: BackendEngine, step_cfg: StepConfig,
                 intr: Intrinsics, raster_cfg: RasterConfig, backend_thread=None,
                 seed: int = 1):
        self.config = config
        self.dataset = dataset
        self.engine = engine
        self.backend_thread = backend_thread
        self.cfg = step_cfg
        self.intr = intr
        self.raster_cfg = raster_cfg
        self.device = engine.device
        # TPU.track_alpha_min: coarser contribution cutoff for the tracking
        # loop only; mapping and keyframe-policy renders keep alpha_min
        tam = float((config.get("TPU") or {}).get("track_alpha_min", 0.0))
        self.track_raster_cfg = (
            dataclasses.replace(raster_cfg, alpha_min=tam) if tam > 0.0 else raster_cfg
        )
        # TPU.track_compact: 0 off, > 0 fixed working set, -1 adaptive
        self.track_compact_mode = int((config.get("TPU") or {}).get("track_compact", 0))
        self._binned_hist: List[int] = []
        self._compact_m = 0

        training = config["Training"]
        self.monocular = step_cfg.monocular
        self.use_depth = not self.monocular
        self.kf_interval = int(training.get("kf_interval", 5))
        self.window_size = int(training.get("window_size", 8))
        self.kf_translation = float(training.get("kf_translation", 0.08))
        self.kf_min_translation = float(training.get("kf_min_translation", 0.05))
        self.kf_overlap = float(training.get("kf_overlap", 0.9))
        self.kf_cutoff = float(training.get("kf_cutoff", 0.4))
        self.single_thread = bool(training.get("single_thread", False))
        self.const_velocity = bool(training.get("const_velocity_init", False))
        self.bg_color = torch.zeros(3, device=self.device)
        self.gen = torch.Generator().manual_seed(seed)  # monocular depth noise

        self.cameras: Dict[int, FrameInfo] = {}
        self.kf_indices: List[int] = []
        self.current_window: List[int] = []
        self.occ_aware_visibility: Dict[int, np.ndarray] = {}
        self.initialized = not self.monocular
        self.reset = True
        self.requested_init = False
        self.requested_keyframe = 0
        self.median_depth = 4.0
        self.anchor_idx = 0
        self.cur_frame_idx = 0
        self.timers = None  # optional PhaseTimers injected by SLAM
        self.snapshot = (engine.gmap.params, engine.gmap.aux.active)
        # tracking runs on the smallest row prefix (cap/4, cap/2, cap) that
        # holds every active row; insertion fills the lowest free rows
        cap = engine.capacity
        self.track_tiers = sorted(
            {min(cap, max(4096, cap // 4)), min(cap, max(4096, cap // 2)), cap}
        )
        self._snapshot_hw: Optional[int] = None
        self._zero_depth: Optional[torch.Tensor] = None  # monocular tracking depth

    # ----------------------------------------------------------------- comms

    def _send(self, msg) -> None:
        if self.backend_thread is not None:
            self.backend_thread.backend_queue.put(msg)
            return
        tag = msg[0]
        e = self.engine
        if tag == "init":
            e.handle_init(msg[1], msg[2], msg[3])
        elif tag == "keyframe":
            e.handle_keyframe(msg[1], msg[2], msg[3], msg[4], True)
        self._sync_direct(tag)

    def _sync_direct(self, tag: str) -> None:
        e = self.engine
        self._adopt_snapshot((e.gmap.params, e.gmap.aux.active), e.occ_aware_visibility,
                             {i: np.asarray(kf.T_w2c) for i, kf in e.viewpoints.items()}, tag)

    def _adopt_snapshot(self, snapshot, visibility, kf_poses: Dict[int, np.ndarray],
                        tag: str) -> None:
        self.snapshot = snapshot
        self._snapshot_hw = None
        self.occ_aware_visibility = {k: np.asarray(v) for k, v in visibility.items()}
        corr, newest = self._gauge_correction(kf_poses)
        for kf_idx, T in kf_poses.items():
            if kf_idx in self.cameras:
                self.cameras[kf_idx].T_est = T
        self._apply_gauge(corr, newest, set(kf_poses))
        if tag == "init":
            self.requested_init = False
        elif tag == "keyframe":
            self.requested_keyframe = max(0, self.requested_keyframe - 1)

    def _gauge_correction(self, kf_poses: Dict[int, np.ndarray]):
        """Correction that carries frames tracked after the newest keyframe
        into the gauge the backend's BA moved the keyframes to:
        T_f_new = T_f_old @ inv(T_kf_old) @ T_kf_new."""
        synced = [i for i in kf_poses if i in self.cameras]
        if not synced:
            return None, None
        newest = max(synced)
        corr = np.linalg.inv(self.cameras[newest].T_est) @ kf_poses[newest]
        if np.abs(corr - np.eye(4)).max() < 1e-6:
            return None, None
        return corr, newest

    def _apply_gauge(self, corr, newest, kf_ids) -> None:
        if corr is None:
            return
        for idx, cam in self.cameras.items():
            if idx > newest and idx not in kf_ids:
                cam.T_est = cam.T_est @ corr

    def _drain_frontend_queue(self) -> None:
        if self.backend_thread is None:
            return
        q = self.backend_thread.frontend_queue
        while True:
            try:
                tag, snapshot, visibility, keyframes = q.get_nowait()
            except queue.Empty:
                return
            self._adopt_snapshot(snapshot, visibility,
                                 {int(k): np.asarray(T) for k, T in keyframes}, tag)

    # ------------------------------------------------------------- per frame

    def _valid_rgb_depth(self, image, depth):
        return torch.where(image.sum(dim=-1) > self.cfg.rgb_boundary_threshold, depth,
                           torch.zeros_like(depth))

    def _noise_draws(self):
        """Random source of one monocular depth map: the bootstrap sheet or
        a keyframe's pseudo-depth."""
        return self.gen

    def initialize(self, cur_frame_idx: int, image, depth, T_gt) -> None:
        """Bootstrap / reset: the frame becomes keyframe 0 at its GT pose,
        with its sensor depth or, monocular, a noisy depth sheet."""
        self.initialized = not self.monocular
        self.kf_indices = [cur_frame_idx]
        self.current_window = [cur_frame_idx]
        self.occ_aware_visibility = {}
        self.anchor_idx = cur_frame_idx
        kf = Keyframe(idx=cur_frame_idx, image=image, depth=depth if self.use_depth else None,
                      T_w2c=np.asarray(T_gt, np.float32), exposure=np.zeros(2, np.float32),
                      T_gt=T_gt)
        self.cameras[cur_frame_idx] = FrameInfo(cur_frame_idx, np.asarray(T_gt), T_gt,
                                                np.zeros(2), is_keyframe=True)
        if self.monocular or depth is None:
            depth_map = mono_bootstrap_depth(self._noise_draws(), self.intr.height,
                                             self.intr.width, init=True, device=self.device)
        else:
            depth_map = self._valid_rgb_depth(image, depth)
        self.requested_init = True
        self._send(["init", cur_frame_idx, kf, depth_map])
        self.reset = False

    def _tracking_tier(self, active) -> int:
        if self._snapshot_hw is None:
            idx = torch.nonzero(active).flatten()
            self._snapshot_hw = int(idx.max()) + 1 if idx.numel() else 0
        for t in self.track_tiers:
            if t >= self._snapshot_hw:
                return t
        return self.track_tiers[-1]

    @staticmethod
    def _compact_ladder(tier: int) -> List[int]:
        return [tier // 2, (3 * tier) // 4]

    def _choose_compact(self, tier: int) -> int:
        """Adaptive mode (-1): smallest ladder rung >= 1.35x the recent binned
        max, sticky while it keeps a 1.2x margin; tiers above the backend's
        small tier run uncompacted."""
        mode = self.track_compact_mode
        if mode == 0:
            return 0
        if mode > 0:
            return mode if mode < tier else 0
        if tier > self.engine.tier_small or not self._binned_hist:
            return 0
        maxb = max(self._binned_hist)
        cands = [m for m in self._compact_ladder(tier) if m >= 1.35 * maxb]
        best = min(cands) if cands else 0
        cur = self._compact_m
        if 0 < cur < tier and cur >= 1.2 * maxb and (best == 0 or best >= cur):
            return cur
        return best

    def tracking(self, cur_frame_idx: int, image, depth) -> TrackResult:
        prev = self.cameras[cur_frame_idx - 1]
        T_init = prev.T_est
        if (self.const_velocity and (cur_frame_idx - 2) in self.cameras
                and (cur_frame_idx - 2) >= self.anchor_idx):
            prev2 = self.cameras[cur_frame_idx - 2]
            T_init = prev.T_est @ np.linalg.inv(prev2.T_est) @ prev.T_est
        params, active = self.snapshot
        tier = self._tracking_tier(active)
        if tier < active.shape[0]:
            params, active = params.map(lambda x: x[:tier]), active[:tier]
        use_depth = self.use_depth and depth is not None
        if not use_depth:
            if self._zero_depth is None:
                self._zero_depth = torch.zeros((self.intr.height, self.intr.width),
                                               device=self.device)
            depth = self._zero_depth
        self._compact_m = self._choose_compact(tier)
        cfg = dataclasses.replace(self.cfg, track_compact=self._compact_m)
        track_fn = track_frame_gn if cfg.tracking_solver == "gn" else track_frame
        result = track_fn(
            params, active, np.asarray(T_init, np.float32), np.zeros(2, np.float32),
            image, depth, None, self.bg_color, cfg, self.intr, self.track_raster_cfg,
            use_depth=use_depth,
        )
        touched = result.touched.cpu().numpy()
        cap = self.engine.capacity
        if touched.shape[0] < cap:
            touched = np.pad(touched, (0, cap - touched.shape[0]))
        result = result._replace(
            T_w2c=result.T_w2c.cpu().numpy(), exposure_ab=result.exposure_ab.cpu().numpy(),
            touched=touched,
        )
        self.median_depth = float(result.median_depth)
        self._binned_hist.append(int(result.n_binned))
        del self._binned_hist[:-5]
        if result.compact_dropped > 0:
            Log(f"tracking working-set overflow: {result.compact_dropped} binned gaussians "
                f"dropped at m={self._compact_m} (falling back to the full tier)",
                tag="MonoGS-TPU")
            self._compact_m = 0
        if not np.isfinite(self.median_depth):
            self.median_depth = 4.0
        return result

    def make_keyframe_depth(self, image, depth, track: TrackResult):
        """A new keyframe's insertion depth: sensor depth on valid RGB, or,
        monocular, pseudo-depth from the render at the tracked pose."""
        if self.monocular:
            return pseudo_depth_map(self._noise_draws(), track.depth, track.opacity, image,
                                    self.median_depth, self.cfg.rgb_boundary_threshold)
        return self._valid_rgb_depth(image, depth)

    def _tally(self, name: str, t0: float) -> None:
        if self.timers is not None:
            self.timers.total[name] += time.time() - t0
            self.timers.count[name] += 1

    # ------------------------------------------------------------------- run

    def run(self, max_frames: Optional[int] = None) -> None:
        n_frames = len(self.dataset)
        if max_frames is not None:
            n_frames = min(n_frames, max_frames)
        cur_frame_idx = self.cur_frame_idx
        pump = getattr(self.backend_thread, "pump", None)

        while cur_frame_idx < n_frames:
            self.cur_frame_idx = cur_frame_idx
            if pump is not None:
                t0 = time.time()
                pump()
                self._tally("pump", t0)
            self._drain_frontend_queue()
            if self.requested_init or (
                    (self.single_thread or not self.initialized) and self.requested_keyframe > 0):
                # wait for the backend: an init, or a keyframe while the
                # frontend is single-threaded or not yet initialized
                if pump is not None:
                    pump(idle_budget=0)
                    self._drain_frontend_queue()
                continue

            t0 = time.time()
            image, depth, T_gt = self.dataset[cur_frame_idx]
            self._tally("load_frame", t0)
            if self.reset:
                self.initialize(cur_frame_idx, image, depth, T_gt)
                cur_frame_idx += 1
                continue

            self.initialized = self.initialized or len(self.current_window) == self.window_size

            t0 = time.time()
            track = self.tracking(cur_frame_idx, image, depth)
            self._tally("tracking", t0)
            if self.timers is not None:
                self.timers.tally("tracking_iters", int(track.n_iters))
            self.cameras[cur_frame_idx] = FrameInfo(cur_frame_idx, track.T_w2c, T_gt,
                                                    track.exposure_ab)
            if self.requested_keyframe > 0:
                cur_frame_idx += 1
                continue

            last_keyframe_idx = self.current_window[0]
            check_time = (cur_frame_idx - last_keyframe_idx) >= self.kf_interval
            cur_vis = track.touched
            last_vis = self.occ_aware_visibility.get(last_keyframe_idx, np.zeros_like(cur_vis))
            create_kf = is_keyframe_check(
                track.T_w2c, self.cameras[last_keyframe_idx].T_est, self.median_depth,
                cur_vis, last_vis, self.kf_translation, self.kf_min_translation,
                self.kf_overlap,
            )
            if len(self.current_window) < self.window_size:
                union = max(np.count_nonzero(cur_vis | last_vis), 1)
                intersection = np.count_nonzero(cur_vis & last_vis)
                create_kf = check_time and (intersection / union) < self.kf_overlap
            if self.single_thread:
                create_kf = check_time and create_kf

            if create_kf:
                t0 = time.time()
                poses = {i: self.cameras[i].T_est for i in self.current_window}
                poses[cur_frame_idx] = track.T_w2c
                self.current_window, removed = add_to_window(
                    cur_frame_idx, cur_vis, self.occ_aware_visibility, self.current_window,
                    poses, self.kf_cutoff, self.initialized, self.window_size,
                )
                if self.monocular and not self.initialized and removed is not None:
                    self.reset = True
                    Log(f"Keyframes lacks sufficient overlap to initialize the map, "
                        f"resetting (evicted {removed}; |cur_vis|="
                        f"{int(np.count_nonzero(cur_vis))})")
                    continue
                if int(track.tile_overflow) > 0:
                    Log(f"raster tile-list overflow: {int(track.tile_overflow)} entries "
                        f"dropped (raise TPU.max_per_tile)", tag="MonoGS-TPU")
                depth_map = self.make_keyframe_depth(image, depth, track)
                kf = Keyframe(idx=cur_frame_idx, image=image,
                              depth=depth if self.use_depth else None, T_w2c=track.T_w2c,
                              exposure=track.exposure_ab, T_gt=T_gt)
                self.cameras[cur_frame_idx].is_keyframe = True
                self.kf_indices.append(cur_frame_idx)
                Log(f"Keyframe {cur_frame_idx} (#{len(self.kf_indices)}), "
                    f"window {self.current_window} (n_vis {int(np.count_nonzero(cur_vis))})")
                self.requested_keyframe += 1
                self._send(["keyframe", cur_frame_idx, kf, list(self.current_window),
                            depth_map])
                self._tally("keyframe", t0)
            cur_frame_idx += 1

        self.cur_frame_idx = cur_frame_idx
        if self.backend_thread is not None:
            if pump is not None:
                pump(idle_budget=0)
            self._drain_frontend_queue()
        else:
            self._sync_direct("final")

"""Tracking frontend: per-frame loop, keyframe policy, window management
(port of `monogs_dev_tpu/core/frontend.py`, RGB-D and monocular).

Tracking runs on the device with the solver `Training.tracking_solver`
names: Adam through the rasterizer (core/tracking.py, the default) or
Gauss-Newton (core/tracking_gn.py); the keyframe policy and
window bookkeeping stay host-side numpy, as in the reference. A monocular
run bootstraps from a noisy depth sheet, inserts keyframes with pseudo-depth
from the render, and counts as initialized once the window is full; a
keyframe evicted before then resets the system.

With a backend scheduler the frontend talks to the backend through the
reference's message protocol (core/backend.py); with `BackendThread` the
messages cross between two host threads and two CUDA streams, each with the
event after which its tensors are ready. With a `VizChannel` it publishes a
`GaussianPacket` each tracked frame and takes the viewer's pause requests;
with `throttle` (a live camera) it holds keyframe frames to at most 3 a
second, as the reference does.
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
from ..utils.profiling import span, sync, tally
from .backend import BackendEngine, adopt_on_stream, device_tensors, stream_event
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
                 seed: int = 1, throttle: bool = False, viz_channel=None):
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
        self.throttle = throttle
        self.viz_channel = viz_channel
        self.paused = False

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
        self.snapshot = (engine.gmap.params, engine.gmap.aux.active)
        # tracking runs on the smallest row prefix (cap/4, cap/2, cap) that
        # holds every active row; insertion fills the lowest free rows
        cap = engine.capacity
        self.track_tiers = sorted(
            {min(cap, max(4096, cap // 4)), min(cap, max(4096, cap // 2)), cap}
        )
        self._snapshot_hw: Optional[int] = None
        self._zero_depth: Optional[torch.Tensor] = None  # monocular tracking depth
        self._prefetch: Dict[int, tuple] = {}
        self._run_end = 0  # frames past the current run's end are not prefetched

    # ----------------------------------------------------------------- comms

    def _send(self, msg) -> None:
        if self.backend_thread is not None:
            bt = self.backend_thread
            bt.backend_queue.put(msg + [stream_event(self.device) if bt.cross_stream else None])
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
                        tag: str, ready=None) -> None:
        adopt_on_stream(ready, device_tensors(snapshot), self.device)
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

    def _drain_frontend_queue(self, block: bool = False) -> None:
        """Adopt every message the backend has sent; with `block`, wait up
        to 2,000 s for the first while the backend lives. Raises what ended
        a backend thread."""
        bt = self.backend_thread
        if bt is None:
            return
        check = getattr(bt, "check", None)
        deadline = time.time() + 2000.0
        while True:
            if check is not None:
                check()
            try:
                data = bt.frontend_queue.get(timeout=0.05) if block else \
                    bt.frontend_queue.get_nowait()
            except queue.Empty:
                if block and bt.is_alive() and time.time() < deadline:
                    continue
                return
            tag, snapshot, visibility, keyframes, ready = data
            self._adopt_snapshot(snapshot, visibility,
                                 {int(k): np.asarray(T) for k, T in keyframes}, tag, ready)
            block = False

    # ------------------------------------------------------------- per frame

    def _load_frame(self, idx: int):
        """(image, depth, T_gt) of frame idx on the device: the copy that
        `_prefetch_frame` started while the previous frame was tracked, or
        a fresh fetch. Also how a resumed run rebuilds its keyframes."""
        hit = self._prefetch.pop(idx, None)
        return hit if hit is not None else self._fetch_frame(idx)

    def _fetch_frame(self, idx: int, apart: bool = False):
        """One frame from the dataset, on the device. The real-data loaders
        decode into pinned host memory and copy without blocking, so the
        host goes on at once. `apart`: a prefetch, whose time the enclosing
        span (tracking) does not count."""
        with span("fetch_frame", apart=apart):
            image, depth, T_gt = self.dataset[idx]
        return image, depth, np.asarray(T_gt)

    def _prefetch_frame(self, idx: int) -> None:
        if idx not in self._prefetch and idx < self._run_end:
            self._prefetch = {idx: self._fetch_frame(idx, apart=True)}

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
            with sync("tier"):
                idx = torch.nonzero(active).flatten()
            if idx.numel():
                with sync("tier"):
                    self._snapshot_hw = int(idx.max()) + 1
            else:
                self._snapshot_hw = 0
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
        # fetch the next frame before the result is read back to the host
        self._prefetch_frame(cur_frame_idx + 1)
        with sync("readback"):
            touched = result.touched.cpu().numpy()
        cap = self.engine.capacity
        if touched.shape[0] < cap:
            touched = np.pad(touched, (0, cap - touched.shape[0]))
        with sync("readback"):
            T_w2c = result.T_w2c.cpu().numpy()
        with sync("readback"):
            exposure_ab = result.exposure_ab.cpu().numpy()
        result = result._replace(T_w2c=T_w2c, exposure_ab=exposure_ab, touched=touched)
        with sync("readback"):
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

    def _publish(self, track: TrackResult, image) -> None:
        """This frame's packet for the viewer: the frontend's map snapshot
        (kept by reference: no map tensor is ever written in place), its
        host copies, the tracked pose and the keyframe window."""
        from ..viz.snapshot import GaussianPacket

        params, active = self.snapshot
        self.viz_channel.publish(GaussianPacket.from_map(
            params, active, ready=stream_event(self.device),
            current_frame_T=np.asarray(track.T_w2c), gt_color=image.cpu().numpy(),
            keyframe_poses=[self.cameras[i].T_est for i in self.current_window]))

    # ------------------------------------------------------------------- run

    def run(self, max_frames: Optional[int] = None) -> None:
        n_frames = len(self.dataset)
        if max_frames is not None:
            n_frames = min(n_frames, max_frames)
        cur_frame_idx = self.cur_frame_idx
        self._run_end = n_frames
        pump = getattr(self.backend_thread, "pump", None)

        while cur_frame_idx < n_frames:
            with span("frame"):
                self.cur_frame_idx = cur_frame_idx
                tic = time.time()
                if pump is not None:
                    pump()
                self._drain_frontend_queue()
                if self.viz_channel is not None:
                    # the viewer's pause channel
                    ctrl = self.viz_channel.poll_control()
                    if ctrl is not None and ctrl.flag_pause != self.paused:
                        self.paused = ctrl.flag_pause
                        if self.backend_thread is not None:
                            self.backend_thread.backend_queue.put(
                                ["pause" if self.paused else "unpause"])
                    if self.paused:
                        time.sleep(0.01)
                        continue
                if self.requested_init or ((self.single_thread or not self.initialized)
                                           and self.requested_keyframe > 0):
                    # wait for the backend: an init, or a keyframe while the
                    # frontend is single-threaded or not yet initialized; a
                    # backend thread gets the host while this one sleeps
                    if pump is not None:
                        pump(idle_budget=0)
                        self._drain_frontend_queue()
                    else:
                        time.sleep(0.005)
                    continue

                image, depth, T_gt = self._load_frame(cur_frame_idx)
                if self.reset:
                    self.initialize(cur_frame_idx, image, depth, T_gt)
                    cur_frame_idx += 1
                    continue

                self.initialized = self.initialized or len(self.current_window) == self.window_size

                # the next frame's fetch inside tracking() counts as fetch_frame only
                with span("tracking"):
                    track = self.tracking(cur_frame_idx, image, depth)
                tally("tracking_iters", int(track.n_iters))
                self.cameras[cur_frame_idx] = FrameInfo(cur_frame_idx, track.T_w2c, T_gt,
                                                        track.exposure_ab)
                if self.viz_channel is not None:
                    self._publish(track, image)
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
                    with span("keyframe"):
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
                        with sync("overflow"):
                            tile_overflow = int(track.tile_overflow)
                        if tile_overflow > 0:
                            Log(f"raster tile-list overflow: {tile_overflow} entries "
                                f"dropped (raise TPU.max_per_tile)", tag="MonoGS-TPU")
                        depth_map = self.make_keyframe_depth(image, depth, track)
                        kf = Keyframe(idx=cur_frame_idx, image=image,
                                      depth=depth if self.use_depth else None, T_w2c=track.T_w2c,
                                      exposure=track.exposure_ab, T_gt=T_gt)
                        self.cameras[cur_frame_idx].is_keyframe = True
                        self.kf_indices.append(cur_frame_idx)
                        Log(f"Keyframe {cur_frame_idx} (#{len(self.kf_indices)}), "
                            f"window {self.current_window} "
                            f"(n_vis {int(np.count_nonzero(cur_vis))})")
                        self.requested_keyframe += 1
                        self._send(["keyframe", cur_frame_idx, kf, list(self.current_window),
                                    depth_map])
                cur_frame_idx += 1
                if create_kf and self.throttle:
                    # a live camera: keyframe frames at most 3 a second
                    time.sleep(max(0.01, 1.0 / 3.0 - (time.time() - tic)))

        self.cur_frame_idx = cur_frame_idx
        if self.backend_thread is not None:
            if pump is not None:
                pump(idle_budget=0)
            self._drain_frontend_queue()
        else:
            self._sync_direct("final")

"""Mapping backend: host orchestration around the mapping loop (port of the
single-device path of `monogs_dev_tpu/core/backend.py`).

Owns the map, the keyframe store, the occlusion-aware visibility and the
window optimizer state; runs the init/keyframe/idle mapping rounds of the
reference message protocol. The map's row count is a tier: full capacity at
bootstrap, compacted to `tier_small` when the alive set fits, grown back
under insert or densify pressure.
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.camera import Intrinsics
from ..models.gaussians import GaussianMap, compact_map, create_map, insert_points_evict, resize_map
from ..ops.raster_types import RasterConfig
from ..utils.logging import Log
from .insertion import new_points_from_frame
from .keyframe import Keyframe
from .mapping import (
    KeyframeBatch,
    KeyframeOptState,
    TorchDraws,
    harvest_visibility,
    make_keyframe_opt_state,
    mapping_iterations,
    visibility_prune,
)
from .params import MapOptConfig, StepConfig

CAMERAS_EXTENT = 6.0  # reference slam.py (backend.cameras_extent = 6.0)


def next_chunk(chunk: int, drift: float, dilation: float, current: int, map_chunk: int) -> int:
    """Proportional control of the binning-reuse chunk length (used when
    mapping_rebin_every == 0): aim at 60% of the dilation margin from the
    last chunk's bulk drift; grow at most 2x per decision."""
    per_iter = drift / max(chunk, 1)
    if per_iter <= 0.05 * dilation / max(map_chunk, 1):
        target = map_chunk
    else:
        target = int(0.6 * dilation / per_iter)
    if target > current:
        target = min(target, max(current, 1) * 2)
    return max(1, min(map_chunk, target))


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class BackendEngine:
    """Owns the map; executes init/keyframe/mapping commands."""

    def __init__(self, config, step_cfg: StepConfig, opt_cfg: MapOptConfig,
                 intr: Intrinsics, raster_cfg: RasterConfig, capacity: int, device,
                 seed: int = 0):
        self.config = config
        self.cfg = step_cfg
        self.opt_cfg = opt_cfg
        self.intr = intr
        self.raster_cfg = raster_cfg
        self.capacity = capacity
        self.device = torch.device(device)

        training = config["Training"]
        self.init_itr_num = int(training["init_itr_num"])
        self.init_gaussian_update = int(training["init_gaussian_update"])
        self.init_gaussian_reset = int(training["init_gaussian_reset"])
        self.init_gaussian_th = float(training["init_gaussian_th"])
        self.init_gaussian_extent = CAMERAS_EXTENT * float(training["init_gaussian_extent"])
        self.mapping_itr_num = int(training["mapping_itr_num"])
        self.gaussian_update_every = int(training["gaussian_update_every"])
        self.gaussian_update_offset = int(training["gaussian_update_offset"])
        self.gaussian_th = float(training["gaussian_th"])
        self.gaussian_extent = CAMERAS_EXTENT * float(training["gaussian_extent"])
        self.gaussian_reset = int(training["gaussian_reset"])
        self.size_threshold = float(training["size_threshold"])
        self.window_size = int(training["window_size"])
        self.pose_window = int(training["pose_window"])
        self.prune_mode = training.get("prune_mode", "slam")
        self.refinement_itr_num = int(training.get("refinement_itr_num", 26000))

        ds = config["Dataset"]
        self.pcd_downsample = int(ds.get("pcd_downsample", 64))
        self.pcd_downsample_init = int(ds.get("pcd_downsample_init", 32))
        self.point_size = float(ds.get("point_size", 0.01))
        self.adaptive_pointsize = bool(ds.get("adaptive_pointsize", True))

        self.use_depth = not self.cfg.monocular
        self.bg_color = torch.zeros(3, device=self.device)
        tpu_grp = config.get("TPU", {}) or {}
        self.map_chunk = int(tpu_grp.get("map_chunk", 10))
        self.idle_iters = int(tpu_grp.get("idle_iters", 1))
        self.idle_every = int(tpu_grp.get("idle_every", 1))
        self.tier_small = int(tpu_grp.get("map_tier_small", 0)) or max(
            capacity // 2, min(capacity, 8192)
        )
        self.tier_small = min(_next_pow2(self.tier_small), capacity)
        self.gen = torch.Generator().manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        self.reset()

    # ------------------------------------------------------------------ state

    def reset(self) -> None:
        self.gmap: GaussianMap = create_map(self.capacity, self.cfg.sh_degree, self.device)
        self._grow_pending = False
        self.iteration_count = 0
        self._adaptive_chunk = min(2, self.map_chunk)
        self.viewpoints: Dict[int, Keyframe] = {}
        self.current_window: List[int] = []
        self.occ_aware_visibility: Dict[int, np.ndarray] = {}
        self.initialized = not self.cfg.monocular
        self.kf_state: Optional[KeyframeOptState] = None
        self.telemetry = {
            "insert_dropped": 0,
            "insert_evicted": 0,
            "densify_dropped": 0,
            "map_chunks": 0,
            "map_iters": 0,
            "max_binning_drift": 0.0,
            "max_bulk_drift": 0.0,
            "map_compactions": 0,
            "map_grows": 0,
        }

    def _point_draws(self):
        """Random source of one keyframe insertion."""
        return self.gen

    def _mapping_draws(self):
        """Random source of one mapping dispatch (see TorchDraws)."""
        return TorchDraws(self.gen)

    # ------------------------------------------------------ capacity tiers

    def map_rows(self) -> int:
        return int(self.gmap.aux.active.shape[0])

    def _grow_to_capacity(self) -> None:
        rows = self.map_rows()
        self._grow_pending = False
        if rows >= self.capacity:
            return
        self.gmap = resize_map(self.gmap, self.capacity)
        self.telemetry["map_grows"] += 1
        Log(f"map tier grown {rows} -> {self.capacity} rows", tag="MonoGS-TPU")

    def _maybe_compact(self) -> None:
        """Shrink the tier to `tier_small` when the alive set plus one
        keyframe insert plus densify headroom fits; the host visibility
        vectors get the same row permutation."""
        rows = self.map_rows()
        target = self.tier_small
        if target >= rows:
            return
        alive = int(self.gmap.aux.active.sum())
        kf_insert = (self.intr.height * self.intr.width) // self.pcd_downsample
        densify_headroom = min(6144, self.capacity // 8)
        if alive + kf_insert + densify_headroom > target:
            return
        self.gmap, perm = compact_map(self.gmap, target)
        perm_np = perm.cpu().numpy()
        for k, v in list(self.occ_aware_visibility.items()):
            vv = np.asarray(v)
            if vv.shape[0] < perm_np.shape[0]:
                vv = np.pad(vv, (0, perm_np.shape[0] - vv.shape[0]))
            out = np.zeros(self.capacity, bool)
            out[:target] = vv[perm_np[:target]]
            self.occ_aware_visibility[k] = out
        self.telemetry["map_compactions"] += 1
        Log(f"map compacted: {alive} active -> {target} rows (was {rows})", tag="MonoGS-TPU")

    # ------------------------------------------------------------- insertion

    def add_next_kf(self, frame_idx: int, kf: Keyframe, depth_map: torch.Tensor,
                    init: bool = False) -> None:
        downsample = self.pcd_downsample_init if init else self.pcd_downsample
        h, w = self.intr.height, self.intr.width
        budget = _next_pow2(max(int(2 * h * w / downsample), 256))
        if self.map_rows() < self.capacity:
            free = int((~self.gmap.aux.active).sum())
            if budget // 2 > free:
                self._grow_to_capacity()
        new_params, valid = new_points_from_frame(
            self._point_draws(), kf.image, depth_map, kf.exposure, kf.T_w2c, self.intr,
            self.cfg.sh_degree, budget, downsample, self.point_size,
            self.adaptive_pointsize,
        )
        self.gmap, dropped, evicted = insert_points_evict(self.gmap, new_params, valid, frame_idx)
        self.telemetry["insert_dropped"] += int(dropped)
        self.telemetry["insert_evicted"] += int(evicted)
        self.viewpoints[frame_idx] = kf

    # ----------------------------------------------------------- batch build

    def _slot_tier(self) -> int:
        """4 slots while the window is small, else window_size + 2."""
        need = min(len(self.current_window), self.cfg.window_slots - 2) + 2
        if need <= 4 or self.cfg.window_slots <= 4:
            return min(4, self.cfg.window_slots) if self.cfg.window_slots < 4 else 4
        return self.cfg.window_slots

    def _stack_slots(self, kf_ids: List[int], b: int):
        h, w = self.intr.height, self.intr.width
        images = torch.zeros((b, h, w, 3), device=self.device)
        depths = torch.zeros((b, h, w), device=self.device)
        for s, kf_idx in enumerate(kf_ids):
            kf = self.viewpoints[kf_idx]
            images[s] = kf.image
            if kf.depth is not None:
                depths[s] = kf.depth
        return images, depths

    def _build_batch(self, apply_exposure: bool, frames_to_optimize: int, b: int):
        """Stack the current window + 2 random past keyframes into slots."""
        window = list(self.current_window)[: b - 2]
        others = [i for i in self.viewpoints if i not in set(window)]
        rand: List[int] = []
        if others:
            picks = self.np_rng.choice(np.array(others), size=min(2, len(others)),
                                       replace=False)
            rand = [int(i) for i in picks]
        slot_ids = window + rand
        T = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
        exposure = np.zeros((b, 2), np.float32)
        valid = np.zeros(b, bool)
        opt_pose = np.zeros(b, bool)
        opt_exp = np.zeros(b, bool)
        harvest = np.zeros(b, bool)
        for s, kf_idx in enumerate(slot_ids):
            kf = self.viewpoints[kf_idx]
            T[s] = kf.T_w2c
            exposure[s] = kf.exposure
            valid[s] = True
            in_window = s < len(window)
            harvest[s] = in_window
            if in_window and kf_idx != 0:
                opt_exp[s] = True
                if s < frames_to_optimize:
                    opt_pose[s] = True
        images, depths = self._stack_slots(slot_ids, b)

        def t(x):
            return torch.as_tensor(x, device=self.device)

        batch = KeyframeBatch(
            images=images, depths=depths, T_w2c=t(T), exposure=t(exposure), valid=t(valid),
            optimize_pose=t(opt_pose), optimize_exposure=t(opt_exp),
            apply_exposure=t(np.full(b, apply_exposure) & valid), harvest_visibility=t(harvest),
        )
        return batch, slot_ids

    def _writeback(self, batch: KeyframeBatch, slot_ids: List[int]) -> None:
        T_np = batch.T_w2c.cpu().numpy()
        exp_np = batch.exposure.cpu().numpy()
        for s, kf_idx in enumerate(slot_ids):
            kf = self.viewpoints[kf_idx]
            kf.T_w2c = T_np[s]
            kf.exposure = exp_np[s]

    def _resample_random_slots(self, batch: KeyframeBatch, slot_ids: List[int], n_win: int):
        """Redraw the 2 random past keyframes between chunks of one round;
        the window slots keep the poses the previous chunk optimized."""
        n_rand = len(slot_ids) - n_win
        others = [i for i in self.viewpoints if i not in set(slot_ids[:n_win])]
        if n_rand != 2 or len(others) < 2:
            return batch, slot_ids
        picks = self.np_rng.choice(np.array(others), size=2, replace=False)
        rand = [int(i) for i in picks]
        images, depths = self._stack_slots(rand, 2)
        kfs = [self.viewpoints[i] for i in rand]
        T = batch.T_w2c.clone()
        exposure = batch.exposure.clone()
        T[n_win:n_win + 2] = torch.as_tensor(np.stack([kf.T_w2c for kf in kfs]).astype(np.float32),
                                             device=self.device)
        exposure[n_win:n_win + 2] = torch.as_tensor(
            np.stack([kf.exposure for kf in kfs]).astype(np.float32), device=self.device)
        all_images = batch.images.clone()
        all_depths = batch.depths.clone()
        all_images[n_win:n_win + 2] = images
        all_depths[n_win:n_win + 2] = depths
        batch = dataclasses.replace(batch, images=all_images, depths=all_depths, T_w2c=T,
                                    exposure=exposure)
        return batch, slot_ids[:n_win] + rand

    def _consume_chunk_telemetry(self, out, chunk: int, densified: bool) -> None:
        self.telemetry["densify_dropped"] += int(out.n_dropped)
        if (out.n_dropped > 0 or out.n_free < 2048) and self.map_rows() < self.capacity:
            self._grow_pending = True  # grow before densify children are dropped
        self.telemetry["map_chunks"] += 1
        self.telemetry["map_iters"] += chunk
        if densified:
            return  # split children read as fake drift
        self.telemetry["max_binning_drift"] = max(self.telemetry["max_binning_drift"],
                                                  out.max_drift)
        self.telemetry["max_bulk_drift"] = max(self.telemetry["max_bulk_drift"], out.bulk_drift)
        self._adaptive_chunk = next_chunk(chunk, out.bulk_drift, self.cfg.mapping_rebin_dilation,
                                          self._adaptive_chunk, self.map_chunk)

    # ---------------------------------------------------------------- mapping

    def map(self, iters: int = 1, prune: bool = False, init_mode: bool = False,
            frames_to_optimize: Optional[int] = None, harvest: bool = True) -> None:
        """One mapping round (slam_backend.py BackEnd.map)."""
        if not self.current_window:
            return
        if frames_to_optimize is None:
            frames_to_optimize = self.pose_window
        last_batch, slot_ids = self._map_single(iters, init_mode, frames_to_optimize)
        if last_batch is not None and harvest:
            self._harvest_tail(last_batch, slot_ids)
        if prune and len(self.current_window) == self.window_size:
            self._visibility_prune()
            self._maybe_compact()
            if not self.initialized:
                self.initialized = True
                Log("Initialized SLAM")

    def _map_single(self, iters: int, init_mode: bool, frames_to_optimize: int):
        if init_mode:
            update_every, update_offset = self.init_gaussian_update, 1
            reset_interval = self.init_gaussian_reset
            g_th, g_extent = self.init_gaussian_th, self.init_gaussian_extent
            size_th = 0.0
        else:
            update_every, update_offset = self.gaussian_update_every, self.gaussian_update_offset
            reset_interval = self.gaussian_reset
            g_th, g_extent = self.gaussian_th, self.gaussian_extent
            size_th = self.size_threshold

        remaining = iters
        batch = None
        slot_ids: List[int] = []
        tier = self._slot_tier()
        if self.kf_state is None or self.kf_state.mu.shape[0] != tier:
            self.kf_state = make_keyframe_opt_state(tier, self.device)
        n_win = min(len(self.current_window), tier - 2)
        while remaining > 0:
            if self._grow_pending:
                self._grow_to_capacity()
            if self.cfg.mapping_rebin_every > 0:
                # binnings refresh inside the loop: the whole round may run
                # as chunks of map_chunk iterations
                chunk = min(remaining, max(self.map_chunk, 1))
            else:
                # end each chunk exactly on the next densify/reset event so a
                # topology change never renders against a stale binning
                event = self._next_map_event(self.iteration_count, update_every,
                                             update_offset, reset_interval, init_mode)
                chunk = min(self._adaptive_chunk, remaining, event - self.iteration_count)
            if batch is None:
                batch, slot_ids = self._build_batch(not init_mode, frames_to_optimize, tier)
            else:
                batch, slot_ids = self._resample_random_slots(batch, slot_ids, n_win)
            out = mapping_iterations(
                self.gmap, batch, self.kf_state, self.iteration_count, self._mapping_draws(),
                self.bg_color, g_th, g_extent, self.cfg, self.opt_cfg, self.intr,
                self.raster_cfg, iters=chunk, update_every=update_every,
                update_offset=update_offset, reset_interval=reset_interval,
                size_threshold=size_th, use_depth=self.use_depth, init_mode=init_mode,
            )
            self.gmap = out.gmap
            self.kf_state = out.kf_state
            self.iteration_count = out.iteration_count
            densified = (self.iteration_count % update_every) == update_offset or (
                init_mode and self.iteration_count == reset_interval)
            self._consume_chunk_telemetry(out, chunk, densified)
            batch = out.batch
            remaining -= chunk
        if batch is not None:
            self._writeback(batch, slot_ids)
        return batch, slot_ids

    @staticmethod
    def _next_map_event(start: int, update_every: int, update_offset: int,
                        reset_interval: int, init_mode: bool) -> int:
        """Smallest iteration > start where densify or an opacity reset fires."""
        k = (start - update_offset) // update_every * update_every + update_offset
        while k <= start:
            k += update_every
        cands = [k]
        if init_mode:
            if start < reset_interval:
                cands.append(reset_interval)
        else:
            cands.append((start // reset_interval + 1) * reset_interval)
        return min(cands)

    def _harvest_tail(self, last_batch: KeyframeBatch, slot_ids: list) -> None:
        """Refresh occ-aware visibility from the round's final poses; host
        vectors are always capacity-padded."""
        vis = harvest_visibility(self.gmap, last_batch, self.bg_color, self.cfg, self.intr,
                                 self.raster_cfg).cpu().numpy()
        if vis.shape[1] < self.capacity:
            vis = np.pad(vis, ((0, 0), (0, self.capacity - vis.shape[1])))
        for s, kf_idx in enumerate(slot_ids):
            if s < len(self.current_window):
                self.occ_aware_visibility[kf_idx] = vis[s]
        window = set(self.current_window)
        self.occ_aware_visibility = {k: v for k, v in self.occ_aware_visibility.items()
                                     if k in window}

    def _visibility_prune(self) -> None:
        b = self.cfg.window_slots
        n = self.map_rows()
        vis = np.zeros((b, n), bool)
        valid = np.zeros(b, bool)
        kf_ids = np.full(b, -1, np.int32)
        for s, kf_idx in enumerate(self.current_window[:b]):
            if kf_idx in self.occ_aware_visibility:
                vis[s] = np.asarray(self.occ_aware_visibility[kf_idx])[:n]
                valid[s] = True
                kf_ids[s] = kf_idx
        sorted_window = sorted(self.current_window, reverse=True)
        third_newest = sorted_window[2] if len(sorted_window) > 2 else 0
        prev_active = self.gmap.aux.active
        self.gmap = visibility_prune(
            self.gmap, torch.as_tensor(vis, device=self.device),
            torch.as_tensor(valid, device=self.device),
            torch.as_tensor(kf_ids, device=self.device), third_newest, self.initialized,
            self.prune_mode, self.cfg.monocular,
        )
        if self.cfg.monocular:
            # the keyframe policy reads these vectors: drop the pruned rows;
            # rows past the tier were never prunable and stay
            kept = (self.gmap.aux.active | ~prev_active).cpu().numpy()
            kept = np.pad(kept, (0, self.capacity - kept.shape[0]), constant_values=True)
            for k in list(self.occ_aware_visibility):
                self.occ_aware_visibility[k] = np.asarray(self.occ_aware_visibility[k]) & kept

    # ------------------------------------------------------------- commands

    def handle_init(self, frame_idx: int, kf: Keyframe, depth_map: torch.Tensor) -> None:
        Log("Resetting the system")
        self.reset()
        self.current_window = [frame_idx]
        self.add_next_kf(frame_idx, kf, depth_map, init=True)
        self.initialize_map(frame_idx)

    def initialize_map(self, frame_idx: int) -> None:
        self.kf_state = None
        self.map(iters=self.init_itr_num, init_mode=True, frames_to_optimize=0)
        Log("Initialized map")

    def handle_keyframe(self, frame_idx: int, kf: Keyframe, current_window: List[int],
                        depth_map: torch.Tensor, single_thread: bool) -> None:
        self.current_window = list(current_window)
        self.add_next_kf(frame_idx, kf, depth_map, init=False)
        frames_to_optimize = self.pose_window
        iter_per_kf = self.mapping_itr_num if single_thread else 10
        if not self.initialized:
            if len(self.current_window) == self.window_size:
                frames_to_optimize = self.window_size - 1
                iter_per_kf = 300
                Log("Performing initial BA for initialization")
            else:
                iter_per_kf = self.mapping_itr_num
        self.kf_state = None
        # map(iter_per_kf) followed by one more iteration with the prune
        self.map(iters=iter_per_kf + 1, prune=True, frames_to_optimize=frames_to_optimize)

    def color_refinement(self) -> None:
        """Photometric-only refinement of the map over the keyframes, for
        `Training.refinement_itr_num` iterations."""
        from .refinement import run_color_refinement

        self.gmap, self.iteration_count = run_color_refinement(
            self, iterations=self.refinement_itr_num)

    def keyframe_poses(self) -> Dict[int, np.ndarray]:
        return {idx: np.asarray(kf.T_w2c) for idx, kf in self.viewpoints.items()}


class _BackendProtocol:
    """The reference message protocol (init/keyframe/color_refinement/
    pause/unpause/stop) over a backend_queue/frontend_queue pair, with its
    idle cadence: one background mapping round per idle pass, and a
    10-iteration prune pass plus a frontend sync every 10 un-synced
    iterations."""

    engine: BackendEngine
    single_thread: bool

    def _init_protocol(self, engine: BackendEngine, single_thread: bool):
        self.engine = engine
        self.single_thread = single_thread
        self.backend_queue: "queue.Queue" = queue.Queue()
        self.frontend_queue: "queue.Queue" = queue.Queue()
        self.pause = False
        self.last_sent = 0
        self.stopped = False

    def push_to_frontend(self, tag: str = "sync_backend") -> None:
        self.last_sent = 0
        e = self.engine
        keyframes = [(idx, np.asarray(e.viewpoints[idx].T_w2c)) for idx in e.current_window]
        snapshot = (e.gmap.params, e.gmap.aux.active)
        self.frontend_queue.put([tag, snapshot, dict(e.occ_aware_visibility), keyframes])

    def _idle_round(self) -> None:
        e = self.engine
        if self.stopped or self.pause or not e.current_window or self.single_thread:
            return
        if self.last_sent + e.idle_iters >= 10:
            e.map(iters=e.idle_iters + 10, prune=True)
            self.push_to_frontend()
        else:
            e.map(iters=e.idle_iters, harvest=False)
            self.last_sent += e.idle_iters

    def _handle(self, data) -> None:
        e = self.engine
        tag = data[0]
        if tag == "stop":
            self.stopped = True
        elif tag == "pause":
            self.pause = True
        elif tag == "unpause":
            self.pause = False
        elif tag == "color_refinement":
            e.color_refinement()
            self.push_to_frontend()
        elif tag == "init":
            _, frame_idx, kf, depth_map = data
            e.handle_init(frame_idx, kf, depth_map)
            self.push_to_frontend("init")
        elif tag == "keyframe":
            _, frame_idx, kf, window, depth_map = data
            e.handle_keyframe(frame_idx, kf, window, depth_map, self.single_thread)
            self.push_to_frontend("keyframe")
        else:
            raise RuntimeError(f"Unprocessed message {tag}")


class InlineBackendScheduler(_BackendProtocol):
    """Message-driven backend pumped synchronously by the frontend thread:
    one host thread issues one command stream, time-slicing tracking and
    mapping on one device."""

    def __init__(self, engine: BackendEngine, single_thread: bool = False):
        self._init_protocol(engine, single_thread)
        self._pump_tick = 0

    def start(self) -> None:
        pass

    def is_alive(self) -> bool:
        return not self.stopped

    def join(self, timeout: Optional[float] = None) -> None:
        self.pump(idle_budget=0)

    def pump(self, idle_budget: int = 1) -> None:
        while True:
            try:
                data = self.backend_queue.get_nowait()
            except queue.Empty:
                break
            self._handle(data)
        if idle_budget > 0:
            self._pump_tick += 1
            if self._pump_tick % max(self.engine.idle_every, 1) == 0:
                for _ in range(idle_budget):
                    self._idle_round()

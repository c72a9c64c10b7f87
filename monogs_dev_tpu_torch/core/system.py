"""SLAM orchestrator (port of `monogs_dev_tpu/core/system.py`: `SLAM.__init__`,
`run`, `stop`, plus `raster_config_from` and `resolve_thread_flags`).

Wires config -> dataset -> map -> frontend/backend on one device and runs
the sequence. FPS is total frames over the wall time of the frontend run.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..data.synthetic import load_dataset
from ..eval.ate import ate_rmse
from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..utils.logging import Log
from ..utils.profiling import PhaseTimers
from .backend import BackendEngine, InlineBackendScheduler
from .frontend import FrontEnd
from .params import MapOptConfig, StepConfig


def resolve_thread_flags(config) -> tuple:
    """(frontend_single_thread, backend_single_thread): `Training.single_thread`
    gates the frontend, `Dataset.single_thread` serializes the backend."""
    return (
        bool(config["Training"].get("single_thread", False)),
        bool((config.get("Dataset") or {}).get("single_thread", False)),
    )


def raster_config_from(config) -> RasterConfig:
    tpu = config.get("TPU", {}) or {}
    return RasterConfig(
        tile=int(tpu.get("tile", 16)),
        max_per_tile=int(tpu.get("max_per_tile", 1024)),
        k_dup=int(tpu.get("k_dup", 16)),
        tile_group=int(tpu.get("tile_group", 60)),
        tight_cull=bool(tpu.get("tight_cull", True)),
    )


class SLAM:
    def __init__(self, config, device, seed: int = 0):
        # fp32 throughout: the pose chains and SSIM-style filters degrade
        # badly under TF32 (the JAX package's utils/precision.py counterpart)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.monocular = config["Dataset"]["sensor_type"] == "monocular"
        self.step_cfg = StepConfig.from_config(config)
        self.opt_cfg = MapOptConfig.from_config(config)
        self.dataset = load_dataset(config, self.device)
        self.intr = Intrinsics(fx=self.dataset.fx, fy=self.dataset.fy, cx=self.dataset.cx,
                               cy=self.dataset.cy, width=self.dataset.width,
                               height=self.dataset.height)
        self.raster_cfg = raster_config_from(config)
        tpu = config.get("TPU", {}) or {}
        self.capacity = int(tpu.get("capacity", 65536))
        self.single_thread, self.backend_single_thread = resolve_thread_flags(config)
        self.engine = BackendEngine(
            config, self.step_cfg, self.opt_cfg, self.intr, self.raster_cfg,
            capacity=self.capacity, device=self.device, seed=seed,
        )
        self.backend_thread = (None if self.backend_single_thread
                               else InlineBackendScheduler(self.engine))
        self.frontend = FrontEnd(config, self.dataset, self.engine, self.step_cfg, self.intr,
                                 self.raster_cfg, backend_thread=self.backend_thread,
                                 seed=seed + 1)
        self.fps: float = 0.0
        self.timers = PhaseTimers()
        self.frontend.timers = self.timers

    def run(self, max_frames: Optional[int] = None) -> None:
        if self.backend_thread is not None:
            self.backend_thread.start()
        t0 = time.time()
        self.frontend.run(max_frames=max_frames)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time()
        n = len(self.dataset) if max_frames is None else min(max_frames, len(self.dataset))
        self.fps = n / max(t1 - t0, 1e-9)
        Log(f"Total FPS: {self.fps:.3f}")

    def stop(self) -> None:
        if self.backend_thread is not None:
            self.backend_thread.backend_queue.put(["stop"])
            self.backend_thread.join(timeout=30)

    def keyframe_ate(self) -> float:
        """Keyframe-trajectory ATE RMSE (m) against the dataset's GT poses."""
        fe = self.frontend
        cams = [fe.cameras[i] for i in fe.kf_indices]
        return ate_rmse([c.T_est for c in cams], [c.T_gt for c in cams],
                        correct_scale=self.monocular)

    def n_alive(self) -> int:
        return int(self.engine.gmap.aux.active.sum())

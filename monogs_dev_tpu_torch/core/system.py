"""SLAM orchestrator (port of `monogs_dev_tpu/core/system.py`: `SLAM.__init__`,
`run`, `stop`, `evaluate`, plus `raster_config_from`, `resolve_thread_flags`
and `make_save_dir`).

Wires config -> dataset -> map -> frontend/backend on one device, runs the
sequence, and drives the eval tail (ATE, rendering metrics before and after
colour refinement, PLY export). FPS is total frames over the wall time of
the frontend run.
"""

from __future__ import annotations

import datetime
import os
import shutil
import time
from typing import Optional

import torch

from ..data.synthetic import load_dataset
from ..eval.ate import ate_rmse, eval_ate
from ..eval.rendering import eval_rendering, save_gaussians
from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..utils.logging import Log
from ..utils.profiling import MetricsLogger, PhaseTimers
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
    def __init__(self, config, device, seed: int = 0, save_dir: Optional[str] = None):
        # fp32 throughout: the pose chains and SSIM-style filters degrade
        # badly under TF32 (the JAX package's utils/precision.py counterpart)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.save_dir = save_dir
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
        self.metrics = MetricsLogger(
            save_dir, use_wandb=bool(config["Results"].get("use_wandb", False)),
            wandb_kwargs={"project": config["Dataset"].get("type", "monogs"), "config": config},
        )

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
        self.metrics.log({"fps": self.fps, "n_frames": n})

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

    def _eval_rendering(self, tag: str) -> dict:
        e = self.engine
        return eval_rendering(self.frontend.cameras, self.dataset, e.gmap.params,
                              e.gmap.aux.active, self.intr, self.raster_cfg,
                              self.step_cfg.sh_degree, self.save_dir,
                              self.frontend.kf_indices, iteration=tag)

    def evaluate(self, eval_rendering_flag: bool = True) -> dict:
        """The eval tail: keyframe ATE, then PSNR/SSIM/LPIPS before and after
        colour refinement, the PLY and the metrics table (slam.py:121-190 of
        the reference)."""
        fe, e = self.frontend, self.engine
        results = {"fps": self.fps, "n_keyframes": len(fe.kf_indices),
                   "n_gaussians": self.n_alive(), "telemetry": dict(e.telemetry)}
        results["ate"] = eval_ate(fe.cameras, fe.kf_indices, self.save_dir, 0, final=True,
                                  monocular=self.monocular)
        if eval_rendering_flag:
            results["before_opt"] = self._eval_rendering("before_opt")
            if self.backend_thread is not None:
                self.backend_thread.backend_queue.put(["color_refinement"])
                self.backend_thread.pump(idle_budget=0)
                fe._drain_frontend_queue()
            else:
                e.color_refinement()
            results["after_opt"] = self._eval_rendering("after_opt")
            save_gaussians(e.gmap.params, e.gmap.aux.active, self.save_dir, "final", final=True)
            self.metrics.log_table(
                "Metrics", ["tag", "psnr", "ssim", "lpips", "RMSE ATE", "FPS"],
                [[tag, r["mean_psnr"], r["mean_ssim"], r["mean_lpips"], results["ate"], self.fps]
                 for tag, r in (("Before", results["before_opt"]),
                                ("After", results["after_opt"]))],
            )
        self.metrics.log(results)
        self.metrics.finish()
        return results


def make_save_dir(config, config_path: str) -> Optional[str]:
    """results/<dataset tail>_<datetime>/ with a copy of the config, when
    `Results.save_results` is set (slam.py:229-242 of the reference)."""
    if not config["Results"].get("save_results", False):
        return None
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    tail = os.path.basename(config["Dataset"].get("dataset_path", "synthetic").rstrip("/"))
    save_dir = os.path.join(config["Results"].get("save_dir", "results"), f"{tail}_{stamp}")
    os.makedirs(save_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(save_dir, "config.yml"))
    Log(f"saving results in {save_dir}")
    return save_dir

"""SLAM orchestrator (port of `monogs_dev_tpu/core/system.py`: `SLAM.__init__`,
`run`, `stop`, `evaluate`, `save_checkpoint`, `resume`, plus
`raster_config_from`, `resolve_thread_flags` and `make_save_dir`).

Wires config -> dataset -> map -> frontend/backend on one device, runs the
sequence, and drives the eval tail (ATE, rendering metrics before and after
colour refinement, PLY export). FPS is total frames over the wall time of
the frontend run.

`TPU.scheduler` picks the backend's scheduler: "inline" (the default; the
frontend pumps it on its own thread) or "thread" (`BackendThread`, a host
thread and CUDA stream of its own); `Dataset.single_thread` runs the backend
directly instead. `Results.use_gui` opens a `VizChannel` for a viewer, and
`Dataset.type: realsense` (a live camera) shortens the initial BA and
throttles keyframe frames, as in the reference. `TPU.mesh_devices: N` maps
data-parallel (`parallel/mesh.py`): the engine builds the mesh and logs its
devices, and a data-parallel round is one round to the schedulers, so a
thread's hold waits for it and the mesh's state travels with the engine's
tensors at every hand-off (`backend.engine_tensors`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import time
from typing import Optional

import torch

from ..data.datasets import load_dataset
from ..eval.ate import ate_rmse, eval_ate
from ..eval.rendering import eval_rendering, save_gaussians
from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..utils.logging import Log
from ..utils import profiling
from ..utils.profiling import MetricsLogger, PhaseTimers
from .backend import BackendEngine, BackendThread, InlineBackendScheduler
from .frontend import FrontEnd
from .params import MapOptConfig, StepConfig


STOP_TIMEOUT_S = 600.0  # a backend thread ends its round in flight, then stops


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
        self.live_mode = config["Dataset"]["type"] == "realsense"
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
            capacity=self.capacity, device=self.device, seed=seed, live_mode=self.live_mode,
        )
        scheduler = str(tpu.get("scheduler", "inline"))
        if self.backend_single_thread:
            self.backend_thread = None
        elif scheduler == "thread":
            self.backend_thread = BackendThread(self.engine)
        else:
            self.backend_thread = InlineBackendScheduler(self.engine)
        self.viz_channel = None
        if config["Results"].get("use_gui", False):
            from ..viz.snapshot import VizChannel

            self.viz_channel = VizChannel()
        self.frontend = FrontEnd(config, self.dataset, self.engine, self.step_cfg, self.intr,
                                 self.raster_cfg, backend_thread=self.backend_thread,
                                 seed=seed + 1, throttle=self.live_mode,
                                 viz_channel=self.viz_channel)
        self.fps: float = 0.0
        # the recorder that the port's spans write to (utils/profiling.py)
        self.timers = PhaseTimers()
        profiling.activate(self.timers)
        self.metrics = MetricsLogger(
            save_dir, use_wandb=bool(config["Results"].get("use_wandb", False)),
            wandb_kwargs={"project": config["Dataset"].get("type", "monogs"), "config": config},
        )

    def run(self, max_frames: Optional[int] = None) -> None:
        """Run the frontend up to frame `max_frames`; a later call goes on
        from there (the backend thread is started once)."""
        profiling.activate(self.timers)
        if self.backend_thread is not None and not self.backend_thread.is_alive():
            self.backend_thread.start()
        t0 = time.time()
        self.frontend.run(max_frames=max_frames)
        if self.device.type == "cuda":
            with profiling.sync("run_end"):
                torch.cuda.synchronize(self.device)
        t1 = time.time()
        n = len(self.dataset) if max_frames is None else min(max_frames, len(self.dataset))
        self.fps = n / max(t1 - t0, 1e-9)
        Log(f"Total FPS: {self.fps:.3f}")
        self.metrics.log({"fps": self.fps, "n_frames": n})

    def stop(self) -> None:
        """Stop the backend and join it; raises what ended a backend thread,
        and if the thread does not end within STOP_TIMEOUT_S."""
        bt = self.backend_thread
        if bt is None:
            return
        bt.backend_queue.put(["stop"])
        bt.join(timeout=STOP_TIMEOUT_S)
        if bt.is_alive():
            raise RuntimeError(f"the backend thread did not stop within {STOP_TIMEOUT_S} s")

    def _held(self):
        """A context in which the map is this thread's to read: a live
        backend thread is held between rounds."""
        if isinstance(self.backend_thread, BackendThread):
            return self.backend_thread.held()
        return contextlib.nullcontext()

    def keyframe_ate(self) -> float:
        """Keyframe-trajectory ATE RMSE (m) against the dataset's GT poses."""
        fe = self.frontend
        cams = [fe.cameras[i] for i in fe.kf_indices]
        return ate_rmse([c.T_est for c in cams], [c.T_gt for c in cams],
                        correct_scale=self.monocular)

    def n_alive(self) -> int:
        with self._held():
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
            bt = self.backend_thread
            threaded = isinstance(bt, BackendThread) and bt.is_alive()
            if threaded:
                # no idle rounds through the eval tail: both renders read
                # the map of one moment, and the drain below waits for the
                # refinement's own message
                bt.backend_queue.put(["pause"])
                with bt.held():
                    fe._drain_frontend_queue()
            results["before_opt"] = self._eval_rendering("before_opt")
            if bt is not None:
                bt.backend_queue.put(["color_refinement"])
                if hasattr(bt, "pump"):
                    bt.pump(idle_budget=0)
                    fe._drain_frontend_queue()
                else:
                    fe._drain_frontend_queue(block=True)
            else:
                e.color_refinement()
            results["after_opt"] = self._eval_rendering("after_opt")
            save_gaussians(e.gmap.params, e.gmap.aux.active, self.save_dir, "final", final=True)
            if threaded and not fe.paused:
                bt.backend_queue.put(["unpause"])
            self.metrics.log_table(
                "Metrics", ["tag", "psnr", "ssim", "lpips", "RMSE ATE", "FPS"],
                [[tag, r["mean_psnr"], r["mean_ssim"], r["mean_lpips"], results["ate"], self.fps]
                 for tag, r in (("Before", results["before_opt"]),
                                ("After", results["after_opt"]))],
            )
        self.metrics.log(results)
        self.metrics.finish()
        return results

    def save_checkpoint(self, path: str) -> str:
        """Write the full state (map, Adam moments, keyframes, trajectory;
        utils/checkpoint.py) to `path`."""
        from ..utils.checkpoint import save_checkpoint

        bt = self.backend_thread
        with self._held():  # the messages queued so far handled, then saved
            if hasattr(bt, "pump"):
                bt.pump(idle_budget=0)
            self.frontend._drain_frontend_queue()
            save_checkpoint(path, self.engine, self.frontend)
        Log(f"checkpoint saved to {path}")
        return path

    def resume(self, path: str) -> int:
        """Restore a checkpoint and position the frontend at the next frame;
        a following `run()` continues the sequence. Call before `run()`."""
        from ..utils.checkpoint import restore_checkpoint

        with self._held():
            next_frame = restore_checkpoint(path, self.engine, self.frontend)
        Log(f"resumed from {path}: {len(self.engine.viewpoints)} keyframes, "
            f"continuing at frame {next_frame}")
        return next_frame


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

#!/usr/bin/env python
"""CLI entry point of the PyTorch/CUDA port: the interface of `slam.py`.

    python slam_torch.py --config configs/synthetic/bench_vga.yaml --max-frames 12
    python slam_torch.py --config configs/synthetic/bench_vga_parity.yaml --eval
    python slam_torch.py --config configs/rgbd/tum/fixture_surface.yaml --max-frames 6 \
        --save-checkpoint
    python slam_torch.py --config configs/rgbd/tum/fixture_surface.yaml --resume <npz>

Runs on `--device` (default `cuda`, where the blend runs in the CUDA kernels
of monogs_dev_tpu_torch/csrc) and stops when that device is missing.
`--device cpu` runs the plain torch blend instead, for debugging at small
sizes. `--eval` applies the reference's overrides (save_results, no GUI,
rendering eval on), runs the eval tail after the sequence and prints its
results JSON; artifacts land in results/<dataset>_<datetime>/.
`--save-checkpoint` writes the full state (utils/checkpoint.py) after the
run, into the results directory or, without one, `checkpoint.npz`;
`--resume <npz>` restores such a file (from either package) and continues
the sequence from its next frame.

`TPU.scheduler: thread` in the config runs the backend on a host thread of
its own (core/backend.py::BackendThread). `Results.use_gui: True` opens the
viewer (monogs_dev_tpu_torch/viz/gui.py) on a thread when $DISPLAY is set;
without a display the run goes on and logs that the GUI is off.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

import torch

from monogs_dev_tpu_torch.core.system import SLAM, make_save_dir
from monogs_dev_tpu_torch.utils.config import load_config
from monogs_dev_tpu_torch.utils.logging import Log


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None, help="limit sequence length")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--resume", type=str, default=None,
                        help="full-state checkpoint.npz to resume from (utils/checkpoint.py)")
    parser.add_argument("--save-checkpoint", action="store_true",
                        help="write checkpoint.npz into the results dir after the run")
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's main path runs on the GPU "
                           "(pass --device cpu to run the plain blend on the CPU)")
    config = load_config(args.config)
    if args.eval:
        Log("Running in evaluation mode; overriding save_results=True, use_gui=False, "
            "eval_rendering=True")
        config["Results"].update(save_results=True, use_gui=False, eval_rendering=True)
    slam = SLAM(config, device, seed=args.seed, save_dir=make_save_dir(config, args.config))
    gui = None
    if slam.viz_channel is not None:
        if os.environ.get("DISPLAY"):
            from monogs_dev_tpu_torch.viz.gui import run_gui

            gui = threading.Thread(target=run_gui,
                                   args=(slam.viz_channel, slam.intr, slam.raster_cfg),
                                   daemon=True, name="gui")
            gui.start()
        else:
            Log("use_gui=True but no $DISPLAY; GUI disabled "
                "(use viz.OfflineViewer / export_turntable headless)")
    try:
        if args.resume:
            slam.resume(args.resume)
        slam.run(max_frames=args.max_frames)
        if args.save_checkpoint:
            slam.save_checkpoint(os.path.join(slam.save_dir or "", "checkpoint.npz"))
        if args.eval or config["Results"].get("eval_rendering", False):
            result = slam.evaluate(
                eval_rendering_flag=config["Results"].get("eval_rendering", True))
        else:
            result = {
                "fps": slam.fps,
                "n_keyframes": len(slam.frontend.kf_indices),
                "n_gaussians": slam.n_alive(),
                "ate_cm": 100.0 * slam.keyframe_ate(),
            }
        result["device"] = str(slam.device)
        print(json.dumps(result, indent=2), flush=True)
    finally:
        slam.stop()
        if gui is not None:  # the window closes on the finish packet
            from monogs_dev_tpu_torch.viz.snapshot import GaussianPacket

            slam.viz_channel.publish(GaussianPacket(finish=True))
            gui.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())

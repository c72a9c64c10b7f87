#!/usr/bin/env python
"""CLI entry point of the PyTorch/CUDA port: the interface of `slam.py`.

    python slam_torch.py --config configs/synthetic/bench_vga.yaml --max-frames 12
    python slam_torch.py --config configs/synthetic/bench_vga_parity.yaml --eval

Runs on `--device` (default `cuda`, where the blend runs in the CUDA kernels
of monogs_dev_tpu_torch/csrc) and stops when that device is missing.
`--device cpu` runs the plain torch blend instead, for debugging at small
sizes. `--eval` applies the reference's overrides (save_results, no GUI,
rendering eval on), runs the eval tail after the sequence and prints its
results JSON; artifacts land in results/<dataset>_<datetime>/.
"""

from __future__ import annotations

import argparse
import json
import sys

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
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--save-checkpoint", action="store_true")
    args = parser.parse_args()
    if args.resume or args.save_checkpoint:
        raise NotImplementedError("checkpoints (utils/checkpoint.py) are not ported yet")

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
    try:
        slam.run(max_frames=args.max_frames)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

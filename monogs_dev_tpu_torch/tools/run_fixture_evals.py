#!/usr/bin/env python
"""Quality rows for the EuRoC stereo and Realsense-replay configs on the
port's own fixtures (port of the JAX package's `tools/run_fixture_evals.py`).

  stereo: a EuRoC-layout rendered stereo sequence (`make_fixtures.write_euroc`,
          100 frames at 320x240) -> `EuRoCParser` -> rectification -> the
          matcher's metric depth -> full SLAM with the eval tail (ATE and
          PSNR/SSIM row, 500 refinement iterations)
  replay: a Realsense-replay sequence (`make_fixtures.write_replay`, 120
          colour frames at 640x480, identity ground truth as live capture)
          -> monocular SLAM on `configs/live/realsense_replay.yaml` ->
          rendering metrics row (no ATE: the loader's poses are identity)

Each applies the JAX tool's config overrides value for value, runs
`SLAM(config, device, save_dir=...)`, `run()`, `evaluate(eval_rendering_flag=
True)` and `stop()`, and prints the card's name and power limit and the wall
seconds, then `STEREO ROW {json}` or `REPLAY ROW {json}` with the JAX tool's
keys. Sequences are written once under `<out>/` and reused (a `.done` marker
holds their Dataset group); the eval artifacts land in
`<out>/euroc_fixture_eval/` and `<out>/replay_fixture_eval/`.

    python -m monogs_dev_tpu_torch.tools.run_fixture_evals stereo|replay|both \\
        [--frames N] [--size WxH] [--device cuda|cpu] [--out DIR]

`--device` defaults to `cuda` and stops without a card; `--device cpu` runs
the plain blend. `--frames` and `--size` replace each row's own depth and
size (100 at 320x240, 120 at 640x480).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from ..core.system import SLAM
from ..utils.config import load_config
from . import make_fixtures as mf

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EUROC_CONFIG = os.path.join(REPO, "configs", "stereo", "euroc", "base_config.yaml")
REPLAY_CONFIG = os.path.join(REPO, "configs", "live", "realsense_replay.yaml")
DEFAULT_OUT = os.path.join(REPO, "results", "fixture_evals")
REFINEMENT_ITERS = 500
# tools/run_fixture_evals.py:67-68 and :117-122
STEREO_TPU = {"capacity": 32768, "max_per_tile": 512, "k_dup": 8}
# in-program rebinning: the live config's 10x position_lr_init (0.0016) moves
# the map far within one reused binning during the initial BA
REPLAY_TPU = {"capacity": 65536, "max_per_tile": 512, "k_dup": 8, "mapping_rebin_every": 4,
              "map_chunk": 25, "mapping_rebin_dilation": 6.0}


def _base_config(path: str):
    return load_config(path)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "device: cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return f"device: {out or torch.cuda.get_device_name(device)}"


def _fixture(out_dir: str, name: str, write) -> dict:
    """The Dataset group of the sequence in <out_dir>/<name>, written by
    `write(path)` unless a `.done` marker says it is there."""
    path = os.path.join(out_dir, name)
    marker = os.path.join(path, ".done")
    if os.path.exists(marker):
        with open(marker) as f:
            return json.load(f)
    ds_cfg = write(path)
    with open(marker, "w") as f:
        json.dump(ds_cfg, f)
    return ds_cfg


def _run(config, device, save_dir: str, label: str):
    os.makedirs(save_dir, exist_ok=True)
    t0 = time.time()
    slam = SLAM(config, device, save_dir=save_dir)
    try:
        slam.run()
        results = slam.evaluate(eval_rendering_flag=True)
    finally:
        slam.stop()
    print(card_line(torch.device(device)), flush=True)
    print(f"{label} wall seconds: {time.time() - t0:.1f}", flush=True)
    return results


def run_stereo(n_frames: int = 100, w: int = 320, h: int = 240, device="cuda",
               out_dir: str = DEFAULT_OUT) -> dict:
    device = torch.device(device)

    def write(path):
        params, active = mf.load_params(mf.DEFAULT_SCENE, device)
        ds = mf.write_euroc(path, params, active, n_frames=n_frames, w=w, h=h)
        return {"dataset_path": ds["dataset_path"], "Calibration": ds["Calibration"]}

    ds_cfg = _fixture(out_dir, f"euroc_{w}x{h}_n{n_frames}", write)
    config = _base_config(EUROC_CONFIG)
    config["Dataset"].update(ds_cfg)
    config["Results"]["save_results"] = True
    config["Results"]["eval_rendering"] = True
    config["Training"]["refinement_itr_num"] = REFINEMENT_ITERS
    config.setdefault("TPU", {})
    config["TPU"].update(STEREO_TPU)
    results = _run(config, device, os.path.join(out_dir, "euroc_fixture_eval"), "stereo")
    row = {
        "ate_cm": results["ate"] * 100 if results["ate"] is not None else None,
        "psnr_before": results["before_opt"]["mean_psnr"],
        "psnr_after": results["after_opt"]["mean_psnr"],
        "ssim": results["after_opt"]["mean_ssim"],
        "n_keyframes": results["n_keyframes"],
        "n_gaussians": results["n_gaussians"],
        "fps": results["fps"],
    }
    print("STEREO ROW " + json.dumps(row), flush=True)
    return row


def run_replay(n_frames: int = 120, w: int = 640, h: int = 480, device="cuda",
               out_dir: str = DEFAULT_OUT) -> dict:
    device = torch.device(device)

    def write(path):
        params, active = mf.load_params(mf.REPLAY_SCENE, device)
        return mf.write_replay(path, params, active, n_frames=n_frames, w=w, h=h)

    ds_cfg = _fixture(out_dir, f"replay_{w}x{h}_n{n_frames}", write)
    config = _base_config(REPLAY_CONFIG)
    config["Dataset"]["dataset_path"] = ds_cfg["dataset_path"]
    # the writer's rig: fx = 0.9 * w (576 at 640x480, as the JAX tool sets)
    config["Dataset"]["Calibration"].update(ds_cfg["Calibration"])
    config["Results"]["save_results"] = True
    config["Results"]["eval_rendering"] = True
    config["Training"]["refinement_itr_num"] = REFINEMENT_ITERS
    config.setdefault("TPU", {})
    config["TPU"].update(REPLAY_TPU)
    # identity ground truth: rendering metrics only
    results = _run(config, device, os.path.join(out_dir, "replay_fixture_eval"), "replay")
    row = {
        "psnr_before": results["before_opt"]["mean_psnr"],
        "psnr_after": results["after_opt"]["mean_psnr"],
        "ssim": results["after_opt"]["mean_ssim"],
        "n_keyframes": results["n_keyframes"],
        "n_gaussians": results["n_gaussians"],
        "fps": results["fps"],
    }
    print("REPLAY ROW " + json.dumps(row), flush=True)
    return row


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="both", choices=("stereo", "replay", "both"))
    ap.add_argument("--frames", type=int, default=None, help="frames a row (100 / 120)")
    ap.add_argument("--size", default=None, help="WxH (320x240 / 640x480)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="sequences and eval artifacts")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the rows run on a card "
                         "(--device cpu runs the plain blend)")
    kw = {"device": device, "out_dir": args.out}
    if args.frames is not None:
        kw["n_frames"] = args.frames
    if args.size is not None:
        kw["w"], kw["h"] = (int(v) for v in args.size.split("x"))
    if args.which in ("stereo", "both"):
        run_stereo(**kw)
    if args.which in ("replay", "both"):
        run_replay(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())

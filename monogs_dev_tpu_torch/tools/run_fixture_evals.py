#!/usr/bin/env python
"""Quality rows for the EuRoC stereo and Realsense-replay configs on the
port's own fixtures (port of the JAX package's `tools/run_fixture_evals.py`),
and the scale-pressure row.

  stereo: a EuRoC-layout rendered stereo sequence (`make_fixtures.write_euroc`,
          100 frames at 320x240) -> `EuRoCParser` -> rectification -> the
          matcher's metric depth -> full SLAM with the eval tail (ATE and
          PSNR/SSIM row, 500 refinement iterations)
  replay: a Realsense-replay sequence (`make_fixtures.write_replay`, 120
          colour frames at 640x480, identity ground truth as live capture)
          -> monocular SLAM on `configs/live/realsense_replay.yaml` ->
          rendering metrics row (no ATE: the loader's poses are identity)
  scale:  `configs/synthetic/scale_vga.yaml` as committed (240 frames at
          640x480 of the committed 24,000-Gaussian surface scene, capacity
          131,072, small tier 65,536): ATE, the alive counts, the map's
          tier and drop telemetry, PSNR/SSIM before and after refinement,
          the tracked frames/s over frames 2.., the config's gates, and
          K1/K2/K3 timed on the final map through the counted wrappers
          (`ops/blend_timing.py`) with their bound (the JAX package's row:
          BASELINE.md)

Each applies the JAX tool's config overrides value for value, runs
`SLAM(config, device, save_dir=...)`, `run()`, `evaluate(eval_rendering_flag=
True)` and `stop()`, and prints the card's name and power limit and the wall
seconds, then `STEREO ROW {json}` or `REPLAY ROW {json}` with the JAX tool's
keys (the scale row: `SCALE ROW {json}`, and exit code 1 when one of its
gates fails). Sequences are written once under `<out>/` and reused (a
`.done` marker holds their Dataset group); the eval artifacts land in
`<out>/euroc_fixture_eval/`, `<out>/replay_fixture_eval/` and
`<out>/scale_eval/`.

    python -m monogs_dev_tpu_torch.tools.run_fixture_evals stereo|replay|both|scale \\
        [--frames N] [--size WxH] [--device cuda|cpu] [--out DIR]

`--device` defaults to `cuda` and stops without a card; `--device cpu` runs
the plain blend (and times no kernel). `--frames` and `--size` replace each
row's own depth and size (100 at 320x240, 120 at 640x480, 240 at 640x480;
the scale row's calibration scales with the size).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from ..core import backend
from ..core.system import SLAM
from ..models import gaussians
from ..ops.blend_timing import blend_kernel_times
from ..ops.rasterize import grid_dims, tile_wh
from ..utils.config import load_config
from . import make_fixtures as mf
from .kernel_lab import tile_props

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EUROC_CONFIG = os.path.join(REPO, "configs", "stereo", "euroc", "base_config.yaml")
REPLAY_CONFIG = os.path.join(REPO, "configs", "live", "realsense_replay.yaml")
SCALE_CONFIG = os.path.join(REPO, "configs", "synthetic", "scale_vga.yaml")
# the config's gates (configs/synthetic/scale_vga.yaml:1-9): drops under this
# share of requests, ATE under the RGB-D bar
SCALE_DROP_SHARE, SCALE_ATE_CM = 0.10, 3.0
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


@contextlib.contextmanager
def insert_requests():
    """Counts, while open, the points a keyframe insert asks rows for
    (`insert_points_evict`), the children densification asks rows for (every
    other `insert_points` call), and the alive count after each keyframe's
    insert."""
    counts = {"insert_requested": 0, "densify_requested": 0, "alive_at_keyframes": []}
    insert, evict = gaussians.insert_points, backend.insert_points_evict

    def counting_insert(gmap, new_params, valid, kf_id):
        counts["densify_requested"] += int(valid.sum())
        return insert(gmap, new_params, valid, kf_id)

    def counting_evict(gmap, new_params, valid, kf_id):
        n = int(valid.sum())
        counts["insert_requested"] += n
        counts["densify_requested"] -= n  # its own insert_points call
        out = evict(gmap, new_params, valid, kf_id)
        counts["alive_at_keyframes"].append(int(out[0].aux.active.sum()))
        return out

    gaussians.insert_points, backend.insert_points_evict = counting_insert, counting_evict
    try:
        yield counts
    finally:
        gaussians.insert_points, backend.insert_points_evict = insert, evict


def final_map_kernels(slam) -> dict:
    """K1/K3/K2 timed on the map at the last keyframe's pose, binned as
    the mapping loop bins it, with their bound and the prop set's size."""
    e, rcfg = slam.engine, slam.raster_cfg
    kf = slam.frontend.kf_indices[-1]
    T = torch.as_tensor(e.viewpoints[kf].T_w2c, dtype=torch.float32, device=slam.device)
    t_props, counts = tile_props(e.gmap.params, e.gmap.aux.active, T, slam.intr, rcfg,
                                 dilate=slam.step_cfg.mapping_rebin_dilation)
    out = blend_kernel_times(t_props, counts, grid_dims(slam.intr, *tile_wh(rcfg))[0], rcfg)
    out["props"] = {"keyframe": kf, "entries": int(counts.sum()),
                    "max_per_tile": rcfg.max_per_tile, "tiles": int(counts.shape[0])}
    return out


def run_scale(n_frames: int = 240, w: int = 640, h: int = 480, device="cuda",
              out_dir: str = DEFAULT_OUT) -> dict:
    device = torch.device(device)
    config = _base_config(SCALE_CONFIG)
    ds = config["Dataset"]
    ds["n_frames"] = n_frames
    cal = ds["Calibration"]
    sx, sy = w / float(cal["width"]), h / float(cal["height"])
    cal.update(fx=cal["fx"] * sx, cx=cal["cx"] * sx, fy=cal["fy"] * sy, cy=cal["cy"] * sy,
               width=w, height=h)
    config["Results"]["save_results"] = True
    config["Results"]["eval_rendering"] = True
    save_dir = os.path.join(out_dir, "scale_eval")
    os.makedirs(save_dir, exist_ok=True)
    t0 = time.time()
    slam = SLAM(config, device, save_dir=save_dir)
    try:
        with insert_requests() as counts:
            slam.run(max_frames=2)  # frame 0, its initialization, frame 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.time()
            slam.run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tracked_fps = (n_frames - 2) / (time.time() - t1)
        results = slam.evaluate(eval_rendering_flag=True)
        kernels = final_map_kernels(slam) if device.type == "cuda" else None
    finally:
        slam.stop()
    print(card_line(device), flush=True)
    wall_s = time.time() - t0
    print(f"scale wall seconds: {wall_s:.1f}", flush=True)
    tel = results["telemetry"]
    ate_cm = results["ate"] * 100 if results["ate"] is not None else None
    insert_share = ((tel["insert_dropped"] + tel["insert_evicted"])
                    / max(counts["insert_requested"], 1))
    densify_share = tel["densify_dropped"] / max(counts["densify_requested"], 1)
    row = {
        "ate_cm": ate_cm,
        "alive_end": results["n_gaussians"],
        "alive_max_at_keyframe": max(counts["alive_at_keyframes"], default=0),
        "map_grows": tel["map_grows"],
        "map_compactions": tel["map_compactions"],
        "insert_dropped": tel["insert_dropped"],
        "insert_evicted": tel["insert_evicted"],
        "densify_dropped": tel["densify_dropped"],
        "insert_requested": counts["insert_requested"],
        "densify_requested": counts["densify_requested"],
        "insert_dropped_share": insert_share,
        "densify_dropped_share": densify_share,
        "n_keyframes": results["n_keyframes"],
        "psnr_before": results["before_opt"]["mean_psnr"],
        "ssim_before": results["before_opt"]["mean_ssim"],
        "psnr_after": results["after_opt"]["mean_psnr"],
        "ssim_after": results["after_opt"]["mean_ssim"],
        "tracked_fps": tracked_fps,
        "wall_s": wall_s,
        "gates": {"map_grows": tel["map_grows"] >= 1,
                  "drops": max(insert_share, densify_share) < SCALE_DROP_SHARE,
                  "ate": ate_cm is not None and ate_cm < SCALE_ATE_CM},
        "kernels": kernels,
    }
    print("SCALE ROW " + json.dumps(row), flush=True)
    return row


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="both",
                    choices=("stereo", "replay", "both", "scale"))
    ap.add_argument("--frames", type=int, default=None, help="frames a row (100 / 120 / 240)")
    ap.add_argument("--size", default=None, help="WxH (320x240 / 640x480 / 640x480)")
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
    if args.which == "scale":
        return 0 if all(run_scale(**kw)["gates"].values()) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

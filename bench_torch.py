#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: end-to-end synthetic monocular SLAM
frames/s on one GPU (the counterpart of bench.py).

`configs/synthetic/bench_vga.yaml` forced monocular, as bench.py runs it:
the frames are rendered first (dataset synthesis is not timed); the
pipeline warms up for at least 16 frames and then on in steps of 5 until
the frontend and the backend are initialized (at most to frame 162 of 192,
where 25 measured frames still fit); then 25 frames are timed between
`torch.cuda.synchronize()` calls. Prints one JSON line:

    {"metric": "synthetic_vga_mono_slam_fps", "value": ..., "unit": "frames/s",
     "device": "<nvidia-smi name, power.limit>"}

    python bench_torch.py [--config <yaml>] [--device cpu]

The default device is `cuda`; without a card the script stops unless
`--device cpu` is given (then "device" is "cpu" and the rate is a CPU
figure, not a device metric).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "synthetic", "bench_vga.yaml")
N_WARM_MIN, N_MEAS = 16, 25


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(config, device, n_warm_min: int = N_WARM_MIN, n_meas: int = N_MEAS,
              seed: int = 0, at_init=None):
    """Warm up to initialization, then time `n_meas` frames. `at_init(slam)`,
    if given, runs between the two, outside both times. Returns (slam,
    info): info has "fps", "warm_frames" (where the window starts),
    "initialized" (False if the frames ran out first), "init_s" and
    "window_s"."""
    import torch

    from monogs_dev_tpu_torch.core.system import SLAM

    config["Dataset"]["sensor_type"] = "monocular"
    device = torch.device(device)
    slam = SLAM(config, device, seed=seed)
    n_total = len(slam.dataset)
    for i in range(n_total):
        slam.dataset.render_frame(i)
    _sync(device)

    fe, engine = slam.frontend, slam.engine
    t0 = time.time()
    frame = n_warm_min
    fe.run(max_frames=frame)
    while not (fe.initialized and engine.initialized):
        if frame + 5 + n_meas > n_total:
            break
        frame += 5
        fe.run(max_frames=frame)
    _sync(device)
    init_s = time.time() - t0
    if at_init is not None:
        at_init(slam)
        _sync(device)
    t1 = time.time()
    fe.run(max_frames=frame + n_meas)
    _sync(device)
    t2 = time.time()
    return slam, {
        "fps": n_meas / (t2 - t1),
        "warm_frames": frame,
        "initialized": bool(fe.initialized and engine.initialized),
        "init_s": init_s,
        "window_s": t2 - t1,
    }


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="port bench: synthetic VGA monocular SLAM frames/s")
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, REPO)
    from monogs_dev_tpu_torch.utils.config import load_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: bench_torch.py measures the card "
                         "(--device cpu runs it on the CPU)")
    config = load_config(args.config)
    config["Results"]["save_results"] = False
    slam, info = run_bench(config, device)
    slam.stop()
    print(f"bench: window [{info['warm_frames']}, {info['warm_frames'] + N_MEAS}) "
          f"{info['fps']:.3f} frames/s; initialized {info['initialized']}; "
          f"warm-up {info['init_s']:.1f} s; timers {json.dumps(slam.timers.summary())}",
          file=sys.stderr, flush=True)
    if not info["initialized"]:
        raise SystemExit("the system did not initialize before the measured window")
    print(json.dumps({
        "metric": "synthetic_vga_mono_slam_fps",
        "value": info["fps"],
        "unit": "frames/s",
        "device": smi_line() if device.type == "cuda" else "cpu",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

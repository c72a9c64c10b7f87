#!/usr/bin/env python
"""Write sequences in the TUM RGB-D, Replica, EuRoC-MAV stereo and
Realsense-replay layouts from a synthetic scene (port of the JAX package's
`tools/make_tum_fixture.py`, `tools/make_euroc_fixture.py` and
`tools/make_replay_fixture.py`; the Replica writer has no JAX counterpart).

Frames are rendered with the port's `render_tiled` (colour) and
`render_median_depth` (depth, 0 where alpha < 0.5) from a scene npz
(`data/scenes/`, written by `tools/export_synthetic_scene.py`: by default
`surface_seed0_n6000`, and for the replay layout the JAX replay writer's
scene, `surface_seed2_n12000` at Gaussian scale 0.03) on the given
device (default `cuda`; `--device cpu` renders with the plain blend), and
written as PNG (and Replica's colour as baseline JPEG) with
`data/image_io.py`; no PIL, cv2 or JAX.

  TUM:    rgb/<ts>.png, depth/<ts>.png (16-bit, depth_scale units a metre),
          rgb.txt, depth.txt, groundtruth.txt (ts tx ty tz qx qy qz qw, C2W)
  Replica: results/frame%06d.jpg (4:2:0), results/depth%06d.png (16-bit,
          depth_scale units a metre), traj.txt (a flat 4x4 C2W a line)
  EuRoC:  mav0/cam{0,1}/data/<ns>.png, an already rectified pair (right eye
          shifted +baseline along x, baseline = BASELINE_FX / fx, so the
          loader's disparity-to-depth constant is exact), and
          mav0/state_groundtruth_estimate0/data.csv (body poses, wxyz)
  replay: color/<idx>.png, and gt_poses.npy for diagnostics only

    python -m monogs_dev_tpu_torch.tools.make_fixtures tum|replica|euroc|replay <out_dir> \\
        [--frames 40] [--size 160x120] [--scene <npz>] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import _EUROC_T_I_C0, StereoDataset
from ..data.image_io import write_jpeg, write_png
from ..data.synthetic import SCENE_DIR, load_scene, orbit_pose, scene_file_name
from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_median_depth, render_tiled

DEFAULT_SCENE = os.path.join(SCENE_DIR, scene_file_name("surface", 0, 6000))
# tools/make_replay_fixture.py:41-43: make_surface_scene(PRNGKey(2), n=12000, scale=0.03)
REPLAY_SCENE = os.path.join(SCENE_DIR, scene_file_name("surface", 2, 12000))
WRITER_RASTER = RasterConfig(max_per_tile=512, k_dup=16)
REPLAY_RASTER = RasterConfig(max_per_tile=512, k_dup=8)  # the JAX replay writer's


def quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), Shepperd's branch-stable method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def orbit(n_frames: int, n: Optional[int] = None, sweep: float = 0.45, ease: bool = False,
          profile: Optional[str] = None) -> List[np.ndarray]:
    """W2C poses 0..n_frames-1 of `orbit_pose(i, n, ...)` (n defaults to
    n_frames)."""
    return [orbit_pose(i, n or n_frames, sweep=sweep, ease=ease, profile=profile)
            for i in range(n_frames)]


def load_params(scene: str, device):
    params = load_scene(scene, {}, device)
    return params, torch.ones(params.xyz.shape[0], dtype=torch.bool, device=params.xyz.device)


@torch.no_grad()
def render_rgbd(params, active, T_w2c: np.ndarray, intr: Intrinsics,
                rcfg: RasterConfig = WRITER_RASTER, depth: bool = True):
    """(colour (H, W, 3) float32 in [0, 1], median depth (H, W) float32 with
    0 where alpha < 0.5, or None), as numpy."""
    T = torch.as_tensor(np.asarray(T_w2c, np.float32), device=params.xyz.device)
    out = render_tiled(params, active, T, intr, 0, config=rcfg, need_touched=False)
    color = np.clip(out.color.cpu().numpy(), 0.0, 1.0)
    if not depth:
        return color, None
    d = render_median_depth(params, active, T, intr, rcfg).cpu().numpy().copy()
    d[out.alpha.cpu().numpy() < 0.5] = 0.0
    return color, d


def write_tum(out_dir: str, params, active, intr: Intrinsics, poses: List[np.ndarray],
              depth_scale: float = 5000.0) -> None:
    """A TUM RGB-D sequence of len(poses) frames at 30 Hz."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], ["# ts tx ty tz qx qy qz qw"]
    for i, T_w2c in enumerate(poses):
        color, depth = render_rgbd(params, active, T_w2c, intr)
        ts = f"{i / 30.0:.6f}"
        write_png(os.path.join(out_dir, "rgb", f"{ts}.png"), (color * 255).astype(np.uint8))
        d16 = np.clip(depth * depth_scale, 0, 65535).astype(np.uint16)
        write_png(os.path.join(out_dir, "depth", f"{ts}.png"), d16)
        rgb_lines.append(f"{ts} rgb/{ts}.png")
        depth_lines.append(f"{ts} depth/{ts}.png")
        T_c2w = np.linalg.inv(T_w2c)
        q = quat_wxyz(T_c2w[:3, :3])
        tx, ty, tz = T_c2w[:3, 3]
        gt_lines.append(f"{ts} {tx:.6f} {ty:.6f} {tz:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} "
                        f"{q[0]:.6f}")
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_replica(out_dir: str, params, active, intr: Intrinsics, poses: List[np.ndarray],
                  depth_scale: float = 6553.5) -> None:
    """A Replica sequence (the layout of `configs/rgbd/replica/*.yaml`'s
    datasets) of len(poses) frames."""
    res = os.path.join(out_dir, "results")
    os.makedirs(res, exist_ok=True)
    rows = []
    for i, T_w2c in enumerate(poses):
        color, depth = render_rgbd(params, active, T_w2c, intr)
        write_jpeg(os.path.join(res, f"frame{i:06d}.jpg"),
                   np.clip(color * 255.0, 0, 255).astype(np.uint8))
        d16 = np.clip(depth * depth_scale, 0, 65535).astype(np.uint16)
        write_png(os.path.join(res, f"depth{i:06d}.png"), d16)
        rows.append(" ".join(f"{v:.17g}" for v in np.linalg.inv(T_w2c).reshape(-1)))
    with open(os.path.join(out_dir, "traj.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_euroc(out_dir: str, params, active, n_frames: int = 12, w: int = 160,
                h: int = 120) -> Dict:
    """A rectified EuRoC stereo sequence along orbit_pose(i, max(n_frames,
    40), sweep=0.45); returns the Dataset group (path, Calibration)."""
    fx = 0.9 * w
    baseline = StereoDataset.BASELINE_FX / fx
    intr = Intrinsics(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, width=w, height=h)
    cam0 = os.path.join(out_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(out_dir, "mav0", "cam1", "data")
    gt_dir = os.path.join(out_dir, "mav0", "state_groundtruth_estimate0")
    for d in (cam0, cam1, gt_dir):
        os.makedirs(d, exist_ok=True)
    T_shift = np.eye(4, dtype=np.float32)
    T_shift[0, 3] = -baseline
    rows = ["#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z"]
    inv_tic = np.linalg.inv(_EUROC_T_I_C0)
    for i in range(n_frames):
        T_l = orbit_pose(i, max(n_frames, 40), sweep=0.45).astype(np.float32)
        T_r = T_shift @ T_l
        ts = str(10_000_000_000 + i * 50_000_000)
        for T, d in ((T_l, cam0), (T_r, cam1)):
            color, _ = render_rgbd(params, active, T, intr, depth=False)
            write_png(os.path.join(d, f"{ts}.png"), (color * 255).astype(np.uint8))
        T_wi = np.linalg.inv(T_l) @ inv_tic
        q = quat_wxyz(T_wi[:3, :3])
        p = T_wi[:3, 3]
        rows.append(f"{ts},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
                    f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f}")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    eye = {"fx": fx, "fy": fx, "cx": w / 2.0, "cy": h / 2.0,
           "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0}
    rot = {"data": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]}
    calib = {"width": w, "height": h, "depth_scale": 1.0,
             "cam0": {"raw": dict(eye), "opt": dict(eye), "R": dict(rot)},
             "cam1": {"raw": dict(eye), "opt": dict(eye), "R": dict(rot)}}
    return {"dataset_path": out_dir, "Calibration": calib, "baseline": baseline}


def write_replay(out_dir: str, params, active, n_frames: int = 120, w: int = 640,
                 h: int = 480, orbit_n: Optional[int] = None) -> Dict:
    """Colour frames 0..n_frames-1 along orbit_pose(i, orbit_n, sweep=0.4,
    profile="ease_in") (orbit_n defaults to n_frames; a larger one writes
    the first frames of that longer sequence), no ground truth for the
    loader (identity, as live capture); returns the Dataset group."""
    fx = 0.9 * w
    intr = Intrinsics(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, width=w, height=h)
    color_dir = os.path.join(out_dir, "color")
    os.makedirs(color_dir, exist_ok=True)
    poses = orbit(n_frames, n=orbit_n, sweep=0.4, profile="ease_in")
    for i, T in enumerate(poses):
        color, _ = render_rgbd(params, active, T, intr, REPLAY_RASTER, depth=False)
        write_png(os.path.join(color_dir, f"{i:06d}.png"),
                  np.clip(color * 255.0, 0, 255).astype(np.uint8))
    np.save(os.path.join(out_dir, "gt_poses.npy"), np.stack(poses))
    return {"type": "realsense_replay", "sensor_type": "monocular", "dataset_path": out_dir,
            "Calibration": {"fx": fx, "fy": fx, "cx": w / 2.0, "cy": h / 2.0, "k1": 0.0,
                            "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": w,
                            "height": h, "distorted": False}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("layout", choices=("tum", "replica", "euroc", "replay"))
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", default="160x120", help="WxH")
    ap.add_argument("--scene", default=None,
                    help="scene npz (default: surface_seed2_n12000 for replay, else "
                         "surface_seed0_n6000)")
    ap.add_argument("--sweep", type=float, default=0.45, help="TUM and Replica orbit sweep")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the writer renders on a card "
                         "(--device cpu renders with the plain blend)")
    w, h = (int(v) for v in args.size.split("x"))
    scene = args.scene or (REPLAY_SCENE if args.layout == "replay" else DEFAULT_SCENE)
    params, active = load_params(scene, device)
    if args.layout in ("tum", "replica"):
        fx = 0.9 * w
        intr = Intrinsics(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, width=w, height=h)
        write = write_tum if args.layout == "tum" else write_replica
        write(args.out_dir, params, active, intr, orbit(args.frames, sweep=args.sweep))
    elif args.layout == "euroc":
        write_euroc(args.out_dir, params, active, args.frames, w, h)
    else:
        write_replay(args.out_dir, params, active, args.frames, w, h)
    print(f"wrote {args.frames} {args.layout} frames to {args.out_dir} ({w}x{h})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

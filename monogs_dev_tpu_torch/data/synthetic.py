"""Synthetic Gaussian-scene dataset (port of `monogs_dev_tpu/data/synthetic.py`).

The JAX package draws its scene from `jax.random`, which torch cannot
reproduce, so the scene comes from an npz file written on the JAX side by
`tools/export_synthetic_scene.py` (committed under `data/scenes/`, or named
by `Dataset.scene_file`). Frames are rendered from it with this package's
own rasterizer at the `orbit_pose` trajectory, so ground-truth poses,
appearance and depth are exact.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.camera import Intrinsics
from ..models.convert import params_from_numpy
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_tiled
from .datasets import load_dataset  # noqa: F401  (the factory's old home)

SCENE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")


def scene_file_name(kind: str, seed: int, n: int) -> str:
    return f"{kind}_seed{seed}_n{n}.npz"


def orbit_pose(i: int, n_frames: int, radius: float = 0.5, sweep: float = 1.2,
               ease: bool = False, profile=None) -> np.ndarray:
    """Lateral arc with yaw and a slight push-in, looking down +z (W2C).
    Profiles: const, ease (smoothstep), ease_in (quadratic ramp over the
    first quarter, then constant cruise)."""
    t = i / max(n_frames - 1, 1)
    if profile is None:
        profile = "ease" if ease else "const"
    if profile == "ease":
        t = t * t * (3.0 - 2.0 * t)
    elif profile == "ease_in":
        r = 0.25
        t = t * t / (r * (2.0 - r)) if t < r else (2.0 * t - r) / (2.0 - r)
    elif profile != "const":
        raise ValueError(f"unknown orbit profile {profile!r}")
    angle = (t - 0.5) * sweep
    center = np.array([np.sin(angle) * radius * 4.0, 0.15 * np.sin(2 * angle), 0.4 * t])
    c, s = np.cos(angle), np.sin(angle)
    T_c2w = np.eye(4)
    T_c2w[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    T_c2w[:3, 3] = center
    return np.linalg.inv(T_c2w)


def load_scene(path: str, want: dict, device):
    """Scene params from an npz written by `tools/export_synthetic_scene.py`,
    checked against the generator settings in `want` (e.g. gaussian_scale)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"synthetic scene {path} not found: write it with "
            "`python tools/export_synthetic_scene.py --config <yaml>`"
        )
    with np.load(path) as z:
        arrays = dict(z)
    for k, v in want.items():
        if k in arrays and not np.isclose(float(arrays[k]), v):
            raise ValueError(f"scene file {path} has {k}={float(arrays[k])}, wanted {v}")
    return params_from_numpy(arrays, device)


def load_lab_scene(device):
    """The kernel lab's scene (tools/kernel_lab.py:621): 32,768 blobs of
    scale 0.03 drawn by the JAX package from seed 0, seen from eye(4)."""
    return load_scene(os.path.join(SCENE_DIR, scene_file_name("blobs", 0, 32768)),
                      {"gaussian_scale": 0.03}, device)


class SyntheticDataset:
    """Dataset group keys: scene, n_frames, n_gaussians, seed, sweep, ease,
    profile, the Calibration block, and optionally scene_file."""

    def __init__(self, config, device):
        ds = config["Dataset"]
        cal = ds["Calibration"]
        self.fx, self.fy = float(cal["fx"]), float(cal["fy"])
        self.cx, self.cy = float(cal["cx"]), float(cal["cy"])
        self.width, self.height = int(cal["width"]), int(cal["height"])
        self.has_depth = "depth_scale" in cal
        self.device = torch.device(device)
        self.num_imgs = int(ds.get("n_frames", 60))
        self.sensor_type = ds.get("sensor_type", "depth")
        self.intr = Intrinsics(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
                               width=self.width, height=self.height)
        kind = ds.get("scene", "blobs")
        default_scale = 0.035 if kind == "surface" else 0.06
        want = {"gaussian_scale": float(ds.get("gaussian_scale", default_scale))}
        if kind == "surface":
            want["extent_x"] = float(ds.get("extent_x", 5.0))
            want["extent_y"] = float(ds.get("extent_y", 3.0))
        self.scene_params = load_scene(
            ds.get("scene_file") or os.path.join(
                SCENE_DIR, scene_file_name(kind, int(ds.get("seed", 0)),
                                           int(ds.get("n_gaussians", 2000)))),
            want, self.device)
        self.scene_active = torch.ones(self.scene_params.xyz.shape[0], dtype=torch.bool,
                                       device=self.device)
        sweep = float(ds.get("sweep", 1.2))
        self.poses = [orbit_pose(i, self.num_imgs, sweep=sweep, ease=bool(ds.get("ease", False)),
                                 profile=ds.get("profile")) for i in range(self.num_imgs)]
        self._raster_cfg = RasterConfig(max_per_tile=512, k_dup=16)
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.num_imgs

    @torch.no_grad()
    def render_frame(self, idx: int):
        if idx not in self._cache:
            out = render_tiled(
                self.scene_params, self.scene_active,
                torch.as_tensor(self.poses[idx], dtype=torch.float32, device=self.device),
                self.intr, 0, config=self._raster_cfg, need_touched=False,
            )
            color = torch.clamp(out.color, 0.0, 1.0)
            # normalized expected depth; 0 where nothing was hit
            depth = out.depth / torch.clamp(out.alpha, min=1e-6)
            depth = torch.where(out.alpha < 0.5, torch.zeros_like(depth), depth)
            self._cache[idx] = (color, depth)
        return self._cache[idx]

    def __getitem__(self, idx: int):
        """(color (H, W, 3), depth (H, W) or None, W2C GT pose) on the device."""
        color, depth = self.render_frame(idx)
        if self.sensor_type == "monocular" or not self.has_depth:
            return color, None, self.poses[idx]
        return color, depth, self.poses[idx]

"""Synthetic Gaussian-scene dataset (port of `monogs_dev_tpu/data/synthetic.py`).

The scene is the JAX package's own where an npz of it exists (committed
under `data/scenes/`, or named by `Dataset.scene_file`; written by
`tools/export_synthetic_scene.py`). Otherwise this module draws it:
`make_synthetic_scene` and `make_surface_scene` are the JAX generators'
arithmetic on draws from a `torch.Generator`, since torch cannot reproduce
`jax.random`'s streams; given JAX's draws (`draws=`) they return JAX's
scene. Frames are rendered from the scene with this package's own
rasterizer at the `orbit_pose` trajectory, so ground-truth poses,
appearance and depth are exact.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry.sh import rgb_to_sh
from ..models.camera import Intrinsics
from ..models.convert import params_from_numpy
from ..models.gaussians import GaussianParams, inverse_sigmoid
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_tiled
from ..utils.logging import Log
from ..utils.profiling import sync
from .datasets import load_dataset  # noqa: F401  (the factory's old home)

SCENE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")


def scene_file_name(kind: str, seed: int, n: int) -> str:
    return f"{kind}_seed{seed}_n{n}.npz"


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=g) * (hi - lo) + lo


def synthetic_draws(g: torch.Generator, n: int, extent: float = 2.0,
                    z_range: tuple = (2.0, 6.0)) -> dict:
    """The five draws of `make_synthetic_scene` on the CPU, with the ranges
    of the JAX generator's: x, y, z uniform, rgb uniform, quats normal."""
    return {"x": _uniform(g, (n,), -extent, extent),
            "y": _uniform(g, (n,), -extent, extent),
            "z": _uniform(g, (n,), z_range[0], z_range[1]),
            "rgb": _uniform(g, (n, 3), 0.05, 0.95),
            "quats": torch.randn((n, 4), generator=g)}


def surface_draws(g: torch.Generator, n: int, extent_x: float = 5.0,
                  extent_y: float = 3.0) -> dict:
    """The draws of `make_surface_scene` on the CPU: x, y uniform over the
    extents, the relief's normal noise, the colour's uniform jitter in
    [-1, 1] (the JAX generator splits a fifth key and leaves it unused: its
    quaternions are the identity)."""
    return {"x": _uniform(g, (n,), -extent_x, extent_x),
            "y": _uniform(g, (n,), -extent_y, extent_y),
            "noise": torch.randn((n,), generator=g),
            "rgb": _uniform(g, (n, 3), -1.0, 1.0)}


def _draws_of(draws: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in draws.items()}


def _scene(xyz, rgb, log_scales, quats, sh_degree: int, device):
    n = xyz.shape[0]
    r = max((sh_degree + 1) ** 2 - 1, 0)
    params = GaussianParams(
        xyz=xyz, f_dc=rgb_to_sh(rgb)[:, None, :], f_rest=torch.zeros((n, r, 3)),
        log_scales=log_scales, quats=quats,
        opacity_logit=torch.full((n,), float(inverse_sigmoid(torch.tensor(0.95)))))
    return (params.map(lambda v: v.to(device)),
            torch.ones((n,), dtype=torch.bool, device=device))


def make_synthetic_scene(n: int = 2000, extent: float = 2.0, z_range: tuple = (2.0, 6.0),
                         scale: float = 0.06, sh_degree: int = 0, *,
                         generator: torch.Generator = None, draws: dict = None,
                         device="cpu"):
    """A volumetric cloud of n blobs (`monogs_dev_tpu/data/synthetic.py:26`):
    (GaussianParams, active) on `device`. The draws come from `draws` (the
    keys of `synthetic_draws`, e.g. JAX's own) or else from `generator`;
    both the draws and the arithmetic run on the CPU, so a seed gives the
    same scene on every device."""
    if draws is None:
        draws = synthetic_draws(generator, n, extent, z_range)
    d = _draws_of(draws)
    quats = d["quats"]
    return _scene(torch.stack([d["x"], d["y"], d["z"]], dim=-1), d["rgb"],
                  torch.full((n, 3), float(torch.log(torch.tensor(scale)))),
                  quats / torch.linalg.norm(quats, dim=-1, keepdim=True), sh_degree, device)


def make_surface_scene(n: int = 8000, extent_x: float = 5.0, extent_y: float = 3.0,
                       z_base: float = 3.0, scale: float = 0.035, sh_degree: int = 0, *,
                       generator: torch.Generator = None, draws: dict = None,
                       device="cpu"):
    """An opaque 2.5D textured relief of n flattened splats
    (`monogs_dev_tpu/data/synthetic.py:59`): (GaussianParams, active) on
    `device`, from `draws` (the keys of `surface_draws`) or `generator`, on
    the CPU as `make_synthetic_scene`."""
    if draws is None:
        draws = surface_draws(generator, n, extent_x, extent_y)
    d = _draws_of(draws)
    x, y = d["x"], d["y"]
    z = (z_base + 0.6 * torch.sin(2.0 * x) + 0.4 * torch.cos(3.0 * y)
         + 0.15 * torch.sin(5.0 * x) * torch.cos(4.0 * y) + 0.03 * d["noise"])
    base = 0.5 + 0.35 * torch.stack([torch.sin(1.3 * x + 2.1 * y),
                                     torch.sin(2.2 * x - 1.1 * y + 1.0),
                                     torch.cos(1.7 * x + 0.6 * y)], dim=-1)
    rgb = torch.clamp(base + 0.15 * d["rgb"], 0.02, 0.98)
    log_s = float(torch.log(torch.tensor(scale)))
    log_s_flat = float(torch.log(torch.tensor(scale * 0.3)))  # flattened onto the relief
    log_scales = torch.tensor([log_s, log_s, log_s_flat]).expand(n, 3).clone()
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)
    return _scene(torch.stack([x, y, z], dim=-1), rgb, log_scales, quats, sh_degree, device)


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
    """Scene params from an npz of the JAX package's scene, checked against
    the generator settings in `want` (e.g. gaussian_scale)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"synthetic scene file {path} not found; leave Dataset.scene_file "
            "unset to draw the scene with this package's generator"
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


def draw_scene(kind: str, seed: int, n: int, want: dict, device) -> GaussianParams:
    """The scene drawn by this package's generator from
    `torch.Generator().manual_seed(seed)`: not the JAX package's scene of
    that seed, and it says so."""
    g = torch.Generator().manual_seed(seed)
    if kind == "surface":
        params, _ = make_surface_scene(n, want["extent_x"], want["extent_y"],
                                       scale=want["gaussian_scale"], generator=g, device=device)
    else:
        params, _ = make_synthetic_scene(n, scale=want["gaussian_scale"], generator=g,
                                         device=device)
    Log(f"no scene file {scene_file_name(kind, seed, n)}: drew the {kind} scene with this "
        f"package's generator (torch seed {seed}), not the JAX package's scene of that seed")
    return params


class SyntheticDataset:
    """Dataset group keys: scene, n_frames, n_gaussians, seed, sweep, ease,
    profile, the Calibration block, and optionally scene_file. The scene is
    `scene_file` (which must exist), else the committed npz of (scene, seed,
    n_gaussians), else `draw_scene`'s."""

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
        seed, n = int(ds.get("seed", 0)), int(ds.get("n_gaussians", 2000))
        default_scale = 0.035 if kind == "surface" else 0.06
        want = {"gaussian_scale": float(ds.get("gaussian_scale", default_scale))}
        if kind == "surface":
            want["extent_x"] = float(ds.get("extent_x", 5.0))
            want["extent_y"] = float(ds.get("extent_y", 3.0))
        path = ds.get("scene_file") or os.path.join(SCENE_DIR, scene_file_name(kind, seed, n))
        if ds.get("scene_file") or os.path.exists(path):
            self.scene_params = load_scene(path, want, self.device)
        else:
            self.scene_params = draw_scene(kind, seed, n, want, self.device)
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
            with sync("fetch"):
                pose = torch.as_tensor(self.poses[idx], dtype=torch.float32, device=self.device)
            out = render_tiled(self.scene_params, self.scene_active, pose, self.intr, 0,
                               config=self._raster_cfg, need_touched=False)
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

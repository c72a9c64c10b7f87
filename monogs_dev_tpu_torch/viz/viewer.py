"""Map viewer: re-render the live map from any viewpoint (port of
`monogs_dev_tpu/viz/viewer.py`).

  - `render_view`: the map rendered from a pose through the production
    renderer (`ops/rasterize.py::render_tiled`, the K1 blend kernel on the
    card), in colour, depth or opacity;
  - `render_ellipsoids`: every Gaussian as an opaque ellipse in its colour;
  - `OfflineViewer`: drains a `VizChannel` and writes PNG frames, a headless
    stand-in for the interactive window;
  - `export_turntable`: an orbit around the map, as PNG frames (and an
    animated GIF where PIL is installed).

PNGs are written with `data/image_io.py::write_png`, which needs no PIL;
the depth and opacity colour maps are matplotlib's where it is installed,
else grey.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data.image_io import write_png
from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_tiled


def _pose(T_w2c, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T_w2c, np.float32), device=device)


@torch.no_grad()
def render_view(params, active, T_w2c, intr: Intrinsics, sh_degree: int = 0,
                mode: str = "color", raster_cfg: RasterConfig = RasterConfig(),
                scale_modifier: float = 1.0) -> np.ndarray:
    """Render the map from a viewpoint: (H, W, 3) float32 in [0, 1].
    mode: color | depth | opacity."""
    out = render_tiled(params, active, _pose(T_w2c, params.xyz.device), intr, sh_degree,
                       config=raster_cfg, scale_modifier=scale_modifier, need_touched=False)
    if mode == "color":
        return np.clip(out.color.cpu().numpy(), 0.0, 1.0)
    if mode == "depth":
        depth = out.depth.cpu().numpy() / np.maximum(out.alpha.cpu().numpy(), 1e-6)
        return _colormap(depth, "turbo")
    if mode == "opacity":
        return _colormap(out.alpha.cpu().numpy(), "viridis")
    raise ValueError(f"unknown mode {mode}")


@torch.no_grad()
def render_ellipsoids(params, active, T_w2c, intr: Intrinsics,
                      raster_cfg: RasterConfig = RasterConfig(),
                      scale_modifier: float = 1.0) -> np.ndarray:
    """Ellipsoid debug view: opacities forced to ~1, so that structure,
    scale and orientation show whatever the training state."""
    solid = params.replace(opacity_logit=torch.full_like(params.opacity_logit, 12.0))
    out = render_tiled(solid, active, _pose(T_w2c, params.xyz.device), intr, 0,
                       config=raster_cfg, scale_modifier=scale_modifier, need_touched=False)
    return np.clip(out.color.cpu().numpy(), 0.0, 1.0)


def orbit_poses(center: np.ndarray, radius: float, n_frames: int,
                elevation: float = 0.35) -> list:
    """W2C poses orbiting `center` on a tilted circle, always looking at it."""
    poses = []
    for i in range(n_frames):
        ang = 2.0 * np.pi * i / max(n_frames, 1)
        eye = center + radius * np.array(
            [np.sin(ang), -np.sin(elevation), -np.cos(ang) * np.cos(elevation)])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right = right / np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R_c2w = np.stack([right, up2, fwd], axis=1)  # columns
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_c2w.T
        T[:3, 3] = -R_c2w.T @ eye
        poses.append(T)
    return poses


def to_uint8(image01: np.ndarray) -> np.ndarray:
    return (np.clip(image01, 0, 1) * 255).astype(np.uint8)


def export_turntable(params, active, intr: Intrinsics, out_path: str, n_frames: int = 36,
                     mode: str = "color", radius: Optional[float] = None,
                     raster_cfg: RasterConfig = RasterConfig(), fps: int = 12) -> str:
    """Render an orbit around the map into `<out_path stem>_frames/orbit_*.png`
    and, where PIL is installed, an animated GIF at `out_path`. Returns the
    GIF's path, or the frames' directory without PIL."""
    act = active.cpu().numpy()
    xyz = params.xyz.cpu().numpy()[act]
    if xyz.size == 0:
        raise ValueError("no active gaussians to visualize")
    center = xyz.mean(axis=0)
    if radius is None:
        radius = 1.5 * float(np.percentile(np.linalg.norm(xyz - center, axis=-1), 90))
    frames = []
    frame_dir = os.path.splitext(out_path)[0] + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    for i, T in enumerate(orbit_poses(center, radius, n_frames)):
        if mode == "ellipsoid":
            img = render_ellipsoids(params, active, T, intr, raster_cfg)
        else:
            img = render_view(params, active, T, intr, mode=mode, raster_cfg=raster_cfg)
        save_view_png(img, os.path.join(frame_dir, f"orbit_{i:04d}.png"))
        frames.append(to_uint8(img))
    try:
        from PIL import Image
    except ImportError:
        return frame_dir
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    images = [Image.fromarray(f) for f in frames]
    images[0].save(out_path, save_all=True, append_images=images[1:],
                   duration=int(1000 / fps), loop=0)
    return out_path


def _colormap(x: np.ndarray, name: str) -> np.ndarray:
    lo, hi = np.percentile(x, 2.0), np.percentile(x, 98.0)
    xn = np.clip((x - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    try:
        import matplotlib

        return np.asarray(matplotlib.colormaps[name](xn))[..., :3].astype(np.float32)
    except Exception:  # no matplotlib (as on the card's machine): grey
        return np.stack([xn] * 3, axis=-1).astype(np.float32)


def save_view_png(image01: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, to_uint8(image01))


class OfflineViewer:
    """Headless viewer: drains a VizChannel, writes PNG frames."""

    def __init__(self, channel, intr: Intrinsics, out_dir: str, mode: str = "color",
                 every: int = 1):
        self.channel = channel
        self.intr = intr
        self.out_dir = out_dir
        self.mode = mode
        self.every = every
        self._count = 0

    def tick(self, params=None, active=None) -> Optional[str]:
        """Render the newest packet (if any) with the map `params, active`
        from its frame's pose, or without them save its input image.
        Returns the written path."""
        packet = self.channel.latest()
        if packet is None or packet.finish:
            return None
        self._count += 1
        if self._count % self.every != 0:
            return None
        if params is None or packet.current_frame_T is None:
            if packet.gt_color is not None:
                path = os.path.join(self.out_dir, f"frame_{self._count:05d}.png")
                save_view_png(packet.gt_color, path)
                return path
            return None
        packet.adopt()
        img = render_view(params, active, packet.current_frame_T, self.intr, mode=self.mode)
        path = os.path.join(self.out_dir, f"view_{self._count:05d}.png")
        save_view_png(img, path)
        return path

"""Undistortion and rectification: the maps of `cv2.initUndistortRectifyMap`
and the bilinear resampling of `cv2.remap(..., cv2.INTER_LINEAR)`, which the
JAX package's loaders use for distorted monocular cameras and both EuRoC
eyes (`monogs_dev_tpu/data/datasets.py:193-205,245-300,307-310`).

The maps are computed once per camera in float64 numpy, as cv2 computes
them (five coefficients k1, k2, p1, p2, k3, a rectifying rotation R and the
new camera matrix), and stored as float32. The resampling runs on the
dataset's device: the four neighbours of each source coordinate weighted
by its exact fractions in float32, rounded to 8 bits with ties to even,
samples outside the source image counting as 0 (cv2's default constant
border). cv2 5.0 does the same for 8-bit images and float maps (older cv2
rounded the coordinates to 1/32 pixel first, which moves a result by up to
a few levels); `tests/test_torch_datasets.py` holds both maps and
resampling to cv2.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def init_undistort_rectify_map(K: np.ndarray, dist, R: np.ndarray, new_K: np.ndarray,
                               size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(map_x, map_y) float32 (height, width): for every pixel of the
    undistorted (rectified) image, where to sample the source image.
    `size` is (width, height), as cv2 takes it."""
    w, h = size
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (list(np.asarray(dist, np.float64).reshape(-1)) + [0.0] * 5)[:5]
    ir = np.linalg.inv(np.asarray(new_K, np.float64) @ np.asarray(R, np.float64))
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xw = u * ir[0, 0] + v * ir[0, 1] + ir[0, 2]
    yw = u * ir[1, 0] + v * ir[1, 1] + ir[1, 2]
    ww = u * ir[2, 0] + v * ir[2, 1] + ir[2, 2]
    x, y = xw / ww, yw / ww
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2.0 * x2)
    yd = y * kr + p1 * (r2 + 2.0 * y2) + p2 * _2xy
    map_x = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


class RemapPlan(NamedTuple):
    """A map split into the top-left source pixel and its fractions, on the
    device."""

    x0: torch.Tensor  # (H, W) int64
    y0: torch.Tensor
    fx: torch.Tensor  # (H, W) float32 in [0, 1)
    fy: torch.Tensor


def remap_plan(map_x: np.ndarray, map_y: np.ndarray, device) -> RemapPlan:
    map_x = np.asarray(map_x, np.float32)
    map_y = np.asarray(map_y, np.float32)
    x0, y0 = np.floor(map_x), np.floor(map_y)
    dev = torch.device(device)
    return RemapPlan(torch.as_tensor(x0.astype(np.int64), device=dev),
                     torch.as_tensor(y0.astype(np.int64), device=dev),
                     torch.as_tensor(map_x - x0, device=dev),
                     torch.as_tensor(map_y - y0, device=dev))


def remap_linear(img: torch.Tensor, plan: RemapPlan) -> torch.Tensor:
    """uint8 (H, W) or (H, W, C) source -> uint8 image of the plan's shape."""
    h, w = img.shape[:2]
    src = img.to(torch.float32)
    if src.dim() == 2:
        src = src[..., None]
    fx, fy = plan.fx[..., None], plan.fy[..., None]
    weights = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy)
    acc = None
    for wk, (dx, dy) in zip(weights, ((0, 0), (1, 0), (0, 1), (1, 1))):
        xs, ys = plan.x0 + dx, plan.y0 + dy
        inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        v = torch.where(inside[..., None], src[ys.clamp(0, h - 1), xs.clamp(0, w - 1)], 0.0)
        acc = v * wk if acc is None else acc + v * wk
    out = torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)  # ties to even
    return out[..., 0] if img.dim() == 2 else out

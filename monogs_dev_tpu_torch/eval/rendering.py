"""Rendering-quality evaluation: masked PSNR, SSIM and LPIPS (port of
`monogs_dev_tpu/eval/rendering.py`), and the PLY snapshot of the map.

Every `interval`-th frame that is not a keyframe is rendered from its
estimated pose and scored against the dataset's image. LPIPS from a random
backbone is reported loudly: `mean_lpips` is None and the value moves to
`mean_lpips_noncanonical`, beside its backend tag.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import render_tiled
from ..utils.logging import Log
from ..utils.losses import psnr as psnr_fn
from ..utils.losses import ssim as ssim_fn
from ..utils.ply import save_ply
from .lpips import CANONICAL, lpips, lpips_backend


@torch.no_grad()
def eval_rendering(cameras: Dict[int, "FrameInfo"], dataset, params, active,  # noqa: F821
                   intr: Intrinsics, raster_cfg: RasterConfig, sh_degree: int,
                   save_dir: Optional[str], kf_indices: List[int], iteration: str = "final",
                   interval: int = 5) -> dict:
    psnrs, ssims, lpipss = [], [], []
    backend = None
    for idx in range(0, len(dataset) - 1, interval):
        if idx in kf_indices or idx not in cameras:
            continue
        gt, _, _ = dataset[idx]
        T = torch.as_tensor(cameras[idx].T_est, dtype=torch.float32, device=gt.device)
        out = render_tiled(params, active, T, intr, sh_degree, config=raster_cfg,
                           need_touched=False)
        pred = torch.clamp(out.color, 0.0, 1.0)
        psnrs.append(float(psnr_fn(pred, gt, gt.sum(dim=-1) > 0.0)))
        ssims.append(float(ssim_fn(pred, gt)))
        lpipss.append(lpips(pred, gt))
        backend = lpips_backend()

    output = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "mean_ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "mean_lpips": float(np.mean(lpipss)) if lpipss else None,
        "lpips_backend": backend,
        "n_frames": len(psnrs),
    }
    Log(f'mean psnr: {output["mean_psnr"]}, ssim: {output["mean_ssim"]}, '
        f'lpips: {output["mean_lpips"]}', tag="Eval")
    if lpipss and backend != CANONICAL:
        # values from a random backbone must never be quoted against
        # published LPIPS: the comparable field is withheld
        Log("WARNING: LPIPS ran on the NON-CANONICAL random backbone "
            f"('{backend}'); values are not comparable to published LPIPS. Put the "
            "v0.1 weights npz beside eval/lpips.py or at $MONOGS_LPIPS_WEIGHTS for "
            "canonical numbers.", tag="Eval")
        output["mean_lpips_noncanonical"] = output.pop("mean_lpips")
        output["mean_lpips"] = None
    if save_dir is not None:
        psnr_dir = os.path.join(save_dir, "psnr", str(iteration))
        os.makedirs(psnr_dir, exist_ok=True)
        with open(os.path.join(psnr_dir, "final_result.json"), "w", encoding="utf-8") as f:
            json.dump(output, f, indent=2)
    return output


def save_gaussians(params, active, save_dir: Optional[str], iteration, final: bool = False):
    """PLY snapshot under point_cloud/final or point_cloud/iteration_<n>."""
    if save_dir is None:
        return
    path = os.path.join(save_dir,
                        "point_cloud/final" if final else f"point_cloud/iteration_{iteration}")
    n = save_ply(params, active, os.path.join(path, "point_cloud.ply"))
    Log(f"Saved {n} gaussians to {path}", tag="Eval")

"""On a card: the port's timed render (K3) and pose gradient (K1 forward,
K2 backward) against the plain reference at the cell's camera, on a scene
as the benchmark draws it. Skips without a CUDA device."""

import json
import os

import pytest
import torch

from benchmark import scene
from benchmark.reference import loss as L
from benchmark.reference import render as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.gpu
def test_kernels_against_the_reference_at_the_cells_size(card):
    from monogs_dev_tpu_torch.core import tracking
    from monogs_dev_tpu_torch.core.params import StepConfig
    from monogs_dev_tpu_torch.models.camera import Intrinsics
    from monogs_dev_tpu_torch.models.gaussians import GaussianParams
    from monogs_dev_tpu_torch.ops.project import project_gaussians
    from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
    from monogs_dev_tpu_torch.ops.rasterize import build_binning, render_tiled
    from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

    with open(os.path.join(ROOT, "benchmark", "configs", "tum_fr3_office_rgbd.json")) as f:
        cfg = json.load(f)
    limits = cfg["limits"]
    cam = scene.camera_of(cfg["config"]["Dataset"])
    intr = Intrinsics(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                      height=cam.height)
    g, act = scene.surface_scene(1, 17, 8000, 5.0, 3.0, 3.0, 0.035, card)
    n = act.shape[0]
    params = GaussianParams(xyz=g["xyz"], f_dc=g["f_dc"],
                            f_rest=torch.zeros((n, 0, 3), device=card),
                            log_scales=g["log_scales"], quats=g["quats"],
                            opacity_logit=g["opacity_logit"])
    T = torch.tensor(scene.loop_pose(3, 0.01, 0.008), dtype=torch.float32, device=card)
    img, dep = R.sensor_frame(g, act, torch.tensor(scene.loop_pose(4, 0.01, 0.008),
                                                   dtype=torch.float32, device=card), cam)
    tpu = cfg["config"]["TPU"]
    rc = RasterConfig(tile=tpu["tile"], max_per_tile=tpu["max_per_tile"], k_dup=tpu["k_dup"])
    blend = R.Blend(tile=rc.tile, k_dup=rc.k_dup, max_per_tile=rc.max_per_tile)
    with torch.no_grad():
        out = render_tiled(params, act, T, intr, 0, torch.zeros(3, device=card), rc)
    color, _, _ = R.render(g, act, T, cam, blend)
    assert float((out.color - color).abs().mean()) < limits["render_mae"]
    step = StepConfig(alpha=float(cfg["config"]["Training"].get("alpha", 0.95)),
                      per_block_mask=cfg["layout"] == "replica")
    mask = compute_grad_mask(img, step.edge_threshold, step.per_block_mask)
    with torch.no_grad():
        b = build_binning(project_gaussians(params, act, T, intr, 0), intr, rc,
                          dilate=step.rebin_dilation)
    ab = torch.zeros(2, device=card)
    _, g_port = tracking.pose_gradient(T, ab, params, act, b, img, dep, mask,
                                       tracking.tile_mask_of(mask, intr, rc),
                                       torch.zeros(3, device=card), step, intr, rc, True)
    _, g_ref = L.tracking_gradient(
        g, act, T, ab, img, dep, cam, R.Blend(tile=rc.tile, k_dup=rc.k_dup,
                                              max_per_tile=rc.max_per_tile,
                                              dilate=step.rebin_dilation),
        alpha=step.alpha, rgb_threshold=step.rgb_boundary_threshold,
        edge_threshold=step.edge_threshold, per_block=step.per_block_mask)
    assert float(torch.linalg.norm(g_port - g_ref) / torch.linalg.norm(g_ref)) < limits["grad_rel"]

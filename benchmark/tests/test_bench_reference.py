"""The plain reference against the port on the CPU at a tiny size: its
renderer equals the port's brute-force `render_reference` with no tile
lists and the port's tiled render with them (under both caps, overflowing),
its pose gradient equals the port's `pose_gradient`, and TF32's rounding."""

import pytest
import torch

from benchmark import scene
from benchmark.reference import loss as L
from benchmark.reference import render as R


@pytest.fixture(scope="module")
def setup():
    from monogs_dev_tpu_torch.models.camera import Intrinsics
    from monogs_dev_tpu_torch.models.gaussians import GaussianParams

    g, act = scene.surface_scene(5, 5, 3000, 5.0, 3.0, 3.0, 0.08, "cpu")
    params = GaussianParams(xyz=g["xyz"], f_dc=g["f_dc"], f_rest=torch.zeros(3000, 0, 3),
                            log_scales=g["log_scales"], quats=g["quats"],
                            opacity_logit=g["opacity_logit"])
    intr = Intrinsics(fx=80.0, fy=80.0, cx=48.0, cy=32.0, width=96, height=64)
    cam = R.Camera(80.0, 80.0, 48.0, 32.0, 96, 64)
    T = torch.tensor(scene.loop_pose(3, 0.01, 0.01), dtype=torch.float32)
    return g, act, params, intr, cam, T


def test_untiled_render_equals_the_ports_brute_force_oracle(setup):
    from monogs_dev_tpu_torch.ops.rasterize_ref import render_reference

    g, act, params, intr, cam, T = setup
    o = render_reference(params, act, T, intr, 0)
    c, d, a = R.render(g, act, T, cam, R.Blend(k_dup=0))
    assert float((o.color - c).abs().max()) < 1e-5
    assert float((o.alpha - a).abs().max()) < 1e-5
    assert float((o.depth - d).abs().max()) < 1e-4


@pytest.mark.parametrize("k_dup,max_per_tile", [(16, 1024), (4, 16), (2, 8)])
def test_tiled_render_equals_the_ports(setup, k_dup, max_per_tile):
    from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
    from monogs_dev_tpu_torch.ops.rasterize import render_tiled

    g, act, params, intr, cam, T = setup
    o = render_tiled(params, act, T, intr, 0, torch.zeros(3),
                     RasterConfig(k_dup=k_dup, max_per_tile=max_per_tile))
    c, _, _ = R.render(g, act, T, cam, R.Blend(k_dup=k_dup, max_per_tile=max_per_tile))
    assert float((o.color - c).abs().max()) < 1e-5
    if k_dup < 16:  # the caps bite: the uncapped render is far off
        assert int(o.dup_overflow) + int(o.tile_overflow) > 0
        c0, _, _ = R.render(g, act, T, cam, R.Blend(k_dup=0))
        assert float((o.color - c0).abs().mean()) > 0.1


@pytest.mark.parametrize("k_dup,max_per_tile", [(16, 1024), (4, 16)])
def test_pose_gradient_equals_the_ports(setup, k_dup, max_per_tile):
    from monogs_dev_tpu_torch.core import tracking
    from monogs_dev_tpu_torch.core.params import StepConfig
    from monogs_dev_tpu_torch.ops.project import project_gaussians
    from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
    from monogs_dev_tpu_torch.ops.rasterize import build_binning
    from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

    g, act, params, intr, cam, T = setup
    img, dep = R.sensor_frame(g, act, torch.tensor(scene.loop_pose(5, 0.01, 0.01),
                                                   dtype=torch.float32), cam)
    cfg = StepConfig(alpha=0.9)
    rc = RasterConfig(k_dup=k_dup, max_per_tile=max_per_tile)
    mask = compute_grad_mask(img, cfg.edge_threshold, False)
    assert torch.equal(mask, L.edge_mask(img, cfg.edge_threshold, False))
    with torch.no_grad():
        b = build_binning(project_gaussians(params, act, T, intr, 0), intr, rc,
                          dilate=cfg.rebin_dilation)
    ab = torch.tensor([0.01, -0.02])
    loss, g_port = tracking.pose_gradient(T, ab, params, act, b, img, dep, mask,
                                          tracking.tile_mask_of(mask, intr, rc), torch.zeros(3),
                                          cfg, intr, rc, True)
    loss_ref, g_ref = L.tracking_gradient(
        g, act, T, ab, img, dep, cam,
        R.Blend(k_dup=k_dup, max_per_tile=max_per_tile, dilate=cfg.rebin_dilation),
        alpha=cfg.alpha, rgb_threshold=cfg.rgb_boundary_threshold,
        edge_threshold=cfg.edge_threshold, per_block=False)
    assert abs(float(loss) - loss_ref) < 1e-6 * abs(loss_ref) + 1e-8
    assert float(torch.linalg.norm(g_port - g_ref) / torch.linalg.norm(g_ref)) < 1e-5


def test_per_block_edge_mask_equals_the_ports():
    from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

    img = torch.rand((70, 100, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(compute_grad_mask(img, 4.0, True), L.edge_mask(img, 4.0, True))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265, -2.7182818])
    r = R.tf32_round(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    assert bool(((r - x).abs() <= x.abs() * 2 ** -11).all())
    assert bool((R.tf32_round(r) == r).all())
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())

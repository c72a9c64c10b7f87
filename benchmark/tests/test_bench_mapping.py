"""The run's mapping check on one plain iteration of the port's
`core/mapping.py::mapping_iterations`, called as the backend calls it and
recorded by the run's `MapRecorder`: the reference's gradient of the
iteration's loss against the gradient that the port's Adam moments took in,
and Adam's step against the change the port made. Two keyframes of the
benchmark's relief and a map that is the relief a little off, so that the
loss has gradients to read; on the CPU at a tiny size, and on a card at the
cell's size."""

import copy
import json
import os

import pytest
import torch

from benchmark import scene
from benchmark import session as S
from benchmark.reference import render as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mapping_checks(device, width, height):
    from monogs_dev_tpu_torch.core import backend, mapping
    from monogs_dev_tpu_torch.core.params import MapOptConfig, StepConfig
    from monogs_dev_tpu_torch.core.system import raster_config_from
    from monogs_dev_tpu_torch.models.camera import Intrinsics
    from monogs_dev_tpu_torch.models.gaussians import GaussianMap, GaussianParams, create_map
    from monogs_dev_tpu_torch.utils.config import DotDict

    with open(os.path.join(ROOT, "benchmark", "configs", "tum_fr3_office_rgbd.json")) as f:
        cfg = json.load(f)
    config = copy.deepcopy(cfg["config"])
    cal = config["Dataset"]["Calibration"]
    s = width / cal["width"]
    cal.update(fx=cal["fx"] * s, fy=cal["fy"] * s, cx=width / 2.0, cy=height / 2.0,
               width=width, height=height)
    config = DotDict.wrap(config)
    step_cfg, opt_cfg = StepConfig.from_config(config), MapOptConfig.from_config(config)
    raster_cfg = raster_config_from(config)
    cam = scene.camera_of(config["Dataset"])
    intr = Intrinsics(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=width, height=height)

    g, act = scene.surface_scene(1, 17, 8000, 5.0, 3.0, 3.0, 0.035, device)
    gen = torch.Generator().manual_seed(3)
    n = act.shape[0]
    off = {k: (0.02 * torch.randn(v.shape, generator=gen)).to(device) for k, v in g.items()}
    params = GaussianParams(xyz=g["xyz"] + off["xyz"], f_dc=g["f_dc"] + 5 * off["f_dc"],
                            f_rest=torch.zeros((n, 0, 3), device=device),
                            log_scales=g["log_scales"] + 5 * off["log_scales"],
                            quats=g["quats"] + off["quats"],
                            opacity_logit=g["opacity_logit"] + 20 * off["opacity_logit"])
    empty = create_map(n, 0, device)
    gmap = GaussianMap(params, empty.aux.replace(active=act), empty.moments)

    b = 4
    poses = [scene.loop_pose(i, 0.0059271, 0.0083) for i in (0, 12)]
    images = torch.zeros((b, height, width, 3), device=device)
    depths = torch.zeros((b, height, width), device=device)
    T = torch.eye(4, device=device).repeat(b, 1, 1)
    for k, P in enumerate(poses):
        T[k] = torch.tensor(P, dtype=torch.float32, device=device)
        images[k], depths[k] = R.sensor_frame(g, act, T[k], cam)
    valid = torch.tensor([True, True, False, False], device=device)
    batch = mapping.KeyframeBatch(
        images=images, depths=depths, T_w2c=T, exposure=torch.zeros((b, 2), device=device),
        valid=valid, optimize_pose=valid.clone(), optimize_exposure=valid.clone(),
        apply_exposure=valid.clone(), harvest_visibility=valid.clone())

    rec = S.MapRecorder(backend)
    rec.install()
    rec.on = True
    try:
        backend.mapping_iterations(
            gmap, batch, mapping.make_keyframe_opt_state(b, device), 1109,
            mapping.TorchDraws(torch.Generator().manual_seed(5)), torch.zeros(3, device=device),
            0.7, 6.0, step_cfg, opt_cfg, intr, raster_cfg, iters=1, update_every=150,
            update_offset=50, reset_interval=2001, size_threshold=20.0, use_depth=True,
            init_mode=False)
    finally:
        rec.remove()
    assert rec.last is not None and rec.last["it"] == 1110
    checks = S.map_checks(rec.last, S.reference_map_gradient(rec.last, cam))
    return checks, cfg["limits"]


def test_the_mapping_check_on_a_tiny_map():
    checks, limits = _mapping_checks("cpu", 96, 64)
    assert checks["map_grad_rel"][0] < limits["map_grad_rel"]
    assert checks["map_step_rel"][0] < limits["map_step_rel"]


@pytest.mark.gpu
def test_the_mapping_check_at_the_cells_size(card):
    checks, limits = _mapping_checks(card, 640, 480)
    print("mapping check at 640x480 on the card:", checks)
    assert checks["map_grad_rel"][0] < limits["map_grad_rel"]
    assert checks["map_step_rel"][0] < limits["map_step_rel"]

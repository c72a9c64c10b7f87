"""The evaluation tail against the JAX package: PSNR and SSIM (1e-6), LPIPS
with the JAX package's random backbone carried across (1e-5 relative),
`eval_rendering` on the same map and poses (mean PSNR within 1e-3 dB),
colour refinement from the same map with the same `default_rng(0)` draws
(params within rtol 1e-4), the PLY layout (read back by the JAX package's
`load_ply`), and `slam_torch.py --eval` on the CPU.

Tolerances: PSNR/SSIM are the same float32 formulas over ~15k pixels, their
means in another order (1e-6); LPIPS sums five conv stacks of ~10^5 terms
in another order (1e-5 relative); refinement is 5 Adam steps whose first
step is ~lr x sign(g): a gradient that rounds to the other side of 0 would
move a parameter by a whole lr, which this map does not meet at rtol 1e-4."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core.params import MapOptConfig as JMapOpt
from monogs_dev_tpu.core.params import StepConfig as JStepConfig
from monogs_dev_tpu.core.refinement import run_color_refinement as j_refine
from monogs_dev_tpu.data.synthetic import make_synthetic_scene, orbit_pose
from monogs_dev_tpu.eval import lpips as jlp
from monogs_dev_tpu.eval.rendering import eval_rendering as j_eval_rendering
from monogs_dev_tpu.models import gaussians as jg
from monogs_dev_tpu.models.camera import Intrinsics as JIntrinsics
from monogs_dev_tpu.ops.raster_types import RasterConfig as JRasterConfig
from monogs_dev_tpu.ops.rasterize import render_tiled as j_render
from monogs_dev_tpu.utils import losses as jl
from monogs_dev_tpu.utils.ply import load_ply as j_load_ply
from monogs_dev_tpu_torch.core.params import MapOptConfig, StepConfig
from monogs_dev_tpu_torch.core.refinement import run_color_refinement
from monogs_dev_tpu_torch.eval import lpips as tlp
from monogs_dev_tpu_torch.eval.ate import eval_ate
from monogs_dev_tpu_torch.eval.rendering import eval_rendering
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.convert import gaussian_map_from_numpy, gaussian_map_to_numpy
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.utils import losses as tl
from monogs_dev_tpu_torch.utils.ply import load_ply, save_ply
from tests.test_torch_mapping import assert_maps_close, jmap_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(fx=72.0, fy=72.0, cx=40.0, cy=32.0, width=80, height=64)
JINTR, INTR = JIntrinsics(**KW), Intrinsics(**KW)
RKW = dict(tile=16, max_per_tile=256, k_dup=16, tile_group=20)
JRCFG, RCFG = JRasterConfig(use_pallas=False, **RKW), RasterConfig(**RKW)
N_FRAMES = 12


@pytest.fixture(scope="module")
def world():
    """The tiny blob scene's frames at 12 orbit poses, and a map made from
    the scene with perturbed colours, positions and scales (JAX side). The
    scene's blobs are isotropic, where the rotation gradient is 0 up to
    rounding and Adam would turn that noise into whole lr steps: the map's
    scales differ per axis so every parameter has a gradient of its own."""
    scene, active = make_synthetic_scene(jax.random.PRNGKey(0), n=800, scale=0.06)
    poses = [np.asarray(orbit_pose(i, 30), np.float32) for i in range(N_FRAMES)]
    images = [np.clip(np.asarray(j_render(scene, active, jnp.asarray(T), JINTR, 0, config=JRCFG,
                                          need_touched=False).color), 0, 1) for T in poses]
    rng = np.random.default_rng(0)
    noisy = scene._replace(
        f_dc=scene.f_dc + jnp.asarray(0.2 * rng.normal(size=scene.f_dc.shape), jnp.float32),
        xyz=scene.xyz + jnp.asarray(0.005 * rng.normal(size=scene.xyz.shape), jnp.float32),
        log_scales=scene.log_scales + jnp.asarray(0.4 * rng.normal(size=scene.log_scales.shape),
                                                  jnp.float32))
    gmap, _ = jg.insert_points(jg.create_map(1024, 0), noisy, active, 0)
    return dict(gmap=gmap, poses=poses, images=images)


def _random_images(seed, shape=(64, 80, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_ssim_l1_match():
    a, b = _random_images(0)
    mask = np.random.default_rng(1).uniform(size=a.shape[:2]) > 0.3
    ta, tb = torch.tensor(a), torch.tensor(b)
    for t, j in ((tl.psnr(ta, tb), jl.psnr(a, b)),
                 (tl.psnr(ta, tb, torch.tensor(mask)), jl.psnr(a, b, mask)),
                 (tl.ssim(ta, tb), jl.ssim(jnp.asarray(a), jnp.asarray(b))),
                 (tl.l1_loss(ta, tb), jl.l1_loss(a, b))):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    assert 0.0 < float(tl.ssim(ta, tb)) < 1.0


def test_lpips_matches_jax_backbone():
    """The JAX package's random backbone carried across: LPIPS within 1e-5
    relative; the port's own backbone is its own, tagged apart."""
    jp = jlp.random_lpips_params()
    arrays = {}
    for i in range(5):
        arrays.update({f"conv{i}_w": np.asarray(jp.conv_w[i]),
                       f"conv{i}_b": np.asarray(jp.conv_b[i]),
                       f"lin{i}_w": np.asarray(jp.lin_w[i])})
    tp = tlp.lpips_params_from_numpy(arrays, jp.backend)
    for seed in (0, 1):
        a, b = _random_images(seed)
        np.testing.assert_allclose(tlp.lpips(a, b, tp), jlp.lpips(a, b, jp), rtol=1e-5)
    a, b = _random_images(2)
    assert tlp.lpips(a, a) == 0.0 and tlp.lpips(a, b) > 0.0
    assert tlp.random_lpips_params().backend == "alexnet-random-torch" != jp.backend
    np.testing.assert_array_equal(tlp.random_lpips_params().conv_w[0],
                                  tlp.random_lpips_params().conv_w[0])


def test_lpips_weights_npz_is_loaded_and_tagged(tmp_path, monkeypatch):
    tp = tlp.random_lpips_params(seed=3)
    arrays = {}
    for i in range(5):
        arrays.update({f"conv{i}_w": tp.conv_w[i].numpy(), f"conv{i}_b": tp.conv_b[i].numpy(),
                       f"lin{i}_w": tp.lin_w[i].numpy().reshape(1, -1, 1, 1)})
    path = str(tmp_path / "w.npz")
    np.savez(path, **arrays)
    monkeypatch.setenv("MONOGS_LPIPS_WEIGHTS", path)
    tlp.load_lpips_params.cache_clear()
    tlp._params_on.cache_clear()
    try:
        assert tlp.lpips_backend() == tlp.CANONICAL
        a, b = _random_images(4)
        np.testing.assert_allclose(tlp.lpips(a, b), tlp.lpips(a, b, tp), rtol=1e-6)
    finally:
        monkeypatch.delenv("MONOGS_LPIPS_WEIGHTS")
        tlp.load_lpips_params.cache_clear()
        tlp._params_on.cache_clear()


class _Frames:
    """A dataset of fixed frames: (image, None, pose) per index."""

    def __init__(self, images, poses, to):
        self.items = [(to(im), None, T) for im, T in zip(images, poses)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _cameras(world):
    """Estimated poses: ground truth nudged by a few mm."""
    cams = {}
    for i, T in enumerate(world["poses"]):
        T_est = T.copy()
        T_est[:3, 3] += 0.002 * np.sin([i, i + 1.0, i + 2.0])
        cams[i] = types.SimpleNamespace(idx=i, T_est=T_est, T_gt=T)
    return cams


def test_eval_rendering_matches(world, tmp_path):
    cams = _cameras(world)
    kfs = [0, 5]
    g = world["gmap"]
    j_out = j_eval_rendering(cams, _Frames(world["images"], world["poses"], np.asarray),
                             g.params, g.aux.active, JINTR, JRCFG, 0, None, kfs)
    tmap = gaussian_map_from_numpy(jmap_to_numpy(g), "cpu")
    t_out = eval_rendering(cams, _Frames(world["images"], world["poses"], torch.tensor),
                           tmap.params, tmap.aux.active, INTR, RCFG, 0, str(tmp_path), kfs)
    assert t_out["n_frames"] == j_out["n_frames"] == 1  # frames 0 and 5 are keyframes; 10
    assert abs(t_out["mean_psnr"] - j_out["mean_psnr"]) < 1e-3
    assert abs(t_out["mean_ssim"] - j_out["mean_ssim"]) < 1e-5
    assert 10.0 < t_out["mean_psnr"] < 60.0
    # the random backbone is reported under its tag, never as LPIPS
    assert t_out["mean_lpips"] is None and t_out["lpips_backend"] == "alexnet-random-torch"
    assert t_out["mean_lpips_noncanonical"] > 0.0
    with open(tmp_path / "psnr" / "final" / "final_result.json") as f:
        assert json.load(f)["mean_psnr"] == t_out["mean_psnr"]
    ate = eval_ate(cams, list(range(N_FRAMES)), str(tmp_path), 0, final=True)
    assert 0.0 < ate < 0.004
    assert (tmp_path / "trj_final.json").exists()
    assert (tmp_path / "plot" / "stats_final.json").exists()


def test_color_refinement_matches(world):
    """`run_color_refinement`, 5 iterations over 3 keyframes from the same
    map, the keyframes drawn from `default_rng(0)` on both sides."""
    kf_ids = [0, 4, 8]
    g = world["gmap"]

    def engine(gmap, to_img, step_cfg, opt_cfg, intr, rcfg, bg):
        views = {i: types.SimpleNamespace(image=to_img(world["images"][i]),
                                          T_w2c=world["poses"][i]) for i in kf_ids}
        return types.SimpleNamespace(viewpoints=views, gmap=gmap, iteration_count=0,
                                     bg_color=bg, cfg=step_cfg, opt_cfg=opt_cfg, intr=intr,
                                     raster_cfg=rcfg, device=torch.device("cpu"))

    tmap = gaussian_map_from_numpy(jmap_to_numpy(g), "cpu")
    # the JAX refinement donates the map it is given: hand it a copy
    gj, _ = j_refine(engine(jax.tree.map(jnp.copy, g), jnp.asarray, JStepConfig(), JMapOpt(),
                            JINTR, JRCFG, jnp.zeros(3)), iterations=5)
    gt, _ = run_color_refinement(engine(tmap, torch.tensor, StepConfig(), MapOptConfig(), INTR,
                                        RCFG, torch.zeros(3)), iterations=5)
    assert_maps_close(gaussian_map_to_numpy(gt), jmap_to_numpy(gj), rtol=1e-4, atol=1e-7)
    moved = np.abs(gaussian_map_to_numpy(gt)["params.f_dc"] - np.asarray(g.params.f_dc)).max()
    assert moved > 1e-3


def test_ply_round_trip(world, tmp_path):
    """A PLY written by the port reads back, through the JAX package's
    `load_ply` and the port's, equal to the map's active rows."""
    g = world["gmap"]
    tmap = gaussian_map_from_numpy(jmap_to_numpy(g), "cpu")
    path = str(tmp_path / "pc.ply")
    n = save_ply(tmap.params, tmap.aux.active, path)
    active = np.asarray(g.aux.active)
    assert n == int(active.sum()) > 0
    jp, jact = j_load_ply(path)
    tp, tact = load_ply(path)
    assert bool(np.all(jact)) and bool(tact.all())
    for f in dataclasses.fields(tp):
        want = np.asarray(getattr(g.params, f.name))[active]
        np.testing.assert_array_equal(np.asarray(getattr(jp, f.name)), want, err_msg=f.name)
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(), want, err_msg=f.name)


def test_cli_eval_writes_artifacts(tmp_path):
    """`slam_torch.py --config tiny_rgbd.yaml --device cpu --eval`, with 5
    refinement iterations and 8 frames: the results JSON and the artifacts
    tests/test_system.py checks of the JAX package's evaluate."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        f'inherit_from: "{os.path.join(REPO, "configs/synthetic/tiny_rgbd.yaml")}"\n'
        "Training:\n  refinement_itr_num: 5\n"
        f'Results:\n  save_dir: "{tmp_path / "results"}"\n')
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "slam_torch.py"), "--config", str(cfg), "--device",
         "cpu", "--eval", "--max-frames", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    res = json.loads(out[out.index("\n{\n") + 1:])
    assert np.isfinite(res["ate"]) and np.isfinite(res["before_opt"]["mean_psnr"])
    assert np.isfinite(res["after_opt"]["mean_psnr"]) and res["n_keyframes"] >= 1
    assert res["device"] == "cpu"
    (run_dir,) = (tmp_path / "results").iterdir()
    for rel in ("plot", "trj_final.json", "psnr/before_opt/final_result.json",
                "psnr/after_opt/final_result.json", "point_cloud/final/point_cloud.ply",
                "metrics.jsonl", "metrics_table.md", "config.yml"):
        assert (run_dir / rel).exists(), rel

"""Adam tracking parity (`core/tracking.py::track_frame`) against the JAX
package on the tiny blob scene (800 Gaussians, 80x64, the scene of
configs/synthetic/tiny_rgbd.yaml drawn by JAX and handed over as numpy). The
JAX side runs the XLA blend (`use_pallas: False`), as its tiny configs do.

Tolerances and why:
- loss rtol 1e-5, gradient within 1e-4 x max|g|: the same float32 function,
  its pixel and entry sums in another order;
- the pose after each of the first 3 iterations within 1e-5: Adam's first
  steps are ~lr x sign(g), so these hold the gradient's signs and the
  update's order; a component whose gradient is ~0 could flip between
  summation orders and move the pose by a whole lr, which this scene's
  start pose does not meet;
- the final pose within 1 mm and 1e-3 rad: ~30 closed-loop iterations let
  the rounding differences grow; iteration counts equal or 1 apart (the
  stop tests read float32 values that differ in the last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core import tracking as jtracking
from monogs_dev_tpu.core.params import StepConfig as JStepConfig
from monogs_dev_tpu.data.synthetic import make_synthetic_scene, orbit_pose
from monogs_dev_tpu.geometry import se3_exp as j_se3_exp
from monogs_dev_tpu.models.camera import Intrinsics as JIntrinsics
from monogs_dev_tpu.ops.project import project_gaussians as j_project
from monogs_dev_tpu.ops.raster_types import RasterConfig as JRasterConfig
from monogs_dev_tpu.ops.rasterize import build_binning as j_build_binning
from monogs_dev_tpu.ops.rasterize import render_binned as j_render_binned
from monogs_dev_tpu.ops.rasterize import render_tiled as j_render
from monogs_dev_tpu.utils.losses import compute_grad_mask as j_grad_mask
from monogs_dev_tpu.utils.losses import tracking_loss as j_tracking_loss
from monogs_dev_tpu_torch.core import tracking as tt
from monogs_dev_tpu_torch.core.params import StepConfig
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.convert import params_from_numpy
from monogs_dev_tpu_torch.ops.project import project_gaussians
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.ops.rasterize import build_binning
from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

torch.set_num_threads(2)

KW = dict(fx=72.0, fy=72.0, cx=40.0, cy=32.0, width=80, height=64)
JINTR, INTR = JIntrinsics(**KW), Intrinsics(**KW)
RKW = dict(tile=16, max_per_tile=256, k_dup=16, tile_group=20)
JRCFG, RCFG = JRasterConfig(use_pallas=False, **RKW), RasterConfig(**RKW)
SKW = dict(tracking_max_iters=30, exposure_lr=0.01, alpha=0.9)
TAU0 = np.array([0.01, -0.008, 0.012, 0.004, -0.006, 0.003], np.float32)


@pytest.fixture(scope="module")
def frame():
    params, active = make_synthetic_scene(jax.random.PRNGKey(0), n=800, scale=0.06)
    T_true = np.asarray(orbit_pose(3, 30), np.float32)
    gt = j_render(params, active, jnp.asarray(T_true), JINTR, 0, config=JRCFG,
                  need_touched=False)
    alpha = np.asarray(gt.alpha)
    depth = np.where(alpha < 0.5, 0.0, np.asarray(gt.depth) / np.maximum(alpha, 1e-6))
    T_init = np.array(j_se3_exp(jnp.asarray(TAU0)) @ jnp.asarray(T_true), np.float32)
    arrays = {f"params.{k}": np.asarray(v) for k, v in params._asdict().items()}
    image = np.clip(np.asarray(gt.color), 0, 1).astype(np.float32)
    return dict(jparams=params, jactive=active, tparams=params_from_numpy(arrays, "cpu"),
                tactive=torch.tensor(np.asarray(active)), image=image,
                depth=depth.astype(np.float32), T_true=T_true, T_init=T_init)


def _j_tile_mask(mask, intr, rcfg):
    """The JAX body's tile mask (core/tracking.py run_level)."""
    tw = th = rcfg.tile
    tx_n, ty_n = -(-intr.width // tw), -(-intr.height // th)
    m_pad = jnp.zeros((ty_n * th, tx_n * tw), bool).at[: intr.height, : intr.width].set(mask)
    return m_pad.reshape(ty_n, th, tx_n, tw).any(axis=(1, 3)).reshape(-1)


@pytest.mark.parametrize("monocular", [False, True], ids=["rgbd", "mono"])
@pytest.mark.parametrize("masked", [True, False], ids=["tile_mask", "no_tile_mask"])
def test_loss_and_gradient_match(frame, monocular, masked):
    """`pose_loss` and its (tau, exposure) gradient at a perturbed pose
    against `jax.value_and_grad` of the JAX body's `loss_fn`."""
    use_depth = not monocular
    exp_ab = np.array([0.05, -0.02], np.float32)
    jcfg = JStepConfig(monocular=monocular, **SKW)
    cfg = StepConfig(monocular=monocular, **SKW)
    image, depth = frame["image"], frame["depth"]

    jmask = j_grad_mask(jnp.asarray(image), jcfg.edge_threshold, False)
    jT = jnp.asarray(frame["T_init"])
    jproj = j_project(frame["jparams"], frame["jactive"], jT, JINTR, 0)
    jbin = j_build_binning(jproj, JINTR, JRCFG, dilate=jcfg.rebin_dilation)
    jtm = _j_tile_mask(jmask, JINTR, JRCFG) if masked else None

    def j_loss(tau, ab):
        proj = j_project(frame["jparams"], frame["jactive"], j_se3_exp(tau) @ jT, JINTR, 0)
        out = j_render_binned(proj, proj.means2d, jbin, JINTR, jnp.zeros(3), JRCFG,
                              need_touched=False, tile_mask=jtm)
        return j_tracking_loss(out.color, out.depth, out.alpha, jnp.asarray(image),
                               jnp.asarray(depth) if use_depth else None, ab, jmask,
                               monocular, jcfg.alpha, jcfg.rgb_boundary_threshold)

    jl, (jg_tau, jg_exp) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.zeros(6), jnp.asarray(exp_ab))
    jg = np.concatenate([np.asarray(jg_tau), np.asarray(jg_exp)])

    timg, tdep = torch.tensor(image), torch.tensor(depth)
    mask = compute_grad_mask(timg, cfg.edge_threshold, False)
    assert (mask.numpy() != np.asarray(jmask)).mean() < 1e-3
    T = torch.tensor(frame["T_init"])
    with torch.no_grad():
        proj = project_gaussians(frame["tparams"], frame["tactive"], T, INTR, 0)
        binning = build_binning(proj, INTR, RCFG, dilate=cfg.rebin_dilation)
    tm = tt.tile_mask_of(mask, INTR, RCFG) if masked else None
    if masked:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jtm))
        assert 0 < int(tm.sum()) < tm.numel()  # some tiles are masked out
    tau = torch.zeros(6, requires_grad=True)
    ab = torch.tensor(exp_ab, requires_grad=True)
    loss = tt.pose_loss(tau, ab, T, frame["tparams"], frame["tactive"], binning, timg, tdep,
                        mask, tm, torch.zeros(3), cfg, INTR, RCFG, use_depth)
    g = torch.cat(torch.autograd.grad(loss, (tau, ab))).numpy()

    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    assert np.abs(jg).max() > 0


def _j_iteration_poses(frame, n, monkeypatch):
    """The JAX tracker's pose after each of its first `n` iterations: run
    eagerly, its retractions se3_exp(tau_new) @ T recorded."""
    taus = []

    def se3_exp_recording(tau):
        if not isinstance(tau, jax.core.Tracer):
            taus.append(np.asarray(tau))
        return j_se3_exp(tau)

    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jtracking, "se3_exp", se3_exp_recording)
        jtracking.track_frame(frame["jparams"], frame["jactive"], frame["T_init"],
                              np.zeros(2, np.float32), frame["image"], frame["depth"], None,
                              jnp.zeros(3), JStepConfig(**dict(SKW, tracking_max_iters=n)),
                              JINTR, JRCFG, use_depth=True)
    taus = [t for t in taus if np.any(t != 0.0)]  # the loss's tau is zeros
    assert len(taus) == n
    poses, T = [], jnp.asarray(frame["T_init"])
    for tau in taus:
        T = j_se3_exp(jnp.asarray(tau)) @ T
        poses.append(np.asarray(T))
    return poses


def test_first_iterations_match(frame, monkeypatch):
    """The pose after each of the first 3 Adam iterations, within 1e-5."""
    n = 3
    j_poses = _j_iteration_poses(frame, n, monkeypatch)
    t_poses = []
    orig = tt.se3_exp

    def se3_exp_recording(tau):
        out = orig(tau)
        if not tau.requires_grad:
            t_poses.append(out)
        return out

    monkeypatch.setattr(tt, "se3_exp", se3_exp_recording)
    cfg = StepConfig(**dict(SKW, tracking_max_iters=n))
    tt.track_frame(frame["tparams"], frame["tactive"], frame["T_init"], np.zeros(2, np.float32),
                   torch.tensor(frame["image"]), torch.tensor(frame["depth"]), None,
                   torch.zeros(3), cfg, INTR, RCFG, use_depth=True)
    assert len(t_poses) == n
    T = torch.tensor(frame["T_init"])
    for k, (step, T_j) in enumerate(zip(t_poses, j_poses)):
        T = step @ T
        np.testing.assert_allclose(T.numpy(), T_j, rtol=0, atol=1e-5, err_msg=f"iteration {k}")
    # each step moves the pose by about lr: the test holds the signs
    assert np.abs(j_poses[0][:3, 3] - frame["T_init"][:3, 3]).max() > 5e-4


def _rot_angle(T):
    c = (np.trace(T[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("variant", [
    dict(),
    dict(pyramid_levels=1, pyramid_coarse_iters=10, plateau_iters=6, plateau_rel_tol=1e-3),
    dict(track_compact=512),
], ids=["reference", "pyramid_plateau", "compact"])
def test_track_frame_matches(frame, variant):
    """A whole `track_frame` from the same start: final pose within 1 mm and
    1e-3 rad of the JAX package's, iteration counts within 1, both nearer
    the true pose than the start, the final render's touch flags and
    median depth as the JAX package's."""
    jres = jtracking.track_frame(frame["jparams"], frame["jactive"], frame["T_init"],
                                 np.zeros(2, np.float32), frame["image"], frame["depth"], None,
                                 jnp.zeros(3), JStepConfig(**SKW, **variant), JINTR, JRCFG,
                                 use_depth=True)
    tres = tt.track_frame(frame["tparams"], frame["tactive"], frame["T_init"],
                          np.zeros(2, np.float32), torch.tensor(frame["image"]),
                          torch.tensor(frame["depth"]), None, torch.zeros(3),
                          StepConfig(**SKW, **variant), INTR, RCFG, use_depth=True)
    T_j = np.asarray(jres.T_w2c, np.float64)
    T_t = tres.T_w2c.numpy().astype(np.float64)
    rel = np.linalg.inv(T_j) @ T_t
    assert np.linalg.norm(rel[:3, 3]) < 1e-3 and _rot_angle(rel) < 1e-3, (T_j, T_t)
    assert abs(int(jres.n_iters) - tres.n_iters) <= 1, (int(jres.n_iters), tres.n_iters)
    err0 = np.linalg.norm(frame["T_init"][:3, 3] - frame["T_true"][:3, 3])
    for T in (T_j, T_t):
        assert np.linalg.norm(T[:3, 3] - frame["T_true"][:3, 3]) < err0
    np.testing.assert_allclose(tres.exposure_ab.numpy(), np.asarray(jres.exposure_ab),
                               atol=1e-3)
    assert int(tres.compact_dropped) == int(jres.compact_dropped)
    assert tres.n_binned == int(jres.n_binned)
    assert (tres.touched.numpy() != np.asarray(jres.touched)).sum() <= 2
    np.testing.assert_allclose(float(tres.median_depth), float(jres.median_depth), rtol=1e-3)

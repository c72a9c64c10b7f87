"""The monocular path against the JAX package: the bootstrap and pseudo-depth
maps with the noise draws passed in, the monocular visibility prune, the
window's eviction before initialization, the scale-corrected (Sim(3)) ATE,
and one monocular SLAM run through initialization in both packages.

The run is a cut of configs/synthetic/bench_vga.yaml forced monocular:
the 1.5k-Gaussian surface scene of tests/test_torch_slice.py (made by JAX
and handed over as numpy; capacity 4096, init_itr_num 30, mapping_itr_num
10, no working-set compaction), at 64x48 (fx 57.6) with no tracking pyramid
(the 128x96 cut with one pyramid level runs longer on the CPU) and
`window_size` 4 (the bench's 6 fills after ~60 frames; with 3, the prune at
initialization, n_obs <= 3 over 3 slots, empties the map), so that the
window fills and the system initializes by frame ~21. Frames are run as
bench.py runs them: 16, then on in steps of 5 until the frontend and the
backend are initialized. The port replays the JAX package's draws
(keyframe insertion, mapping slot subsets and split noise, bootstrap and
pseudo-depth noise). Bars: both initialize, the same keyframe count +-1,
and both scale-corrected keyframe ATEs under 8 cm (tests/test_system.py's
mono bar). Most of this file's time goes to the JAX package's compiles."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core import frontend as jfe
from monogs_dev_tpu.core import mapping as jm
from monogs_dev_tpu.core.insertion import mono_bootstrap_depth as j_bootstrap
from monogs_dev_tpu.core.insertion import pseudo_depth_map as j_pseudo
from monogs_dev_tpu.core.system import SLAM as JSLAM
from monogs_dev_tpu.eval.ate import ate_rmse as j_ate
from monogs_dev_tpu.models import gaussians as jg
from monogs_dev_tpu.utils.config import load_config
from monogs_dev_tpu_torch.core import frontend as tfe
from monogs_dev_tpu_torch.core import mapping as tm
from monogs_dev_tpu_torch.core.insertion import mono_bootstrap_depth, pseudo_depth_map
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.eval.ate import ate_rmse
from monogs_dev_tpu_torch.models.convert import gaussian_map_from_numpy, gaussian_map_to_numpy
from tests.test_torch_mapping import JaxReplayDraws, assert_maps_close, jmap_to_numpy
from tools.export_synthetic_scene import export_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64


def _depth_render(seed, opaque=True):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 4.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 9.0  # outliers
    depth[:4] = 0.0  # nothing rendered
    opacity = (rng.uniform(0.9, 1.0, (H, W)) if opaque else np.full((H, W), 0.5)).astype(np.float32)
    image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    image[-3:] = 0.0  # invalid RGB
    return depth, opacity, image


@pytest.mark.parametrize("opaque", [True, False], ids=["rendered", "no-valid-pixel"])
def test_pseudo_depth_map_with_draws(opaque):
    depth, opacity, image = _depth_render(0, opaque)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_pseudo(key, jnp.asarray(depth), jnp.asarray(opacity), jnp.asarray(image),
                               jnp.asarray(2.7, jnp.float32), 0.01))
    draws = np.asarray(jax.random.normal(key, (H, W)))
    got = pseudo_depth_map(draws, torch.tensor(depth), torch.tensor(opacity), torch.tensor(image),
                           2.7, 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[-3:].any() and np.isfinite(got).all()
    if not opaque:  # the fallback: a noisy sheet at the running median depth
        assert abs(np.median(got[:-3]) - 2.7) < 0.05


@pytest.mark.parametrize("init", [True, False])
def test_mono_bootstrap_depth_with_draws(init):
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_bootstrap(key, H, W, init=init))
    got = mono_bootstrap_depth(np.asarray(jax.random.normal(key, (H, W))), H, W, init=init,
                               device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a Generator draws its own noise of the same distribution
    own = mono_bootstrap_depth(torch.Generator().manual_seed(0), H, W, init=init, device="cpu")
    assert abs(float(own.mean()) - float(want.mean())) < 0.05


def _kf_map(cap=512, seed=0):
    """A map of 400 rows inserted by keyframes 0, 5, 9 and 14."""
    rng = np.random.default_rng(seed)
    gmap = jg.create_map(cap, 0)
    for kf, n in ((0, 100), (5, 100), (9, 100), (14, 100)):
        params = jg.GaussianParams(
            xyz=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
            f_dc=jnp.asarray(rng.uniform(size=(n, 1, 3)), jnp.float32),
            f_rest=jnp.zeros((n, 0, 3)), log_scales=jnp.full((n, 3), -3.0),
            quats=jnp.tile(jnp.array([[1.0, 0, 0, 0]]), (n, 1)), opacity_logit=jnp.zeros((n,)))
        gmap, _ = jg.insert_points(gmap, params, jnp.ones((n,), bool), kf)
    return gmap


@pytest.mark.parametrize("initialized", [False, True])
@pytest.mark.parametrize("prune_mode", ["slam", "odometry"])
def test_monocular_visibility_prune_matches(prune_mode, initialized):
    gmap = _kf_map()
    rng = np.random.default_rng(1)
    vis = rng.uniform(size=(8, 512)) < 0.55
    valid = np.array([True] * 6 + [False] * 2)
    kf_ids = np.array([14, 9, 5, 0, 3, 2, -1, -1], np.int32)
    want = jm.visibility_prune(gmap, vis, valid, kf_ids, 9, initialized, prune_mode, True)
    got = tm.visibility_prune(gaussian_map_from_numpy(jmap_to_numpy(gmap), "cpu"),
                              torch.tensor(vis), torch.tensor(valid), torch.tensor(kf_ids), 9,
                              initialized, prune_mode, True)
    assert_maps_close(gaussian_map_to_numpy(got), jmap_to_numpy(want))
    assert 0 < int(got.aux.active.sum()) < 400  # some rows pruned, some kept


def test_backend_prune_drops_pruned_rows_from_visibility(config):
    """After a monocular prune the backend's occ-aware visibility (what the
    keyframe policy reads) keeps no pruned row, as the JAX backend's does;
    rows past the map's tier stay as they were."""
    from monogs_dev_tpu_torch.core.backend import BackendEngine
    from monogs_dev_tpu_torch.core.params import MapOptConfig, StepConfig
    from monogs_dev_tpu_torch.core.system import raster_config_from
    from monogs_dev_tpu_torch.models.camera import Intrinsics

    cfg = dict(config, Training=dict(config["Training"], window_size=4))
    engine = BackendEngine(cfg, StepConfig.from_config(cfg), MapOptConfig.from_config(cfg),
                           Intrinsics(115.2, 115.2, 64.0, 48.0, 128, 96),
                           raster_config_from(cfg), capacity=1024, device="cpu")
    gmap = _kf_map()  # 512 rows: a map at half its capacity
    engine.gmap = gaussian_map_from_numpy(jmap_to_numpy(gmap), "cpu")
    engine.current_window = [14, 9, 5, 0]
    rng = np.random.default_rng(4)
    occ = {k: rng.uniform(size=1024) < 0.6 for k in engine.current_window}
    engine.occ_aware_visibility = {k: v.copy() for k, v in occ.items()}
    engine._visibility_prune()
    want = jm.visibility_prune(gmap, np.stack([occ[k][:512] for k in engine.current_window]
                                              + [np.zeros(512, bool)] * 4),
                               np.array([True] * 4 + [False] * 4),
                               np.array([14, 9, 5, 0, -1, -1, -1, -1], np.int32), 5, False,
                               "slam", True)
    assert_maps_close(gaussian_map_to_numpy(engine.gmap), jmap_to_numpy(want))
    pruned = np.asarray(gmap.aux.active) & ~np.asarray(want.aux.active)
    assert pruned.any()
    for k, v in occ.items():
        got = engine.occ_aware_visibility[k]
        np.testing.assert_array_equal(got[:512], v[:512] & ~pruned)
        np.testing.assert_array_equal(got[512:], v[512:])


@pytest.mark.parametrize("initialized", [False, True])
def test_add_to_window_matches(initialized):
    """Before initialization the overlap cutoff is 0.4, not kf_cutoff."""
    rng = np.random.default_rng(2)
    window = [20, 15, 11, 6, 0]
    cur = rng.uniform(size=300) < 0.5
    vis = {k: rng.uniform(size=300) < 0.5 for k in window}  # overlap ~0.5
    # overlap ~0.33 (|cur & vis| / min(|cur|, |vis|)): under 0.4, over 0.25
    vis[6] = (cur & (rng.uniform(size=300) < 0.33)) | ~cur
    poses = {k: np.eye(4) for k in window + [25]}
    for k in poses:
        poses[k][:3, 3] = rng.normal(size=3)
    args = (25, cur, vis, window, poses, 0.25, initialized, 6)
    got, want = tfe.add_to_window(*args), jfe.add_to_window(*args)
    assert got == want
    assert (got[1] == 6) == (not initialized)


def test_sim3_ate_matches():
    """Keyframe ATE with scale correction on a Sim(3)-perturbed trajectory."""
    rng = np.random.default_rng(3)
    gt = []
    for i in range(12):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.02 * np.sin(i), 0.05 * i]
        gt.append(T)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = q * np.sign(np.linalg.det(q))
    s, t = 2.5, np.array([0.3, -1.0, 0.7])
    est = []
    for T in gt:
        c2w = np.linalg.inv(T)
        e = np.eye(4)
        e[:3, :3] = R @ c2w[:3, :3]
        e[:3, 3] = s * R @ c2w[:3, 3] + t + 0.003 * rng.normal(size=3)
        est.append(np.linalg.inv(e))
    got = ate_rmse(est, gt, correct_scale=True)
    assert got == pytest.approx(j_ate(est, gt, correct_scale=True), rel=1e-9)
    assert got < 0.003  # only the noise is left after the Sim(3) alignment
    assert ate_rmse(est, gt) > 0.05  # a rigid alignment cannot undo the scale


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    cfg = load_config(os.path.join(REPO, "configs/synthetic/bench_vga.yaml"))
    cfg["Dataset"].update(n_gaussians=1500, n_frames=40, pcd_downsample=16,
                          pcd_downsample_init=8, sensor_type="monocular")
    cfg["Dataset"]["Calibration"].update(fx=57.6, fy=57.6, cx=32.0, cy=24.0, width=64,
                                         height=48)
    cfg["Training"].update(init_itr_num=30, mapping_itr_num=10, tracking_pyramid_levels=0,
                           window_size=4)
    cfg["TPU"].update(capacity=4096, max_per_tile=128, tile_group=48, track_compact=0)
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    cfg["Dataset"]["scene_file"] = export_scene(cfg, path)
    return cfg


def run_to_init(slam, frontend, engine, cap=36):
    """bench.py's warm-up: 16 frames, then on in steps of 5 until both the
    frontend and the backend are initialized."""
    n = 16
    slam.run(max_frames=n)
    while not (frontend.initialized and engine.initialized) and n < cap:
        n += 5
        slam.run(max_frames=n)
    slam.stop()
    kfs = list(frontend.kf_indices)
    cams = [frontend.cameras[i] for i in kfs]
    ate = ate_rmse([c.T_est for c in cams], [c.T_gt for c in cams], correct_scale=True)
    return frontend.initialized and engine.initialized, kfs, ate


def test_mono_slice_through_initialization_matches_jax(config):
    jslam = JSLAM(config, save_dir=None, seed=0)
    j_init, j_kfs, j_ate_v = run_to_init(jslam, jslam.frontend, jslam.engine)

    slam = SLAM(config, "cpu", seed=0)
    # the JAX backend splits one key per keyframe insertion and per mapping
    # dispatch, in this order; the frontend one per depth map it draws
    state = {"back": jax.random.PRNGKey(0), "front": jax.random.PRNGKey(1)}

    def split(which):
        state[which], k = jax.random.split(state[which])
        return k

    def point_draws():
        k1, k2 = jax.random.split(split("back"))
        shape = (slam.intr.height, slam.intr.width)
        return (np.asarray(jax.random.uniform(k1, shape)),
                np.asarray(jax.random.uniform(k2, shape)))

    slam.engine._point_draws = point_draws
    slam.engine._mapping_draws = lambda: JaxReplayDraws(split("back"))
    slam.frontend._noise_draws = lambda: np.asarray(
        jax.random.normal(split("front"), (slam.intr.height, slam.intr.width)))
    t_init, t_kfs, t_ate = run_to_init(slam, slam.frontend, slam.engine)

    assert j_init and t_init, (j_kfs, t_kfs)
    assert abs(len(t_kfs) - len(j_kfs)) <= 1, (t_kfs, j_kfs)
    assert len(t_kfs) >= 3  # the window filled
    assert j_ate_v < 0.08 and t_ate < 0.08, (t_ate, j_ate_v)
    for cam in slam.frontend.cameras.values():
        assert np.isfinite(cam.T_est).all()

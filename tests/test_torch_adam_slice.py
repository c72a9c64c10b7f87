"""The Adam-tracked slice: the JAX package's `SLAM` and the port's on
configs/synthetic/tiny_rgbd.yaml (Adam tracking, 80x64, 800-Gaussian blob
scene made by JAX and handed over as numpy), 10 frames each, with the JAX
package's random draws replayed in the port.

Bars: the same keyframes; the frames tracked before the first keyframe's
mapping within 5 mm of the JAX package's; from there on, each frame's
distance to the ground truth within 10% of the JAX package's. A per-frame
5 mm bar cannot hold past the first keyframe on this config: its 15 Adam
steps a frame lag the camera by 8 to 75 cm, and the keyframe mapping on
such frames amplifies rounding. The port against itself, with the first
image scaled by (1 + 1e-7), already differs by millimetres at the first
keyframe and by centimetres at frame 9 (`test_tiny_slice_amplifies_rounding`),
so centimetres between the packages there are this config's resolution,
not a fault. The 10% band was set after seeing 0.8-6.5% between the
packages.

The slow tests hold the port to tests/test_system.py's quality bars on the
surface configs (RGB-D ATE under 3 cm on surface_160, monocular under 8 cm
on surface_mono_160); each runs the whole sequence, minutes on a CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core.system import SLAM as JSLAM
from monogs_dev_tpu.utils.config import load_config
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.eval.ate import ate_rmse
from tests.test_torch_mapping import JaxReplayDraws
from tools.export_synthetic_scene import export_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 10


def _config(name, tmp_path_factory):
    cfg = load_config(os.path.join(REPO, "configs/synthetic", name))
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    cfg["Dataset"]["scene_file"] = export_scene(cfg, path)
    return cfg


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    cfg = _config("tiny_rgbd.yaml", tmp_path_factory)
    assert cfg["Training"].get("tracking_solver", "adam") == "adam"
    return cfg


def _positions(fe):
    return {i: np.linalg.inv(np.asarray(c.T_est, np.float64))[:3, 3] for i, c in fe.cameras.items()}


def _replay_run(config, image0_scale=1.0):
    """The port's run with the JAX backend's draws replayed: it splits one
    key per keyframe insertion and per mapping dispatch, in this order
    (tests/test_torch_slice.py). Returns (keyframes, positions)."""
    slam = SLAM(config, "cpu", seed=0)
    state = {"key": jax.random.PRNGKey(0)}

    def split():
        state["key"], k = jax.random.split(state["key"])
        return k

    def point_draws():
        k1, k2 = jax.random.split(split())
        shape = (slam.intr.height, slam.intr.width)
        return (np.asarray(jax.random.uniform(k1, shape)),
                np.asarray(jax.random.uniform(k2, shape)))

    slam.engine._point_draws = point_draws
    slam.engine._mapping_draws = lambda: JaxReplayDraws(split())
    if image0_scale != 1.0:
        color, depth = slam.dataset.render_frame(0)
        slam.dataset._cache[0] = (color * image0_scale, depth)
    slam.run(max_frames=N_FRAMES)
    slam.stop()
    assert len(slam.frontend.cameras) == N_FRAMES
    return list(slam.frontend.kf_indices), _positions(slam.frontend)


@pytest.fixture(scope="module")
def port_run(config):
    return _replay_run(config)


def test_adam_slice_with_replayed_draws_matches_jax(config, port_run):
    jslam = JSLAM(config, save_dir=None, seed=0)
    jslam.run(max_frames=N_FRAMES)
    jslam.stop()
    kfs, pos_t = port_run
    assert kfs == jslam.frontend.kf_indices and len(kfs) >= 2
    pos_j = _positions(jslam.frontend)
    for i in range(N_FRAMES):
        if i < kfs[1]:
            assert np.linalg.norm(pos_t[i] - pos_j[i]) < 0.005, i
        else:
            gt = np.linalg.inv(np.asarray(jslam.frontend.cameras[i].T_gt, np.float64))[:3, 3]
            err_t, err_j = np.linalg.norm(pos_t[i] - gt), np.linalg.norm(pos_j[i] - gt)
            assert abs(err_t - err_j) < 0.1 * err_j, (i, err_t, err_j)


def test_tiny_slice_amplifies_rounding(config, port_run):
    """The port against itself, the first image scaled by (1 + 1e-7): the
    same keyframes, the frames before the first keyframe within 0.1 mm, and
    past it a difference of more than 1 mm (the config's resolution)."""
    kfs, pos = port_run
    kfs_p, pos_p = _replay_run(config, image0_scale=1.0 + 1e-7)
    assert kfs_p == kfs
    diff = [np.linalg.norm(pos[i] - pos_p[i]) for i in range(N_FRAMES)]
    assert max(diff[: kfs[1]]) < 1e-4
    assert max(diff[kfs[1]:]) > 1e-3, diff


def _run_port(cfg):
    slam = SLAM(cfg, "cpu", seed=0)
    slam.run()
    slam.stop()
    fe = slam.frontend
    assert all(np.isfinite(c.T_est).all() for c in fe.cameras.values())
    kfs = fe.kf_indices
    return kfs, ate_rmse([fe.cameras[i].T_est for i in kfs], [fe.cameras[i].T_gt for i in kfs],
                         correct_scale=slam.monocular)


@pytest.mark.slow
def test_surface_rgbd_ate_under_three_cm(tmp_path_factory):
    kfs, ate = _run_port(_config("surface_160.yaml", tmp_path_factory))
    assert len(kfs) >= 5
    assert ate < 0.03, f"surface-scene ATE {ate * 100:.2f} cm >= 3 cm"


@pytest.mark.slow
def test_surface_mono_ate_under_bar(tmp_path_factory):
    kfs, ate = _run_port(_config("surface_mono_160.yaml", tmp_path_factory))
    assert len(kfs) >= 6
    assert ate < 0.08, f"mono surface ATE {ate * 100:.1f} cm >= 8 cm"

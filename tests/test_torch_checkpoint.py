"""Full-state checkpoints (`monogs_dev_tpu_torch/utils/checkpoint.py`) against
the JAX package's (`monogs_dev_tpu/utils/checkpoint.py`).

- Keys: a map state built as tests/test_config_and_io.py builds it (plus
  non-zero Adam moments) written by either package loads in the other with
  every array equal bit for bit, and both write the same keys.
- Whole run: the JAX `SLAM` on tiny_rgbd.yaml runs 8 frames, saves and goes
  on to 12; the port resumes that file and runs to 12 with the JAX
  package's draws replayed from the saved run's state (as
  tests/test_torch_adam_slice.py replays them). Bars: the same keyframes,
  and each frame's distance to the ground truth within that test's 10%
  band of the JAX run's. The resume itself takes one mapping iteration (the
  visibility harvest) that the continuing JAX run does not take, so the
  maps start one Adam step apart.
- Port against port: save, resume in a fresh `SLAM`; alive count,
  keyframes and window equal, `load_map` equal to the saved map and
  trajectory bit for bit, and the next 4 frames finite.
- The CLI: `slam_torch.py --save-checkpoint` writes a file and `--resume`
  continues from it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core.system import SLAM as JSLAM
from monogs_dev_tpu.utils import checkpoint as jck
from monogs_dev_tpu.utils.config import load_config
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.models.convert import gaussian_map_to_numpy
from monogs_dev_tpu_torch.utils import checkpoint as tck
from tests.test_torch_mapping import JaxReplayDraws
from tools.export_synthetic_scene import export_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic", "tiny_rgbd.yaml")


class _Kf:
    def __init__(self, T, exposure):
        self.T_w2c = T
        self.exposure = exposure


class _Engine:
    pass


def _jax_engine():
    from monogs_dev_tpu.models import create_map, insert_points
    from tests.test_gaussian_map import make_batch

    gmap = create_map(16, 0)
    gmap, _ = insert_points(gmap, make_batch(8, jax.random.PRNGKey(0)), jnp.ones(8, bool),
                            kf_id=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    mu = jax.tree_util.tree_map(lambda x: jax.random.normal(k1, x.shape), gmap.params)
    nu = jax.tree_util.tree_map(lambda x: jax.random.uniform(k2, x.shape), gmap.params)
    gmap = gmap._replace(moments=gmap.moments._replace(mu=mu, nu=nu,
                                                       count=jnp.asarray(7, jnp.int32)))
    e = _Engine()
    e.gmap = gmap
    e.iteration_count = 42
    e.current_window = [5, 2]
    e.initialized = True
    e.viewpoints = {2: _Kf(jnp.eye(4), jnp.array([0.1, -0.2])),
                    5: _Kf(jnp.eye(4) * 2.0, jnp.array([0.3, 0.4]))}
    return e


def test_checkpoint_keys_cross_load(tmp_path):
    e = _jax_engine()
    j_path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(j_path, e)
    with np.load(j_path) as z:
        j_arrays = {k: z[k] for k in z.files}

    gmap, host = tck.load_map(j_path, "cpu")
    t_arrays = gaussian_map_to_numpy(gmap)
    t_arrays["moments.count"] = t_arrays.pop("count")
    for k, v in t_arrays.items():
        assert v.dtype == j_arrays[k].dtype and np.array_equal(v, j_arrays[k]), k
    assert host["iteration_count"] == 42 and host["current_window"] == [5, 2]
    assert host["kf_ids"] == [2, 5] and host["initialized"]

    # and back: the port writes, the JAX package reads
    pe = _Engine()
    pe.gmap, pe.iteration_count, pe.current_window = gmap, 42, [5, 2]
    pe.initialized = True
    pe.viewpoints = {i: _Kf(host["kf_T"][n], host["kf_exposure"][n])
                     for n, i in enumerate(host["kf_ids"])}
    t_path = str(tmp_path / "port.npz")
    tck.save_checkpoint(t_path, pe)
    with np.load(t_path) as z:
        assert sorted(z.files) == sorted(j_arrays)
        for k in z.files:
            assert z[k].dtype == j_arrays[k].dtype and np.array_equal(z[k], j_arrays[k]), k
    jmap, jhost = jck.load_map(t_path)
    for group, tree in (("params", jmap.params), ("mu", jmap.moments.mu),
                        ("nu", jmap.moments.nu), ("aux", jmap.aux)):
        for name, arr in zip(tree._fields, tree):
            assert np.array_equal(np.asarray(arr), j_arrays[f"{group}.{name}"]), (group, name)
    assert int(jmap.moments.count) == 7 and jhost["kf_ids"] == [2, 5]


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    cfg = load_config(TINY)
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    cfg["Dataset"]["scene_file"] = export_scene(cfg, path)
    return cfg


def _positions(fe):
    return {i: np.linalg.inv(np.asarray(c.T_est, np.float64))[:3, 3] for i, c in fe.cameras.items()}


def _gt(fe, i):
    return np.linalg.inv(np.asarray(fe.cameras[i].T_gt, np.float64))[:3, 3]


def test_port_resumes_a_jax_checkpoint(config, tmp_path):
    path = str(tmp_path / "jax_ckpt.npz")
    jslam = JSLAM(config, save_dir=None, seed=0)
    jslam.run(max_frames=8)
    key, np_state = jslam.engine.rng, jslam.engine.np_rng.bit_generator.state
    jslam.save_checkpoint(path)
    jslam.run(max_frames=12)
    jslam.stop()
    jfe = jslam.frontend

    slam = SLAM(config, "cpu", seed=0)
    assert slam.resume(path) == 8
    assert slam.frontend.kf_indices == [i for i in jfe.kf_indices if i < 8]
    # from here on, the JAX run's draws: one key per keyframe insertion and
    # per mapping dispatch, and its numpy generator's slot picks
    state = {"key": key}

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
    slam.engine.np_rng.bit_generator.state = np_state
    slam.run(max_frames=12)
    slam.stop()
    fe = slam.frontend
    assert fe.kf_indices == jfe.kf_indices
    pos_t, pos_j = _positions(fe), _positions(jfe)
    for i in range(8, 12):
        err_t = np.linalg.norm(pos_t[i] - _gt(jfe, i))
        err_j = np.linalg.norm(pos_j[i] - _gt(jfe, i))
        assert abs(err_t - err_j) < 0.1 * err_j, (i, err_t, err_j)


def test_port_checkpoint_resumes_in_the_port(config, tmp_path):
    path = str(tmp_path / "port_ckpt.npz")
    slam = SLAM(config, "cpu", seed=0)
    slam.run(max_frames=8)
    assert slam.save_checkpoint(path) == path
    e, fe = slam.engine, slam.frontend
    saved = gaussian_map_to_numpy(e.gmap)
    alive, kfs, window = slam.n_alive(), list(fe.kf_indices), list(e.current_window)
    trj = {i: c.T_est.copy() for i, c in fe.cameras.items()}
    slam.stop()

    gmap, host = tck.load_map(path, "cpu")
    for k, v in gaussian_map_to_numpy(gmap).items():
        assert v.dtype == saved[k].dtype and np.array_equal(v, saved[k]), k
    assert host["trj_ids"] == sorted(trj)
    assert all(np.array_equal(host["trj_est"][n], trj[i]) for n, i in enumerate(sorted(trj)))

    resumed = SLAM(config, "cpu", seed=0)
    assert resumed.resume(path) == 8
    rfe, re_ = resumed.frontend, resumed.engine
    assert resumed.n_alive() == alive
    assert rfe.kf_indices == kfs and re_.current_window == window
    assert rfe.current_window == window and sorted(re_.viewpoints) == sorted(kfs)
    assert sorted(rfe.cameras) == sorted(trj)  # (the harvest moved the window's poses)
    assert set(re_.occ_aware_visibility) == set(window)
    resumed.run(max_frames=12)
    resumed.stop()
    assert sorted(rfe.cameras) == list(range(12))
    assert all(np.isfinite(rfe.cameras[i].T_est).all() for i in range(8, 12))


def test_cli_saves_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")

    def cli(*args):
        proc = subprocess.run([sys.executable, os.path.join(REPO, "slam_torch.py"), "--config",
                               TINY, "--device", "cpu", *args], cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(proc.stdout[proc.stdout.index("{"):])

    first = cli("--max-frames", "4", "--save-checkpoint")
    path = tmp_path / "checkpoint.npz"
    assert path.exists() and first["n_keyframes"] >= 1
    with np.load(path) as z:
        assert int(z["fe_next_frame"]) == 4
    second = cli("--max-frames", "6", "--resume", str(path))
    assert second["n_keyframes"] >= first["n_keyframes"]
    assert np.isfinite(second["ate_cm"])

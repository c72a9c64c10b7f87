"""The port's threaded backend (`TPU.scheduler: thread`), its live mode and
its message protocol, against its inline scheduler and the JAX package.

(a) The same scripted messages (pause, init, three keyframes, colour
    refinement, stop) go to the port's `BackendThread` and to its
    `InlineBackendScheduler` on tiny_rgbd (80x64, capacity 4096): with idle
    rounds paused the two maps and keyframe poses are equal bit for bit.
    The same messages go to the JAX package's `BackendThread`, with the JAX
    draws replayed into the port's thread as tests/test_torch_slice.py
    replays them, on that test's config (a 128x96 cut of bench_vga):
    keyframe positions within that test's 5 mm, the alive count within 2%
    (densify's thresholds on float32 sums in another order). tiny_rgbd is
    no config for that comparison: Adam's 1e-15 epsilon turns rounding-level
    gradients into full steps there (tests/test_torch_adam_slice.py).
(b) tests/test_system.py::TestThreadedMode on the port: tiny_rgbd with both
    single_thread flags off and the thread scheduler reaches a keyframe with
    a live map, and the thread has ended after `stop()`.
(c) An exception inside the backend thread surfaces in `SLAM.run`.
(e) Live mode (`Dataset.type: realsense`): the initial BA runs 50 + 1
    iterations in both packages (300 + 1 otherwise), and keyframe frames
    sleep to at most 3 a second (`time.sleep` patched).

The keyframes are frames 0, 3, 6 and 9 at their ground-truth poses, the
later three moved by a few millimetres.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core import backend as jbackend
from monogs_dev_tpu.core.keyframe import Keyframe as JKeyframe
from monogs_dev_tpu.core.system import SLAM as JSLAM
from monogs_dev_tpu_torch.core import backend as tbackend
from monogs_dev_tpu_torch.core import frontend as tfrontend
from monogs_dev_tpu_torch.core import system as tsystem
from monogs_dev_tpu_torch.core.keyframe import Keyframe
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.models.convert import gaussian_map_to_numpy
from monogs_dev_tpu_torch.utils.config import load_config
from tests.test_torch_mapping import JaxReplayDraws
from tools.export_synthetic_scene import export_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KF_FRAMES = (0, 3, 6, 9)


def tiny_config(**overrides):
    cfg = load_config(os.path.join(REPO, "configs/synthetic/tiny_rgbd.yaml"))
    for key, value in overrides.items():
        group, name = key.split(".")
        cfg[group][name] = value
    return cfg


@pytest.fixture(scope="module")
def parity_config(tmp_path_factory):
    """tests/test_torch_slice.py's config, with the backend run directly."""
    cfg = load_config(os.path.join(REPO, "configs/synthetic/bench_vga.yaml"))
    cfg["Dataset"].update(n_gaussians=1500, n_frames=24, pcd_downsample=16,
                          pcd_downsample_init=8, single_thread=True)
    cfg["Dataset"]["Calibration"].update(fx=115.2, fy=115.2, cx=64.0, cy=48.0, width=128,
                                         height=96)
    cfg["Training"].update(init_itr_num=30, mapping_itr_num=10, tracking_pyramid_levels=1)
    cfg["TPU"].update(capacity=4096, max_per_tile=128, tile_group=48, track_compact=0)
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    cfg["Dataset"]["scene_file"] = export_scene(cfg, path)
    return cfg


def keyframe_frames(cfg):
    """(index, image, depth, pose) numpy of the keyframes, from the port's
    dataset."""
    slam = SLAM(cfg, "cpu", seed=0)
    out = []
    rng = np.random.default_rng(5)
    for i in KF_FRAMES:
        image, depth, pose = slam.dataset[i]
        pose = np.array(pose, np.float32)
        if i:
            pose[:3, 3] += rng.uniform(-0.004, 0.004, 3).astype(np.float32)
        img = image.numpy()
        depth = np.where(img.sum(-1) > 0.01, depth.numpy(), 0.0).astype(np.float32)
        out.append((i, img, depth, pose))
    return out


@pytest.fixture(scope="module")
def frames():
    return keyframe_frames(tiny_config())


def messages(frames, make_kf, to_dev):
    """pause, init, three keyframes, colour refinement, stop."""
    msgs = [["pause"]]
    for n, (i, img, depth, pose) in enumerate(frames):
        kf = make_kf(i, to_dev(img), to_dev(depth), pose)
        if n == 0:
            msgs.append(["init", i, kf, to_dev(depth)])
        else:
            window = [f[0] for f in frames[n::-1]]
            msgs.append(["keyframe", i, kf, window, to_dev(depth)])
    return msgs + [["color_refinement"], ["stop"]]


def port_messages(frames):
    return messages(frames, lambda i, img, d, T: Keyframe(
        idx=i, image=img, depth=d, T_w2c=T, exposure=np.zeros(2, np.float32), T_gt=T),
        torch.from_numpy)


def jax_messages(frames):
    return messages(frames, lambda i, img, d, T: JKeyframe(
        idx=i, image=img, depth=d, T_w2c=T, exposure=np.zeros(2, np.float32), T_gt=T),
        jnp.asarray)


def replay_jax_draws(slam):
    """The JAX engine's draws in the port's engine (tests/test_torch_slice.py)."""
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


def run_scripted(scheduler_cls, msgs, cfg, replay=False):
    """The port's engine (seed 0) behind `scheduler_cls`."""
    slam = SLAM(cfg, "cpu", seed=0)
    if replay:
        replay_jax_draws(slam)
    sched = scheduler_cls(slam.engine)
    sched.start()
    for m in msgs:
        sched.backend_queue.put(m)
    sched.join(timeout=600)
    assert not sched.is_alive()
    replies = []
    while not sched.frontend_queue.empty():
        replies.append(sched.frontend_queue.get_nowait()[0])
    return slam.engine, replies


def test_thread_matches_inline_bit_for_bit(frames):
    engine_t, replies_t = run_scripted(tbackend.BackendThread, port_messages(frames),
                                       tiny_config())
    engine_i, replies_i = run_scripted(tbackend.InlineBackendScheduler, port_messages(frames),
                                       tiny_config())
    assert replies_t == replies_i == ["init", "keyframe", "keyframe", "keyframe",
                                      "sync_backend"]
    a, b = gaussian_map_to_numpy(engine_t.gmap), gaussian_map_to_numpy(engine_i.gmap)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert sorted(engine_t.viewpoints) == list(KF_FRAMES)
    for i in KF_FRAMES:
        assert np.array_equal(engine_t.viewpoints[i].T_w2c, engine_i.viewpoints[i].T_w2c), i
    assert engine_t.iteration_count == engine_i.iteration_count


def test_thread_matches_jax_thread(parity_config):
    frames = keyframe_frames(parity_config)
    jslam = JSLAM(parity_config, save_dir=None, seed=0)
    jthread = jbackend.BackendThread(jslam.engine)
    jthread.start()
    for m in jax_messages(frames):
        jthread.backend_queue.put(m)
    jthread.join(timeout=600)
    assert not jthread.is_alive()
    engine, replies = run_scripted(tbackend.BackendThread, port_messages(frames),
                                   parity_config, replay=True)
    assert len(replies) == 5 and jthread.frontend_queue.qsize() == 5
    je = jslam.engine
    for i in KF_FRAMES:
        p = np.linalg.inv(np.asarray(engine.viewpoints[i].T_w2c, np.float64))[:3, 3]
        q = np.linalg.inv(np.asarray(je.viewpoints[i].T_w2c, np.float64))[:3, 3]
        assert np.linalg.norm(p - q) < 0.005, i
    n_port = int(engine.gmap.aux.active.sum())
    n_jax = int(np.asarray(je.gmap.aux.active).sum())
    assert abs(n_port - n_jax) <= 0.02 * n_jax, (n_port, n_jax)
    assert engine.iteration_count == je.iteration_count


def test_tiny_run_in_thread_mode():
    cfg = tiny_config(**{"Training.single_thread": False, "Dataset.single_thread": False,
                         "TPU.scheduler": "thread"})
    slam = SLAM(cfg, "cpu", seed=0)
    assert isinstance(slam.backend_thread, tbackend.BackendThread)
    slam.run(max_frames=8)
    assert len(slam.frontend.kf_indices) >= 1
    assert slam.n_alive() > 0
    slam.stop()
    assert not slam.backend_thread.is_alive()
    assert slam.backend_thread.handled["init"] == 1
    poses = [c.T_est for c in slam.frontend.cameras.values()]
    assert len(poses) == 8 and all(np.isfinite(T).all() for T in poses)


def test_a_thread_left_running_is_stopped_at_exit():
    """A process that leaves a thread-mode SLAM running exits 0, its backend
    thread stopped and joined by `_stop_at_exit` (registered with atexit).
    The child registers its own exit hook before it imports the port, so
    that hook runs after the port's and reads the thread's state."""
    import subprocess
    import sys

    code = f"""
import atexit, os, sys
sys.path.insert(0, {REPO!r})
seen = {{}}
atexit.register(lambda: print("at exit: alive", seen["bt"].is_alive(),
                              "stops", seen["bt"].handled["stop"], flush=True))
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.utils.config import load_config
cfg = load_config(os.path.join({REPO!r}, "configs/synthetic/tiny_rgbd.yaml"))
cfg["Training"]["single_thread"] = cfg["Dataset"]["single_thread"] = False
cfg["TPU"]["scheduler"] = "thread"
slam = SLAM(cfg, "cpu", seed=0)
slam.run(max_frames=3)
seen["bt"] = slam.backend_thread
assert seen["bt"].is_alive()
print("left running", flush=True)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-2:] == ["left running", "at exit: alive False stops 1"]
    assert "still runs" not in proc.stderr


def test_a_thread_that_outlives_the_exit_join_is_reported(monkeypatch, capsys):
    """A backend thread that does not end within EXIT_JOIN_S of its stop at
    exit (here: held by the caller) is named on stderr, not passed over."""
    cfg = tiny_config(**{"Training.single_thread": False, "Dataset.single_thread": False,
                         "TPU.scheduler": "thread"})
    slam = SLAM(cfg, "cpu", seed=0)
    slam.run(max_frames=2)
    bt = slam.backend_thread
    assert bt in tbackend._STARTED
    monkeypatch.setattr(tbackend, "EXIT_JOIN_S", 0.2)
    with bt.held():
        tbackend._stop_at_exit()
        assert bt.is_alive()
    assert f"backend thread {bt.name} still runs 0.2 s after its stop" in capsys.readouterr().err
    bt.join(60)
    assert not bt.is_alive() and bt.handled["stop"] == 1


def test_evaluate_and_checkpoint_in_thread_mode(tmp_path):
    """The eval tail and a checkpoint with the backend thread live: the
    thread pauses for the eval's renders, refines the colours on its own
    stream and is let go after; the checkpoint holds it between rounds."""
    cfg = tiny_config(**{"Training.single_thread": False, "Dataset.single_thread": False,
                         "TPU.scheduler": "thread"})
    slam = SLAM(cfg, "cpu", seed=0, save_dir=str(tmp_path))
    slam.run(max_frames=6)
    slam.save_checkpoint(str(tmp_path / "ck.npz"))
    assert slam.backend_thread.is_alive()
    res = slam.evaluate(eval_rendering_flag=True)
    assert np.isfinite(res["after_opt"]["mean_psnr"]) and np.isfinite(res["ate"])
    bt = slam.backend_thread
    slam.stop()  # after the "unpause" the eval tail queued
    assert not bt.is_alive()
    assert bt.handled["color_refinement"] == 1
    assert bt.handled["pause"] == bt.handled["unpause"] == 1
    resumed = SLAM(cfg, "cpu", seed=0)
    assert resumed.resume(str(tmp_path / "ck.npz")) == 6


def test_backend_thread_exception_surfaces_in_run(monkeypatch):
    cfg = tiny_config(**{"Training.single_thread": False, "Dataset.single_thread": False,
                         "TPU.scheduler": "thread"})
    slam = SLAM(cfg, "cpu", seed=0)

    def fail(*args, **kwargs):
        raise ValueError("mapping failed")

    monkeypatch.setattr(slam.engine, "handle_init", fail)
    with pytest.raises(RuntimeError, match="backend thread failed") as info:
        slam.run(max_frames=4)
    assert isinstance(info.value.__cause__, ValueError)
    slam.stop()  # reported once: stop() joins without raising it again
    assert not slam.backend_thread.is_alive()


def test_launch_counts_add_up_across_threads():
    """`ops/blend.py::count_launch` from 8 threads with a 1 us switch
    interval: no lost update, by kernel and by thread."""
    import sys
    import threading

    from monogs_dev_tpu_torch.ops import blend as B

    n = 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        B.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [B.count_launch("K1") for _ in range(n)],
                                    name=f"t{i}") for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert B.LAUNCHES["K1"] == 8 * n
        assert all(B.THREAD_LAUNCHES[f"t{i}"]["K1"] == n for i in range(8))
    finally:
        sys.setswitchinterval(old)
        B.reset_launch_counts()


def init_ba_iterations(engine, keyframe_cls, to_dev):
    """The iterations of the initial BA: an uninitialized engine whose
    window fills with this keyframe (insertion and mapping recorded, not
    run)."""
    calls = []
    engine.add_next_kf = lambda *a, **k: None
    engine.map = lambda iters=1, **k: calls.append(iters)
    engine.initialized = False
    w = engine.window_size
    kf = keyframe_cls(idx=w, image=to_dev(np.zeros((2, 2, 3), np.float32)), depth=None,
                      T_w2c=np.eye(4, dtype=np.float32), exposure=np.zeros(2, np.float32),
                      T_gt=np.eye(4, dtype=np.float32))
    engine.handle_keyframe(w, kf, list(range(w, 0, -1)), None, False)
    return calls


@pytest.mark.parametrize("live", [True, False])
def test_live_mode_initial_ba_matches_jax(live):
    cfg = tiny_config()
    slam = SLAM(cfg, "cpu", seed=0)
    jslam = JSLAM(cfg, save_dir=None, seed=0)
    slam.engine.live_mode = live
    jslam.engine.live_mode = live
    want = [51] if live else [301]
    assert init_ba_iterations(jslam.engine, JKeyframe, jnp.asarray) == want
    assert init_ba_iterations(slam.engine, Keyframe, torch.from_numpy) == want


def test_live_mode_wiring_and_keyframe_throttle(monkeypatch):
    """A realsense config (its loader swapped for the synthetic scene, as no
    camera is attached) sets live mode on the engine and the throttle on the
    frontend; each keyframe frame then sleeps max(0.01, 1/3 - its time)."""
    cfg = tiny_config(**{"Dataset.type": "realsense"})
    real_load = tsystem.load_dataset
    synthetic = dict(cfg, Dataset=dict(cfg["Dataset"], type="synthetic"))
    monkeypatch.setattr(tsystem, "load_dataset", lambda c, dev: real_load(synthetic, dev))
    slam = SLAM(cfg, "cpu", seed=0)
    assert slam.live_mode and slam.engine.live_mode and slam.frontend.throttle
    sleeps = []
    monkeypatch.setattr(tfrontend.time, "sleep", sleeps.append)
    slam.run(max_frames=8)
    n_kf = len(slam.frontend.kf_indices) - 1  # frame 0 is the init, not a keyframe frame
    assert n_kf >= 1 and len(sleeps) == n_kf, (sleeps, slam.frontend.kf_indices)
    assert all(0.01 <= s <= 1.0 / 3.0 for s in sleeps), sleeps

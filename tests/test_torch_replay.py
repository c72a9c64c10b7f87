"""The Realsense-replay path against the JAX package, and the port's
fixture-eval tool (`monogs_dev_tpu_torch/tools/run_fixture_evals.py`)
against the JAX tool's rows.

The replay run is `configs/live/realsense_replay.yaml` with the JAX tool's
overrides (tools/run_fixture_evals.py:102-122: 10x position_lr_init from the
config, rebinning every 4 mapping iterations in chunks of 25, dilation 6,
k_dup 8), cut to size as tests/test_torch_mono.py cuts bench_vga: 64x48
(fx 57.6), capacity 2048, max_per_tile 128 (512: the plain blend's cost
on the CPU grows with it), init_itr_num 30, mapping_itr_num 10,
tracking_itr_num 15, window_size 4 (the config's 8 fills after far more
frames), on a 24-frame sequence of the replay writer's orbit (ease-in,
sweep 0.4) written by the port's writer and read
by both packages' `RealsenseReplayDataset` (identity poses). Frames are run
as bench.py runs them: 16, then on in steps of 5 until the frontend and the
backend are initialized. The port replays the JAX package's draws. Bars:
both initialize, by the same frame +-5, the same keyframe count +-1, finite
poses, no reset after initialization, and both Sim(3)-aligned keyframe
ATEs against the writer's `gt_poses.npy` under 8 cm (tests/test_system.py's
mono bar) and within 2 cm of each other. Both then run on to the same frame
and the eval renders its frames (every 5th, keyframes left out): the same
frames, mean PSNR within 1 dB and SSIM within 0.03 of JAX's (the path's
PSNR is low in both, ~14 dB at this size: the map of a monocular start on
a slow orbit).

The tool runs end to end with `--device cpu` on both rows at a tiny size
(stereo 128x96, replay 64x48, 7 frames each) with short Training budgets
and a keyframe interval of 6 (so that frame 5, which the eval renders, is
not a keyframe): both rows print, with exactly the
JAX tool's keys (tools/run_fixture_evals.py:76-88, :130-140) and finite
values after the card's line and the wall seconds, the eval artifacts
land under `--out`, and a second run reads the sequences back."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core.system import SLAM as JSLAM
from monogs_dev_tpu.eval.rendering import eval_rendering as j_eval_rendering
from monogs_dev_tpu.utils.config import load_config
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.eval.ate import ate_rmse
from monogs_dev_tpu_torch.tools import make_fixtures as mf
from monogs_dev_tpu_torch.tools import run_fixture_evals as rfe
from tests.test_torch_mapping import JaxReplayDraws

torch.set_num_threads(2)

W, H, N_FRAMES = 64, 48, 24
STEREO_KEYS = ["ate_cm", "psnr_before", "psnr_after", "ssim", "n_keyframes", "n_gaussians", "fps"]
REPLAY_KEYS = ["psnr_before", "psnr_after", "ssim", "n_keyframes", "n_gaussians", "fps"]


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    seq = str(tmp_path_factory.mktemp("replay") / "seq")
    params, active = mf.load_params(mf.REPLAY_SCENE, "cpu")
    ds_cfg = mf.write_replay(seq, params, active, n_frames=N_FRAMES, w=W, h=H)
    cfg = load_config(rfe.REPLAY_CONFIG)
    cfg["Dataset"]["dataset_path"] = seq
    cfg["Dataset"]["Calibration"].update(ds_cfg["Calibration"])
    cfg["TPU"].update(rfe.REPLAY_TPU)
    cfg["TPU"].update(capacity=2048, max_per_tile=128)
    cfg["Training"].update(init_itr_num=30, mapping_itr_num=10, tracking_itr_num=15,
                           window_size=4)
    return cfg, np.load(os.path.join(seq, "gt_poses.npy"))


def run_to_init(slam, frontend, engine, gt, cap=N_FRAMES):
    """bench.py's warm-up: 16 frames, then on in steps of 5 until both the
    frontend and the backend are initialized. Returns (initialized, the
    frame count run, keyframes, Sim(3) keyframe ATE, frames reset at)."""
    resets = []
    initialize = frontend.initialize

    def counting_initialize(idx, *args):
        resets.append(idx)
        return initialize(idx, *args)

    frontend.initialize = counting_initialize
    n = 16
    slam.run(max_frames=n)
    while not (frontend.initialized and engine.initialized) and n < cap:
        n += 5
        slam.run(max_frames=n)
    kfs = list(frontend.kf_indices)
    ate = ate_rmse([frontend.cameras[i].T_est for i in kfs], [gt[i] for i in kfs],
                   correct_scale=True)
    for cam in frontend.cameras.values():
        assert np.isfinite(cam.T_est).all()
    return frontend.initialized and engine.initialized, n, kfs, ate, resets[1:]


def test_replay_path_through_initialization_matches_jax(replay):
    cfg, gt = replay
    jslam = JSLAM(cfg, save_dir=None, seed=0)
    assert type(jslam.dataset).__name__ == "RealsenseReplayDataset"
    j_init, j_n, j_kfs, j_ate, j_resets = run_to_init(jslam, jslam.frontend, jslam.engine, gt)

    slam = SLAM(cfg, "cpu", seed=0)
    assert type(slam.dataset).__name__ == "RealsenseReplayDataset"
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
    t_init, t_n, t_kfs, t_ate, t_resets = run_to_init(slam, slam.frontend, slam.engine, gt)
    # both on to the same frame, then the eval's rendering metrics
    m = max(j_n, t_n)
    jslam.run(max_frames=m)
    slam.run(max_frames=m)
    jslam.stop()
    slam.stop()
    e, fe = jslam.engine, jslam.frontend
    j_eval = j_eval_rendering(fe.cameras, jslam.dataset, e.gmap.params, e.gmap.aux.active,
                              jslam.intr, jslam.raster_cfg, jslam.step_cfg.sh_degree, None,
                              fe.kf_indices)
    t_eval = slam._eval_rendering("final")

    print(f"JAX: frames {j_n}, keyframes {j_kfs}, ATE {j_ate}, eval {j_eval}; port: frames "
          f"{t_n}, keyframes {t_kfs}, ATE {t_ate}, eval {t_eval}")
    assert j_init and t_init, (j_kfs, t_kfs)
    assert abs(t_n - j_n) <= 5, (t_n, j_n)
    assert abs(len(t_kfs) - len(j_kfs)) <= 1, (t_kfs, j_kfs)
    assert len(t_kfs) >= 4  # the window filled
    assert j_ate < 0.08 and t_ate < 0.08, (t_ate, j_ate)
    assert abs(t_ate - j_ate) < 0.02, (t_ate, j_ate)
    init_frame = t_kfs[3]  # the window of 4 filled here
    assert all(r < init_frame for r in t_resets), (t_resets, t_kfs)
    assert t_eval["n_frames"] == j_eval["n_frames"] >= 1
    assert abs(t_eval["mean_psnr"] - j_eval["mean_psnr"]) < 1.0, (t_eval, j_eval)
    assert abs(t_eval["mean_ssim"] - j_eval["mean_ssim"]) < 0.03, (t_eval, j_eval)


def _short_budgets(path):
    """The row's config with short budgets, and no keyframe before frame 6
    (kf_interval 6; 5 in both configs), so that frame 5, the one the eval
    renders in a 7-frame run, is not a keyframe."""
    cfg = load_config(path)
    cfg["Training"].update(init_itr_num=20, mapping_itr_num=5, tracking_itr_num=10,
                           kf_interval=6)
    return cfg


def test_fixture_eval_tool_prints_both_rows(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(rfe, "_base_config", _short_budgets)
    monkeypatch.setattr(rfe, "REFINEMENT_ITERS", 10)
    out = str(tmp_path / "evals")
    args = ["--frames", "7", "--device", "cpu", "--out", out]
    assert rfe.main(["stereo", "--size", "128x96"] + args) == 0
    assert rfe.main(["replay", "--size", "64x48"] + args) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = {}
    for tag, keys in (("STEREO ROW ", STEREO_KEYS), ("REPLAY ROW ", REPLAY_KEYS)):
        (line,) = [ln for ln in lines if ln.startswith(tag)]
        row = json.loads(line[len(tag):])
        assert list(row) == keys
        assert all(np.isfinite(v) for v in row.values()), row
        rows[tag] = row
        at = lines.index(line)
        assert lines[at - 2] == "device: cpu" and " wall seconds: " in lines[at - 1]
    assert rows["STEREO ROW "]["n_keyframes"] >= 1
    for name in ("euroc_128x96_n7", "replay_64x48_n7"):
        # a second run reads the sequence's Dataset group back, writing nothing
        ds_cfg = rfe._fixture(out, name, write=None)
        assert ds_cfg["dataset_path"] == os.path.join(out, name)
        assert ds_cfg["Calibration"]["width"] == (128 if name.startswith("euroc") else 64)
    for name in ("euroc_fixture_eval", "replay_fixture_eval"):
        assert os.path.exists(os.path.join(out, name, "psnr", "after_opt"))


def test_fixture_eval_tool_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        rfe.main(["replay", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)

"""The map's capacity tiers at a run's scale, in the port against the JAX
package, and the scale-pressure config (configs/synthetic/scale_vga.yaml).

- Growth under insert pressure (the port's side of
  tests/test_system.py::test_grow_back_under_insert_pressure): both
  packages run configs/synthetic/tiny_rgbd.yaml to frame 10 (the port with
  the JAX package's random draws replayed, as tests/test_torch_adam_slice.py
  runs it), compact the map to the same tight tier (the power of two above
  the alive rows plus 8) with the visibility remapped, and run on to frame
  30. Both grow the map back to its capacity at the insert of the first
  keyframe after the compaction, with finite poses. That keyframe comes at
  frame 18 in the port and 27 in the JAX package, and does so without the
  compaction too: the tiny slice's known divergence past its first
  keyframes (ROADMAP Queue 3, "Not faults") moves it, so the growing
  keyframe is the same by its place, not by its frame.
- scale_vga.yaml through the port's `load_config` and `SLAM` (its
  `BackendEngine`), no frame run: capacity 131,072, the small tier 65,536,
  the densify budgets 8,192 / 4,096, the point downsampling 32 / 16, the
  240-frame ease-in sweep at 640x480 and the committed 24,000-Gaussian
  surface scene with its extents 9.0 / 4.0. The fixture-eval tool's scale
  row is tested in tests/test_torch_scale_row.py."""

import os

import jax
import numpy as np
import torch

from monogs_dev_tpu.core.backend import _next_pow2 as j_next_pow2
from monogs_dev_tpu.core.system import SLAM as JSLAM
from monogs_dev_tpu.models.gaussians import compact_map as j_compact_map
from monogs_dev_tpu.utils.config import load_config as j_load_config
from monogs_dev_tpu_torch.core.backend import _next_pow2
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.models.gaussians import compact_map
from monogs_dev_tpu_torch.utils.config import load_config
from tests.test_torch_mapping import JaxReplayDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic", "tiny_rgbd.yaml")
SCALE = os.path.join(REPO, "configs", "synthetic", "scale_vga.yaml")
COMPACT_AT, RUN_TO = 10, 30


def _record_grows(engine):
    """Wrap `add_next_kf` to list the frames whose insert grew the map."""
    grows = []
    add = engine.add_next_kf

    def recording(frame_idx, *args, **kw):
        before = engine.telemetry["map_grows"]
        out = add(frame_idx, *args, **kw)
        if engine.telemetry["map_grows"] > before:
            grows.append(frame_idx)
        return out

    engine.add_next_kf = recording
    return grows


def _compact(engine, compact, next_pow2, to_numpy):
    """Compact the map to the tight tier, remapping the visibility as the
    JAX test does; returns the tier."""
    alive = int(to_numpy(engine.gmap.aux.active).sum())
    tight = next_pow2(alive + 8)
    engine.gmap, perm = compact(engine.gmap, tight)
    perm = to_numpy(perm)
    for k, v in list(engine.occ_aware_visibility.items()):
        out = np.zeros(engine.capacity, bool)
        out[:tight] = np.asarray(v)[perm[:tight]]
        engine.occ_aware_visibility[k] = out
    return tight


def _port_slam(cfg):
    """The port's SLAM with the JAX backend's draws replayed
    (tests/test_torch_adam_slice.py::_replay_run)."""
    slam = SLAM(cfg, "cpu", seed=0)
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
    return slam


def _grow_run(slam, compact, next_pow2, to_numpy):
    e = slam.engine
    grows = _record_grows(e)
    slam.run(max_frames=COMPACT_AT)
    assert e.telemetry["map_grows"] == 0 and not grows
    tight = _compact(e, compact, next_pow2, to_numpy)
    assert tight < e.capacity and int(to_numpy(e.gmap.aux.active).shape[0]) == tight
    slam.run(max_frames=RUN_TO)
    slam.stop()
    cams = slam.frontend.cameras
    assert len(cams) == RUN_TO
    assert all(np.isfinite(np.asarray(c.T_est)).all() for c in cams.values())
    assert e.telemetry["map_grows"] >= 1 and grows
    assert int(to_numpy(e.gmap.aux.active).shape[0]) == e.capacity
    return tight, grows, list(slam.frontend.kf_indices)


def test_grow_back_under_insert_pressure_matches_jax():
    jslam = JSLAM(j_load_config(TINY), save_dir=None, seed=0)
    j_tight, j_grows, j_kfs = _grow_run(jslam, j_compact_map, j_next_pow2, np.asarray)
    t_tight, t_grows, t_kfs = _grow_run(_port_slam(load_config(TINY)), compact_map, _next_pow2,
                                        lambda x: x.cpu().numpy())
    print(f"tier {t_tight} (JAX {j_tight}); grown at frames {t_grows} (JAX {j_grows}); "
          f"keyframes {t_kfs} (JAX {j_kfs})")
    assert t_tight == j_tight
    assert t_kfs[:4] == j_kfs[:4] == [k for k in j_kfs if k < COMPACT_AT]
    assert t_grows[0] == t_kfs[4] and j_grows[0] == j_kfs[4]


def test_scale_config_loads_at_its_width():
    cfg = load_config(SCALE)
    slam = SLAM(cfg, "cpu", seed=0)
    e, ds = slam.engine, slam.dataset
    assert e.capacity == 131072 and e.tier_small == 65536 and e.map_rows() == 131072
    assert (e.cfg.densify_clone_budget, e.cfg.densify_split_budget) == (8192, 4096)
    assert (e.pcd_downsample, e.pcd_downsample_init) == (32, 16)
    assert (ds.width, ds.height, len(ds)) == (640, 480, 240)
    assert int(cfg["Training"]["refinement_itr_num"]) == 200
    assert cfg["Dataset"]["profile"] == "ease_in" and float(cfg["Dataset"]["sweep"]) == 1.1
    x, y, _ = ds.scene_params.xyz.unbind(-1)
    assert ds.scene_params.xyz.shape == (24000, 3)
    assert 8.99 < float(x.abs().max()) <= 9.0 and 3.99 < float(y.abs().max()) <= 4.0
    assert not slam.frontend.cameras and int(e.gmap.aux.active.sum()) == 0
    slam.stop()

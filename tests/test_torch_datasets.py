"""The port's loaders (`monogs_dev_tpu_torch/data/`) against the JAX
package's (`monogs_dev_tpu/data/datasets.py`), which read with PIL and cv2.

- Loaders: the same length, paths and poses (atol 1e-12), and images and
  depths equal bit for bit on the CPU, on the committed `tum_surface`, on
  TUM, Replica (JPEG: PIL's decode against the port's) and replay (PNG and
  JPEG frames) directories built as `tests/test_datasets.py` builds them,
  on a Replica directory from the port's writer, on a distorted TUM camera, and on a
  EuRoC directory from the port's writer (160x120, 6 frames). EuRoC depth
  comes from the matcher, which equals cv2's bit for bit there, so the
  depths are equal too; the matcher equals cv2 at every uniqueness ratio
  from 0 to 80 (`data/stereo.py`'s docstring).
- Maps: the undistort and rectify maps within 1e-3 px of
  `cv2.initUndistortRectifyMap` on configs/stereo/euroc/mh02.yaml's two eyes
  and configs/rgbd/tum/fr1_desk.yaml; remapped uint8 images within 1 level
  of `cv2.remap` on >= 99% of pixels.
- Stereo: on the port's EuRoC pair, the JAX test's bars
  (tests/test_datasets.py:306-309): valid share > 0.15 and median relative
  error < 0.1 against `render_median_depth`; the port's disparity equal
  to cv2's on every pixel; a block texture shifted by 16 px gives 16 px;
  `median3x3` equal to `cv2.medianBlur(int16, 3)` bit for bit, borders and
  -16 values included.
- `render_median_depth` within 1e-4 m of the JAX one on >= 99.5% of pixels.
- The TUM writer against the JAX package's `render_tiled` and
  `render_median_depth` with the same scene: colour equal on >= 99.9% of
  values and within 1 level elsewhere, uint16 depth within 1 unit on
  >= 99.5% of pixels.
- Scenes: every config under configs/synthetic/ (and surface_160 at seeds 1
  and 2) finds its committed scene npz, with the generator settings the
  config asks for, and the npz holds the JAX package's scene.
"""

import glob
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from monogs_dev_tpu.data import datasets as J
from monogs_dev_tpu.utils.config import DotDict, load_config
from monogs_dev_tpu_torch.data import camera_maps
from monogs_dev_tpu_torch.data import datasets as T
from monogs_dev_tpu_torch.data import stereo
from monogs_dev_tpu_torch.data.image_io import read_png
from monogs_dev_tpu_torch.data.stereo import INVALID, median3x3, sgbm_disparity
from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.ops.rasterize import render_median_depth
from monogs_dev_tpu_torch.tools import make_fixtures as mf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(SCENE_DIR, "surface_seed0_n6000.npz")


def _calib(w=32, h=24, depth_scale=5000.0):
    return {"fx": 30.0, "fy": 30.0, "cx": w / 2, "cy": h / 2, "k1": 0.0, "k2": 0.0, "p1": 0.0,
            "p2": 0.0, "k3": 0.0, "width": w, "height": h, "depth_scale": depth_scale,
            "distorted": False}


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _cfg(dtype, path, calib, **extra):
    return DotDict.wrap({"Dataset": {"type": dtype, "dataset_path": path, "Calibration": calib,
                                     **extra}})


def _assert_same(cfg, idxs=None, depth_equal=True):
    """The two packages' loaders on one config: length, paths, poses,
    images and (optionally) depths."""
    j, t = J.load_dataset(cfg), T.load_dataset(cfg, "cpu")
    assert len(j) == len(t) > 0
    assert j.color_paths == t.color_paths
    assert getattr(j, "depth_paths", None) == getattr(t, "depth_paths", None)
    for i in range(len(j)) if idxs is None else idxs:
        (ij, dj, pj), (it, dt, pt) = j[i], t[i]
        assert it.dtype == torch.float32 and it.device.type == "cpu"
        assert np.abs(pj - pt).max() <= 1e-12
        assert np.array_equal(ij, it.numpy()), i
        if depth_equal:
            assert (dj is None) == (dt is None)
            if dj is not None:
                assert dt.dtype == torch.float32 and np.array_equal(dj, dt.numpy()), i
    return j, t


def test_tum_fixture_matches_jax():
    cal = _calib(w=160, h=120)
    cal.update(fx=144.0, fy=144.0)
    _assert_same(_cfg("tum", os.path.join(REPO, "tests", "fixtures", "tum_surface"), cal))


def test_tum_fixture_distorted_matches_jax():
    """fr1_desk's distortion on the fixture's frames: the remap on uint8
    before the float conversion, as the JAX loader does."""
    cal = _calib(w=160, h=120)
    cal.update(fx=144.0, fy=144.0, k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
               k3=1.163314, distorted=True)
    cfg = _cfg("tum", os.path.join(REPO, "tests", "fixtures", "tum_surface"), cal)
    j, t = J.load_dataset(cfg), T.load_dataset(cfg, "cpu")
    for i in (0, 41):
        (ij, dj, _), (it, dt, _) = j[i], t[i]
        diff = np.abs(np.rint(ij * 255) - np.rint(it.numpy() * 255))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        assert np.array_equal(dj, dt.numpy())


@pytest.fixture
def tum_dir(tmp_path):
    """tests/test_datasets.py's TUM directory: comment lines in every text
    file, groundtruth.txt with two."""
    root = tmp_path / "tum"
    rng = np.random.default_rng(0)
    rgb_lines, depth_lines, gt_lines = [], ["# depth"], ["# gt", "# cols"]
    for i in range(6):
        ts = 100.0 + i * 0.1
        _write_png(str(root / "rgb" / f"{ts:.4f}.png"),
                   rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
        _write_png(str(root / "depth" / f"{ts:.4f}.png"),
                   (rng.uniform(0.5, 3.0, (24, 32)) * 5000).astype(np.uint16))
        rgb_lines.append(f"{ts:.4f} rgb/{ts:.4f}.png")
        depth_lines.append(f"{ts:.4f} depth/{ts:.4f}.png")
        gt_lines.append(f"{ts:.4f} {0.1 * i} 0.0 0.0 0.0 0.0 0.0 1.0")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(depth_lines))
    (root / "groundtruth.txt").write_text("\n".join(gt_lines))
    return str(root)


def test_tum_directory_matches_jax(tum_dir):
    j, t = _assert_same(_cfg("tum", tum_dir, _calib()))
    assert len(t) == 6
    np.testing.assert_allclose(t[2][2][:3, 3], [-0.2, 0.0, 0.0], atol=1e-6)


def test_tum_subsampling_at_32hz_matches_jax(tmp_path):
    """Frames 10 ms apart: the 32 Hz subsampling keeps every fourth."""
    root = tmp_path / "tum"
    rng = np.random.default_rng(4)
    lines = {"rgb": [], "depth": [], "gt": ["# gt"]}
    for i in range(12):
        ts = 5.0 + 0.01 * i
        for kind, arr in (("rgb", rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)),
                          ("depth", rng.integers(0, 9000, (8, 8)).astype(np.uint16))):
            _write_png(str(root / kind / f"{ts:.3f}.png"), arr)
            lines[kind].append(f"{ts:.3f} {kind}/{ts:.3f}.png")
        lines["gt"].append(f"{ts:.3f} 0.0 {0.01 * i} 0.0 0.0 0.0 0.0 1.0")
    for kind, name in (("rgb", "rgb.txt"), ("depth", "depth.txt"), ("gt", "groundtruth.txt")):
        (root / name).write_text("\n".join(lines[kind]))
    j, t = _assert_same(_cfg("tum", str(root), _calib(8, 8)))
    assert len(t) == 3


def test_replica_directory_matches_jax(tmp_path):
    root = tmp_path / "replica"
    rng = np.random.default_rng(1)
    lines = []
    for i in range(4):
        _write_png(str(root / "results" / f"frame{i:06d}.jpg"),
                   rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
        _write_png(str(root / "results" / f"depth{i:06d}.png"),
                   (rng.uniform(0.5, 3.0, (24, 32)) * 6553.5).astype(np.uint16))
        c2w = np.eye(4)
        c2w[:3, 3] = [0.0, 0.1 * i, 0.0]
        lines.append(" ".join(str(v) for v in c2w.reshape(-1)))
    (root / "traj.txt").write_text("\n".join(lines))
    j, t = _assert_same(_cfg("replica", str(root), _calib(depth_scale=6553.5)))
    np.testing.assert_allclose(t[3][2][:3, 3], [0.0, -0.3, 0.0], atol=1e-6)


def test_replica_writer_directory_matches_jax(tmp_path):
    """`write_replica`'s layout (the port's JPEG encoder, 16-bit depth at
    Replica's depth_scale, flat C2W rows) through both packages' Replica
    loaders: images (PIL's decode against the port's) and depths equal."""
    params, active = mf.load_params(SCENE, "cpu")
    intr = Intrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80, height=60)
    poses = mf.orbit(3, n=48, sweep=0.45)
    mf.write_replica(str(tmp_path / "replica"), params, active, intr, poses, depth_scale=6553.5)
    assert sorted(os.listdir(tmp_path / "replica" / "results")) == [
        "depth000000.png", "depth000001.png", "depth000002.png", "frame000000.jpg",
        "frame000001.jpg", "frame000002.jpg"]
    cal = _calib(80, 60, depth_scale=6553.5)
    j, t = _assert_same(_cfg("replica", str(tmp_path / "replica"), cal))
    for i in range(3):
        assert np.allclose(t.poses[i], poses[i], atol=1e-9)
        assert float((t[i][1] > 0).float().mean()) > 0.5


def test_replay_directory_of_jpeg_frames_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for i in range(3):
        _write_png(str(tmp_path / "color" / f"{i:05d}.jpg"),
                   rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    calib = _calib()
    del calib["depth_scale"]
    j, t = _assert_same(_cfg("realsense_replay", str(tmp_path), calib))
    assert t.color_paths[0].endswith(".jpg") and t[0][1] is None


def test_replay_directory_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for i in range(3):
        _write_png(str(tmp_path / "color" / f"{i:05d}.png"),
                   rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    calib = _calib()
    del calib["depth_scale"]
    j, t = _assert_same(_cfg("realsense_replay", str(tmp_path), calib))
    assert t[0][1] is None and np.array_equal(t[0][2], np.eye(4))


def test_replay_writer_reads_back(tmp_path):
    params, active = mf.load_params(SCENE, "cpu")
    ds_cfg = mf.write_replay(str(tmp_path / "replay"), params, active, n_frames=3, w=64, h=48)
    t = T.load_dataset(DotDict.wrap({"Dataset": ds_cfg}), "cpu")
    j = J.load_dataset(DotDict.wrap({"Dataset": ds_cfg}))
    assert len(t) == 3 and np.array_equal(j[2][0], t[2][0].numpy())
    assert np.load(str(tmp_path / "replay" / "gt_poses.npy")).shape == (3, 4, 4)


def test_replay_scene_is_the_jax_replay_writers():
    """The replay layout's default scene (`make_fixtures.REPLAY_SCENE`) is
    what tools/make_replay_fixture.py renders, make_surface_scene(PRNGKey(2),
    n=12000, scale=0.03), field for field, and `load_params` reads it so."""
    import jax

    from monogs_dev_tpu.data.synthetic import make_surface_scene

    ref, _ = make_surface_scene(jax.random.PRNGKey(2), n=12000, scale=0.03)
    with np.load(mf.REPLAY_SCENE) as z:
        arrays = dict(z)
    assert float(arrays["gaussian_scale"]) == np.float32(0.03)
    params, active = mf.load_params(mf.REPLAY_SCENE, "cpu")
    assert bool(active.all()) and active.shape == (12000,)
    for name, value in ref._asdict().items():
        np.testing.assert_array_equal(arrays[f"params.{name}"], np.asarray(value, np.float32))
        np.testing.assert_array_equal(getattr(params, name).numpy(), np.asarray(value))


def test_fixture_writer_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "replay")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mf.main(["replay", out, "--frames", "2", "--size", "32x24"])
    assert not os.path.exists(out)
    assert mf.main(["replay", out, "--frames", "2", "--size", "32x24", "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(out, "color"))) == ["000000.png", "000001.png"]


@pytest.fixture(scope="module")
def euroc(tmp_path_factory):
    params, active = mf.load_params(SCENE, "cpu")
    root = str(tmp_path_factory.mktemp("euroc"))
    ds_cfg = mf.write_euroc(root, params, active, n_frames=6, w=160, h=120)
    cfg = _cfg("euroc", ds_cfg["dataset_path"], ds_cfg["Calibration"], sensor_type="stereo")
    return cfg, params, active


def test_euroc_writer_and_loader_match_jax(euroc):
    cfg = euroc[0]
    j, t = _assert_same(cfg, idxs=(0, 3), depth_equal=False)
    assert len(t) == 6 and t.color_paths_r == j.color_paths_r
    from monogs_dev_tpu_torch.data.synthetic import orbit_pose

    for i in (0, 5):  # the ground truth through the body-to-cam0 chain
        assert np.allclose(t.poses[i], orbit_pose(i, 40, sweep=0.45), atol=1e-5)
    for i in (1, 4):
        dj, dt = j[i][1], t[i][1].numpy()
        left = cv2.imread(j.color_paths[i], 0)
        right = cv2.imread(j.color_paths_r[i], 0)
        lt, rt = t.rectified_pair(i)
        assert np.array_equal(lt.numpy(), left) and np.array_equal(rt.numpy(), right)
        sg = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
        sg.setUniquenessRatio(40)
        assert np.array_equal(sg.compute(left, right), sgbm_disparity(lt, rt).numpy())
        assert np.array_equal(dj, dt)


@pytest.mark.parametrize("ratio", [0, 10, 15, 20, 25, 30, 35, 40, 45, 50, 60, 80])
def test_matcher_with_a_loose_uniqueness_test_equals_cv2(euroc, ratio):
    """At every uniqueness ratio, from off (0) and loose (10) to strict
    (80), the port's disparity is cv2's bit for bit: costs, paths and their
    int16 saturation, the uniqueness test, sub-pixel step, left-right check
    and median."""
    t = T.load_dataset(euroc[0], "cpu")
    sg = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
    sg.setUniquenessRatio(ratio)
    for i in (1, 4):
        lt, rt = t.rectified_pair(i)
        assert np.array_equal(sg.compute(lt.numpy(), rt.numpy()),
                              sgbm_disparity(lt, rt, uniqueness_ratio=ratio).numpy())


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (2, 3), (5, 1), (9, 11), (120, 160)])
def test_median_matches_cv2_median_blur(shape):
    """`median3x3` against `cv2.medianBlur(int16, 3)` bit for bit: replicated
    borders, runs of invalid (-16) values, the first NUM_DISP columns."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(-16, 1100, shape).astype(np.int16)
    img[rng.random(shape) < 0.3] = INVALID
    img[:, :min(shape[1], stereo.NUM_DISP) // 2] = INVALID
    got = median3x3(torch.from_numpy(img.astype(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), cv2.medianBlur(img, 3))


def _euroc_eye_maps(eye):
    c = load_config(os.path.join(REPO, "configs/stereo/euroc/mh02.yaml"))["Dataset"]["Calibration"]
    raw, opt = c[eye]["raw"], c[eye]["opt"]
    K = np.array([[raw["fx"], 0, raw["cx"]], [0, raw["fy"], raw["cy"]], [0, 0, 1.0]])
    K_opt = np.array([[opt["fx"], 0, opt["cx"]], [0, opt["fy"], opt["cy"]], [0, 0, 1.0]])
    R = np.array(c[eye]["R"]["data"]).reshape(3, 3)
    d = np.array([raw[k] for k in ("k1", "k2", "p1", "p2", "k3")])
    return (K, d, R, K_opt, (c["width"], c["height"]))


def _fr1_desk_maps():
    c = load_config(os.path.join(REPO, "configs/rgbd/tum/fr1_desk.yaml"))["Dataset"]["Calibration"]
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1.0]])
    d = np.array([c[k] for k in ("k1", "k2", "p1", "p2", "k3")])
    return (K, d, np.eye(3), K, (c["width"], c["height"]))


@pytest.mark.parametrize("camera", ["mh02_cam0", "mh02_cam1", "fr1_desk"])
def test_maps_and_remap_match_cv2(camera):
    args = _fr1_desk_maps() if camera == "fr1_desk" else _euroc_eye_maps(camera[5:])
    mx, my = cv2.initUndistortRectifyMap(*args, cv2.CV_32FC1)
    px, py = camera_maps.init_undistort_rectify_map(*args)
    assert np.abs(px - mx).max() <= 1e-3 and np.abs(py - my).max() <= 1e-3
    w, h = args[-1]
    rng = np.random.default_rng(3)
    plan = camera_maps.remap_plan(px, py, "cpu")
    for img in (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)):
        ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR).astype(np.int64)
        out = camera_maps.remap_linear(torch.from_numpy(img), plan).numpy().astype(np.int64)
        diff = np.abs(out - ref)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_stereo_depth_on_the_euroc_pair(euroc):
    cfg, params, active = euroc
    t = T.load_dataset(cfg, "cpu")
    image, depth, pose = t[1]
    gt = render_median_depth(params, active, torch.as_tensor(pose, dtype=torch.float32),
                             Intrinsics(144.0, 144.0, 80.0, 60.0, 160, 120),
                             RasterConfig(max_per_tile=512, k_dup=16)).numpy()
    depth = depth.numpy()
    valid = (depth > 0.1) & (depth < 10.0) & (gt > 0.1)
    assert valid.mean() > 0.15
    rel = np.abs(depth[valid] - gt[valid]) / gt[valid]
    assert np.median(rel) < 0.1
    lt, rt = t.rectified_pair(1)
    sg = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
    sg.setUniquenessRatio(40)
    ref = sg.compute(lt.numpy(), rt.numpy()).astype(np.int64)
    mine = sgbm_disparity(lt, rt).numpy().astype(np.int64)
    assert ((ref >= 0) & (mine >= 0)).mean() > 0.15
    assert np.array_equal(ref, mine)


def test_stereo_matcher_finds_a_known_shift():
    """tests/test_datasets.py's block texture shifted by 16 px."""
    rng = np.random.default_rng(3)
    w, h, disp = 256, 128, 16
    blocks = rng.integers(0, 256, (h // 4 + 1, (w + disp) // 4 + 1))
    base = np.kron(blocks, np.ones((4, 4)))[:h, :w + disp].astype(np.uint8)
    left = torch.from_numpy(np.ascontiguousarray(base[:, :-disp]))
    right = torch.from_numpy(np.ascontiguousarray(base[:, disp:]))
    d = sgbm_disparity(left, right).numpy()
    valid = d >= 0
    assert valid.mean() > 0.5 and np.median(d[valid]) == 16 * disp
    assert (d[:, :64] == -16).all()  # cv2 leaves the first numDisparities columns invalid


def _jax_params():
    from monogs_dev_tpu.models.gaussians import GaussianParams

    with np.load(SCENE) as z:
        return GaussianParams(**{k[7:]: jnp.asarray(z[k]) for k in z.files
                                 if k.startswith("params.")})


def test_median_depth_matches_jax():
    from monogs_dev_tpu.models.camera import Intrinsics as JI
    from monogs_dev_tpu.ops import RasterConfig as JRC
    from monogs_dev_tpu.ops.rasterize import render_median_depth as jax_median_depth

    jp = _jax_params()
    params, active = mf.load_params(SCENE, "cpu")
    for i in (0, 20):
        pose = mf.orbit_pose(i, 40, sweep=0.45).astype(np.float32)
        a = np.asarray(jax_median_depth(jp, jnp.ones(active.shape[0], bool), jnp.asarray(pose),
                                        JI(120.0, 120.0, 48.0, 40.0, 96, 80),
                                        JRC(max_per_tile=512, k_dup=16, use_pallas=False)))
        b = render_median_depth(params, active, torch.as_tensor(pose),
                                Intrinsics(120.0, 120.0, 48.0, 40.0, 96, 80),
                                RasterConfig(max_per_tile=512, k_dup=16)).numpy()
        assert (a > 0).mean() > 0.5
        assert (np.abs(a - b) <= 1e-4).mean() >= 0.995


def test_tum_writer_matches_jax_render(tmp_path):
    from monogs_dev_tpu.models.camera import Intrinsics as JI
    from monogs_dev_tpu.ops import RasterConfig as JRC
    from monogs_dev_tpu.ops.rasterize import render_median_depth as jax_median_depth
    from monogs_dev_tpu.ops.rasterize import render_tiled as jax_render

    w, h = 96, 72
    intr = Intrinsics(0.9 * w, 0.9 * w, w / 2.0, h / 2.0, w, h)
    jintr = JI(0.9 * w, 0.9 * w, w / 2.0, h / 2.0, w, h)
    jcfg = JRC(max_per_tile=512, k_dup=16, use_pallas=False)
    poses = mf.orbit(3, n=40, sweep=0.45)
    params, active = mf.load_params(SCENE, "cpu")
    mf.write_tum(str(tmp_path), params, active, intr, poses)
    jp = _jax_params()
    jactive = jnp.ones(active.shape[0], bool)
    rgb = sorted(glob.glob(str(tmp_path / "rgb" / "*.png")))
    dep = sorted(glob.glob(str(tmp_path / "depth" / "*.png")))
    assert len(rgb) == len(dep) == 3
    for i, pose in enumerate(poses):
        T_j = jnp.asarray(pose, jnp.float32)
        out = jax_render(jp, jactive, T_j, jintr, 0, config=jcfg, need_touched=False)
        color = (np.clip(np.asarray(out.color), 0.0, 1.0) * 255).astype(np.uint8)
        depth = np.array(jax_median_depth(jp, jactive, T_j, jintr, jcfg))
        depth[np.asarray(out.alpha) < 0.5] = 0.0
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        c_diff = np.abs(read_png(rgb[i]).astype(np.int64) - color)
        d_diff = np.abs(read_png(dep[i]).astype(np.int64) - d16)
        assert (c_diff == 0).mean() >= 0.999 and c_diff.max() <= 1
        assert (d_diff <= 1).mean() >= 0.995
    gt = open(tmp_path / "groundtruth.txt").read().splitlines()
    assert gt[0].startswith("#") and len(gt) == 4
    cal = _calib(w, h)
    cal.update(fx=intr.fx, fy=intr.fy)
    t = T.load_dataset(_cfg("tum", str(tmp_path), cal), "cpu")
    assert all(np.abs(t.poses[i] - poses[i]).max() < 1e-5 for i in range(3))


def test_load_dataset_factory(tmp_path, monkeypatch):
    cfg = load_config(os.path.join(REPO, "configs/synthetic/tiny_rgbd.yaml"))
    from monogs_dev_tpu_torch.data.synthetic import SyntheticDataset
    from monogs_dev_tpu_torch.data.synthetic import load_dataset as reexported

    assert reexported is T.load_dataset
    assert isinstance(T.load_dataset(cfg, "cpu"), SyntheticDataset)
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(RuntimeError, match="pyrealsense2 is not available"):
        T.load_dataset(_cfg("realsense", "", _calib()), "cpu")
    with pytest.raises(ValueError, match="Unknown dataset type"):
        T.load_dataset(_cfg("nope", "", _calib()), "cpu")


SYNTHETIC_CONFIGS = [(os.path.basename(p), 0) for p in
                     sorted(glob.glob(os.path.join(REPO, "configs", "synthetic", "*.yaml")))]


@pytest.mark.parametrize("name,seed", SYNTHETIC_CONFIGS + [("surface_160.yaml", 1),
                                                            ("surface_160.yaml", 2)])
def test_synthetic_configs_have_their_scene(name, seed):
    """`SyntheticDataset` loads the committed scene (its `want` check on
    gaussian_scale and the surface extents passes), and the npz equals the
    JAX package's draw on its first and last Gaussians."""
    import jax

    from monogs_dev_tpu.data.synthetic import make_surface_scene, make_synthetic_scene
    from monogs_dev_tpu_torch.data.synthetic import SyntheticDataset
    from monogs_dev_tpu_torch.utils.config import load_config as t_load_config

    cfg = t_load_config(os.path.join(REPO, "configs", "synthetic", name))
    if seed:
        cfg["Dataset"]["seed"] = seed
    ds = cfg["Dataset"]
    assert "scene_file" not in ds
    scene = SyntheticDataset(cfg, "cpu").scene_params
    n = int(ds.get("n_gaussians", 2000))
    assert scene.xyz.shape == (n, 3)
    key = jax.random.PRNGKey(int(ds.get("seed", 0)))
    if ds.get("scene", "blobs") == "surface":
        ref, _ = make_surface_scene(key, n=n, scale=float(ds.get("gaussian_scale", 0.035)),
                                    extent_x=float(ds.get("extent_x", 5.0)),
                                    extent_y=float(ds.get("extent_y", 3.0)))
    else:
        ref, _ = make_synthetic_scene(key, n=n, scale=float(ds.get("gaussian_scale", 0.06)))
    for rows in (slice(0, 8), slice(n - 8, n)):
        np.testing.assert_array_equal(scene.xyz[rows].numpy(), np.asarray(ref.xyz)[rows])
        np.testing.assert_array_equal(scene.log_scales[rows].numpy(),
                                      np.asarray(ref.log_scales)[rows])

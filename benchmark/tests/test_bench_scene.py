"""The benchmark's inputs: the same seed gives the same scene, path and
files; the camera keeps the traffic's speeds; the port's TUM and Replica
loaders read the written frames back (PNG exactly, JPEG within its
quantisation)."""

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.reference import render as R

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def test_same_seed_same_scene_and_path():
    a, _ = scene.surface_scene(1, 2 ** 31 + 11, 500, 5.0, 3.0, 3.0, 0.035, "cpu")
    b, _ = scene.surface_scene(1, 2 ** 31 + 11, 500, 5.0, 3.0, 3.0, 0.035, "cpu")
    c, _ = scene.surface_scene(1, 2 ** 31 + 12, 500, 5.0, 3.0, 3.0, 0.035, "cpu")
    d, _ = scene.surface_scene(2, 2 ** 31 + 11, 500, 5.0, 3.0, 3.0, 0.035, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    # the seed draws the texture; the session's slot draws the shapes
    assert torch.equal(a["xyz"], c["xyz"]) and not torch.equal(a["f_dc"], c["f_dc"])
    assert not torch.equal(a["xyz"], d["xyz"])
    assert scene.session_seed(7, 4, 3) == 31


def test_the_camera_turns_and_moves_at_the_traffics_speeds():
    """At every frame the yaw grows by rad_per_frame and the centre moves
    m_per_frame (to the chord's second order), sideways the way it turns."""
    w, v = 0.0059271, 0.0083
    c2w = [np.linalg.inv(scene.loop_pose(i, w, v)) for i in range(65)]
    assert np.allclose(c2w[0], np.eye(4))
    for a, b in zip(c2w, c2w[1:]):
        R = a[:3, :3].T @ b[:3, :3]
        assert np.isclose(np.arctan2(R[0, 2], R[0, 0]), w, rtol=1e-9)
        assert np.isclose(np.linalg.norm(b[:3, 3] - a[:3, 3]), v, rtol=1e-5)
        assert b[0, 3] > a[0, 3]


def test_quaternion_round_trip():
    from monogs_dev_tpu_torch.data.datasets import _quat_xyzw_to_matrix

    for i in range(0, 120, 7):
        T = np.linalg.inv(scene.loop_pose(i, 0.05, 0.01))
        assert np.allclose(_quat_xyzw_to_matrix(scene.quat_xyzw(T[:3, :3]))[:3, :3], T[:3, :3],
                           atol=1e-12)


@pytest.mark.parametrize("layout", ["tum", "replica"])
def test_the_port_reads_the_written_frames(layout, tiny_cell, tmp_path):
    """Both layouts of the generator; the Replica one (JPEG colour) on the
    fr3_office configuration's camera with the Replica loader."""
    from monogs_dev_tpu_torch.data.datasets import load_dataset

    cell = tiny_cell("tum_fr3_office_rgbd:tum_sessions4", frames=5)
    cfg = cell["config"]
    cfg["layout"] = layout
    cfg["config"]["Dataset"]["type"] = layout
    path, gt = scene.sequence(cfg, cell["traffic"], 123, 0, str(tmp_path), "cpu")
    again, _ = scene.sequence(cfg, cell["traffic"], 123, 0, str(tmp_path / "b"), "cpu")
    config = dict(cfg["config"], Dataset=dict(cfg["config"]["Dataset"], dataset_path=path))
    ds = load_dataset(config, "cpu")
    assert len(ds) == 5
    cam = scene.camera_of(cfg["config"]["Dataset"])
    g, act = scene.surface_scene(0, scene.session_seed(123, 1, 0), 8000, 5.0, 3.0, 3.0, 0.035,
                                 "cpu")
    scale = float(cfg["config"]["Dataset"]["Calibration"]["depth_scale"])
    for i in range(5):
        image, depth, T = ds[i]
        color, d = R.sensor_frame(g, act, torch.tensor(gt[i], dtype=torch.float32), cam)
        rgb, d16 = scene.frames_u8_u16(color, d, scale)
        assert np.array_equal(np.round(depth.numpy() * scale).astype(np.uint16), d16)
        got = np.round(image.numpy() * 255.0).astype(np.int64)
        if cfg["layout"] == "tum":
            assert np.array_equal(got, rgb.astype(np.int64))
            assert np.allclose(T, gt[i], atol=1e-6)
        else:  # baseline JPEG, quality 95, 4:2:0: PIL's decode of the file, and near
            from PIL import Image

            assert np.array_equal(got, np.asarray(Image.open(ds.color_paths[i])))
            mse = float(((got - rgb) ** 2).mean())
            assert 10 * np.log10(255.0 ** 2 / mse) > 25.0
            assert np.allclose(T, gt[i], atol=1e-9)
    with open(ds.color_paths[0], "rb") as f, \
            open(ds.color_paths[0].replace(str(tmp_path), str(tmp_path / "b")), "rb") as g2:
        assert f.read() == g2.read()
    assert again.startswith(str(tmp_path / "b"))

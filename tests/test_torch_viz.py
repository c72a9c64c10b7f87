"""The port's viewer layer (`monogs_dev_tpu_torch/viz/`) against the JAX
package's on the same map (made by JAX, handed over through
models/convert.py), on the CPU.

tests/test_gui.py's cases (`TestOrbitCamera`, `TestViewerState` with every
render mode) and tests/test_system.py::TestVizChannel's three, on the port;
`render_view` per mode against the JAX package's at
tests/test_torch_rasterizer.py's tolerance (colour and alpha 3e-5; depth
3e-4, which the depth mode divides by alpha: compared where alpha > 0.5 at
6e-4), with the colour map taken out on both sides (its 256-entry table
turns a rounding difference at a bin edge into a step); `GaussianPacket.
from_map`'s fields against the JAX package's (1e-6); `export_turntable`'s
PNGs read back through `read_png` equal to the rendered uint8 frames;
`OfflineViewer.tick`; and the pause channel through a SLAM run, which
sends the backend "pause" and then "unpause"."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from monogs_dev_tpu.data.synthetic import make_synthetic_scene, orbit_pose
from monogs_dev_tpu.models.camera import Intrinsics as JIntrinsics
from monogs_dev_tpu.ops.raster_types import RasterConfig as JRasterConfig
from monogs_dev_tpu.viz import snapshot as jsnapshot
from monogs_dev_tpu.viz import viewer as jviewer
from monogs_dev_tpu_torch.core import frontend as tfrontend
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.data.image_io import read_png
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.convert import params_from_numpy
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.utils.config import load_config
from monogs_dev_tpu_torch.viz import viewer
from monogs_dev_tpu_torch.viz.gui import OrbitCamera, ViewerState, _to_photo_data
from monogs_dev_tpu_torch.viz.snapshot import GaussianPacket, VizChannel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTR = Intrinsics(fx=60.0, fy=60.0, cx=40.0, cy=30.0, width=80, height=60)
CFG = RasterConfig(max_per_tile=256, k_dup=8, tile_group=20)
JINTR = JIntrinsics(**dataclasses.asdict(INTR))
JCFG = JRasterConfig(max_per_tile=256, k_dup=8, tile_group=20)
POSE = np.asarray(orbit_pose(3, 10), np.float32)


@pytest.fixture(scope="module")
def scene():
    """(JAX params, JAX active, port params, port active)."""
    params, active = make_synthetic_scene(jax.random.PRNGKey(0), n=80, scale=0.1)
    arrays = {f"params.{k}": np.asarray(v) for k, v in params._asdict().items()}
    return params, active, params_from_numpy(arrays, "cpu"), torch.tensor(np.asarray(active))


@pytest.fixture(scope="module")
def packet(scene):
    _, _, params, active = scene
    return GaussianPacket.from_map(
        params, active, current_frame_T=POSE,
        keyframe_poses=[np.asarray(orbit_pose(i, 10)) for i in (0, 3)])


class TestOrbitCamera:
    def test_w2c_looks_at_target(self):
        cam = OrbitCamera(target=np.array([0.0, 0.0, 4.0]), radius=2.0)
        T = cam.w2c()
        p = T[:3, :3] @ cam.target + T[:3, 3]
        np.testing.assert_allclose(p[:2], 0.0, atol=1e-6)
        assert abs(p[2] - cam.radius) < 1e-6

    def test_rotate_zoom_bounds(self):
        cam = OrbitCamera()
        cam.rotate(0.3, 99.0)
        assert cam.pitch <= 1.45
        cam.zoom(1e9)
        assert cam.radius <= 100.0
        R = cam.w2c()[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)


class TestViewerState:
    def test_ingest_centers_once(self, packet):
        st = ViewerState(INTR, CFG)
        assert st.ingest(packet)
        first_target = st.camera.target.copy()
        np.testing.assert_allclose(first_target, packet.xyz.mean(axis=0), atol=1e-5)
        assert not st.ingest(None)
        st.ingest(packet)
        np.testing.assert_allclose(st.camera.target, first_target)

    def test_follow_uses_current_frame(self, packet):
        st = ViewerState(INTR, CFG)
        st.ingest(packet)
        st.follow, st.from_behind = True, False
        np.testing.assert_allclose(st.view_matrix(), packet.current_frame_T)
        st.from_behind = True
        assert not np.allclose(st.view_matrix(), packet.current_frame_T)
        st.follow = False
        np.testing.assert_allclose(st.view_matrix(), st.camera.w2c())

    @pytest.mark.parametrize("mode", ViewerState.MODES)
    def test_render_modes(self, packet, mode):
        st = ViewerState(INTR, CFG)
        st.ingest(packet)
        st.follow = False
        st.mode = mode
        img = st.render()
        assert img.shape == (60, 80, 3)
        assert np.isfinite(img).all() and img.max() <= 1.0 + 1e-6

    def test_frusta_project(self, packet):
        st = ViewerState(INTR, CFG)
        st.ingest(packet)
        st.follow = False
        st.camera.radius = 6.0
        segs = st.frusta_segments()
        assert len(segs) > 0 and len(segs) % 8 == 0
        st.show_cameras = False
        assert st.frusta_segments() == []

    def test_jump_to_keyframe_reseats_orbit(self, packet):
        st = ViewerState(INTR, CFG)
        st.ingest(packet)
        st.jump_to_keyframe(1)
        assert not st.follow
        T_kf = np.asarray(packet.keyframe_poses[1])
        fwd_kf = T_kf[:3, :3].T @ np.array([0, 0, 1.0])
        fwd_cam = st.camera.w2c()[:3, :3].T @ np.array([0, 0, 1.0])
        assert fwd_kf @ fwd_cam > 0.99

    def test_pause_protocol(self, packet):
        st = ViewerState(INTR, CFG)
        ch = VizChannel()
        msg = st.toggle_pause()
        assert st.paused and msg.flag_pause
        ch.request_pause(msg.flag_pause)
        assert ch.poll_control().flag_pause is True
        assert not st.toggle_pause().flag_pause

    def test_photo_data_is_ppm(self, packet):
        st = ViewerState(INTR, CFG)
        st.ingest(packet)
        st.follow = False
        data = _to_photo_data(st.render())
        assert data.startswith(b"P6 80 60 255 ")
        assert len(data) == len(b"P6 80 60 255 ") + 80 * 60 * 3


class TestVizChannel:
    def test_latest_wins_and_pause(self):
        ch = VizChannel(maxsize=2)
        for i in range(5):
            ch.publish(GaussianPacket(xyz=np.zeros((i + 1, 3))))
        packet = ch.latest()
        assert packet is not None and packet.xyz.shape[0] == 5
        assert ch.latest() is None
        ch.request_pause(True)
        ctrl = ch.poll_control()
        assert ctrl is not None and ctrl.flag_pause
        assert ch.poll_control() is None

    def test_packet_from_map(self, scene):
        _, _, params, active = scene
        packet = GaussianPacket.from_map(params, active)
        assert packet.xyz.shape == (int(active.sum()), 3)
        assert packet.rgb.min() >= 0.0 and packet.rgb.max() <= 1.0

    def test_render_view_modes(self, scene):
        _, _, params, active = scene
        for mode in ("color", "depth", "opacity"):
            img = viewer.render_view(params, active, np.eye(4), INTR, mode=mode, raster_cfg=CFG)
            assert img.shape == (60, 80, 3) and np.all(np.isfinite(img))


@pytest.mark.parametrize("mode", ["color", "depth", "opacity"])
def test_render_view_matches_jax(scene, mode, monkeypatch):
    jp, ja, tp, ta = scene
    for mod in (viewer, jviewer):
        monkeypatch.setattr(mod, "_colormap", lambda x, name: np.stack([x] * 3, axis=-1))
    got = viewer.render_view(tp, ta, POSE, INTR, mode=mode, raster_cfg=CFG)
    want = jviewer.render_view(jp, ja, POSE, JINTR, mode=mode, raster_cfg=JCFG)
    assert got.shape == want.shape == (60, 80, 3)
    if mode == "depth":
        alpha = jviewer.render_view(jp, ja, POSE, JINTR, mode="opacity", raster_cfg=JCFG)
        sel = alpha > 0.5
        assert sel.mean() > 0.1
        np.testing.assert_allclose(got[sel], want[sel], atol=6e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_packet_from_map_matches_jax(scene):
    jp, ja, tp, ta = scene
    got = GaussianPacket.from_map(tp, ta)
    want = jsnapshot.GaussianPacket.from_map(jp, ja)
    for name in ("xyz", "rgb", "opacity", "scales"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)


def test_export_turntable_pngs_read_back(scene, tmp_path):
    _, _, params, active = scene
    out = viewer.export_turntable(params, active, INTR, str(tmp_path / "orbit.gif"),
                                  n_frames=4, raster_cfg=CFG)
    assert os.path.exists(out)
    act = active.numpy()
    xyz = params.xyz.numpy()[act]
    center = xyz.mean(axis=0)
    radius = 1.5 * float(np.percentile(np.linalg.norm(xyz - center, axis=-1), 90))
    for i, T in enumerate(viewer.orbit_poses(center, radius, 4)):
        img = viewer.to_uint8(viewer.render_view(params, active, T, INTR, raster_cfg=CFG))
        back = read_png(str(tmp_path / "orbit_frames" / f"orbit_{i:04d}.png"))
        assert back.dtype == np.uint8 and np.array_equal(back, img), i


def test_offline_viewer_tick(scene, tmp_path):
    _, _, params, active = scene
    ch = VizChannel()
    view = viewer.OfflineViewer(ch, INTR, str(tmp_path))
    assert view.tick() is None  # nothing published
    gt = np.full((60, 80, 3), 0.5, np.float32)
    ch.publish(GaussianPacket.from_map(params, active, current_frame_T=POSE, gt_color=gt))
    path = view.tick()  # no map passed: the input image
    assert os.path.basename(path) == "frame_00001.png"
    assert np.array_equal(read_png(path), viewer.to_uint8(gt))
    ch.publish(GaussianPacket.from_map(params, active, current_frame_T=POSE, gt_color=gt))
    path = view.tick(params, active)  # the map from the packet's pose
    want = viewer.to_uint8(viewer.render_view(params, active, POSE, INTR))
    assert np.array_equal(read_png(path), want)


def test_gui_pause_pauses_and_unpauses_backend(monkeypatch):
    """use_gui: a packet per tracked frame; a pause request from the viewer
    reaches the backend as "pause", its release as "unpause"."""
    cfg = load_config(os.path.join(REPO, "configs/synthetic/tiny_rgbd.yaml"))
    cfg["Dataset"]["single_thread"] = False
    cfg["Results"]["use_gui"] = True
    slam = SLAM(cfg, "cpu", seed=0)
    ch = slam.viz_channel
    assert ch is not None
    published = []
    real_publish = ch.publish
    monkeypatch.setattr(ch, "publish", lambda p: (published.append(p), real_publish(p)))
    sleeps = []

    def sleep(s):  # the paused frontend's wait: the viewer lets go
        sleeps.append(s)
        ch.request_pause(False)

    monkeypatch.setattr(tfrontend.time, "sleep", sleep)
    ch.request_pause(True)
    slam.run(max_frames=4)
    slam.stop()
    assert sleeps == [0.01]
    assert slam.backend_thread.handled["pause"] == 1
    assert slam.backend_thread.handled["unpause"] == 1
    assert len(published) == 3  # frames 1-3 tracked; frame 0 initializes
    p = published[-1]
    assert p.xyz.shape[0] == int(p.active.sum()) > 0
    # frame 1 precedes every keyframe the backend moved: its pose is as tracked
    np.testing.assert_array_equal(published[0].current_frame_T, slam.frontend.cameras[1].T_est)

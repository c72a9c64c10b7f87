"""The port runs without JAX: in a fresh interpreter where `import jax` fails,
every module of monogs_dev_tpu_torch (the kernel lab's `ops/blend_lab.py`
and `tools/kernel_lab.py`, the Adam tracker and the eval modules among them)
and `bench_torch.py` import, a tiny scene renders on the CPU, the lab's
L1/L2 plain versions run, the Adam tracker takes 3 steps, and the metrics,
PLY and ATE artifacts work; nothing of the JAX package or of
`tools/kernel_lab.py` gets imported along the way. A second interpreter,
where PIL and cv2 fail to import as well (the card machine has neither),
runs the ingest path the card runs: the TUM loader on the committed
fixture, the EuRoC writer, loader and matcher on a 2-frame pair, and a
checkpoint saved and loaded. A third, with matplotlib blocked too, runs
the tiny RGB-D config with the backend on its own thread
(`TPU.scheduler: thread`) and the viewer channel open, renders the newest
packet through `OfflineViewer` and writes a turntable's PNG frames. A
fourth, with jax blocked, runs the tiny RGB-D config with
`TPU.mesh_devices: 2` on a two-shard CPU mesh, every mapping round through
the data-parallel `_map_dp`, and renders through `render_reference`. A
fifth, with jax, PIL and cv2 blocked, writes a Replica sequence (JPEG
colour) with the port's writer and runs `configs/rgbd/replica/office0_sp.yaml`
on it, cut to a small frame and a few iterations, through the port's JPEG
decoder. A sixth, with jax, PIL and cv2 blocked, runs the port's
fixture-eval tool (`tools/run_fixture_evals.py`) on its replay row, cut to
64x48, 7 frames and a few iterations: the JAX replay writer's scene, the
Realsense-replay loader, the monocular path of
`configs/live/realsense_replay.yaml` and the eval tail. A seventh, with jax
blocked, runs the tiny RGB-D config at a seed whose scene is not committed,
on the scene the port's own generator draws (`data/synthetic.py`)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
torch.set_num_threads(1)
import monogs_dev_tpu_torch
names = [m.name for m in pkgutil.walk_packages(monogs_dev_tpu_torch.__path__, "monogs_dev_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.gaussians import GaussianParams
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.ops.rasterize import render_tiled
g = torch.Generator().manual_seed(0)
n = 30
params = GaussianParams(
    xyz=torch.cat([torch.rand((n, 2), generator=g) * 2 - 1, torch.rand((n, 1), generator=g) * 3 + 2], 1),
    f_dc=torch.rand((n, 1, 3), generator=g), f_rest=torch.zeros((n, 0, 3)),
    log_scales=torch.full((n, 3), -2.5), quats=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
    opacity_logit=torch.ones(n))
out = render_tiled(params, torch.ones(n, dtype=torch.bool), torch.eye(4),
                   Intrinsics(40.0, 40.0, 16.0, 16.0, 32, 32), 0,
                   config=RasterConfig(max_per_tile=32, k_dup=8, tile_group=4))
assert out.color.shape == (32, 32, 3) and bool(torch.isfinite(out.color).all())
assert float(out.alpha.max()) > 0.1 and int(out.n_touched.sum()) > 0
import bench_torch
from monogs_dev_tpu_torch.ops import blend_lab as BL
assert "monogs_dev_tpu_torch.ops.blend_lab" in names
assert "monogs_dev_tpu_torch.tools.kernel_lab" in names
assert "monogs_dev_tpu_torch.tools.run_fixture_evals" in names
props = torch.zeros((2, 32, 10))
props[:, :, :2] = 8.0
props[:, :, 2] = props[:, :, 4] = 0.1
props[:, :, 8] = 0.5
counts = torch.tensor([32, 7], dtype=torch.int32)
props[1, 7:] = 0.0
color, depth, alpha = BL.lab_blend("lean", props, counts, 2, 16)
t_final, n_done = BL.blend_residuals(props, counts, 2, 16)
d = BL.moments_backward(props, t_final, n_done, torch.ones((2, 3, 256)), torch.ones((2, 256)),
                        torch.ones((2, 256)), 2, 16)
assert float(alpha.max()) > 0.9 and bool(torch.isfinite(d).all()) and float(d.abs().max()) > 0
import contextlib, io, os, tempfile, types
import numpy as np
from monogs_dev_tpu_torch.core.params import StepConfig
from monogs_dev_tpu_torch.core.tracking import track_frame
from monogs_dev_tpu_torch.eval.ate import eval_ate
from monogs_dev_tpu_torch.eval.lpips import lpips, lpips_backend
from monogs_dev_tpu_torch.utils.losses import psnr, ssim
from monogs_dev_tpu_torch.utils.ply import load_ply, save_ply
intr = Intrinsics(40.0, 40.0, 16.0, 16.0, 32, 32)
rcfg = RasterConfig(max_per_tile=32, k_dup=8, tile_group=4)
active = torch.ones(n, dtype=torch.bool)
T0 = torch.eye(4)
T0[0, 3] = 0.01
res = track_frame(params, active, T0, torch.zeros(2), out.color, out.depth, None, torch.zeros(3),
                  StepConfig(tracking_max_iters=3), intr, rcfg, use_depth=True)
assert res.n_iters == 3 and bool(torch.isfinite(res.T_w2c).all())
assert float(psnr(res.color, out.color)) > 10.0 and 0.0 < float(ssim(res.color, out.color)) <= 1.0
assert lpips(res.color, out.color) >= 0.0 and lpips_backend() == "alexnet-random-torch"
with tempfile.TemporaryDirectory() as d:
    assert save_ply(params, active, os.path.join(d, "pc.ply")) == n
    assert torch.equal(load_ply(os.path.join(d, "pc.ply"))[0].xyz, params.xyz)
    cams = {i: types.SimpleNamespace(idx=i, T_est=np.eye(4), T_gt=np.eye(4)) for i in range(3)}
    with contextlib.redirect_stdout(io.StringIO()):  # its log line
        assert eval_ate(cams, [0, 1, 2], d, 0, final=True) < 1e-9
    assert os.path.exists(os.path.join(d, "plot", "stats_final.json"))
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")
       or m in ("tools", "tools.kernel_lab")]
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok"), proc.stdout


INGEST = r"""
import os, sys, tempfile
for name in ("jax", "PIL", "cv2"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from monogs_dev_tpu_torch.data.datasets import load_dataset
from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
from monogs_dev_tpu_torch.models.gaussians import create_map
from monogs_dev_tpu_torch.tools import make_fixtures as mf
from monogs_dev_tpu_torch.utils.checkpoint import load_map, save_checkpoint
cal = {"fx": 144.0, "fy": 144.0, "cx": 80.0, "cy": 60.0, "k1": 0.0, "k2": 0.0, "p1": 0.0,
       "p2": 0.0, "k3": 0.0, "width": 160, "height": 120, "depth_scale": 5000.0,
       "distorted": False}
ds = load_dataset({"Dataset": {"type": "tum", "Calibration": cal,
                               "dataset_path": "tests/fixtures/tum_surface"}}, "cpu")
image, depth, pose = ds[5]
assert len(ds) == 80 and image.shape == (120, 160, 3) and float((depth > 0).float().mean()) > 0.5
params, active = mf.load_params(os.path.join(SCENE_DIR, "surface_seed0_n6000.npz"), "cpu")
with tempfile.TemporaryDirectory() as d:
    cfg = mf.write_euroc(os.path.join(d, "euroc"), params, active, n_frames=2, w=160, h=120)
    st = load_dataset({"Dataset": {"type": "euroc", "sensor_type": "stereo",
                                   "dataset_path": cfg["dataset_path"],
                                   "Calibration": cfg["Calibration"]}}, "cpu")
    image, depth, pose = st[1]
    assert len(st) == 2 and float((depth > 0).float().mean()) > 0.15
    e = type("Engine", (), {})()
    e.gmap, e.iteration_count, e.current_window, e.initialized = create_map(32, 0, "cpu"), 3, [0], True
    e.viewpoints = {}
    save_checkpoint(os.path.join(d, "c.npz"), e)
    gmap, host = load_map(os.path.join(d, "c.npz"), "cpu")
    assert torch.equal(gmap.params.xyz, e.gmap.params.xyz) and host["iteration_count"] == 3
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")]
assert not bad, bad
print("ok")
"""


def test_ingest_path_without_pil_cv2_or_jax():
    """The loaders, the matcher, the fixture writer and the checkpoint run
    where PIL, cv2 and JAX are missing, as on the card machine."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", INGEST], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok"), proc.stdout


THREADED = r"""
import os, sys, tempfile
for name in ("jax", "PIL", "cv2", "matplotlib"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from monogs_dev_tpu_torch.core.backend import BackendThread
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.data.image_io import read_png
from monogs_dev_tpu_torch.utils.config import load_config
from monogs_dev_tpu_torch.viz import OfflineViewer, export_turntable, render_view
cfg = load_config("configs/synthetic/tiny_rgbd.yaml")
cfg["Training"]["single_thread"] = False
cfg["Dataset"]["single_thread"] = False
cfg["TPU"]["scheduler"] = "thread"
cfg["Results"]["use_gui"] = True
slam = SLAM(cfg, "cpu", seed=0)
assert isinstance(slam.backend_thread, BackendThread)
slam.run(max_frames=6)
packet = slam.viz_channel.latest()
slam.viz_channel.publish(packet)
slam.stop()
assert not slam.backend_thread.is_alive() and len(slam.frontend.kf_indices) >= 1
with tempfile.TemporaryDirectory() as d:
    path = OfflineViewer(slam.viz_channel, slam.intr, d).tick(packet.params, packet.active)
    assert read_png(path).shape == (64, 80, 3)
    grey = render_view(packet.params, packet.active, packet.current_frame_T, slam.intr,
                       mode="depth")
    assert np.allclose(grey[..., 0], grey[..., 2])  # no matplotlib: the grey map
    out = export_turntable(packet.params, packet.active, slam.intr, os.path.join(d, "t.gif"),
                           n_frames=2)
    assert sorted(os.listdir(out)) == ["orbit_0000.png", "orbit_0001.png"]  # no PIL: no GIF
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")]
assert not bad, bad
print("ok")
"""


def test_thread_mode_and_viewer_without_jax_pil_cv2_or_matplotlib():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", THREADED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ok", proc.stdout  # after the run's log


DATA_PARALLEL = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from monogs_dev_tpu_torch.core import backend
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.ops.rasterize import render_tiled
from monogs_dev_tpu_torch.ops.rasterize_ref import render_reference
from monogs_dev_tpu_torch.utils.config import load_config
cfg = load_config("configs/synthetic/tiny_rgbd.yaml")
cfg["TPU"]["mesh_devices"] = 2
slam = SLAM(cfg, "cpu", seed=0)
e = slam.engine
assert e.mesh.size == 2 and e._dp_slots % 2 == 0
single = []
e._map_single = lambda *a, **k: single.append(a)
slam.run(max_frames=10)  # the init and the keyframe at frame 9
slam.stop()
tel = e.telemetry
assert not single and tel["dp_init_iters"] == e.init_itr_num and tel["map_iters"] > tel["dp_init_iters"]
assert e._dp_state.count == tel["map_iters"] and len(slam.frontend.kf_indices) >= 2
assert all(np.isfinite(c.T_est).all() for c in slam.frontend.cameras.values())
T = torch.as_tensor(slam.frontend.cameras[9].T_est, dtype=torch.float32)
ref = render_reference(e.gmap.params, e.gmap.aux.active, T, slam.intr, 0, config=slam.raster_cfg)
tiled = render_tiled(e.gmap.params, e.gmap.aux.active, T, slam.intr, 0, config=slam.raster_cfg)
assert float((ref.color - tiled.color).abs().max()) < 1e-3 and float(ref.alpha.max()) > 0.5
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")]
assert not bad, bad
print("ok")
"""


def test_data_parallel_mapping_and_reference_render_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", DATA_PARALLEL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ok", proc.stdout


REPLICA = r"""
import os, sys, tempfile
for name in ("jax", "PIL", "cv2"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.data.datasets import ReplicaDataset
from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.tools import make_fixtures as mf
from monogs_dev_tpu_torch.utils.config import load_config
cfg = load_config("configs/rgbd/replica/office0_sp.yaml")
cal = cfg["Dataset"]["Calibration"]
cal.update(fx=60.0, fy=60.0, cx=59.5, cy=33.5, width=120, height=68)
intr = Intrinsics(fx=60.0, fy=60.0, cx=59.5, cy=33.5, width=120, height=68)
params, active = mf.load_params(os.path.join(SCENE_DIR, "surface_seed0_n6000.npz"), "cpu")
with tempfile.TemporaryDirectory() as d:
    mf.write_replica(d, params, active, intr, mf.orbit(3, n=48, sweep=0.45),
                     depth_scale=cal["depth_scale"])
    cfg["Dataset"]["dataset_path"] = d
    cfg["Results"]["save_results"] = False
    cfg["Training"].update(init_itr_num=5, tracking_itr_num=3, mapping_itr_num=3)
    slam = SLAM(cfg, "cpu", seed=0)
    assert isinstance(slam.dataset, ReplicaDataset) and slam.dataset.color_paths[0].endswith(".jpg")
    slam.run(max_frames=3)
    slam.stop()
    fe = slam.frontend
    assert sorted(fe.cameras) == [0, 1, 2]
    assert all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras)
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")]
assert not bad, bad
print("ok")
"""


def test_replica_path_without_pil_cv2_or_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", REPLICA], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ok", proc.stdout


FIXTURE_EVAL = r"""
import json, os, sys, tempfile
for name in ("jax", "PIL", "cv2"):
    sys.modules[name] = None  # any import of them now raises ImportError
import torch
torch.set_num_threads(1)
from monogs_dev_tpu_torch.tools import run_fixture_evals as rfe
from monogs_dev_tpu_torch.utils.config import load_config

def short(path):
    cfg = load_config(path)
    cfg["Training"].update(init_itr_num=10, mapping_itr_num=3, tracking_itr_num=5)
    return cfg

rfe._base_config = short
rfe.REFINEMENT_ITERS = 3
with tempfile.TemporaryDirectory() as d:
    assert rfe.main(["replay", "--frames", "7", "--size", "64x48", "--device", "cpu",
                     "--out", d]) == 0
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")]
assert not bad, bad
print("ok")
"""


def test_fixture_eval_tool_without_pil_cv2_or_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", FIXTURE_EVAL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPLAY ROW ")]
    assert len(row) == 1 and proc.stdout.splitlines()[-1] == "ok", proc.stdout[-3000:]


DRAWN_SCENE = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from monogs_dev_tpu_torch.core.system import SLAM
from monogs_dev_tpu_torch.data.synthetic import make_surface_scene
from monogs_dev_tpu_torch.utils.config import load_config
cfg = load_config("configs/synthetic/tiny_rgbd.yaml")
cfg["Dataset"]["seed"] = 11  # no scene file is committed for it
slam = SLAM(cfg, "cpu", seed=0)
slam.run(max_frames=4)
slam.stop()
assert len(slam.frontend.cameras) == 4 and int(slam.engine.gmap.aux.active.sum()) > 0
assert all(np.isfinite(c.T_est).all() for c in slam.frontend.cameras.values())
params, active = make_surface_scene(500, generator=torch.Generator().manual_seed(3))
assert bool(torch.isfinite(params.xyz).all()) and bool(active.all())
bad = [m for m in sys.modules if m == "monogs_dev_tpu" or m.startswith("monogs_dev_tpu.")]
assert not bad, bad
print("ok")
"""


def test_synthetic_config_at_an_uncommitted_seed_without_jax():
    """The port draws the scene itself where no npz of the JAX package's
    scene exists, and runs a synthetic config on it with jax blocked."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", DRAWN_SCENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "drew the blobs scene with this package's generator" in " ".join(proc.stdout.split())
    assert proc.stdout.splitlines()[-1] == "ok", proc.stdout

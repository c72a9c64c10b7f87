"""The port runs without JAX: in a fresh interpreter where `import jax` fails,
every module of monogs_dev_tpu_torch (the kernel lab's `ops/blend_lab.py`
and `tools/kernel_lab.py`, the Adam tracker and the eval modules among them)
and `bench_torch.py` import, a tiny scene renders on the CPU, the lab's
L1/L2 plain versions run, the Adam tracker takes 3 steps, and the metrics,
PLY and ATE artifacts work; nothing of the JAX package or of
`tools/kernel_lab.py` gets imported along the way."""

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

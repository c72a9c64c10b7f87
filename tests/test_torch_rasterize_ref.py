"""The port's brute-force rasterizer (`ops/rasterize_ref.py::render_reference`)
against the JAX package's, and the port's tiled rasterizer held to it as
tests/test_rasterizer.py holds the JAX tiled rasterizer to its oracle, on
that file's scenes (64x64, 16x16 tiles, L = 64, k_dup 16; 40 Gaussians) and
at its tolerances: colour and alpha 2e-5, depth 2e-4; pose gradient rtol
5e-3 / atol 1e-7; parameter gradients rtol 1e-2 / atol 2e-6; n_touched of the
tiled renderer within a mean of 3 pixels of the oracle's, with the same
Gaussians touched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.geometry import se3_retract as j_se3_retract
from monogs_dev_tpu.ops import render_reference as j_render_reference
from monogs_dev_tpu_torch.geometry.lie import se3_retract
from monogs_dev_tpu_torch.models.gaussians import GaussianParams
from monogs_dev_tpu_torch.ops.rasterize import render_tiled
from monogs_dev_tpu_torch.ops.rasterize_ref import render_reference
from tests.test_rasterizer import CFG as JCFG
from tests.test_rasterizer import INTR as JINTR
from tests.test_torch_rasterizer import CFG, FIELDS, INTR, scene

torch.set_num_threads(2)

TAU = np.array([0.1, -0.05, 0.02, 0.03, -0.02, 0.01], np.float32)  # test_posed_camera's


def t_pose(tau=TAU):
    return se3_retract(torch.tensor(tau), torch.eye(4))


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_reference_matches_jax(sh_degree):
    jp, ja, tp, ta = scene(sh_degree=sh_degree)
    jo = j_render_reference(jp, ja, j_se3_retract(jnp.asarray(TAU), jnp.eye(4)), JINTR,
                            sh_degree, config=JCFG)
    to = render_reference(tp, ta, t_pose(), INTR, sh_degree, config=CFG)
    np.testing.assert_allclose(to.color.numpy(), np.asarray(jo.color), atol=2e-5)
    np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth), atol=2e-4)
    np.testing.assert_allclose(to.alpha.numpy(), np.asarray(jo.alpha), atol=2e-5)
    np.testing.assert_array_equal(to.n_touched.numpy(), np.asarray(jo.n_touched))
    assert int(to.n_touched.sum()) > 0 and float(to.alpha.max()) > 0.5


def test_reference_gradients_match_jax():
    """Every parameter field's gradient and the pose gradient of an L1
    colour loss plus an L1 depth loss, through each package's oracle."""
    jp, ja, tp, ta = scene()

    def j_loss(tau, p):
        out = j_render_reference(p, ja, j_se3_retract(tau, jnp.eye(4)), JINTR, 0, config=JCFG)
        return jnp.abs(out.color - 0.3).mean() + 0.1 * jnp.abs(out.depth - 1.0).mean()

    gj_tau, gj_p = jax.grad(j_loss, argnums=(0, 1))(jnp.zeros(6), jp)
    leaves = tp.map(lambda x: x.detach().requires_grad_(True))
    tau = torch.zeros(6, requires_grad=True)
    out = render_reference(leaves, ta, se3_retract(tau, torch.eye(4)), INTR, 0, config=CFG)
    loss = (out.color - 0.3).abs().mean() + 0.1 * (out.depth - 1.0).abs().mean()
    loss.backward()
    np.testing.assert_allclose(tau.grad.numpy(), np.asarray(gj_tau), rtol=5e-3, atol=1e-7)
    for name, gt in zip(FIELDS, leaves.values()):
        want = np.asarray(getattr(gj_p, name))
        got = np.zeros_like(want) if gt.grad is None else gt.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-6, err_msg=name)
    assert float(np.abs(np.asarray(gj_p.xyz)).max()) > 1e-4


@pytest.mark.parametrize("sh_degree,posed", [(0, False), (3, False), (0, True)],
                         ids=["sh0", "sh3", "posed"])
def test_tiled_matches_reference(sh_degree, posed):
    """tests/test_rasterizer.py::TestParityWithOracle on the port."""
    _, _, tp, ta = scene(sh_degree=sh_degree)
    T = t_pose() if posed else torch.eye(4)
    ref = render_reference(tp, ta, T, INTR, sh_degree, config=CFG)
    tiled = render_tiled(tp, ta, T, INTR, sh_degree, config=CFG)
    assert int(tiled.dup_overflow) == 0 and int(tiled.tile_overflow) == 0
    np.testing.assert_allclose(tiled.color.numpy(), ref.color.numpy(), atol=2e-5)
    np.testing.assert_allclose(tiled.depth.numpy(), ref.depth.numpy(), atol=2e-4)
    np.testing.assert_allclose(tiled.alpha.numpy(), ref.alpha.numpy(), atol=2e-5)
    ref_t, tiled_t = ref.n_touched.numpy(), tiled.n_touched.numpy()
    assert np.mean(np.abs(ref_t - tiled_t)) < 3.0
    assert np.array_equal(ref_t > 0, tiled_t > 0)


def _color_loss(render, tau, params, active, probe=None):
    out = render(params, active, se3_retract(tau, torch.eye(4)), INTR, 0, config=CFG,
                 means2d_probe=probe)
    return (out.color - 0.3).abs().mean()


def test_tiled_gradients_match_reference():
    """tests/test_rasterizer.py::TestGradients on the port: the pose and
    parameter gradients of the tiled renderer against the oracle's, and a
    nonzero means2d-probe gradient."""
    _, _, tp, ta = scene()
    grads = {}
    for name, render in (("tiled", render_tiled), ("ref", render_reference)):
        leaves = tp.map(lambda x: x.detach().requires_grad_(True))
        tau = torch.zeros(6, requires_grad=True)
        _color_loss(render, tau, leaves, ta).backward()
        grads[name] = (tau.grad.numpy(),
                       [np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy()
                        for x in leaves.values()])
    (t_tau, t_p), (r_tau, r_p) = grads["tiled"], grads["ref"]
    assert np.isfinite(t_tau).all() and np.linalg.norm(r_tau) > 1e-6
    np.testing.assert_allclose(t_tau, r_tau, rtol=5e-3, atol=1e-7)
    for name, gt, gr in zip(FIELDS, t_p, r_p):
        assert np.isfinite(gt).all(), name
        np.testing.assert_allclose(gt, gr, rtol=1e-2, atol=2e-6, err_msg=name)
    probe = torch.zeros((tp.xyz.shape[0], 2), requires_grad=True)
    _color_loss(render_tiled, torch.zeros(6), tp, ta, probe).backward()
    assert torch.isfinite(probe.grad).all() and float(probe.grad.abs().sum()) > 0.0


def test_reference_background_and_inactive():
    _, _, tp, ta = scene()
    far = GaussianParams(*[x + torch.tensor([100.0, 0.0, 0.0]) if i == 0 else x
                           for i, x in enumerate(tp.values())])
    bg = torch.tensor([0.2, 0.4, 0.6])
    out = render_reference(far, ta, torch.eye(4), INTR, 0, bg_color=bg, config=CFG)
    np.testing.assert_allclose(out.color.numpy(), np.tile(bg.numpy(), (64, 64, 1)), atol=1e-5)
    half = ta & (torch.arange(ta.shape[0]) < 20)
    a = render_reference(tp, half, torch.eye(4), INTR, 0, config=CFG)
    b = render_reference(tp.map(lambda x: x[:20]), half[:20], torch.eye(4), INTR, 0, config=CFG)
    np.testing.assert_allclose(a.color.numpy(), b.color.numpy(), atol=1e-6)
    assert not a.n_touched[20:].any()

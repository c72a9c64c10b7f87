"""The kernel lab's parity: the port's plain L1 variants and L2 (the CPU side
of ops/blend_lab.py) against `tools/kernel_lab.py::variant_blend` and
`::moments_bwd` in Pallas interpret mode, the lab scene against the JAX
package's draw, and the port's lab entry point on a small cut. The CUDA
kernels themselves are held against the plain versions by
tests/test_torch_gpu.py on a card.

Tolerances as in tests/test_torch_blend.py: colour and alpha 3e-5, depth
3e-4 (sums in another order; the rank-6 power of mxu and lean rounds
differently from the direct form, the same way in both packages); props
gradients rtol 2e-3 with an absolute floor of 1e-5 x the largest gradient."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as jax_compilation_cache

import monogs_dev_tpu.utils.compile_cache as compile_cache
from monogs_dev_tpu.data.synthetic import make_synthetic_scene
from monogs_dev_tpu.ops.blend_pallas import _fwd_rule
from monogs_dev_tpu_torch.data.synthetic import load_lab_scene
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.ops import blend as B
from monogs_dev_tpu_torch.ops import blend_lab as BL
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.tools import kernel_lab as KL
from tests.test_torch_blend import CFG, TX_N, _loss_weights, _xla_grads, make_props

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def no_persistent_compile_cache():
    """This module compiles its JAX programs with the persistent XLA cache
    (tests/conftest.py) off, and turns it back on after: the programs it
    checks the port against are neither read from nor written to the cache
    directory that the other test processes share."""
    enabled = jax.config.jax_enable_compilation_cache
    jax_compilation_cache.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    jax_compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def jlab(monkeypatch_module):
    """tools/kernel_lab.py, loaded by path: importing it turns on the JAX
    compile cache (a no-op here) and reads MONOGS_CHUNK / MONOGS_L (unset:
    chunks of 32, L = 512)."""
    monkeypatch_module.setattr(compile_cache, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch_module.delenv("MONOGS_CHUNK", raising=False)
    monkeypatch_module.delenv("MONOGS_L", raising=False)
    spec = importlib.util.spec_from_file_location("_jax_kernel_lab",
                                                  os.path.join(REPO, "tools", "kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.CHUNK == 32
    return mod


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_module_writes_nothing_to_a_compile_cache(tmp_path):
    """The persistent cache stays off through this module: a fresh program,
    which the cache's thresholds would keep, leaves no entry in the cache
    directory."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        jax_compilation_cache.reset_cache()
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        assert not jax.config.jax_enable_compilation_cache
        jax.jit(lambda x: x * 3.25 + 1.5)(jnp.arange(7.0)).block_until_ready()
        assert not os.listdir(tmp_path)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        jax_compilation_cache.reset_cache()


def lab_props():
    """Four tiles, zero past their counts: a mixed stack (64 entries), one
    whose count (45) is not a multiple of 32, a saturated opaque stack (alpha
    at its 0.99 clamp), and an empty tile."""
    props, _ = make_props(n_tiles=4, l_max=64, seed=5)
    sat, _ = make_props(n_tiles=4, l_max=64, seed=4, spread=6.0, scale=(8.0, 14.0),
                        opacity=(0.995, 0.999), counts=np.full(4, 64))
    props[2] = sat[2]
    counts = np.array([64, 45, 64, 0], np.int32)
    props[np.arange(64)[None, :] >= counts[:, None]] = 0.0
    return props, counts


@pytest.mark.parametrize("variant", BL.LAB_VARIANTS)
def test_lab_variant_matches_pallas(jlab, variant):
    props, counts = lab_props()
    want = [np.asarray(x) for x in jlab.variant_blend(variant, jnp.asarray(props),
                                                       jnp.asarray(counts), TX_N, 16, *CFG)]
    got = [x.numpy() for x in BL.lab_blend(variant, torch.tensor(props), torch.tensor(counts),
                                           TX_N, 16, *CFG, tile_group=3)]
    for name, a, b, tol in zip(("color", "depth", "alpha"), got, want, (3e-5, 3e-4, 3e-5)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
    assert got[2][2].min() > 0.99  # the opaque stack saturates every pixel
    assert not got[0][3].any()  # the empty tile renders nothing


def _moments_grad(props, counts, cots):
    p = torch.tensor(props)
    t_final, n_done = BL.blend_residuals(p, torch.tensor(counts), TX_N, 16, *CFG, tile_group=3)
    return BL.moments_backward(p, t_final, n_done, *(torch.tensor(c) for c in cots), TX_N, 16,
                               *CFG[:2], tile_group=3).numpy()


def test_moments_backward_matches_pallas_unsaturated(jlab):
    props, counts = make_props(seed=2)
    cots = _loss_weights(props.shape[0])
    _, res = _fwd_rule(jnp.asarray(props), jnp.asarray(counts), TX_N, 16, *CFG)
    want = np.asarray(jlab.moments_bwd(res, tuple(jnp.asarray(c) for c in cots), TX_N, 16, *CFG))
    got = _moments_grad(props, counts, cots)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5 * np.abs(want).max())


def test_moments_backward_saturated_matches_xla_blend():
    """Opaque stacks: the TPU lab's moments backward shares the Pallas
    backward's fault here (its divide-out starts from an underflowed
    transmittance), so the reference is the JAX package's XLA blend, as in
    test_torch_blend.py::test_saturated_tiles_and_clamped_alpha."""
    props, counts = make_props(n_tiles=4, seed=4, spread=6.0, scale=(8.0, 14.0),
                               opacity=(0.995, 0.999), counts=np.full(4, 64))
    want = _xla_grads(props, counts)
    got = _moments_grad(props, counts, _loss_weights(4))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5 * np.abs(want).max())


def _cut_props():
    """3,000 of the lab scene's blobs at 128x96: 48 tiles of up to 128
    entries, with seed-1 normal cotangents."""
    params = load_lab_scene("cpu").map(lambda x: x[:3000])
    tp, c = KL.tile_props(params, torch.ones(3000, dtype=torch.bool), torch.eye(4),
                          Intrinsics(fx=115.2, fy=115.2, cx=64.0, cy=48.0, width=128, height=96),
                          RasterConfig(max_per_tile=128, k_dup=16, tile_group=12))
    g = torch.Generator().manual_seed(1)
    cots = (torch.randn((48, 3, 256), generator=g), 0.1 * torch.randn((48, 256), generator=g),
            torch.randn((48, 256), generator=g))
    return tp, c, cots


def test_moments_backward_against_float64_autograd(jlab):
    """The conic gradients cancel in the moments form (d_cb = -(Sxy - my Sx
    - mx Sy + mx my S0)); the port's L2 sums its moments accurately against
    a tile-centred basis and stays within K2's tolerances of float64
    autograd through the plain blend. The JAX lab's fp32 moments are
    printed against the same reference, not asserted."""
    tp, c, cots = _cut_props()
    pr = tp.double().requires_grad_(True)
    out = B.blend_tiles_reference(pr, c, 8, 16, *CFG, tile_group=12)
    (g64,) = torch.autograd.grad(sum((o * w.double()).sum() for o, w in zip(out[:3], cots)), pr)
    g64 = g64.numpy()
    t_final, n_done = BL.blend_residuals(tp, c, 8, 16, *CFG, tile_group=12)
    got = BL.moments_backward(tp, t_final, n_done, *cots, 8, 16, *CFG[:2], tile_group=12).numpy()
    _, res = _fwd_rule(jnp.asarray(tp.numpy()), jnp.asarray(c.numpy()), 8, 16, *CFG)
    jax_lab = np.asarray(jlab.moments_bwd(res, tuple(jnp.asarray(x.numpy()) for x in cots),
                                          8, 16, *CFG))
    for name, x in (("port L2", got), ("JAX lab moments_bwd", jax_lab)):
        err = np.abs(x - g64)
        bad = err > 1e-5 + 2e-3 * np.abs(g64)
        print(f"{name} vs float64 autograd: max |err| {err.max():.3g}, {bad.sum()} of "
              f"{bad.size} outside rtol 2e-3 atol 1e-5 (max |g| {np.abs(g64).max():.3g})")
    np.testing.assert_allclose(got, g64, rtol=2e-3, atol=1e-5)


def test_residuals_match_plain_forward():
    """n_done is the prefix of entries each pixel multiplied in, and t_final
    the transmittance after them: blending only that prefix gives the same
    alpha map, and 1 - alpha = t_final where nothing was cut off."""
    props, counts = make_props(seed=6)
    p, c = torch.tensor(props), torch.tensor(counts)
    t_final, n_done = BL.blend_residuals(p, c, TX_N, 16, *CFG, tile_group=3)
    assert bool((n_done <= c[:, None]).all()) and int(n_done.max()) > 0
    color, depth, alpha, _ = B.blend_tiles_reference(p, c, TX_N, 16, *CFG, tile_group=3)
    open_px = t_final >= CFG[2]
    np.testing.assert_allclose((1.0 - alpha)[open_px].numpy(), t_final[open_px].numpy(),
                               atol=3e-5)


def test_lab_scene_is_the_jax_lab_draw():
    params, _ = make_synthetic_scene(jax.random.PRNGKey(0), n=32768, scale=0.03)
    got = load_lab_scene("cpu")
    for name, a in params._asdict().items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(a), err_msg=name)


def test_lab_entry_point_on_a_small_cut(capsys):
    """The port's lab (`tools/kernel_lab.py::run_lab`, what `python -m
    monogs_dev_tpu_torch.tools.kernel_lab --device cpu` runs) on 3,000 of
    the lab scene's blobs at 128x96: every variant runs and agrees with
    base (forward) or bwd (backward)."""
    params = load_lab_scene("cpu").map(lambda x: x[:3000])
    res = KL.run_lab(KL.ALL_VARIANTS, "cpu", reps=1, params=params,
                     active=torch.ones(3000, dtype=torch.bool),
                     intr=Intrinsics(fx=115.2, fy=115.2, cx=64.0, cy=48.0, width=128, height=96),
                     rcfg=RasterConfig(max_per_tile=128, k_dup=16, tile_group=12))
    assert set(res) == set(KL.ALL_VARIANTS)
    for v in BL.LAB_VARIANTS:
        for err, tol in zip(res[v]["err"], (3e-5, 3e-4, 3e-5)):
            assert err <= tol, v
    assert res["bwdmom"]["err"] <= 1e-5
    assert "counts mean/max" in capsys.readouterr().out


def test_cuda_wrappers_refuse_cpu_tensors():
    props, counts = lab_props()
    p, c = torch.tensor(props), torch.tensor(counts)
    with pytest.raises(ValueError, match="CUDA"):
        BL.lab_forward_cuda("nocond", p, c, TX_N, 16, *CFG)
    z = torch.zeros((4, 256))
    with pytest.raises(ValueError, match="CUDA"):
        BL.moments_backward_cuda(p, z, z.int(), torch.zeros((4, 3, 256)), z, z, TX_N, 16)
    with pytest.raises(ValueError, match="pair2 needs tile count"):
        BL.lab_blend("pair2", p[:3], c[:3], TX_N, 16)
    with pytest.raises(ValueError, match="unknown lab variant"):
        BL.lab_blend("pair3", p, c, TX_N, 16)
    for version in (2, 1):  # the launchers that time either version
        with pytest.raises(ValueError, match="CUDA"):
            BL.lab_forward_launcher("trimat", p, c, TX_N, 16, *CFG, version=version)
        with pytest.raises(ValueError, match="CUDA"):
            BL.moments_launcher(p, z, z.int(), torch.zeros((4, 3, 256)), z, z, TX_N, 16,
                                *CFG[:2], version=version)
    before = dict(B.LAUNCHES), dict(BL.VARIANT_LAUNCHES)
    BL.lab_blend("mxu", p, c, TX_N, 16)  # CPU tensors take the plain version
    assert (dict(B.LAUNCHES), dict(BL.VARIANT_LAUNCHES)) == before

"""Blend parity: the port's plain blend (the CPU side of ops/blend.py) against
the JAX Pallas blend kernels in interpret mode, values and props gradients,
and the CUDA wrappers' refusal of CPU tensors. The CUDA kernels themselves
are held against the plain blend by tests/test_torch_gpu.py on a card.

Tolerances: colour and alpha 3e-5, depth 3e-4 (sums of up to L terms in
another order, depth ~5 m); touch counts exact; props gradients rtol 2e-3
(rtol 5e-3 for the deep stack, whose transmittance chain is longer), with
an absolute floor of 1e-5 x the largest gradient."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.ops.blend_pallas import blend_tiles_pallas, blend_tiles_pallas_touch
from monogs_dev_tpu_torch.ops import blend as B

torch.set_num_threads(2)

TX_N, TILE = 4, 16
CFG = (0.99, 1.0 / 255.0, 1e-4)


def make_props(n_tiles=8, l_max=64, seed=0, spread=24.0, scale=(0.8, 6.0),
               opacity=(0.05, 0.99), counts=None):
    """Per-tile props (T, L, 10) in depth order and counts (T,), numpy."""
    rng = np.random.default_rng(seed)
    tid = np.arange(n_tiles)
    ox = (tid % TX_N) * TILE + 8.0
    oy = (tid // TX_N) * TILE + 8.0
    mu = np.stack([ox[:, None] + rng.uniform(-spread, spread, (n_tiles, l_max)),
                   oy[:, None] + rng.uniform(-spread, spread, (n_tiles, l_max))], -1)
    s1 = rng.uniform(*scale, (n_tiles, l_max))
    s2 = rng.uniform(*scale, (n_tiles, l_max))
    th = rng.uniform(0, np.pi, (n_tiles, l_max))
    c, s = np.cos(th), np.sin(th)
    a = c * c * s1 ** 2 + s * s * s2 ** 2
    b = c * s * (s1 ** 2 - s2 ** 2)
    cc = s * s * s1 ** 2 + c * c * s2 ** 2
    det = a * cc - b * b
    conic = np.stack([cc / det, -b / det, a / det], -1)
    rgb = rng.uniform(0, 1, (n_tiles, l_max, 3))
    opa = rng.uniform(*opacity, (n_tiles, l_max))
    z = np.sort(rng.uniform(1, 5, (n_tiles, l_max)), axis=1)
    props = np.concatenate([mu, conic, rgb, opa[..., None], z[..., None]], -1).astype(np.float32)
    if counts is None:
        counts = rng.integers(0, l_max + 1, n_tiles)
        counts[0] = 0
        counts[1] = l_max
    counts = np.asarray(counts, np.int32)
    props[np.arange(l_max)[None, :] >= counts[:, None]] = 0.0  # sentinel rows
    return props, counts


def run_jax(props, counts, touch):
    fn = blend_tiles_pallas_touch if touch else blend_tiles_pallas
    return [np.asarray(x) for x in fn(jnp.asarray(props), jnp.asarray(counts), TX_N, TILE, *CFG)]


def run_torch(props, counts, touch):
    fn = B.blend_tiles_touch if touch else B.blend_tiles
    return [x.detach().numpy() for x in fn(torch.tensor(props), torch.tensor(counts), TX_N, TILE,
                                            *CFG, tile_group=3)]


def assert_forward_close(out_t, out_j):
    np.testing.assert_allclose(out_t[0], out_j[0], atol=3e-5, err_msg="color")
    np.testing.assert_allclose(out_t[1], out_j[1], atol=3e-4, err_msg="depth")
    np.testing.assert_allclose(out_t[2], out_j[2], atol=3e-5, err_msg="alpha")


def test_forward_and_touch_match_pallas():
    props, counts = make_props()
    out_t = run_torch(props, counts, touch=True)
    out_j = run_jax(props, counts, touch=True)
    assert_forward_close(out_t, out_j)
    np.testing.assert_array_equal(out_t[3], out_j[3])
    assert out_t[3].sum() > 0
    # the forward without touch agrees with the touch variant
    for a, b in zip(run_torch(props, counts, touch=False), out_t[:3]):
        np.testing.assert_array_equal(a, b)


def test_empty_tiles_and_zero_counts_render_nothing():
    props, counts = make_props(counts=np.zeros(8, np.int32))
    color, depth, alpha, touch = run_torch(props, counts, touch=True)
    assert not color.any() and not depth.any() and not alpha.any() and not touch.any()
    # entries past counts never contribute, even with non-zero props
    props2, _ = make_props(counts=np.full(8, 64))
    out = run_torch(props2, np.zeros(8, np.int32), touch=True)
    assert not out[0].any() and not out[3].any()


def _loss_weights(n_tiles, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_tiles, 3, 256)).astype(np.float32),
            (0.1 * rng.normal(size=(n_tiles, 256))).astype(np.float32),
            rng.normal(size=(n_tiles, 256)).astype(np.float32))


def _grads(props, counts, touch):
    wc, wd, wa = _loss_weights(props.shape[0])
    fn_j = blend_tiles_pallas_touch if touch else blend_tiles_pallas

    def jloss(p):
        out = fn_j(p, jnp.asarray(counts), TX_N, TILE, *CFG)
        return (out[0] * wc).sum() + (out[1] * wd).sum() + (out[2] * wa).sum()

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(props)))
    p = torch.tensor(props, requires_grad=True)
    fn_t = B.blend_tiles_touch if touch else B.blend_tiles
    out = fn_t(p, torch.tensor(counts), TX_N, TILE, *CFG, tile_group=3)
    ((out[0] * torch.tensor(wc)).sum() + (out[1] * torch.tensor(wd)).sum()
     + (out[2] * torch.tensor(wa)).sum()).backward()
    return p.grad.numpy(), g_j


@pytest.mark.parametrize("touch", [False, True], ids=["K1-K2", "K3-K2"])
def test_props_gradients_match_pallas(touch):
    props, counts = make_props(seed=2)
    g_t, g_j = _grads(props, counts, touch)
    assert np.isfinite(g_t).all()
    np.testing.assert_allclose(g_t, g_j, rtol=2e-3, atol=1e-5 * np.abs(g_j).max())


def test_deep_stack_gradients():
    """>= 48 overlapping low-opacity entries per tile: the backward's
    transmittance recovery runs over a long chain."""
    props, counts = make_props(n_tiles=4, l_max=64, seed=3, spread=4.0, scale=(6.0, 12.0),
                               opacity=(0.05, 0.15), counts=np.full(4, 64))
    out_t = run_torch(props, counts, touch=True)
    assert out_t[3].min(axis=1).min() > 0  # every entry of every tile touched
    assert (out_t[3] > 0).sum(axis=1).min() >= 48
    assert_forward_close(out_t, run_jax(props, counts, touch=True))
    g_t, g_j = _grads(props, counts, touch=False)
    np.testing.assert_allclose(g_t, g_j, rtol=5e-3, atol=1e-5 * np.abs(g_j).max())


def _xla_grads(props, counts):
    """jax.grad through the JAX package's log-space XLA blend (`_blend_group`)."""
    from monogs_dev_tpu.ops.rasterize import _blend_group

    n_tiles = props.shape[0]
    wc, wd, wa = _loss_weights(n_tiles)
    tid = np.arange(n_tiles)
    ly, lx = np.meshgrid(np.arange(16.0), np.arange(16.0), indexing="ij")
    pix = np.stack([((tid % TX_N) * 16)[:, None] + lx.reshape(-1)[None],
                    ((tid // TX_N) * 16)[:, None] + ly.reshape(-1)[None]], -1).astype(np.float32)
    live = (np.arange(props.shape[1])[None, :] < counts[:, None]).astype(np.float32)

    def jloss(pp):
        c, d, a, _ = _blend_group(pp[..., 0:2], pp[..., 2:5], pp[..., 5:8], pp[..., 8] * live,
                                  pp[..., 9], jnp.asarray(pix), alpha_clamp=CFG[0],
                                  alpha_min=CFG[1], t_min=CFG[2], bg=jnp.zeros(3))
        return (jnp.swapaxes(c, 1, 2) * wc).sum() + (d * wd).sum() + (a * wa).sum()

    return np.asarray(jax.grad(jloss)(jnp.asarray(props)))


def test_saturated_tiles_and_clamped_alpha():
    """Opaque stacks: alpha hits the 0.99 clamp and transmittance drops
    below t_min early (gradient zero at the clamp, early stop). Forward and
    touch against the Pallas kernel; gradients against the JAX package's
    XLA blend, because the Pallas backward is wrong here: it recovers T by
    dividing out of a final transmittance taken after whole 64-entry
    blocks, which underflows to 0 under tens of 0.99 factors. The Pallas
    gradient's distance from the XLA one is printed, not asserted, so the
    test keeps passing once that fault is fixed."""
    props, counts = make_props(n_tiles=4, seed=4, spread=6.0, scale=(8.0, 14.0),
                               opacity=(0.995, 0.999), counts=np.full(4, 64))
    out_t = run_torch(props, counts, touch=True)
    out_j = run_jax(props, counts, touch=True)
    assert_forward_close(out_t, out_j)
    np.testing.assert_array_equal(out_t[3], out_j[3])
    g_t, g_pallas = _grads(props, counts, touch=False)
    g_x = _xla_grads(props, counts)
    np.testing.assert_allclose(g_t, g_x, rtol=2e-3, atol=1e-5 * np.abs(g_x).max())
    print(f"Pallas backward vs XLA blend: max |err| {np.abs(g_pallas - g_x).max():.3g} "
          f"at max |grad| {np.abs(g_x).max():.3g}")


def test_cuda_wrappers_refuse_cpu_tensors():
    props, counts = make_props(n_tiles=2)
    p, c = torch.tensor(props), torch.tensor(counts)
    with pytest.raises(ValueError, match="CUDA"):
        B.blend_forward_cuda(p, c, TX_N, TILE, *CFG, emit_touch=False)
    z = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="CUDA"):
        B.blend_backward_cuda(p, z, z.int(), torch.zeros((2, 3, 256)), z, z, TX_N, TILE,
                              0.99, 1.0 / 255.0)
    before = dict(B.LAUNCHES)
    B.blend_tiles(p, c, TX_N, TILE)  # CPU tensors take the plain version
    assert B.LAUNCHES == before


def test_each_source_builds_with_its_own_flags():
    """Version 2 (blend.cu, blend_lab.cu) contracts multiply-adds: it rounds
    power, alpha and the transmittance by hand; so does the projection
    (project.cu), which rounds its forward's row by hand. The first versions
    (blend_v1.cu, blend_lab_v1.cu) keep -fmad=false. Every source gets one
    `nvcc -c` into its own object, and the library's name hashes the flags."""
    cmds = B.compile_commands("nvcc", "/build", verbose=True)
    by_src = {cmd[-1].rsplit("/", 1)[-1]: cmd for cmd in cmds}
    assert set(by_src) == {"blend.cu", "blend_v1.cu", "blend_lab.cu", "blend_lab_v1.cu",
                           "project.cu"}
    for name in ("blend.cu", "blend_lab.cu", "project.cu"):
        assert "-fmad=false" not in by_src[name]
    for name in ("blend_v1.cu", "blend_lab_v1.cu"):
        assert "-fmad=false" in by_src[name]
    for name, cmd in by_src.items():
        assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-4:-1] == ["-c", "-o", f"/build/{name}.o"] and "-v" in cmd
    assert "-v" not in B.compile_commands("nvcc", "/build")[0]
    key = B.library_path()
    flags = dict(B.SOURCE_FLAGS)
    try:
        B.SOURCE_FLAGS["blend.cu"] = ["-fmad=false"]
        assert B.library_path() != key
    finally:
        B.SOURCE_FLAGS.clear()
        B.SOURCE_FLAGS.update(flags)
    assert B.library_path() == key


def test_library_links_the_shared_cuda_runtime(tmp_path, monkeypatch):
    """The link asks for the shared CUDA runtime (nvcc's default is the
    static one, a second runtime beside torch's), and the library's name
    hashes the link flags. nvcc is stood in for: it records its commands."""
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "", ""

    def run(cmd, **kwargs):
        Proc(cmd)
        return Proc.__new__(Proc)

    monkeypatch.setattr(B, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(B, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(B.subprocess, "Popen", Proc)
    monkeypatch.setattr(B.subprocess, "run", run)
    path, _ = B.build()
    link = calls[-1]
    assert "-shared" in link and link[link.index("-cudart") + 1] == "shared"
    assert os.path.exists(path)
    key = B.library_path()
    monkeypatch.setattr(B, "LINK_FLAGS", ["-shared"])
    assert B.library_path() != key


@pytest.mark.parametrize("tile", [(16, 15), (8, 3), (16, 128)])
def test_cuda_wrappers_refuse_tiles_the_kernels_do_not_take(tile):
    """One thread per pixel, whole warps, one block: a multiple of 32 pixels
    up to 1024. Checked before the device, so the CPU sees it."""
    props, counts = make_props(n_tiles=2)
    p, c = torch.tensor(props), torch.tensor(counts)
    with pytest.raises(ValueError, match="tile of"):
        B.blend_forward_cuda(p, c, TX_N, tile, *CFG, emit_touch=False)
    z = torch.zeros((2, tile[0] * tile[1]))
    with pytest.raises(ValueError, match="tile of"):
        B.backward_launcher(p, z, z.int(), torch.zeros((2, 3, z.shape[1])), z, z, TX_N, tile,
                            0.99, 1.0 / 255.0)


def test_launchers_refuse_cpu_tensors():
    props, counts = make_props(n_tiles=2)
    p, c = torch.tensor(props), torch.tensor(counts)
    before = dict(B.LAUNCHES)
    z = torch.zeros((2, 256))
    for version in (2, 1):
        with pytest.raises(ValueError, match="CUDA"):
            B.forward_launcher(p, c, TX_N, TILE, *CFG, emit_touch=True, version=version)
        with pytest.raises(ValueError, match="CUDA"):
            B.backward_launcher(p, z, z.int(), torch.zeros((2, 3, 256)), z, z, TX_N, TILE,
                                0.99, 1.0 / 255.0, version=version)
    assert dict(B.LAUNCHES) == before


def test_no_system_module_reaches_the_first_version():
    """Version 1 of K1-K3 (csrc/blend_v1.cu) and of the lab's L1/L2
    (csrc/blend_lab_v1.cu) is reached only through the launchers with
    `version=1`: `forward_launcher`/`backward_launcher` (ops/blend.py) and
    `lab_forward_launcher`/`moments_launcher` (ops/blend_lab.py). No module
    of the port and no entry point calls the launchers or names a version-1
    entry point, except those two modules, whose counted wrappers call them
    with the default version 2 (the entry points' names live in ops/blend.py):
    no SLAM or lab run can launch version 1."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "monogs_dev_tpu_torch")
    blend_py = os.path.join(pkg, "ops", "blend.py")
    lab_py = os.path.join(pkg, "ops", "blend_lab.py")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files += [os.path.join(root, f) for f in ("slam_torch.py", "bench_torch.py")]
    # every argument but `version`, and the one module that may call each
    n_args = {"forward_launcher": (8, blend_py), "backward_launcher": (10, blend_py),
              "lab_forward_launcher": (8, lab_py), "moments_launcher": (10, lab_py)}
    calls = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                func = node.func
                name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
                if name in n_args:
                    n, owner = n_args[name]
                    assert path == owner, f"{path}:{node.lineno} calls {name}"
                    assert not node.keywords and len(node.args) == n, node.lineno
                    calls.append(name)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert path == blend_py or "_v1" not in node.value, f"{path}:{node.lineno}"
    assert sorted(calls) == sorted(n_args)
    assert set(B.LAB_ENTRIES[1]) == {"lab_blend_fwd_v1", "lab_moments_bwd_v1"}


def _reach_inputs(kind):
    """(props (T, L, 10), tiles across) for the reach test: a cut of the
    committed lab scene (3,000 blobs at 128x96, tiles of up to 128 entries),
    or the card tests' `l128_edge` props (opacity under alpha_min, conics
    near singular, footprints wider than a tile) with footprints down to
    0.3 px."""
    if kind == "lab_scene":
        from monogs_dev_tpu_torch.data.synthetic import load_lab_scene
        from monogs_dev_tpu_torch.models.camera import Intrinsics
        from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
        from monogs_dev_tpu_torch.tools.kernel_lab import tile_props

        params = load_lab_scene("cpu").map(lambda x: x[:3000])
        tp, _ = tile_props(params, torch.ones(3000, dtype=torch.bool), torch.eye(4),
                           Intrinsics(fx=115.2, fy=115.2, cx=64.0, cy=48.0, width=128, height=96),
                           RasterConfig(max_per_tile=128, k_dup=16, tile_group=12))
        return tp, 8
    from tests.test_torch_gpu import CASES, TX_N as GPU_TX_N, _case_props, _props

    props, _ = _case_props("l128_edge", seed=7)
    small, _ = _props(l_max=CASES["l128"][0], scale=(0.3, 1.0), seed=8)
    return torch.tensor(np.concatenate([props, small], axis=1)), GPU_TX_N


@pytest.mark.parametrize("rank6", [False, True], ids=["direct", "rank6"])
@pytest.mark.parametrize("kind", ["lab_scene", "l128_edge"])
def test_entry_reach_bounds_alpha(kind, rank6):
    """The kernels skip an entry for the pixels outside its reach box
    (csrc/blend.cu, blend_lab.cu::entry_reach): no pixel where the entry's
    alpha, in either power form of the lab (direct, or the rank-6 form of mxu
    and lean, ops/blend_lab.py::_chunk_alpha), is >= alpha_min may lie
    outside the box. The box must also skip something."""
    from monogs_dev_tpu_torch.ops.blend_lab import _chunk_alpha, _pixel_coords

    props, tx_n = _reach_inputs(kind)
    n_tiles = props.shape[0]
    tid = torch.arange(n_tiles)
    ox, oy = ((tid % tx_n) * TILE).float(), ((tid // tx_n) * TILE).float()
    lx, ly = _pixel_coords(TILE, TILE, "cpu")
    alpha = _chunk_alpha(props, ox, oy, lx, ly, rank6, CFG[0], CFG[1])  # (T, L, P)
    rx, ry = B.entry_reach_reference(props, CFG[1])
    dx = (ox[:, None, None] + lx) - props[..., 0:1]
    dy = (oy[:, None, None] + ly) - props[..., 1:2]
    outside = (dx.abs() > rx[..., None]) | (dy.abs() > ry[..., None])
    hit = alpha >= CFG[1]
    assert int(hit.sum()) > 0
    assert int((hit & outside).sum()) == 0
    # the hit nearest its box's edge, as a share of the half-width
    edge = torch.maximum(dx.abs() / rx[..., None], dy.abs() / ry[..., None])[hit]
    assert float(edge.max()) < 1.0
    assert float(outside.float().mean()) > 0.3
    if kind == "l128_edge":  # both kinds of unbounded reach are in the inputs
        assert bool(torch.isneginf(rx).any()) and bool(torch.isposinf(rx).any())

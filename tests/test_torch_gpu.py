"""The CUDA blend kernels (K1-K3) and the kernel lab's (L1 variants, L2)
against their plain torch versions, on a card; K1-K3 also against their
first version (csrc/blend_v1.cu), which they must reproduce, and L1/L2's
first version (csrc/blend_lab_v1.cu) against the same plain versions.

Every test here is marked `gpu` and skips itself without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs where only
torch is installed (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances as in tests/test_torch_blend.py: colour and alpha 3e-5, depth
3e-4, touch counts exact, props gradients rtol 2e-3 with an absolute floor
of 1e-5 x the largest gradient. Both versions round alpha and the
transmittance as the plain version does, so touch counts, n_done and
t_final of the two versions are equal bit for bit.

The kernels stage entries in batches (version 1: 256; version 2: 128 in
the forward, 64 in the backward), so the cases with 512 entries per tile
(the bench's `max_per_tile`) run the multi-batch path: staging of later
batches, the tile's early exit at a batch boundary, touch writes past the
first batch and the backward's replay across batches; `l512_ragged` sets
counts that are no multiple of a batch. The opacity ranges make stacks that
stay transparent through all 512 entries, that saturate inside the first
batch (alpha at its 0.99 clamp), and a mix of both; `l512_sparse` scatters
footprints of about a pixel, so that most warps miss most entries (the
per-warp skips); `l128_edge` mixes in opacities under alpha_min,
conics near singular and footprints wider than a tile."""

import collections
import functools
import os

import numpy as np
import pytest
import torch

from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.gaussians import GaussianParams
from monogs_dev_tpu_torch.ops import blend as B
from monogs_dev_tpu_torch.ops import blend_lab as BL
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.ops.rasterize import render_tiled

CFG = (0.99, 1.0 / 255.0, 1e-4)
TX_N = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (entries per tile, opacity range, footprint std in pixels)
CASES = {
    "l128": (128, (0.05, 0.999), (1.0, 8.0)),
    "l512_mixed": (512, (0.05, 0.999), (1.0, 8.0)),
    "l512_low_opacity": (512, (0.003, 0.03), (1.0, 8.0)),
    "l512_saturated": (512, (0.9, 0.999), (1.0, 8.0)),
    "l512_sparse": (512, (0.05, 0.999), (0.3, 1.2)),
    "l512_ragged": (512, (0.003, 0.3), (1.0, 8.0)),
    "l128_edge": (128, (0.05, 0.999), (1.0, 8.0)),
}
# counts of l512_ragged's tiles 8..15: no multiple of 64, 128 or 256
RAGGED_COUNTS = (511, 449, 385, 321, 257, 193, 129, 1)


def _props(n_tiles=64, l_max=128, opacity=(0.05, 0.999), scale=(1.0, 8.0), seed=0):
    rng = np.random.default_rng(seed)
    tid = np.arange(n_tiles)
    mu = np.stack([(tid % TX_N)[:, None] * 16 + rng.uniform(-16, 32, (n_tiles, l_max)),
                   (tid // TX_N)[:, None] * 16 + rng.uniform(-16, 32, (n_tiles, l_max))], -1)
    s = rng.uniform(*scale, (n_tiles, l_max, 2))
    conic = np.stack([1 / s[..., 0] ** 2, rng.uniform(-0.01, 0.01, (n_tiles, l_max)),
                      1 / s[..., 1] ** 2], -1)
    rest = np.concatenate([rng.uniform(0, 1, (n_tiles, l_max, 3)),
                           rng.uniform(*opacity, (n_tiles, l_max, 1)),
                           np.sort(rng.uniform(1, 5, (n_tiles, l_max, 1)), axis=1)], -1)
    props = np.concatenate([mu, conic, rest], -1).astype(np.float32)
    counts = rng.integers(0, l_max + 1, n_tiles).astype(np.int32)
    counts[:4] = 0
    counts[4:8] = l_max
    return props, counts


def _case_props(case, seed):
    l_max, opacity, scale = CASES[case]
    props, counts = _props(l_max=l_max, opacity=opacity, scale=scale, seed=seed)
    if case == "l512_ragged":
        counts[8:16] = RAGGED_COUNTS
    if case == "l128_edge":  # what the kernels' per-entry reach must not skip wrongly
        rng = np.random.default_rng(seed + 100)
        pick = rng.uniform(size=props.shape[:2])
        props[..., 8] = np.where(pick < 0.25, rng.uniform(0.0, 1.0 / 255.0, pick.shape),
                                 props[..., 8])  # opacity under alpha_min
        flat = (pick >= 0.25) & (pick < 0.4)  # conics near singular: no bounded reach
        props[..., 3] = np.where(flat, 0.9999 * np.sqrt(props[..., 2] * props[..., 4]),
                                 props[..., 3])
        props[..., 2] = np.where(pick >= 0.95, 1e-6, props[..., 2])  # footprints wider than a tile
    return props, counts


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_forward_kernels_match_plain(cuda, case):
    props, counts = _case_props(case, seed=0)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    ref = B.blend_tiles_reference(p, c, TX_N, 16, *CFG)
    for touch in (False, True):
        out = B.blend_forward_cuda(p, c, TX_N, 16, *CFG, emit_touch=touch)
        launch, v1 = B.forward_launcher(p, c, TX_N, 16, *CFG, emit_touch=touch, version=1)
        launch()
        torch.cuda.synchronize()
        for a, b, tol in zip(out[:3], ref[:3], (3e-5, 3e-4, 3e-5)):
            assert float((a - b).abs().max()) <= tol
        for a, b, tol in zip(out[:3], v1[:3], (3e-5, 3e-4, 3e-5)):
            assert float((a - b).abs().max()) <= tol
        assert torch.equal(out[3], v1[3]) and torch.equal(out[4], v1[4])  # t_final, n_done
        if touch:
            assert torch.equal(out[5], ref[3]) and torch.equal(out[5], v1[5])
        assert bool((out[4] <= c[:, None]).all())  # n_done never passes counts
        if case in ("l512_mixed", "l512_low_opacity", "l512_ragged"):
            assert int(out[4].max()) > 256  # pixels blended entries of a later batch


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernel_matches_plain_autograd(cuda, case):
    props, counts = _case_props(case, seed=1)
    c = torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]
    grads = []
    for fn in (B.blend_tiles, lambda *a: B.blend_tiles_reference(*a)[:3]):
        p = torch.tensor(props, device=cuda, requires_grad=True)
        out = fn(p, c, TX_N, 16, *CFG)
        sum((o * wi).sum() for o, wi in zip(out, w)).backward()
        grads.append(p.grad)
    with torch.no_grad():
        p = torch.tensor(props, device=cuda)
        _, _, _, t_final, n_done, _ = B.blend_forward_cuda(p, c, TX_N, 16, *CFG, emit_touch=False)
        launch, d_props = B.backward_launcher(p, t_final, n_done, *w, TX_N, 16, *CFG[:2],
                                              version=1)
        launch()
        grads.append(d_props)
    k, r, v1 = grads
    assert bool(torch.isfinite(k).all())
    for ref in (r, v1):
        assert bool(((k - ref).abs() <= 2e-3 * ref.abs() + 1e-5 * ref.abs().max()).all())


@pytest.mark.gpu
def test_backward_kernel_is_deterministic(cuda):
    """Version 2 adds each warp's gradient row in a fixed order, without
    atomics: two launches on the same inputs agree bit for bit."""
    props, counts = _case_props("l512_mixed", seed=1)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]
    _, _, _, t_final, n_done, _ = B.blend_forward_cuda(p, c, TX_N, 16, *CFG, emit_touch=False)
    a = B.blend_backward_cuda(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    b = B.blend_backward_cuda(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_two_threads_on_two_streams_match_one(cuda):
    """Two host threads, each on a CUDA stream of its own (as the frontend
    and the backend thread run), launch K1 and K2 (through autograd) on the
    same inputs REPS times: every result equals a single-thread launch bit
    for bit, and the launch counts add up exactly, by kernel and by thread."""
    import threading

    reps = 20
    props, counts = _case_props("l512_mixed", seed=2)
    p0, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]

    def once():
        p = p0.clone().requires_grad_(True)
        out = B.blend_tiles(p, c, TX_N, 16, *CFG)
        sum((o * wi).sum() for o, wi in zip(out, w)).backward()
        return [o.detach() for o in out] + [p.grad]

    want = once()
    torch.cuda.synchronize()
    B.reset_launch_counts()
    results, errors = {}, []

    def worker():
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                got = [once() for _ in range(reps)]
            stream.synchronize()
            results[threading.current_thread().name] = got
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, name=f"worker{i}") for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert sorted(results) == ["worker0", "worker1"]
    for name, got in results.items():
        for r in got:
            for a, b in zip(r, want):
                assert torch.equal(a, b), name
    assert B.LAUNCHES["K1"] == 2 * reps and B.LAUNCHES["K2"] == 2 * reps
    assert B.THREAD_LAUNCHES["worker0"]["K1"] == B.THREAD_LAUNCHES["worker1"]["K1"] == reps
    assert sum(n.get("K2", 0) for n in B.THREAD_LAUNCHES.values()) == 2 * reps


@pytest.mark.gpu
def test_launchers_time_the_kernels_alone(cuda):
    """`forward_launcher`/`backward_launcher` relaunch a kernel of either
    version into the same outputs and count nothing."""
    props, counts = _case_props("l128", seed=2)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    before = dict(B.LAUNCHES)
    for version in (2, 1):
        launch, out = B.forward_launcher(p, c, TX_N, 16, *CFG, emit_touch=True, version=version)
        launch()
        first = [x.clone() for x in out]
        launch()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, out))
        launch, d_props = B.backward_launcher(p, out[3], out[4], torch.ones((64, 3, 256), device=cuda),
                                              torch.ones((64, 256), device=cuda),
                                              torch.ones((64, 256), device=cuda), TX_N, 16,
                                              *CFG[:2], version=version)
        launch()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(d_props).all()) and float(d_props.abs().max()) > 0
    assert dict(B.LAUNCHES) == before


@pytest.mark.gpu
def test_render_tiled_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    n = 400
    q = rng.normal(size=(n, 4))
    arrays = dict(
        xyz=np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)], -1),
        f_dc=rng.uniform(-1, 1, (n, 1, 3)), f_rest=np.zeros((n, 0, 3)),
        log_scales=np.log(rng.uniform(0.03, 0.1, (n, 3))),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True), opacity_logit=rng.uniform(-1, 3, n))
    intr = Intrinsics(100.0, 100.0, 64.0, 48.0, 128, 96)
    cfg = RasterConfig(max_per_tile=256, k_dup=16, tile_group=16)
    outs = []
    for dev in ("cpu", cuda):
        params = GaussianParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                                   for k, v in arrays.items()})
        outs.append(render_tiled(params, torch.ones(n, dtype=torch.bool, device=dev),
                                 torch.eye(4, device=dev), intr, 0, config=cfg))
    cpu, gpu = outs
    for name, tol in (("color", 3e-5), ("alpha", 3e-5), ("depth", 3e-4)):
        assert float((getattr(gpu, name).cpu() - getattr(cpu, name)).abs().max()) <= tol, name
    # expf on the card and exp on the CPU differ in the last bit, which can
    # move a pixel across the alpha_min or t_min threshold
    diff = (gpu.n_touched.cpu() - cpu.n_touched).abs()
    assert int(diff.max()) <= 2 and float((diff > 0).float().mean()) < 0.01
    assert int(gpu.n_touched.sum()) > 0


def _lab_props(case, seed):
    """The cases above with props zeroed past each tile's count (the L1
    contract) and a tile count that pair4 divides."""
    props, counts = _case_props(case, seed)
    counts[8] = 100  # a count that is not a multiple of 32
    props[np.arange(props.shape[1])[None, :] >= counts[:, None]] = 0.0
    return props, counts


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BL.LAB_VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_lab_forward_kernel_matches_plain(cuda, case, variant):
    """Both versions of L1 against the plain version, on every case: the
    edge inputs check version 2's reach skip (also against the rank-6 power
    of mxu and lean), the saturated and 512-entry ones its saturation exit
    and its staging across batches."""
    props, counts = _lab_props(case, seed=2)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    ref = BL.lab_blend_reference(variant, p, c, TX_N, 16, *CFG)
    before = BL.VARIANT_LAUNCHES[variant]
    out = BL.lab_blend(variant, p, c, TX_N, 16, *CFG)
    launch, v1 = BL.lab_forward_launcher(variant, p, c, TX_N, 16, *CFG, version=1)
    launch()
    torch.cuda.synchronize()
    assert BL.VARIANT_LAUNCHES[variant] == before + 1
    for got in (out, v1):
        for name, a, b, tol in zip(("color", "depth", "alpha"), got, ref, (3e-5, 3e-4, 3e-5)):
            assert float((a - b).abs().max()) <= tol, name


def _lab_backward_inputs(case, seed, cuda):
    props, counts = _lab_props(case, seed=seed)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]
    t_final, n_done = BL.blend_residuals(p, c, TX_N, 16, *CFG)
    return p, c, w, t_final, n_done


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_lab_moments_backward_matches_plain(cuda, case):
    """Both versions of L2 against its plain version and against float32
    autograd through the plain blend."""
    p, c, w, t_final, n_done = _lab_backward_inputs(case, 3, cuda)
    got = BL.moments_backward(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    launch, v1 = BL.moments_launcher(p, t_final, n_done, *w, TX_N, 16, *CFG[:2], version=1)
    launch()
    plain = BL.moments_backward_reference(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    pr = p.clone().requires_grad_(True)
    out = B.blend_tiles_reference(pr, c, TX_N, 16, *CFG)
    sum((o * wi).sum() for o, wi in zip(out[:3], w)).backward()
    torch.cuda.synchronize()
    for x in (got, v1):
        assert bool(torch.isfinite(x).all())
        for ref in (plain, pr.grad):
            assert bool(((x - ref).abs() <= 2e-3 * ref.abs() + 1e-5 * ref.abs().max()).all())


@pytest.mark.gpu
def test_lab_moments_backward_is_deterministic(cuda):
    """Version 2 of L2 combines each warp's moment row in a fixed order,
    without atomics: two launches on the same inputs agree bit for bit."""
    p, _, w, t_final, n_done = _lab_backward_inputs("l512_mixed", 3, cuda)
    a = BL.moments_backward(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    b = BL.moments_backward(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    assert torch.equal(a, b) and float(a.abs().max()) > 0


@pytest.mark.gpu
def test_lab_launchers_time_the_kernels_alone(cuda):
    """`lab_forward_launcher`/`moments_launcher` relaunch a kernel of either
    version into the same outputs and count nothing."""
    p, c, w, t_final, n_done = _lab_backward_inputs("l128", 4, cuda)
    before = dict(B.LAUNCHES), dict(BL.VARIANT_LAUNCHES)
    for version in (2, 1):
        for variant in ("nocond", "lean", "pair4"):
            launch, out = BL.lab_forward_launcher(variant, p, c, TX_N, 16, *CFG, version=version)
            launch()
            first = [x.clone() for x in out]
            launch()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, out))
            assert float(out[2].max()) > 0
        launch, d_props = BL.moments_launcher(p, t_final, n_done, *w, TX_N, 16, *CFG[:2],
                                              version=version)
        launch()
        first = d_props.clone()
        launch()
        torch.cuda.synchronize()
        assert torch.equal(first, d_props) and float(d_props.abs().max()) > 0
    assert (dict(B.LAUNCHES), dict(BL.VARIANT_LAUNCHES)) == before


@pytest.mark.gpu
def test_backward_kernel_zero_for_masked_tiles(cuda):
    """A tile mask zeroes tiles' counts (ops/rasterize.py::render_binned):
    K2 must return zero d_props for every entry of such a tile, and for the
    entries past each tile's count, whatever their props hold."""
    props, counts = _case_props("l128", seed=3)
    counts[::3] = 0
    c = torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]
    p = torch.tensor(props, device=cuda, requires_grad=True)
    out = B.blend_tiles(p, c, TX_N, 16, *CFG)
    sum((o * wi).sum() for o, wi in zip(out, w)).backward()
    past = torch.arange(p.shape[1], device=cuda)[None, :] >= c[:, None]
    assert bool((p.grad[past] == 0.0).all())
    assert bool((p.grad[torch.tensor(counts == 0, device=cuda)] == 0.0).all())
    assert float(p.grad[~past].abs().max()) > 0.0
    assert bool((out[2][torch.tensor(counts == 0, device=cuda)] == 0.0).all())


def _tracking_scene(dev):
    rng = np.random.default_rng(4)
    n = 1500
    q = rng.normal(size=(n, 4))
    # blobs on the left of the view only: the edge mask leaves the empty
    # tiles on the right out of the blend
    arrays = dict(
        xyz=np.stack([rng.uniform(-1.5, 0.3, n), rng.uniform(-1, 1, n), rng.uniform(2, 5, n)], -1),
        f_dc=rng.uniform(-1, 1, (n, 1, 3)), f_rest=np.zeros((n, 0, 3)),
        log_scales=np.log(rng.uniform(0.02, 0.08, (n, 3))),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True), opacity_logit=rng.uniform(0, 3, n))
    return GaussianParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                             for k, v in arrays.items()})


@pytest.mark.gpu
def test_tracking_gradient_kernels_match_plain_blend(cuda, monkeypatch):
    """The Adam tracker's first-iteration loss and (tau, exposure) gradient
    at 160x128 with the real edge mask (some tiles masked): through K1/K2
    against the same through the plain blend on the card, gradient within
    1e-3 x max|g|, loss within 1e-5 relative."""
    from monogs_dev_tpu_torch.core import tracking as tt
    from monogs_dev_tpu_torch.core.params import StepConfig
    from monogs_dev_tpu_torch.ops import rasterize as R
    from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

    intr = Intrinsics(140.0, 140.0, 80.0, 64.0, 160, 128)
    rcfg = RasterConfig(max_per_tile=256, k_dup=16, tile_group=16)
    cfg = StepConfig(alpha=0.9)
    params = _tracking_scene(cuda)
    active = torch.ones(params.xyz.shape[0], dtype=torch.bool, device=cuda)
    with torch.no_grad():
        gt = render_tiled(params, active, torch.eye(4, device=cuda), intr, 0, config=rcfg,
                          need_touched=False)
    image = torch.clamp(gt.color, 0.0, 1.0)
    depth = torch.where(gt.alpha < 0.5, torch.zeros_like(gt.depth), gt.depth / gt.alpha)
    T = torch.eye(4, device=cuda)
    T[:3, 3] = torch.tensor([0.01, -0.008, 0.012], device=cuda)
    mask = compute_grad_mask(image, cfg.edge_threshold, False)
    tile_mask = tt.tile_mask_of(mask, intr, rcfg)
    assert 0 < int(tile_mask.sum()) < tile_mask.numel()
    with torch.no_grad():
        proj = R.project_gaussians(params, active, T, intr, 0)
        binning = R.build_binning(proj, intr, rcfg, dilate=cfg.rebin_dilation)
    args = (T, torch.zeros(2, device=cuda), params, active, binning, image, depth, mask,
            tile_mask, torch.zeros(3, device=cuda), cfg, intr, rcfg, True)
    before = B.LAUNCHES["K2"]
    loss_k, g_k = tt.pose_gradient(*args)
    assert B.LAUNCHES["K2"] > before
    monkeypatch.setattr(R, "blend_tiles", lambda *a: B.blend_tiles_reference(*a)[:3])
    loss_p, g_p = tt.pose_gradient(*args)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    assert float((g_k - g_p).abs().max()) <= 1e-3 * float(g_p.abs().max())
    assert float(g_p[:6].abs().max()) > 0.0


@pytest.mark.gpu
def test_ssim_and_lpips_on_card_match_cpu(cuda):
    from monogs_dev_tpu_torch.eval.lpips import lpips
    from monogs_dev_tpu_torch.utils.losses import psnr, ssim

    rng = np.random.default_rng(5)
    a = rng.uniform(size=(120, 160, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ca, cb = ta.to(cuda), tb.to(cuda)
    assert abs(float(ssim(ca, cb)) - float(ssim(ta, tb))) <= 1e-6
    assert abs(float(psnr(ca, cb)) - float(psnr(ta, tb))) <= 1e-5
    assert abs(lpips(ca, cb) - lpips(ta, tb)) <= 1e-5 * lpips(ta, tb)


# --------------------------------------------------------------- ingest (data/)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_png_unfilter_on_card_machine_matches_plain(cuda, tmp_path):
    """The C unfilter, built with the card machine's host compiler, against
    its plain version on every filter type and mode, and on VGA frames of
    TUM's two modes, Paeth-filtered as the writer writes them, against the
    frames themselves."""
    from monogs_dev_tpu_torch.data import image_io

    rng = np.random.default_rng(0)
    for arr in (rng.integers(0, 256, (33, 47, 3), dtype=np.uint8),
                rng.integers(0, 65536, (21, 30), dtype=np.uint16),
                rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)):
        info, raw = image_io.parse_png(image_io.encode_png(arr))
        rows = np.frombuffer(raw, np.uint8).reshape(info.height, -1).copy()
        rows[:, 0] = np.arange(info.height) % 5  # every filter type, as data
        raw = rows.tobytes()
        bpp = info.channels * info.sample_bytes
        a = np.empty((info.height, info.stride), np.uint8)
        b = np.empty_like(a)
        image_io.unfilter_c(raw, a, info.height, info.stride, bpp)
        image_io.unfilter_plain(raw, b, info.height, info.stride, bpp)
        assert np.array_equal(a, b)
    for arr in (rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
                rng.integers(0, 65536, (480, 640), dtype=np.uint16)):
        assert np.array_equal(image_io.decode_png(image_io.encode_png(arr)), arr)


def _euroc_pair(dev, w=160, h=120):
    """Frame 1 of `write_euroc`'s rectified pair at w x h, as grey uint8."""
    from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
    from monogs_dev_tpu_torch.models.camera import Intrinsics as I
    from monogs_dev_tpu_torch.tools import make_fixtures as mf

    params, active = mf.load_params(os.path.join(SCENE_DIR, "surface_seed0_n6000.npz"), dev)
    fx = 0.9 * w
    intr = I(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, width=w, height=h)
    T = mf.orbit_pose(1, 40, sweep=0.45).astype(np.float32)
    T_r = T.copy()
    T_r[0, 3] -= 47.90639384423901 / fx
    gray = []
    for pose in (T, T_r):
        color, _ = mf.render_rgbd(params, active, pose, intr, depth=False)
        c = (color * 255).astype(np.int64)
        gray.append(((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2]) >> 15)
                    .astype(np.uint8))
    return gray


@pytest.mark.gpu
def test_matcher_and_remap_on_card_match_cpu(cuda):
    """The matcher is integer arithmetic and the remap float32 with the
    same operation order on both devices: 0 differing pixels."""
    from monogs_dev_tpu_torch.data import camera_maps
    from monogs_dev_tpu_torch.data.stereo import sgbm_disparity

    left, right = _euroc_pair("cpu")
    lc, rc = torch.from_numpy(left), torch.from_numpy(right)
    d_cpu = sgbm_disparity(lc, rc)
    d_gpu = sgbm_disparity(lc.to(cuda), rc.to(cuda)).cpu()
    n_diff = int((d_cpu != d_gpu).sum())
    print(f"matcher: {n_diff} of {d_cpu.numel()} pixels differ between cuda and cpu")
    assert n_diff == 0
    K = np.array([[144.0, 0, 80.0], [0, 144.0, 60.0], [0, 0, 1.0]])
    mx, my = camera_maps.init_undistort_rectify_map(
        K, [-0.28, 0.07, 2e-4, 2e-5, 0.0], np.eye(3), K, (160, 120))
    img = torch.from_numpy(np.stack([left] * 3, axis=-1))
    r_cpu = camera_maps.remap_linear(img, camera_maps.remap_plan(mx, my, "cpu"))
    r_gpu = camera_maps.remap_linear(img.to(cuda), camera_maps.remap_plan(mx, my, cuda)).cpu()
    n_diff = int((r_cpu != r_gpu).sum())
    print(f"remap: {n_diff} of {r_cpu.numel()} values differ between cuda and cpu")
    assert n_diff == 0


@pytest.mark.gpu
def test_matcher_with_median_on_card_matches_cpu_at_320x240(cuda):
    """cv2's 3x3 median after the matcher (`median3x3`, integer sort) on the
    fixture-eval stereo row's size: the card's disparity equals the CPU's
    bit for bit, and the median alone on random int32 images with invalid
    (-16) runs does too."""
    from monogs_dev_tpu_torch.data.stereo import INVALID, median3x3, sgbm_disparity

    left, right = _euroc_pair("cpu", 320, 240)
    lc, rc = torch.from_numpy(left), torch.from_numpy(right)
    d_cpu = sgbm_disparity(lc, rc)
    d_gpu = sgbm_disparity(lc.to(cuda), rc.to(cuda)).cpu()
    assert d_gpu.dtype == torch.int32 and d_gpu.shape == (240, 320)
    assert (d_cpu >= 0).float().mean() > 0.15
    n_diff = int((d_cpu != d_gpu).sum())
    print(f"matcher with median, 320x240: {n_diff} of {d_cpu.numel()} pixels differ")
    assert n_diff == 0
    rng = np.random.default_rng(12)
    for shape in ((1, 1), (2, 3), (240, 320)):
        img = rng.integers(-16, 1024, shape).astype(np.int32)
        img[rng.random(shape) < 0.3] = INVALID
        t = torch.from_numpy(img)
        assert torch.equal(median3x3(t.to(cuda)).cpu(), median3x3(t))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["blobs", "surface"])
def test_scene_generator_gives_the_same_scene_on_card_and_cpu(cuda, kind):
    """A seed draws the same scene on the card as on the CPU: the draws and
    their arithmetic run on the CPU, and the result moves to the device."""
    from monogs_dev_tpu_torch.data.synthetic import make_surface_scene, make_synthetic_scene

    make = make_surface_scene if kind == "surface" else make_synthetic_scene
    on_cpu, _ = make(4000, generator=torch.Generator().manual_seed(7))
    on_card, active = make(4000, generator=torch.Generator().manual_seed(7), device=cuda)
    assert active.device.type == "cuda" and bool(active.all())
    for a, b in zip(on_cpu.values(), on_card.values()):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())


@pytest.mark.gpu
def test_tum_loader_on_cuda_returns_cuda_tensors(cuda):
    from monogs_dev_tpu_torch.data.datasets import load_dataset

    cal = {"fx": 144.0, "fy": 144.0, "cx": 80.0, "cy": 60.0, "k1": 0.0, "k2": 0.0, "p1": 0.0,
           "p2": 0.0, "k3": 0.0, "width": 160, "height": 120, "depth_scale": 5000.0,
           "distorted": False}
    cfg = {"Dataset": {"type": "tum", "Calibration": cal,
                       "dataset_path": os.path.join(REPO, "tests", "fixtures", "tum_surface")}}
    ds, ds_cpu = load_dataset(cfg, cuda), load_dataset(cfg, "cpu")
    image, depth, pose = ds[3]
    assert image.device.type == "cuda" and depth.device.type == "cuda"
    assert image.shape == (120, 160, 3) and image.dtype == torch.float32
    ref = ds_cpu[3]
    assert torch.equal(image.cpu(), ref[0]) and torch.equal(depth.cpu(), ref[1])
    assert np.array_equal(pose, ref[2])


def _blob_scene(n, dev, seed=0, scale=0.08):
    """tests/test_rasterizer.py::make_scene's distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    rgb = rng.uniform(0.1, 0.9, (n, 3))
    arrays = dict(
        xyz=np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)], -1),
        f_dc=((rgb - 0.5) / 0.28209479177387814)[:, None, :], f_rest=np.zeros((n, 0, 3)),
        log_scales=np.full((n, 3), np.log(scale)),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacity_logit=np.full(n, np.log(0.7 / 0.3)))
    return GaussianParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                             for k, v in arrays.items()})


@pytest.mark.gpu
def test_render_tiled_kernels_match_reference_on_card(cuda):
    """tests/test_rasterizer.py's oracle checks on the card: render_tiled
    through K1 (forward) and K2 (backward) against the brute-force
    render_reference, at that file's size and tolerances."""
    from monogs_dev_tpu_torch.geometry.lie import se3_retract
    from monogs_dev_tpu_torch.ops.rasterize_ref import render_reference

    intr = Intrinsics(60.0, 60.0, 32.0, 32.0, 64, 64)
    cfg = RasterConfig(tile=16, max_per_tile=64, k_dup=16, tile_group=8)
    params = _blob_scene(40, cuda)
    active = torch.ones(40, dtype=torch.bool, device=cuda)
    B.reset_launch_counts()
    outs, grads = {}, {}
    tiled = functools.partial(render_tiled, need_touched=False)  # K1, not K3
    for name, render in (("tiled", tiled), ("ref", render_reference)):
        leaves = params.map(lambda x: x.detach().requires_grad_(True))
        tau = torch.zeros(6, device=cuda, requires_grad=True)
        out = render(leaves, active, se3_retract(tau, torch.eye(4, device=cuda)), intr, 0,
                     config=cfg)
        (out.color - 0.3).abs().mean().backward()
        outs[name] = out
        grads[name] = [tau.grad] + [torch.zeros_like(x) if x.grad is None else x.grad
                                    for x in leaves.values()]
    assert B.LAUNCHES["K1"] >= 1 and B.LAUNCHES["K2"] >= 1
    t, r = outs["tiled"], outs["ref"]
    for name, tol in (("color", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        assert float((getattr(t, name) - getattr(r, name)).abs().max()) <= tol, name
    gt, gr = grads["tiled"], grads["ref"]
    assert float(gr[0].norm()) > 1e-6
    torch.testing.assert_close(gt[0], gr[0], rtol=5e-3, atol=1e-7)
    for a, b in zip(gt[1:], gr[1:]):
        torch.testing.assert_close(a, b, rtol=1e-2, atol=2e-6)


@pytest.mark.gpu
def test_dp_step_two_shards_match_one_on_card(cuda):
    """dp_mapping_step on the mesh [cuda:0, cuda:0] against [cuda:0]:
    tests/test_parallel.py's bounds (loss rtol 1e-5; map first moment rtol
    1e-4 / atol 1e-7; poses and exposures atol 1e-6; slots' first moment
    atol 1e-7). On one card `replicate` copies nothing: the replicas are the
    lead's own tensors."""
    from monogs_dev_tpu_torch.core.mapping import TorchDraws
    from monogs_dev_tpu_torch.core.params import MapOptConfig, StepConfig
    from monogs_dev_tpu_torch.models.gaussians import create_map, insert_points
    from monogs_dev_tpu_torch.parallel import (DPBatch, dp_mapping_step, gather,
                                                 make_dp_opt_state, make_mesh, replicate,
                                                 shard_batch)

    intr = Intrinsics(60.0, 60.0, 32.0, 32.0, 64, 64)
    cfg = RasterConfig(tile=16, max_per_tile=64, k_dup=8, tile_group=8)
    scene = _blob_scene(256, cuda, seed=1, scale=0.05)
    gmap, _ = insert_points(create_map(512, 0, cuda), scene,
                            torch.ones(256, dtype=torch.bool, device=cuda), 0)
    images, depths, poses = [], [], []
    for i in range(8):
        th = 0.03 * (i - 4)
        T = torch.eye(4, device=cuda)
        T[0, 0], T[0, 2], T[2, 0], T[2, 2], T[2, 3] = (np.cos(th), np.sin(th), -np.sin(th),
                                                       np.cos(th), 0.1 * th)
        out = render_tiled(gmap.params, gmap.aux.active, T, intr, 0, config=cfg,
                           need_touched=False)
        images.append(out.color)
        depths.append(out.depth)
        poses.append(T)
    g = torch.Generator(device=cuda).manual_seed(7)
    params = gmap.params.replace(
        f_dc=gmap.params.f_dc + 0.1 * torch.randn(gmap.params.f_dc.shape, generator=g,
                                                  device=cuda),
        xyz=gmap.params.xyz + 0.01 * torch.randn(gmap.params.xyz.shape, generator=g,
                                                 device=cuda))
    gmap = type(gmap)(params, gmap.aux, gmap.moments)
    flags = torch.arange(8, device=cuda) > 0
    batch = DPBatch(images=torch.stack(images), depths=torch.stack(depths),
                    T_w2c=torch.stack(poses), exposure=torch.zeros((8, 2), device=cuda),
                    valid=torch.ones(8, dtype=torch.bool, device=cuda), optimize_pose=flags,
                    optimize_exposure=flags)
    res = {}
    for n in (2, 1):
        mesh = make_mesh(device=[cuda] * n)
        step = dp_mapping_step(mesh, StepConfig(monocular=False), MapOptConfig(), intr, cfg,
                               update_every=150, update_offset=0)
        out = step(gmap, shard_batch(mesh, batch), make_dp_opt_state(8, cuda), 0,
                   TorchDraws(torch.Generator(device=cuda)), 0.005, 6.0)
        res[n] = out
        if n == 2:
            for p, a in replicate(mesh, out[0].params, out[0].aux.active):
                assert a is out[0].aux.active
                assert all(x is y for x, y in zip(p.values(), out[0].params.values()))
    (g2, b2, o2, l2, _), (g1, b1, o1, l1, _) = res[2], res[1]
    assert torch.isfinite(l2) and abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1))
    for a, b in zip(g2.moments.mu.values(), g1.moments.mu.values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(gather(b2.T_w2c, cuda), gather(b1.T_w2c, cuda), rtol=0, atol=1e-6)
    torch.testing.assert_close(gather(b2.exposure, cuda), gather(b1.exposure, cuda), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(gather(o2.mu, cuda), gather(o1.mu, cuda), rtol=0, atol=1e-7)
    assert all(bool(torch.isfinite(x).all()) for x in g2.params.values())


@pytest.mark.gpu
def test_jpeg_decode_on_card_matches_cpu(cuda, tmp_path):
    """The JPEG path on the card (`FrameReader`: the C entropy decoder into
    pinned memory, one non-blocking copy, the device stage there) equals the
    same file decoded on the CPU bit for bit, at Replica's 1200x680 (4:2:0)
    and in gray at an odd size; the C entropy decoder, built with the card
    machine's host compiler, equals its plain version on a small file."""
    from monogs_dev_tpu_torch.data import jpeg
    from monogs_dev_tpu_torch.data.datasets import FrameReader

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:680, 0:1200]
    smooth = np.stack([(x // 3) % 256, (y // 2) % 256, ((x + y) // 5) % 256], -1)
    frames = {"rgb_1200x680.jpg": np.clip(smooth + rng.integers(-9, 9, smooth.shape), 0, 255),
              "gray_37x53.jpg": rng.integers(0, 256, (37, 53))}
    reader = FrameReader(cuda)
    for name, arr in frames.items():
        path = tmp_path / name
        path.write_bytes(jpeg.encode_jpeg(arr.astype(np.uint8), 90))
        card = reader.samples(str(path))
        assert card.is_cuda
        assert torch.equal(card.cpu(), jpeg.decode(path.read_bytes(), "cpu"))
    small = jpeg.encode_jpeg(frames["rgb_1200x680.jpg"][:40, :64].astype(np.uint8), 75)
    assert np.array_equal(jpeg.decode_coefficients(small)[1],
                          jpeg.decode_coefficients(small, entropy=jpeg.decode_scan_plain)[1])


@pytest.mark.gpu
def test_kernel_library_runs_on_torchs_cuda_runtime(cuda):
    """The library links the shared CUDA runtime: one libcudart is mapped
    in the process and the library's runtime calls resolve to it."""
    runtimes = B.cuda_runtimes()
    assert runtimes["one_runtime"] and len(runtimes["libcudart"]) == 1, runtimes


def _tiny_inline_slam(dev):
    """tiny_rgbd.yaml with the inline backend pump, as the benchmark's cell
    runs the backend."""
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs/synthetic/tiny_rgbd.yaml"))
    cfg["Training"]["single_thread"] = False
    cfg["Dataset"]["single_thread"] = False
    cfg["Results"]["save_results"] = False
    return SLAM(cfg, dev, seed=0)


def _sync_warnings(slam, fn, monkeypatch):
    """Run fn under torch's sync debug mode set to warn. Returns the sync
    warnings that fn raised, each with the innermost open span of the
    recorder then; the explicit `torch.cuda.synchronize` calls, which the
    mode does not report; the `syncs` tally's delta; and the count of each
    `sync.*` span."""
    import traceback
    import warnings

    from monogs_dev_tpu_torch.utils import profiling

    seen = []
    stack = slam.timers._stack
    inside = [False]
    explicit = [0]
    synchronize = torch.cuda.synchronize

    def counted(*args, **kwargs):
        explicit[0] += inside[0]
        return synchronize(*args, **kwargs)

    def hook(message, category, filename, lineno, file=None, line=None):
        if inside[0] and "synchronizing" in str(message):
            top = stack()[-1].name if stack() else None
            site = f"{filename}:{lineno}"
            if not (top or "").startswith("sync."):  # where it came from
                site += "\n" + "".join(traceback.format_stack()[-10:-2])
            seen.append((top, site))

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    before = slam.timers.tallies["syncs"]
    counts = dict(slam.timers.count)
    synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            assert profiling.active() is slam.timers
            inside[0] = True
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    by_site = {k: v - counts.get(k, 0) for k, v in slam.timers.count.items()
               if k.startswith("sync.") and v > counts.get(k, 0)}
    return seen, explicit[0], slam.timers.tallies["syncs"] - before, by_site


@pytest.mark.gpu
@pytest.mark.parametrize("window", ["one_frame", "to_a_keyframe"])
def test_syncs_tally_equals_torchs_sync_debug_count(cuda, window, monkeypatch):
    """Every call on the per-frame path that torch's sync debug mode reports
    as synchronizing is a `sync.<site>` span of the port, and no span counts
    a sync that torch does not report, but for `SLAM.run`'s closing
    `torch.cuda.synchronize` (`sync.run_end`): the mode does not report an
    explicit device-wide synchronize, so those calls are counted apart.
    one_frame: a tracked frame and the pump's idle mapping round;
    to_a_keyframe: frames 2-13, one call each, with the keyframes' insertion
    and mapping rounds (visibility harvest and prune)."""
    slam = _tiny_inline_slam(cuda)
    slam.run(max_frames=2)
    kf0 = slam.backend_thread.handled["keyframe"]
    last = 3 if window == "one_frame" else 14

    def frames():
        for i in range(3, last + 1):
            slam.run(max_frames=i)

    seen, explicit, tallied, by_site = _sync_warnings(slam, frames, monkeypatch)
    uncovered = collections.Counter(site for top, site in seen
                                    if not (top or "").startswith("sync."))
    assert not uncovered, dict(uncovered)
    warned = collections.Counter(top for top, _ in seen)
    warned["sync.run_end"] += explicit
    differ = {k: (by_site.get(k, 0), warned.get(k, 0)) for k in set(by_site) | set(warned)
              if by_site.get(k, 0) != warned.get(k, 0)}
    assert not differ, differ
    assert explicit == last - 2 and tallied == len(seen) + explicit
    if window == "to_a_keyframe":
        assert slam.backend_thread.handled["keyframe"] > kf0


@pytest.mark.gpu
def test_span_records_bracket_their_kernels_on_the_traces_clock(cuda):
    """`benchmark.trace.Tracer` (torch's profiler with CUDA activity only)
    traces a span around a matmul and a sync: the span is kept as a record
    under that profiler, and the matmul's device interval, on the trace's
    clock as Tracer reads it, lies inside the span's."""
    from benchmark.trace import Tracer
    from monogs_dev_tpu_torch.utils import profiling

    timers, before = profiling.PhaseTimers(), profiling.active()
    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    tracer = Tracer(cuda)
    profiling.activate(timers)
    try:
        tracer.start()
        with profiling.span("matmul"):
            y = x @ x
            with profiling.sync("done"):
                torch.cuda.synchronize()
        tracer.stop()
    finally:
        profiling.activate(before)
    (name, start_ns, end_ns, _, _), = [r for r in timers.records if r[0] == "matmul"]
    assert [r[0] for r in timers.records] == ["sync.done", "matmul"]
    names, ids, st, en = tracer._device_events()
    assert len(st) >= 1, names  # the matmul's kernel(s), nothing else runs
    assert start_ns * 1e-9 <= float(st.min()) and float(en.max()) <= end_ns * 1e-9, (
        start_ns, end_ns, st, en, names)
    assert float(y[0, 0]) == pytest.approx(float(x[0] @ x[:, 0]), rel=1e-4)


# The projection's kernels (csrc/project.cu: P1 forward, P2 pose gradient)
# against the eager composition and the plain pose gradient, on three maps:
# the bench_vga map after its initial mapping, a 131,072-row scale map, and
# a map of edge rows, the last also isotropic at half scale (the viewer's
# scale modifier).

def _edge_map(dev, seed=5):
    """2,048 rows: a random map, with rows behind the camera and at znear,
    far outside the tan-FoV clamp, very elongated (det rounds to <= 0 in
    float32), NaN/Inf/huge/degenerate (quarantined) and inactive."""
    rng = np.random.default_rng(seed)
    n = 2048
    q = rng.normal(size=(n, 4)) * rng.uniform(0.5, 2.0, (n, 1))
    a = dict(xyz=np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                           rng.uniform(1, 6, n)], -1),
             f_dc=rng.uniform(-1.5, 1.5, (n, 1, 3)), f_rest=np.zeros((n, 0, 3)),
             log_scales=np.log(rng.uniform(0.005, 0.2, (n, 3))), quats=q,
             opacity_logit=rng.uniform(-3, 4, n))
    a["xyz"][0:64] = [0.3, -0.2, -1.0]
    a["xyz"][64:96] = [0.1, 0.1, 0.01]
    a["xyz"][96:160, 0] = rng.uniform(8, 20, 64)
    a["log_scales"][160:416] = [8.0, -20.0, -20.0]
    a["xyz"][416:424] = np.nan
    a["log_scales"][424:432] = np.inf
    a["quats"][432:440] = [1e-4, 0.0, 0.0, 0.0]
    a["xyz"][440:448] = [2e6, 0.0, 3.0]
    a["opacity_logit"][448:456] = -np.inf
    a["f_dc"][456:464] = np.nan
    active = np.ones(n, bool)
    active[::7] = False
    params = GaussianParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                               for k, v in a.items()})
    return params, torch.tensor(active, device=dev), Intrinsics(300.0, 300.0, 160.0, 120.0, 320, 240)


def _scale_map(dev, n=131072):
    """scale_vga's relief at 131,072 rows, each turned and stretched at
    random, every row active."""
    from monogs_dev_tpu_torch.data.synthetic import make_surface_scene

    params, active = make_surface_scene(n, 9.0, 4.0, generator=torch.Generator().manual_seed(3),
                                        device=dev)
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32, device=dev)
    jitter = torch.tensor(rng.uniform(-0.7, 0.7, (n, 3)), dtype=torch.float32, device=dev)
    params = params.replace(quats=q, log_scales=params.log_scales + jitter)
    return params, active, Intrinsics(576.0, 576.0, 320.0, 240.0, 640, 480)


@pytest.fixture(scope="module")
def projection_maps():
    """{name: (params, active, intr, T_w2c, scale_modifier, isotropic)} on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.geometry.lie import se3_exp
    from monogs_dev_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs/synthetic/bench_vga.yaml"))
    cfg["Results"]["save_results"] = False
    slam = SLAM(cfg, dev, seed=0)
    slam.run(max_frames=1)
    gmap = slam.engine.gmap
    T0 = torch.tensor(np.asarray(slam.frontend.cameras[0].T_est), dtype=torch.float32,
                      device=dev)
    nudge = se3_exp(torch.tensor([0.004, -0.003, 0.005, 0.002, -0.003, 0.001], device=dev))
    maps = {"bench_vga_init": (gmap.params.map(lambda x: x.detach().clone()),
                               gmap.aux.active.clone(), slam.intr, nudge @ T0, 1.0, False)}
    slam.stop()
    del slam
    twist = se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.03, -0.05, 0.02], device=dev))
    maps["scale_131072"] = (*_scale_map(dev), twist, 1.0, False)
    maps["edge_rows"] = (*_edge_map(dev), twist, 1.0, False)
    maps["edge_rows_isotropic_half"] = (*_edge_map(dev), twist, 0.5, True)
    return maps


MAPS = ["bench_vga_init", "scale_131072", "edge_rows", "edge_rows_isotropic_half"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", MAPS)
def test_projection_kernel_matches_eager(projection_maps, name):
    """P1 against the eager composition on the card: radii and valid equal,
    every continuous field within 2e-6 relative (NaN where the eager path
    has NaN)."""
    from monogs_dev_tpu_torch.ops import project as P

    params, active, intr, T, sm, iso = projection_maps[name]
    with torch.no_grad():
        assert P.uses_kernels(params, 0)
        before = B.LAUNCHES["P1"]
        out = P.project_gaussians_cuda(params, active, T, intr, sm, iso)
        ref = P.project_gaussians_eager(params, active, T, intr, 0, sm, iso)
    torch.cuda.synchronize()
    assert B.LAUNCHES["P1"] == before + 1
    assert torch.equal(out.valid, ref.valid) and torch.equal(out.radii, ref.radii)
    assert 0 < int(ref.valid.sum()) < ref.valid.numel() or name == "scale_131072"
    for field in ("means2d", "conic", "color", "opacity", "depth"):
        torch.testing.assert_close(getattr(out, field), getattr(ref, field), rtol=2e-6, atol=0.0,
                                   equal_nan=True, msg=field)


def _pose_gradients(params, active, intr, T, sm, iso, seed=0):
    """(P2's dL/dT through autograd, the plain version's, autograd of the
    eager composition's) for a random weighting of every output."""
    from monogs_dev_tpu_torch.ops import project as P

    gen = torch.Generator(device=T.device).manual_seed(seed)
    n = params.xyz.shape[0]
    w = {k: torch.randn(s, generator=gen, device=T.device)
         for k, s in (("means2d", (n, 2)), ("conic", (n, 3)), ("depth", (n,)),
                      ("color", (n, 3)), ("opacity", (n,)))}
    w["conic"] = 1e-3 * w["conic"]
    grads = []
    for project in (P.project_gaussians_cuda, P.project_gaussians_eager):
        Tg = T.clone().requires_grad_(True)
        out = project(params, active, Tg, intr, sm, iso) if project is P.project_gaussians_cuda \
            else project(params, active, Tg, intr, 0, sm, iso)
        loss = sum((getattr(out, k) * v).sum() for k, v in w.items())
        grads.append(torch.autograd.grad(loss, Tg)[0])
    plain = P.project_pose_vjp_plain(params, T, intr, w["means2d"], w["conic"], w["depth"], sm,
                                     iso)
    return grads[0], plain, grads[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", MAPS)
def test_projection_pose_gradient_matches_plain_and_autograd(projection_maps, name):
    """P2 against `project_pose_vjp_plain` and against autograd of the eager
    composition, both in float32 on the card: within 1e-5 of the largest
    entry; the bottom row zero."""
    before = B.LAUNCHES["P2"]
    g_kernel, g_plain, g_auto = _pose_gradients(*projection_maps[name])
    torch.cuda.synchronize()
    assert B.LAUNCHES["P2"] == before + 1
    assert bool(torch.isfinite(g_kernel).all()) and bool((g_kernel[3] == 0.0).all())
    scale = float(g_auto.abs().max())
    assert scale > 0.0
    for other in (g_plain, g_auto):
        assert float((g_kernel - other).abs().max()) <= 1e-5 * scale, (g_kernel, other)


@pytest.mark.gpu
def test_projection_pose_gradient_is_deterministic(projection_maps):
    """P2 twice on the same inputs gives the same bits (a fixed order of
    sums, no atomics)."""
    from monogs_dev_tpu_torch.ops import project as P

    params, active, intr, T, _, _ = projection_maps["scale_131072"]
    n = params.xyz.shape[0]
    gen = torch.Generator(device=T.device).manual_seed(1)
    g = (torch.randn((n, 2), generator=gen, device=T.device),
         torch.randn((n, 3), generator=gen, device=T.device),
         torch.randn((n,), generator=gen, device=T.device))
    fields = (T, params.xyz, params.log_scales, params.quats, params.opacity_logit, params.f_dc,
              params.f_rest)
    outs = []
    for _ in range(2):
        launch, dT = P.project_bwd_launcher(*fields, *g, intr)
        launch()
        outs.append(dT)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and float(outs[0].abs().max()) > 0.0


@pytest.mark.gpu
def test_projection_refused_launch_raises(projection_maps):
    """A launch the device refuses (2,048 threads a block) raises, P1 and P2."""
    from monogs_dev_tpu_torch.ops import project as P

    params, active, intr, T, _, _ = projection_maps["edge_rows"]
    fields = (T, params.xyz, params.log_scales, params.quats, params.opacity_logit, params.f_dc,
              params.f_rest)
    launch, _ = P.project_fwd_launcher(*fields, active, intr, threads=2048)
    with pytest.raises(RuntimeError, match="project_fwd launch failed"):
        launch()
    launch, _ = P.project_bwd_launcher(*fields, None, None, params.xyz[:, 2].contiguous(), intr,
                                       threads=2048)
    with pytest.raises(RuntimeError, match="project_bwd_pose launch failed"):
        launch()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["float64_pose", "cpu_pose", "float64_map", "cpu_active"])
def test_projection_on_the_card_refuses_a_wrong_input(projection_maps, what):
    """A card map takes the kernels whatever else comes with it: a pose or
    map field of another dtype, or a pose or `active` on the CPU, raises
    instead of running the eager composition, and launches nothing."""
    from monogs_dev_tpu_torch.ops import project as P

    params, active, intr, T, _, _ = projection_maps["edge_rows"]
    if what == "float64_pose":
        T = T.double()
    elif what == "cpu_pose":
        T = T.cpu()
    elif what == "float64_map":
        params = params.replace(log_scales=params.log_scales.double())
    else:
        active = active.cpu()
    launches = dict(B.LAUNCHES)
    with torch.no_grad(), pytest.raises(ValueError, match="must be"):
        P.project_gaussians(params, active, T, intr, 0)
    assert dict(B.LAUNCHES) == launches


@pytest.mark.gpu
def test_track_frame_on_a_tum_frame_kernels_match_eager(cuda, monkeypatch):
    """The Adam tracker on frame 1 of the TUM-layout fixture (160x120),
    from the map after frame 0's initial mapping: through P1/P2 and through
    the eager projection, the same iteration count, and the poses no further
    apart than 3 times the eager path's own sensitivity to rounding; the
    kernel run projects only through P1 (no `project.eager`). P1's outputs
    equal the eager path's bit for bit, and P2's gradient differs from
    autograd's in rounding alone. Adam scales each component's step by its
    own history, so a rounding-level change of a component near zero
    becomes a step of full size: the sensitivity is how far the eager
    path's pose moves when its gradient is scaled by 1 + 2^-22 and by
    1 - 2^-22, the larger of the two."""
    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core import tracking
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.ops import project as P
    from monogs_dev_tpu_torch.utils import profiling
    from monogs_dev_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs/rgbd/tum/fixture_surface.yaml"))
    cfg["Results"]["save_results"] = False
    slam = SLAM(cfg, cuda, seed=0)
    seen = []
    track = tracking.track_frame

    def recording(*args, **kwargs):
        seen.append((args, kwargs))
        return track(*args, **kwargs)

    monkeypatch.setattr(frontend_mod, "track_frame", recording)
    slam.run(max_frames=2)
    slam.stop()
    args, kwargs = seen[-1]
    profiling.activate(slam.timers)
    results = {}
    pose_gradient = tracking.pose_gradient
    for path in ("kernel", "eager", "eager_up", "eager_down"):
        if path == "eager":
            monkeypatch.setattr(P, "uses_kernels", lambda *a: False)
        elif path != "kernel":
            def scaled(*a, scale=1.0 + (2.0 ** -22 if path == "eager_up" else -2.0 ** -22)):
                loss, g = pose_gradient(*a)
                return loss, g * scale

            monkeypatch.setattr(tracking, "pose_gradient", scaled)
        tallies = dict(slam.timers.tallies)
        launches = dict(B.LAUNCHES)
        res = track(*args, **kwargs)
        torch.cuda.synchronize()
        results[path] = res
        new = {k: slam.timers.tallies[k] - tallies.get(k, 0) for k in ("project.kernel",
                                                                       "project.eager")}
        if path == "kernel":
            assert new["project.eager"] == 0 and new["project.kernel"] > 0, new
            assert B.LAUNCHES["P1"] > launches["P1"] and B.LAUNCHES["P2"] > launches["P2"]
        else:
            assert new["project.kernel"] == 0 and new["project.eager"] > 0, new
    k, e = results["kernel"], results["eager"]
    gap = float((k.T_w2c - e.T_w2c).abs().max())
    sensitivity = max(float((results[p].T_w2c - e.T_w2c).abs().max())
                      for p in ("eager_up", "eager_down"))
    print(f"track_frame: {k.n_iters} and {e.n_iters} iterations, pose gap {gap:.3e}, "
          f"eager's sensitivity {sensitivity:.3e}")
    assert sensitivity > 0.0
    assert k.n_iters == e.n_iters > 0 and gap <= 3.0 * sensitivity, (
        k.n_iters, e.n_iters, gap, sensitivity)

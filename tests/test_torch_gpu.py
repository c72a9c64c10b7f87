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

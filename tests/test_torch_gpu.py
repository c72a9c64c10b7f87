"""The CUDA blend kernels (K1-K3) and the kernel lab's (L1 variants, L2)
against their plain torch versions, on a card.

Every test here is marked `gpu` and skips itself without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs where only
torch is installed (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances as in tests/test_torch_blend.py: colour and alpha 3e-5, depth
3e-4, touch counts exact, props gradients rtol 2e-3 with an absolute floor
of 1e-5 x the largest gradient.

The kernels stage entries in batches of 256, so the cases with 512 entries
per tile (the bench's `max_per_tile`) run the multi-batch path: staging of
the second batch, the tile's early exit at a batch boundary, touch writes
past entry 256 and the backward's replay across batches. The opacity ranges
make stacks that stay transparent through all 512 entries, that saturate
inside the first batch (alpha at its 0.99 clamp), and a mix of both."""

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


# (entries per tile, opacity range)
CASES = {
    "l128": (128, (0.05, 0.999)),
    "l512_mixed": (512, (0.05, 0.999)),
    "l512_low_opacity": (512, (0.003, 0.03)),
    "l512_saturated": (512, (0.9, 0.999)),
}


def _props(n_tiles=64, l_max=128, opacity=(0.05, 0.999), seed=0):
    rng = np.random.default_rng(seed)
    tid = np.arange(n_tiles)
    mu = np.stack([(tid % TX_N)[:, None] * 16 + rng.uniform(-16, 32, (n_tiles, l_max)),
                   (tid // TX_N)[:, None] * 16 + rng.uniform(-16, 32, (n_tiles, l_max))], -1)
    s = rng.uniform(1.0, 8.0, (n_tiles, l_max, 2))
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_forward_kernels_match_plain(cuda, case):
    l_max, opacity = CASES[case]
    props, counts = _props(l_max=l_max, opacity=opacity)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    ref = B.blend_tiles_reference(p, c, TX_N, 16, *CFG)
    for touch in (False, True):
        out = B.blend_forward_cuda(p, c, TX_N, 16, *CFG, emit_touch=touch)
        for a, b, tol in zip(out[:3], ref[:3], (3e-5, 3e-4, 3e-5)):
            assert float((a - b).abs().max()) <= tol
        if touch:
            assert torch.equal(out[5], ref[3])
        assert bool((out[4] <= c[:, None]).all())  # n_done never passes counts
        if case in ("l512_mixed", "l512_low_opacity"):
            assert int(out[4].max()) > 256  # pixels blended entries of the second batch


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernel_matches_plain_autograd(cuda, case):
    l_max, opacity = CASES[case]
    props, counts = _props(l_max=l_max, opacity=opacity, seed=1)
    c = torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]
    grads = []
    for fn in (B.blend_tiles, lambda *a: B.blend_tiles_reference(*a)[:3]):
        p = torch.tensor(props, device=cuda, requires_grad=True)
        out = fn(p, c, TX_N, 16, *CFG)
        sum((o * wi).sum() for o, wi in zip(out, w)).backward()
        grads.append(p.grad)
    k, r = grads
    assert bool(torch.isfinite(k).all())
    assert bool(((k - r).abs() <= 2e-3 * r.abs() + 1e-5 * r.abs().max()).all())


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
    l_max, opacity = CASES[case]
    props, counts = _props(l_max=l_max, opacity=opacity, seed=seed)
    counts[8] = 100  # a count that is not a multiple of 32
    props[np.arange(l_max)[None, :] >= counts[:, None]] = 0.0
    return props, counts


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BL.LAB_VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_lab_forward_kernel_matches_plain(cuda, case, variant):
    props, counts = _lab_props(case, seed=2)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    ref = BL.lab_blend_reference(variant, p, c, TX_N, 16, *CFG)
    before = BL.VARIANT_LAUNCHES[variant]
    out = BL.lab_blend(variant, p, c, TX_N, 16, *CFG)
    torch.cuda.synchronize()
    assert BL.VARIANT_LAUNCHES[variant] == before + 1
    for name, a, b, tol in zip(("color", "depth", "alpha"), out, ref, (3e-5, 3e-4, 3e-5)):
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_lab_moments_backward_matches_plain(cuda, case):
    props, counts = _lab_props(case, seed=3)
    p, c = torch.tensor(props, device=cuda), torch.tensor(counts, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    w = [torch.randn(shape, generator=g, device=cuda) for shape in ((64, 3, 256), (64, 256), (64, 256))]
    t_final, n_done = BL.blend_residuals(p, c, TX_N, 16, *CFG)
    got = BL.moments_backward(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    plain = BL.moments_backward_reference(p, t_final, n_done, *w, TX_N, 16, *CFG[:2])
    pr = p.clone().requires_grad_(True)
    out = B.blend_tiles_reference(pr, c, TX_N, 16, *CFG)
    sum((o * wi).sum() for o, wi in zip(out[:3], w)).backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    for ref in (plain, pr.grad):
        assert bool(((got - ref).abs() <= 2e-3 * ref.abs() + 1e-5 * ref.abs().max()).all())

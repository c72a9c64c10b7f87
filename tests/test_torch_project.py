"""The projection's two paths (ops/project.py): P2's pose gradient as plain
torch (`project_pose_vjp_plain`) against autograd of the eager composition
in float64, and the choice between the CUDA kernels and the eager
composition. The kernels themselves run only on a card
(tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from monogs_dev_tpu_torch.geometry import lie
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.gaussians import GaussianParams
from monogs_dev_tpu_torch.ops import project as P
from monogs_dev_tpu_torch.utils import profiling

torch.set_num_threads(2)

INTR = Intrinsics(fx=60.0, fy=62.0, cx=32.0, cy=30.0, width=64, height=60)
N = 64


def _map(seed, n=N, dtype=torch.float64, sh_rest=0):
    """A random map in front of the camera, a few rows spread wide."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    arrays = dict(
        xyz=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(1.0, 6.0, n)], -1),
        f_dc=rng.uniform(-1.5, 1.5, (n, 1, 3)),
        f_rest=0.1 * rng.normal(size=(n, sh_rest, 3)),
        log_scales=np.log(rng.uniform(0.01, 0.3, (n, 3))),
        quats=q * rng.uniform(0.5, 2.0, (n, 1)),  # normalised on use
        opacity_logit=rng.uniform(-2.0, 3.0, n),
    )
    return GaussianParams(**{k: torch.tensor(v, dtype=dtype) for k, v in arrays.items()})


def _pose(seed, dtype=torch.float64):
    tau = torch.tensor(np.random.default_rng(seed + 100).normal(scale=0.1, size=6), dtype=dtype)
    return lie.se3_exp(tau).detach()


def _with(params, rows, **fields):
    """params with `fields` written into `rows`."""
    out = {}
    for name, value in dataclasses.asdict(params).items():
        if name in fields:
            value = value.clone()
            value[rows] = torch.as_tensor(fields[name], dtype=value.dtype)
        out[name] = value
    return GaussianParams(**out)


def _case(name):
    """(params, active, T, scale_modifier, isotropic) of one case."""
    params, T = _map(1), _pose(1)
    active = torch.ones(N, dtype=torch.bool)
    sm, iso = 1.0, False
    if name == "behind":  # rows behind the camera and at znear
        params = _with(params, slice(0, 12), xyz=[0.3, -0.2, -1.0])
        T = torch.eye(4, dtype=torch.float64)
        params = _with(params, slice(12, 16), xyz=[0.1, 0.1, INTR.znear])
    elif name == "clamp":  # outside the 1.3x tan-FoV range, and exactly on its bounds
        T = torch.eye(4, dtype=torch.float64)
        limx, limy = 1.3 * INTR.tanfovx, 1.3 * INTR.tanfovy
        params = _with(params, slice(0, 8), xyz=[5.0, -4.0, 2.0])
        params = _with(params, slice(8, 12), xyz=[2.0 * limx, -2.0 * limy, 2.0])
        params = _with(params, slice(12, 16), xyz=[-2.0 * limx, 2.0 * limy, 2.0])
    elif name == "det_le_0":  # very elongated, very large rows: det rounds to <= 0
        params = _with(params, slice(0, 32), log_scales=[8.0, -20.0, -20.0])
        sm = 1e10
    elif name == "quarantine":  # NaN, Inf, huge and degenerate rows, active or not
        params = _with(params, slice(0, 4), xyz=float("nan"))
        params = _with(params, slice(4, 8), log_scales=float("inf"))
        params = _with(params, slice(8, 12), quats=[1e-4, 0.0, 0.0, 0.0])
        params = _with(params, slice(12, 16), xyz=[2e6, 0.0, 3.0])
        params = _with(params, slice(16, 20), opacity_logit=float("-inf"))
        params = _with(params, slice(20, 24), f_dc=float("nan"))
        active[2:6] = False
    elif name == "inactive":
        active[::3] = False
    elif name == "isotropic":
        iso = True
    return params, active, T, sm, iso


CASES = ["random", "behind", "clamp", "det_le_0", "quarantine", "inactive", "isotropic"]


@pytest.mark.parametrize("upstream", ["all", "means2d_only", "no_depth"])
@pytest.mark.parametrize("case", CASES)
def test_plain_pose_vjp_matches_autograd_in_float64(case, upstream):
    """P2's arithmetic (`project_pose_vjp_plain`) against autograd of the
    eager composition in float64, relative 1e-9 of the largest entry; the
    gradients of colour and opacity, which P2 ignores, are part of the
    loss."""
    params, active, T0, sm, iso = _case(case)
    T = T0.clone().requires_grad_(True)
    out = P.project_gaussians_eager(params, active, T, INTR, 0, sm, iso)
    rng = np.random.default_rng(7)
    w = {k: torch.tensor(rng.normal(size=tuple(getattr(out, k).shape)), dtype=torch.float64)
         for k in ("means2d", "conic", "depth", "color", "opacity")}
    if upstream != "all":
        w["depth"] = torch.zeros_like(w["depth"])
    if upstream == "means2d_only":
        w["conic"] = torch.zeros_like(w["conic"])
    loss = sum((getattr(out, k) * v).sum() for k, v in w.items())
    (g_auto,) = torch.autograd.grad(loss, T)
    g_plain = P.project_pose_vjp_plain(
        params, T0, INTR, w["means2d"], None if upstream == "means2d_only" else w["conic"],
        None if upstream != "all" else w["depth"], sm, iso)
    assert torch.isfinite(g_auto).all() and float(g_auto[:3].abs().max()) > 0.0
    assert float((g_plain - g_auto).abs().max()) <= 1e-9 * float(g_auto.abs().max())
    assert bool((g_plain[3] == 0.0).all())
    k = P._terms(P.sanitize_params(params, active)[0], T0, INTR, sm, iso)
    if case == "behind":
        assert not bool(k.in_front.all())
    if case == "clamp":
        limx = 1.3 * INTR.tanfovx
        assert bool((k.u.abs() == limx).any()) and bool((k.u.abs() > limx).any())
    if case == "det_le_0":
        assert bool((~k.det_ok).any()) and bool(k.det_ok.any())


class _SeenOnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, for the predicate's other
    clauses."""

    @property
    def is_cuda(self):
        return True


def _seen_on_card(params):
    return params.replace(xyz=params.xyz.as_subclass(_SeenOnCard))


@pytest.mark.parametrize("what", ["on_card", "needs_grad", "needs_grad_no_grad_mode",
                                  "sh_rest", "sh_degree_no_rest", "cpu"])
def test_kernel_predicate(what):
    """`uses_kernels`: the map on the card, no map field asking for a
    gradient under grad mode, degree-0 colour; False for CPU tensors."""
    params = _map(2, dtype=torch.float32, sh_rest=15 if what == "sh_rest" else 0)
    sh = 3 if what.startswith("sh") else 0
    if what.startswith("needs_grad"):
        params = params.map(lambda x: x.requires_grad_(True))
    if what != "cpu":
        params = _seen_on_card(params)
    expect = what in ("on_card", "needs_grad_no_grad_mode", "sh_degree_no_rest")
    with torch.set_grad_enabled(what != "needs_grad_no_grad_mode"):
        assert P.uses_kernels(params, sh) == expect


@pytest.mark.parametrize("what", ["float32", "needs_grad", "sh_rest"])
def test_projection_takes_the_path_the_predicate_names(what, monkeypatch):
    """On the CPU `project_gaussians` is the eager composition, bit for bit,
    and tallies `project.eager`; where the map is taken for the card's, it
    hands the inputs that `uses_kernels` accepts to the kernels and tallies
    `project.kernel`."""
    params = _map(3, dtype=torch.float32, sh_rest=15 if what == "sh_rest" else 0)
    if what == "needs_grad":
        params = params.map(lambda x: x.requires_grad_(True))
    sh = 3 if what == "sh_rest" else 0
    T = _pose(3, dtype=torch.float32)
    active = torch.ones(N, dtype=torch.bool)
    active[5] = False
    timers, before = profiling.PhaseTimers(), profiling.active()
    profiling.activate(timers)
    try:
        out = P.project_gaussians(params, active, T, INTR, sh)
        ref = P.project_gaussians_eager(params, active, T, INTR, sh)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert (timers.tallies["project.eager"], timers.tallies["project.kernel"]) == (1, 0)
        calls, uses_kernels = [], P.uses_kernels
        monkeypatch.setattr(P, "uses_kernels", lambda p, s: uses_kernels(_seen_on_card(p), s))
        monkeypatch.setattr(P, "project_gaussians_cuda",
                            lambda *a: calls.append(a) or P.project_gaussians_eager(
                                a[0], a[1], a[2], a[3], 0))
        P.project_gaussians(params, active, T, INTR, sh)
    finally:
        profiling.activate(before)
    on_kernel = what == "float32"
    assert len(calls) == int(on_kernel)
    assert timers.tallies["project.kernel"] == int(on_kernel)
    assert timers.tallies["project.eager"] == 2 - int(on_kernel)
    assert timers.count["project"] == 2


def test_launchers_refuse_cpu_tensors():
    """P1's and P2's launchers take card tensors only: on the CPU they raise
    before the kernel library is loaded, and count no launch."""
    from monogs_dev_tpu_torch.ops import blend as B

    params = _map(4, dtype=torch.float32)
    fields = (_pose(4, dtype=torch.float32), params.xyz, params.log_scales, params.quats,
              params.opacity_logit, params.f_dc, params.f_rest)
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        P.project_fwd_launcher(*fields, torch.ones(N, dtype=torch.bool), INTR)
    with pytest.raises(ValueError, match="CUDA"):
        P.project_bwd_launcher(*fields, None, None, None, INTR)
    assert dict(B.LAUNCHES) == before

"""The port's scene generators (`monogs_dev_tpu_torch/data/synthetic.py`)
against the JAX package's (`monogs_dev_tpu/data/synthetic.py`).

- With JAX's own draws passed in (`jax.random.split(PRNGKey(seed), 5)` and
  the ranges the JAX function draws with), `make_synthetic_scene` and
  `make_surface_scene` give JAX's scene: every field within 1e-6 abs, at
  seeds 0 and 3 and SH degrees 0 and 1.
- With the port's own draws (`torch.Generator`): the shapes, the bounds
  (positions inside the extents, colour inside its clip), unit
  quaternions, and the same scene from the same seed twice.
- `SyntheticDataset` loads the committed npz where one exists (bit-equal to
  `load_scene`) and draws the scene otherwise: tiny_rgbd.yaml at an
  uncommitted seed renders finite frames with alpha coverage; an explicit
  `scene_file` that does not exist still raises."""

import os

import jax
import numpy as np
import pytest
import torch

from monogs_dev_tpu.data import synthetic as J
from monogs_dev_tpu_torch.data import synthetic as S
from monogs_dev_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1000
FIELDS = ("xyz", "f_dc", "f_rest", "log_scales", "quats", "opacity_logit")


def _assert_close(port, ref, atol=1e-6):
    for name in FIELDS:
        got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape and got.dtype == np.float32, name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("sh_degree", [0, 1])
@pytest.mark.parametrize("seed", [0, 3])
def test_blob_scene_matches_jax_with_its_draws(seed, sh_degree):
    extent, z_range, scale = 1.5, (2.5, 5.0), 0.04
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 5)
    draws = {"x": jax.random.uniform(ks[0], (N,), minval=-extent, maxval=extent),
             "y": jax.random.uniform(ks[1], (N,), minval=-extent, maxval=extent),
             "z": jax.random.uniform(ks[2], (N,), minval=z_range[0], maxval=z_range[1]),
             "rgb": jax.random.uniform(ks[3], (N, 3), minval=0.05, maxval=0.95),
             "quats": jax.random.normal(ks[4], (N, 4))}
    ref, ref_active = J.make_synthetic_scene(key, N, extent, z_range, scale, sh_degree)
    port, active = S.make_synthetic_scene(N, extent, z_range, scale, sh_degree, draws=draws)
    _assert_close(port, ref)
    assert active.dtype == torch.bool and bool(active.all()) and active.shape == ref_active.shape


@pytest.mark.parametrize("sh_degree", [0, 1])
@pytest.mark.parametrize("seed", [0, 3])
def test_surface_scene_matches_jax_with_its_draws(seed, sh_degree):
    ex, ey, z_base, scale = 9.0, 4.0, 2.5, 0.03
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 5)
    draws = {"x": jax.random.uniform(ks[0], (N,), minval=-ex, maxval=ex),
             "y": jax.random.uniform(ks[1], (N,), minval=-ey, maxval=ey),
             "noise": jax.random.normal(ks[2], (N,)),
             "rgb": jax.random.uniform(ks[3], (N, 3), minval=-1.0, maxval=1.0)}
    ref, _ = J.make_surface_scene(key, N, ex, ey, z_base, scale, sh_degree)
    port, active = S.make_surface_scene(N, ex, ey, z_base, scale, sh_degree, draws=draws)
    _assert_close(port, ref)
    assert bool(active.all()) and active.shape == (N,)


@pytest.mark.parametrize("kind", ["blobs", "surface"])
def test_own_draws_are_in_bounds_and_repeat(kind):
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        if kind == "surface":
            return S.make_surface_scene(N, 9.0, 4.0, scale=0.03, sh_degree=1, generator=g)[0]
        return S.make_synthetic_scene(N, 1.5, (2.5, 5.0), 0.04, sh_degree=1, generator=g)[0]

    p = draw(5)
    assert p.xyz.shape == (N, 3) and p.f_dc.shape == (N, 1, 3) and p.f_rest.shape == (N, 3, 3)
    assert p.log_scales.shape == (N, 3) and p.quats.shape == (N, 4)
    assert p.opacity_logit.shape == (N,)
    assert not bool(p.f_rest.any())
    rgb = p.f_dc[:, 0] * 0.28209479177387814 + 0.5
    x, y, z = p.xyz.unbind(-1)
    if kind == "surface":
        assert float(x.abs().max()) <= 9.0 and float(y.abs().max()) <= 4.0
        assert float(rgb.min()) >= 0.02 - 1e-6 and float(rgb.max()) <= 0.98 + 1e-6
        assert float((z - 3.0).abs().max()) < 1.3  # the relief's amplitude plus noise
        assert torch.allclose(p.log_scales[:, 2] - p.log_scales[:, 0],
                              torch.full((N,), float(np.log(0.3))), atol=1e-6)
    else:
        assert float(x.abs().max()) <= 1.5 and float(y.abs().max()) <= 1.5
        assert float(z.min()) >= 2.5 and float(z.max()) <= 5.0
        assert float(rgb.min()) >= 0.05 - 1e-6 and float(rgb.max()) <= 0.95 + 1e-6
    assert torch.allclose(p.quats.norm(dim=-1), torch.ones(N), atol=1e-6)
    assert torch.allclose(torch.sigmoid(p.opacity_logit), torch.full((N,), 0.95))
    again, other = draw(5), draw(6)
    for name in FIELDS:
        assert torch.equal(getattr(p, name), getattr(again, name)), name
    assert not torch.equal(p.xyz, other.xyz)


def _tiny(seed=None, **ds):
    cfg = load_config(os.path.join(REPO, "configs/synthetic/tiny_rgbd.yaml"))
    if seed is not None:
        cfg["Dataset"]["seed"] = seed
    cfg["Dataset"].update(ds)
    return cfg


def test_dataset_loads_the_committed_scene(monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("drew a scene where a committed one exists")

    monkeypatch.setattr(S, "draw_scene", no_draw)
    cfg = _tiny()
    ds = cfg["Dataset"]
    path = os.path.join(S.SCENE_DIR, S.scene_file_name("blobs", 0, int(ds["n_gaussians"])))
    assert os.path.exists(path)
    scene = S.SyntheticDataset(cfg, "cpu").scene_params
    want = S.load_scene(path, {"gaussian_scale": float(ds.get("gaussian_scale", 0.06))}, "cpu")
    for name in FIELDS:
        assert torch.equal(getattr(scene, name), getattr(want, name)), name


def test_dataset_draws_at_an_uncommitted_seed(capsys):
    cfg = _tiny(seed=11)
    ds = cfg["Dataset"]
    n = int(ds["n_gaussians"])
    assert not os.path.exists(os.path.join(S.SCENE_DIR, S.scene_file_name("blobs", 11, n)))
    data = S.SyntheticDataset(cfg, "cpu")
    assert "not the JAX package's scene" in capsys.readouterr().out
    want, _ = S.make_synthetic_scene(n, scale=float(ds.get("gaussian_scale", 0.06)),
                                     generator=torch.Generator().manual_seed(11))
    for name in FIELDS:
        assert torch.equal(getattr(data.scene_params, name), getattr(want, name)), name
    for i in (0, len(data) - 1):
        color, depth, pose = data[i]
        assert color.shape == (data.height, data.width, 3) and bool(torch.isfinite(color).all())
        # the JAX package's seed-0 blob scene covers 12.7% and 14.9% of these frames
        assert bool(torch.isfinite(depth).all()) and float((depth > 0).float().mean()) > 0.08
        assert float(color.std()) > 0.01


def test_dataset_draws_a_surface_scene_with_the_config_extents():
    cfg = load_config(os.path.join(REPO, "configs/synthetic/scale_vga.yaml"))
    ds = cfg["Dataset"]
    ds["seed"], ds["n_gaussians"] = 4, 2000
    data = S.SyntheticDataset(cfg, "cpu")
    x, y, _ = data.scene_params.xyz.unbind(-1)
    assert float(x.abs().max()) <= float(ds["extent_x"]) and float(x.abs().max()) > 8.0
    assert float(y.abs().max()) <= float(ds["extent_y"]) and float(y.abs().max()) > 3.5
    assert np.isclose(float(data.scene_params.log_scales[0, 0]),
                      np.log(float(ds.get("gaussian_scale", 0.035))))


def test_a_missing_scene_file_still_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        S.SyntheticDataset(_tiny(scene_file=str(tmp_path / "nope.npz")), "cpu")

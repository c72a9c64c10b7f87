"""The port's data-parallel mapping (`monogs_dev_tpu_torch/parallel/mesh.py`
and `TPU.mesh_devices` in `core/backend.py`) against the JAX package's on the
8-device virtual CPU mesh of tests/conftest.py, at tests/test_parallel.py's
sizes: 64x64, 16x16 tiles with L = 64, the 256-Gaussian scene at capacity
512, an 8-slot batch. The JAX scene crosses over as numpy
(`models/convert.py`); the port's mesh is 8 (or 1) shards on the CPU.

Bounds are tests/test_parallel.py's own: loss rtol 1e-5; the map's first
moment (0.1 x the summed gradient) rtol 1e-4 / atol 1e-7; each parameter
within the first Adam step's sign bound (2.05 lr, over 1e-5 on under 5% of
elements); poses and exposures atol 1e-6; the slots' first moment atol 1e-7.
Gradients are compared at that test's perturbed scene, away from the optimum
where every L1 residual's gradient is sign(+-1 ulp). Even there one RGB
residual of the JAX scene (slot 7, pixel (12, 62), blue) is ~1e-7, and its
sign differs between the JAX step's jitted render and the port's (as it does
between JAX's own jitted and eager renders): that flips the L1 gradient of
one pixel and moves the first moment of the two Gaussians covering it by up
to 8e-6. The JAX comparison leaves out the Gaussians whose footprint covers
a pixel whose residual changes sign between the packages, after asserting
that there are at most two such pixels and each residual is under 1e-6,
and the slots' moments of the views that hold one.

The engine tests run tests/test_parallel.py's product path as
`__graft_entry__.py` scripts it (init, then keyframes 1-4 on a 4-device
mesh), in both packages with the JAX draws replayed into the port: the DP
telemetry equal, keyframe positions within 5 mm and the alive count within
2% (the band of tests/test_torch_threaded.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_dev_tpu.core import backend as jbackend
from monogs_dev_tpu.core.keyframe import Keyframe as JKeyframe
from monogs_dev_tpu.core.params import MapOptConfig as JMapOpt
from monogs_dev_tpu.core.params import StepConfig as JStepConfig
from monogs_dev_tpu.core.system import raster_config_from as j_raster_config_from
from monogs_dev_tpu.data.synthetic import make_synthetic_scene
from monogs_dev_tpu.ops.rasterize import render_tiled as j_render
from monogs_dev_tpu.parallel import dp_refine_step as j_dp_refine_step
from monogs_dev_tpu.parallel import make_mesh as j_make_mesh
from monogs_dev_tpu_torch import parallel as P
from monogs_dev_tpu_torch.core import backend as tbackend
from monogs_dev_tpu_torch.core.keyframe import Keyframe
from monogs_dev_tpu_torch.core.params import MapOptConfig, StepConfig
from monogs_dev_tpu_torch.core.system import raster_config_from
from monogs_dev_tpu_torch.models.camera import Intrinsics
from monogs_dev_tpu_torch.models.convert import gaussian_map_from_numpy, gaussian_map_to_numpy
from monogs_dev_tpu_torch.ops.project import project_gaussians
from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
from monogs_dev_tpu_torch.ops.rasterize import render_tiled
from tests.test_parallel import INTR as JINTR
from tests.test_parallel import OPT as JOPT
from tests.test_parallel import RCFG as JRCFG
from tests.test_parallel import _make_batch, _run_step, _scene_map
from tests.test_torch_mapping import jmap_to_numpy

torch.set_num_threads(2)

INTR = Intrinsics(fx=60.0, fy=60.0, cx=32.0, cy=32.0, width=64, height=64)
RCFG = RasterConfig(tile=16, max_per_tile=64, k_dup=8, tile_group=8)
OPT = MapOptConfig()
TH, EXTENT = 0.005, 6.0


class KeyDraws:
    """The JAX step's draw: its densify split noise is normal(key)."""

    def __init__(self, key):
        self.key = key

    def split_noise(self, budget):
        return torch.tensor(np.asarray(jax.random.normal(self.key, (2, budget, 3))))


def perturbed_scene():
    """tests/test_parallel.py::scene_fixture: the GT batch from the clean
    map, then the map perturbed away from the optimum (JAX)."""
    gmap = _scene_map()
    batch = _make_batch(gmap, 8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    params = gmap.params._replace(
        f_dc=gmap.params.f_dc + 0.1 * jax.random.normal(k1, gmap.params.f_dc.shape),
        xyz=gmap.params.xyz + 0.01 * jax.random.normal(k2, gmap.params.xyz.shape),
    )
    return gmap._replace(params=params), batch


def port_map(jmap):
    return gaussian_map_from_numpy(jmap_to_numpy(jmap), "cpu")


def port_batch(jbatch) -> P.DPBatch:
    return P.DPBatch(**{f.name: torch.tensor(np.asarray(getattr(jbatch, f.name)))
                        for f in dataclasses.fields(P.DPBatch) if f.name != "live"})


def port_step(n_shards, gmap, batch, it=0, seed=0, update_every=150, opt_cfg=OPT):
    mesh = P.make_mesh(n_shards, "cpu")
    step = P.dp_mapping_step(mesh, StepConfig(monocular=False), opt_cfg, INTR, RCFG,
                             use_depth=True, update_every=update_every, update_offset=0)
    return step(gmap, P.shard_batch(mesh, batch), P.make_dp_opt_state(8), it,
                KeyDraws(jax.random.PRNGKey(seed)), TH, EXTENT)


def result_numpy(res):
    """(map arrays, poses, exposures, slot mu, loss, dropped) of either
    package's step result."""
    gmap, batch, opt, loss, dropped = res
    if isinstance(batch, P.DPBatch):
        return (gaussian_map_to_numpy(gmap), P.gather(batch.T_w2c, "cpu").numpy(),
                P.gather(batch.exposure, "cpu").numpy(), P.gather(opt.mu, "cpu").numpy(),
                float(loss), int(dropped))
    return (jmap_to_numpy(gmap), np.asarray(batch.T_w2c), np.asarray(batch.exposure),
            np.asarray(opt.mu), float(loss), int(dropped))


def assert_steps_close(a, b, skip_rows=(), skip_slots=()):
    """tests/test_parallel.py::test_psum_equivalence_vs_single_device's
    bounds; the map's first moment on every row but `skip_rows`, the slots'
    on every slot but `skip_slots`."""
    ma, Ta, ea, mua, la, _ = result_numpy(a)
    mb, Tb, eb, mub, lb, _ = result_numpy(b)
    assert np.isfinite(la)
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    keep = np.ones(ma["aux.active"].shape[0], bool)
    keep[list(skip_rows)] = False
    for k in mb:
        if k.startswith("mu."):
            np.testing.assert_allclose(ma[k][keep], mb[k][keep], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    for name, lr in (("xyz", JOPT.position_lr_init * JOPT.spatial_lr_scale),
                     ("opacity_logit", JOPT.opacity_lr)):
        d = np.abs(ma["params." + name] - mb["params." + name])
        assert d.max() <= 2.05 * lr, (name, d.max())
        assert (d > 1e-5).mean() < 0.05, name
    np.testing.assert_allclose(Ta, Tb, atol=1e-6)
    np.testing.assert_allclose(ea, eb, atol=1e-6)
    slots = np.ones(mua.shape[0], bool)
    slots[list(skip_slots)] = False
    np.testing.assert_allclose(mua[slots], mub[slots], atol=1e-7)


@pytest.fixture(scope="module")
def scene():
    return perturbed_scene()


@pytest.fixture(scope="module")
def jax_steps(scene):
    """JAX's dp_mapping_step on its 8-device mesh: densify off and on."""
    gmap, batch = scene
    mesh8 = j_make_mesh(8)
    return {"off": _run_step(mesh8, gmap, batch),
            "densify": _run_step(mesh8, gmap, batch, it=0, update_every=1)}


@pytest.fixture(scope="module")
def port_steps(scene):
    gmap, batch = scene
    return {"8": port_step(8, port_map(gmap), port_batch(batch)),
            "1": port_step(1, port_map(gmap), port_batch(batch)),
            "densify": port_step(8, port_map(gmap), port_batch(batch), update_every=1)}


def test_make_mesh():
    mesh = P.make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.axis_names == ("kf",) and mesh.lead == torch.device("cpu")
    assert P.make_mesh(device=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        P.make_mesh(3, ["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.make_mesh(2, "cuda")
    b = P.shard(mesh, torch.arange(16.0).reshape(16, 1))
    assert len(b) == 8 and torch.equal(P.gather(b, "cpu")[:, 0], torch.arange(16.0))
    with pytest.raises(ValueError):
        P.shard(mesh, torch.zeros(12))


@jax.jit
def _jax_color(params, active, T):
    return j_render(params, active, T, JINTR, 0, jnp.zeros(3), JRCFG, need_touched=False).color


def sign_flips(jmap, images, poses, masked=True, max_flips=2):
    """(rows, views): the rows whose projected footprint covers an RGB
    residual (inside the mapping loss's mask if `masked`) whose sign differs
    between JAX's jitted render and the port's render of the same view, and
    those views; each such residual must be under 1e-6, and there may be at
    most `max_flips` of them."""
    tmap = port_map(jmap)
    rows, views = set(), set()
    n_flips = 0
    for view, (img, T) in enumerate(zip(np.asarray(images), np.asarray(poses))):
        jc = np.asarray(_jax_color(jmap.params, jmap.aux.active, jnp.asarray(T)))
        Tt = torch.tensor(T)
        out = render_tiled(tmap.params, tmap.aux.active, Tt, INTR, 0, torch.zeros(3), RCFG,
                           need_touched=False)
        rj, rt = jc - img, out.color.numpy() - img
        flips = np.sign(rj) != np.sign(rt)
        if masked:
            flips &= (img.sum(-1) > 0.01)[..., None]
        for y, x, c in np.argwhere(flips):
            n_flips += 1
            views.add(view)
            assert abs(rj[y, x, c]) < 1e-6 and abs(rt[y, x, c]) < 1e-6, (y, x, c)
            proj = project_gaussians(tmap.params, tmap.aux.active, Tt, INTR, 0)
            d = (proj.means2d - torch.tensor([x, y], dtype=torch.float32)).abs().max(-1).values
            rows.update(torch.nonzero(proj.valid & (d <= proj.radii))[:, 0].tolist())
    assert n_flips <= max_flips, n_flips
    return sorted(rows), sorted(views)


def test_step_matches_jax_on_mesh8(scene, jax_steps, port_steps):
    """(1) The port's 8-shard step against JAX's on mesh8, densify off."""
    gmap, batch = scene
    rows, slots = sign_flips(gmap, batch.images, batch.T_w2c)
    assert_steps_close(port_steps["8"], jax_steps["off"], skip_rows=rows, skip_slots=slots)


def test_densify_step_matches_jax_with_replayed_noise(scene, jax_steps, port_steps):
    """(2) update_every=1: densify fires inside the step with JAX's split
    noise replayed. The alive rows and n_dropped equal, the map finite, the
    densify statistics cleared, parameters within the sign bound. A split
    child sits at parent + R(q) (noise * scale), and the first Adam step
    moves q by +-rotation_lr wherever its gradient is at rounding level (a
    third of the quaternion entries here: the scene's Gaussians are
    isotropic, so no render depends on q), so on the split parents' and
    children's rows xyz is held to the bound's maximum only."""
    mp, *_, lp, dp = result_numpy(port_steps["densify"])
    mj, *_, lj, dj = result_numpy(jax_steps["densify"])
    m0 = result_numpy(port_steps["8"])[0]  # the same step without densify
    before = np.asarray(scene[0].aux.active)
    assert dp == dj == 0
    alive = mp["aux.active"]
    np.testing.assert_array_equal(alive, mj["aux.active"])
    assert alive.sum() > before.sum()
    assert np.isfinite(mp["params.xyz"][alive]).all()
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    np.testing.assert_array_equal(mp["aux.grad_accum"], 0.0)
    grads = m0["aux.grad_accum"] / np.maximum(m0["aux.denom"], 1.0)
    split = (before & (grads >= OPT.densify_grad_threshold)) | (alive & ~before)
    for name, lr in (("xyz", JOPT.position_lr_init * JOPT.spatial_lr_scale),
                     ("opacity_logit", JOPT.opacity_lr)):
        d = np.abs(mp["params." + name] - mj["params." + name])[alive]
        assert d.max() <= 2.05 * lr, (name, d.max())
        rest = (alive & ~split)[alive] if name == "xyz" else np.ones(alive.sum(), bool)
        assert (d[rest] > 1e-5).mean() < 0.05, name


def test_eight_shards_match_one(port_steps):
    """(3) The port's psum (the shards' partials in shard order) against
    one shard, and the replicas equal bit for bit."""
    assert_steps_close(port_steps["8"], port_steps["1"])
    gmap = port_steps["8"][0]
    replicas = P.replicate(P.make_mesh(8, "cpu"), gmap.params, gmap.aux.active)
    for params, active in replicas:
        assert torch.equal(active, gmap.aux.active)
        for a, b in zip(params.values(), gmap.params.values()):
            assert torch.equal(a, b)


def test_pose_updates_respect_masks(scene):
    """(4) tests/test_parallel.py::test_pose_updates_respect_masks."""
    gmap, batch = scene
    batch = port_batch(batch)
    T_pert = batch.T_w2c.clone()
    T_pert[:, 0, 3] += 0.01
    batch.T_w2c = T_pert
    _, b_new, _, _, _ = port_step(8, port_map(gmap), batch)
    T_new = P.gather(b_new.T_w2c, "cpu").numpy()
    np.testing.assert_array_equal(T_new[0], T_pert[0].numpy())  # frozen slot
    assert np.abs(T_new[1:] - T_pert[1:].numpy()).max() > 0
    RtR = T_new[:, :3, :3] @ np.swapaxes(T_new[:, :3, :3], 1, 2)
    np.testing.assert_allclose(RtR, np.tile(np.eye(3), (8, 1, 1)), atol=1e-5)


def test_multi_step_convergence():
    """(5) tests/test_parallel.py::test_multi_step_convergence on the port's
    8-shard mesh: a colour-perturbed map closes most of its photometric gap
    to the loss floor in 25 steps."""
    jmap = _scene_map()
    batch = port_batch(_make_batch(jmap, 8))
    gt = port_map(jmap)
    k = jax.random.PRNGKey(3)
    gmap = port_map(jmap._replace(params=jmap.params._replace(
        f_dc=jmap.params.f_dc + 0.3 * jax.random.normal(k, jmap.params.f_dc.shape))))
    mesh = P.make_mesh(8, "cpu")
    step = P.dp_mapping_step(mesh, StepConfig(monocular=False), MapOptConfig(feature_lr=0.05),
                             INTR, RCFG, use_depth=True, update_every=10_000, update_offset=0)
    batch = P.shard_batch(mesh, batch)
    opt = P.make_dp_opt_state(8)
    draws = KeyDraws(jax.random.PRNGKey(0))
    floor = float(step(gt, batch, opt, 0, draws, TH, EXTENT)[3])
    losses = []
    for it in range(25):
        gmap, batch, opt, loss, _ = step(gmap, batch, opt, it, draws, TH, EXTENT)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    gap0, gap_end = losses[0] - floor, losses[-1] - floor
    assert gap0 > 0.01, (losses[0], floor)
    assert gap_end < 0.5 * gap0, (floor, losses)


@pytest.fixture(scope="module")
def refine_inputs():
    jmap = _scene_map()
    batch = _make_batch(jmap, 8)
    k = jax.random.PRNGKey(3)
    jmap = jmap._replace(params=jmap.params._replace(
        f_dc=jmap.params.f_dc + 0.2 * jax.random.normal(k, jmap.params.f_dc.shape)))
    return jmap, batch


def test_refine_step_matches_jax_then_converges(refine_inputs):
    """(6) dp_refine_step: one step on 8 shards against JAX's on mesh8 (loss
    rtol 1e-5, first moment rtol 1e-4 / atol 1e-7, parameters within the
    sign bound), then tests/test_parallel.py's 20-step convergence and the
    replicas equal bit for bit."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    jmap, batch = refine_inputs
    mesh8 = j_make_mesh(8)
    kf = NamedSharding(mesh8, JP("kf"))
    jstep = j_dp_refine_step(mesh8, JStepConfig(monocular=False), JOPT, JINTR, JRCFG)
    jg, jloss, jit = jstep(jax.device_put(jmap, NamedSharding(mesh8, JP())),
                           jax.device_put(batch.images, kf), jax.device_put(batch.T_w2c, kf),
                           jnp.zeros((), jnp.int32), jnp.zeros(3))

    mesh = P.make_mesh(8, "cpu")
    step = P.dp_refine_step(mesh, StepConfig(monocular=False), OPT, INTR, RCFG)
    images = torch.tensor(np.asarray(batch.images))
    poses = torch.tensor(np.asarray(batch.T_w2c))
    gmap, loss, it = step(port_map(jmap), images, poses, 0, torch.zeros(3))
    assert it == int(jit) == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    mp, mj = gaussian_map_to_numpy(gmap), jmap_to_numpy(jg)
    keep = np.ones(mp["aux.active"].shape[0], bool)
    keep[sign_flips(jmap, batch.images, batch.T_w2c, masked=False)[0]] = False
    for k in mj:
        if k.startswith("mu."):
            np.testing.assert_allclose(mp[k][keep], mj[k][keep], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    for name, lr in (("xyz", JOPT.position_lr_init * JOPT.spatial_lr_scale),
                     ("f_dc", JOPT.feature_lr), ("opacity_logit", JOPT.opacity_lr)):
        d = np.abs(mp["params." + name] - mj["params." + name])
        assert d.max() <= 2.05 * lr, (name, d.max())
        assert (d > 1e-5).mean() < 0.05, name

    losses = [float(loss)]
    images, poses = P.shard(mesh, images), P.shard(mesh, poses)
    for _ in range(19):
        gmap, loss, it = step(gmap, images, poses, it, torch.zeros(3))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses
    for params, _ in P.replicate(mesh, gmap.params, gmap.aux.active):
        for a, b in zip(params.values(), gmap.params.values()):
            assert torch.equal(a, b)


# ----------------------------------------------------------- the engine

GRAFT_CONFIG = {
    # __graft_entry__.py::_dryrun_multichip_impl's config: cadences that
    # cross every DP event class (init-BA densify and the global init
    # reset, steady densify and the non-visible reset)
    "Dataset": {"sensor_type": "depth", "type": "synthetic", "pcd_downsample": 8,
                "pcd_downsample_init": 4, "point_size": 0.05, "adaptive_pointsize": True},
    "Training": {
        "init_itr_num": 8, "init_gaussian_update": 3, "init_gaussian_reset": 6,
        "init_gaussian_th": 0.005, "init_gaussian_extent": 30, "tracking_itr_num": 10,
        "mapping_itr_num": 10, "gaussian_update_every": 5, "gaussian_update_offset": 2,
        "gaussian_th": 0.7, "gaussian_extent": 1.0, "gaussian_reset": 10,
        "size_threshold": 20, "window_size": 4, "pose_window": 3,
        "lr": {"cam_rot_delta": 0.003, "cam_trans_delta": 0.001},
    },
    "opt_params": {
        "position_lr_init": 0.00016, "position_lr_final": 0.0000016,
        "position_lr_delay_mult": 0.01, "position_lr_max_steps": 30000,
        "feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.001,
        "rotation_lr": 0.001, "percent_dense": 0.01, "lambda_dssim": 0.2,
        "densify_grad_threshold": 0.0002,
    },
    "TPU": {"mesh_devices": 4, "tile": 16, "max_per_tile": 64, "k_dup": 8, "tile_group": 8,
            "map_chunk": 4},
}
WINDOWS = [[1, 0], [2, 1, 0], [3, 2, 1, 0], [4, 3, 2, 1]]
DP_TELEMETRY = ("dp_init_iters", "dp_densify_events", "dp_resets", "map_iters")


def graft_config(**tpu):
    cfg = {k: dict(v) for k, v in GRAFT_CONFIG.items()}
    cfg["TPU"].update(tpu)
    return {k: {n: x for n, x in v.items() if x is not None} for k, v in cfg.items()}


@pytest.fixture(scope="module")
def graft_frames():
    """(image, depth, pose) numpy of keyframes 0..4, rendered by JAX as the
    dry run renders them."""
    scene, scene_active = make_synthetic_scene(jax.random.PRNGKey(0), n=256)
    rcfg = j_raster_config_from(GRAFT_CONFIG)
    out = []
    for k in range(5):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.02 * k
        r = j_render(scene, scene_active, jnp.asarray(T), JINTR, 0, config=rcfg)
        dep = jnp.where(r.alpha > 0.5, r.depth, 0.0)
        out.append((np.array(r.color), np.array(dep), T))
    return out


def graft_messages(frames, make_kf, to_dev):
    msgs = []
    for k, (img, dep, T) in enumerate(frames):
        kf = make_kf(k, to_dev(img), to_dev(dep), T)
        msgs.append(["init", 0, kf, to_dev(dep)] if k == 0
                    else ["keyframe", k, kf, WINDOWS[k - 1], to_dev(dep)])
    return msgs


def drive(engine, msgs):
    """The messages straight into the engine; after each, the slots' Adam
    step count and the alive count."""
    counts, alive = [], []
    for m in msgs:
        if m[0] == "init":
            engine.handle_init(*m[1:])
        else:
            engine.handle_keyframe(*m[1:], single_thread=False)
        counts.append(engine._dp_state.count if engine._dp_state is not None else None)
        alive.append(int(np.asarray(engine.gmap.aux.active).sum()))
    return counts, alive


def port_engine(config):
    return tbackend.BackendEngine(
        config, StepConfig.from_config(config), MapOptConfig.from_config(config), INTR,
        raster_config_from(config), capacity=1024, device="cpu", seed=0, live_mode=True)


def replay_jax_engine_draws(engine):
    """The JAX engine's key splits, in its order: two uniforms a keyframe
    insertion, one key a data-parallel step."""
    state = {"key": jax.random.PRNGKey(0)}

    def split():
        state["key"], k = jax.random.split(state["key"])
        return k

    def point_draws():
        k1, k2 = jax.random.split(split())
        shape = (INTR.height, INTR.width)
        return (np.asarray(jax.random.uniform(k1, shape)),
                np.asarray(jax.random.uniform(k2, shape)))

    engine._point_draws = point_draws
    engine._dp_draws = lambda: KeyDraws(split())


def port_msgs(frames):
    return graft_messages(frames, lambda i, img, d, T: Keyframe(
        idx=i, image=img, depth=d, T_w2c=T, exposure=np.zeros(2, np.float32), T_gt=T),
        torch.from_numpy)


@pytest.fixture(scope="module")
def engines(graft_frames):
    config = graft_config()
    je = jbackend.BackendEngine(config, JStepConfig.from_config(config),
                                JMapOpt.from_config(config), JINTR,
                                j_raster_config_from(config), capacity=1024, seed=0,
                                live_mode=True)
    assert je._dp_step is not None and je.mesh.devices.size == 4
    j_counts, j_alive = drive(je, graft_messages(graft_frames, lambda i, img, d, T: JKeyframe(
        idx=i, image=img, depth=d, T_w2c=T, exposure=np.zeros(2, np.float32), T_gt=T),
        jnp.asarray))
    te = port_engine(config)
    replay_jax_engine_draws(te)
    t_counts, t_alive = drive(te, port_msgs(graft_frames))
    return je, (j_counts, j_alive), te, (t_counts, t_alive)


def test_engine_dp_path_matches_jax(engines):
    """(7) TPU.mesh_devices: 4 routes every mapping phase through `_map_dp`
    in both packages; telemetry equal, keyframes within 5 mm, alive count
    within 2%."""
    je, _, te, _ = engines
    assert te.mesh.size == 4 and te._dp_slots == 8 == je._dp_slots
    for k in DP_TELEMETRY:
        assert te.telemetry[k] == je.telemetry[k], (k, te.telemetry[k], je.telemetry[k])
    tel = te.telemetry
    assert tel["dp_init_iters"] == 8 and tel["dp_densify_events"] > 0 and tel["dp_resets"] > 0
    assert tel["map_iters"] == 8 + 4 * 11  # RGB-D: no window-fill BA
    assert te.iteration_count == je.iteration_count
    assert np.isfinite(te.gmap.params.xyz.numpy()).all()
    assert te.current_window == je.current_window == WINDOWS[-1]
    for i in range(5):
        p = np.linalg.inv(np.asarray(te.viewpoints[i].T_w2c, np.float64))[:3, 3]
        q = np.linalg.inv(np.asarray(je.viewpoints[i].T_w2c, np.float64))[:3, 3]
        assert np.linalg.norm(p - q) < 0.005, i
    # the config's gaussian_th 0.7 prunes every Gaussian under opacity 0.7
    # at each steady densify (from iteration 12), in the JAX dry run too:
    # the alive counts are compared after every message
    _, (_, j_alive), _, (_, t_alive) = engines
    assert j_alive[0] > 0, j_alive
    for n_port, n_jax in zip(t_alive, j_alive):
        assert abs(n_port - n_jax) <= 0.02 * n_jax, (t_alive, j_alive)


def test_dp_slot_state_persists_across_keyframes(engines):
    """(9) As in the JAX package, the slots' Adam state is not reset at the
    init or a keyframe (the single path's `kf_state` is): its step count runs
    on over every round."""
    je, (j_counts, _), te, (t_counts, _) = engines
    assert t_counts == j_counts == [8, 19, 30, 41, 52]
    assert te.kf_state is None


def test_engine_dp_path_in_thread_mode(graft_frames, engines):
    """(8) The same messages through `BackendThread` (idle rounds paused):
    the map, keyframe poses and telemetry equal the inline engine's bit for
    bit."""
    _, _, te, _ = engines
    config = graft_config(scheduler="thread")
    engine = port_engine(config)
    replay_jax_engine_draws(engine)
    thread = tbackend.BackendThread(engine)
    thread.start()
    for m in [["pause"]] + port_msgs(graft_frames) + [["stop"]]:
        thread.backend_queue.put(m)
    thread.join(timeout=300)
    assert not thread.is_alive()
    assert thread.handled["keyframe"] == 4 and thread.handled["init"] == 1
    a, b = gaussian_map_to_numpy(engine.gmap), gaussian_map_to_numpy(te.gmap)
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    for i in range(5):
        assert np.array_equal(engine.viewpoints[i].T_w2c, te.viewpoints[i].T_w2c), i
    for k in DP_TELEMETRY:
        assert engine.telemetry[k] == te.telemetry[k], k


def test_no_mesh_without_the_key(graft_frames, monkeypatch):
    """(10) A config without `TPU.mesh_devices` builds no mesh and maps on
    the single-device path."""
    def no_mesh(*args, **kwargs):
        raise AssertionError("a mesh was built")

    monkeypatch.setattr(P, "make_mesh", no_mesh)
    monkeypatch.setattr(P.mesh, "make_mesh", no_mesh)
    engine = port_engine(graft_config(mesh_devices=None))
    assert engine.mesh is None and engine._dp_step is None
    for m in port_msgs(graft_frames)[:2]:
        drive(engine, [m])
    assert engine._dp_state is None and engine.kf_state is not None
    assert engine.telemetry["map_iters"] == 8 + 11
    assert all(engine.telemetry[k] == 0 for k in DP_TELEMETRY[:3])


class _FakeStream:
    def __init__(self, index):
        self.index, self.waited = index, []

    def wait_event(self, event):
        self.waited.append(event)


class _FakeCudaTensor:
    is_cuda = True

    def __init__(self, index):
        self.device = torch.device("cuda", index)
        self.recorded = []

    def record_stream(self, stream):
        self.recorded.append(stream)


def test_hand_off_orders_every_card_of_a_mesh(monkeypatch):
    """A hand-off of a mesh's tensors (`adopt_on_stream`, as `BackendThread`
    calls it with the engine's card) makes the engine card's current stream
    wait on the event even where the first tensor met lies on another card,
    and marks each tensor as used on its own card's stream. Streams are
    stood in for, so no card is needed."""
    streams = {}

    def current_stream(index=None):
        index = 0 if index is None else index
        return streams.setdefault(index, _FakeStream(index))

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    ready = object()
    # a slot moment on cuda:1 first, as engine_tensors lists `_dp_state` last
    # and device_tensors walks its stack from the end
    tensors = [_FakeCudaTensor(1), _FakeCudaTensor(0), _FakeCudaTensor(0)]
    tbackend.adopt_on_stream(ready, tensors + [torch.zeros(2)], torch.device("cuda", 0))
    assert streams[0].waited == [ready] and streams[1].waited == [ready]
    for t in tensors:
        assert t.recorded == [streams[t.device.index]]
    # with no CUDA tensor at all, the engine's card still waits
    streams.clear()
    tbackend.adopt_on_stream(ready, [torch.zeros(2)], torch.device("cuda", 0))
    assert list(streams) == [0] and streams[0].waited == [ready]
    tbackend.adopt_on_stream(None, tensors)  # off the card: nothing to order
    assert streams[0].waited == [ready]

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (fails without a CUDA device);
2. build: compiles the blend kernels (monogs_dev_tpu_torch/csrc) with nvcc;
3. kernels: K1, K3 and K2 at the bench shapes (VGA, 16x16 tiles, L = 512),
   on props from the port's projection, binning and gather of the bench
   scene at frame 0, each held against its plain torch version on the card
   and timed with CUDA events;
4. slice: `configs/synthetic/bench_vga.yaml` (RGB-D, Gauss-Newton tracking)
   through `SLAM`, the code path of `slam_torch.py`: frames 0..11 for the
   tracked frames/s, then on to the first keyframe after frame 0 and two
   frames past it, with the kernel launch counts of that run and the ATE;
5. map kernels: K1, K3 and K2 again, on the map after the init mapping
   and at the end of the slice, binned as the mapping loop bins them;
6. tiers: the slice's final map compacted to a smaller tier and grown
   back, against the same steps on the CPU and against its full render;
7. lab: the kernel lab's entry point (`monogs_dev_tpu_torch/tools/
   kernel_lab.py`, every variant) on the lab scene at the lab's size, with
   the launch counts of that run; then every L1 variant and L2 against its
   plain version (L2 also against autograd through the plain blend), on the
   lab scene and on the slice's map after init binned as mapping bins it,
   each timed with CUDA events beside K1/K2 on the same props;
8. monocular: `configs/synthetic/bench_vga.yaml` forced monocular through
   `SLAM`, the code path of `bench_torch.py`: warm-up until the frontend and
   backend are initialized (by frame 162), 25 timed frames, and the checks
   (finite poses, a full window of keyframes, scale-corrected keyframe ATE
   under 8 cm, K1/K2/K3 launched in the run).

The line before the last lists every kernel with its launches, its largest
error against its plain version, its time, the plain version's time and
its bound on an H100 (`bound_ms`: the larger of the bytes it must move over
3.35 TB/s and its fp32 operations over 67 TFLOP/s, for this run's data).
The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "synthetic", "bench_vga.yaml")
N_FRAMES = 12  # frames 2..11 give the tracked frames/s
MAX_FRAMES = 96  # the first keyframe after frame 0 must come by then
AFTER_KF = 2  # frames tracked against the map that the keyframe grew
TOL = {"color": 3e-5, "alpha": 3e-5, "depth": 3e-4}
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5  # atol: fp32 sums of ~256 pixel terms in another order
# L2's absolute floor, relative to the largest gradient (as tests/test_torch_gpu.py
# holds K2): on the lab scene (max |grad| ~500) float32 autograd and K2 themselves
# miss the absolute 1e-5 floor against float64 autograd (PERF.md, Findings)
L2_ATOL_REL = 1e-5
MONO_FRAME_CAP = 162  # bench.py:106: the last warm-up frame that leaves 25 to time
MONO_ATE_BAR = 0.08  # tests/test_system.py:317
SOURCES = {"K": "monogs_dev_tpu_torch/csrc/blend.cu", "L": "monogs_dev_tpu_torch/csrc/blend_lab.cu"}
REPLACES = {
    "K1": "monogs_dev_tpu/ops/blend_pallas.py:177",
    "K3": "monogs_dev_tpu/ops/blend_pallas.py:211",
    "K2": "monogs_dev_tpu/ops/blend_pallas.py:322",
    "L1": "tools/kernel_lab.py:418",
    "L2": "tools/kernel_lab.py:479",
}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) op/s
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# fp32 ops per (entry, pixel) pair, counted from the sources (expf, log1pf
# and a division as one op each; the gradients' pixel sums as one add per
# component): K1 29, K3 30 (+ the touch test), L1 32 (trimat 34, rank-6 31),
# K2 63, L2 61 (40 in the pixel pass, 11 moments FFMA)
OPS_PER_PAIR = {"K1": 29, "K3": 30, "K2": 63, "L2": 61, "L1": 32, "L1/trimat": 34,
                "L1/mxu": 31, "L1/lean": 31}


def bound(name, counts, n_done, p):
    """(bound_ms, bound_by) of kernel `name` on one call: bytes over HBM_BPS
    against ops over FP32_OPS. Bytes count the blended entries' props
    (sum(counts) x 40 B) and the per-pixel tensors once; ops count the
    (entry, pixel) pairs the data needs: sum(n_done) for K1-K3 and L2 (the
    entries each pixel multiplies in before it saturates), sum(counts) x P
    for L1 (no early exit)."""
    entries = float(counts.sum())
    t = counts.shape[0]
    px_bytes = 4.0 * t * p
    if name.startswith("L1"):
        nbytes = 40 * entries + 4 * t + 5 * px_bytes
        pairs = entries * p
    elif name in ("K2", "L2"):
        nbytes = 40 * entries + 7 * px_bytes + 40 * entries  # props in, d_props out
        pairs = float(n_done.sum())
    else:  # K1, K3: color, depth, alpha, t_final, n_done (+ touch)
        nbytes = 40 * entries + 4 * t + 7 * px_bytes + (4 * entries if name == "K3" else 0)
        pairs = float(n_done.sum())
    ops = pairs * OPS_PER_PAIR.get(name, OPS_PER_PAIR[name[:2]])
    t_bytes, t_ops = nbytes / HBM_BPS, ops / FP32_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of `fn` over `reps` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def check_kernels(label, params, active, T_w2c, intr, rcfg, dilate=0.0):
    """K1/K3/K2 against the plain blend on the props that the port's
    projection, binning (tiles dilated by `dilate` px) and gather give for
    `params` seen from `T_w2c`, each timed with CUDA events beside the
    plain version."""
    import torch

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops.project import project_gaussians
    from monogs_dev_tpu_torch.ops.rasterize import _tile_gather, build_binning, grid_dims, tile_wh

    dev = T_w2c.device
    with torch.no_grad():
        proj = project_gaussians(params, active, T_w2c, intr, 0)
        binning = build_binning(proj, intr, rcfg, dilate=dilate)
        props = torch.cat([proj.means2d, proj.conic, proj.color, proj.opacity[:, None],
                           proj.depth[:, None]], dim=-1)
        props_pad = torch.cat([props, props.new_zeros((1, 10))], dim=0)
        t_props = _tile_gather(props_pad, binning.idx_table, binning.pos_table).contiguous()
    counts = binning.counts
    tw, th = tile_wh(rcfg)
    tx_n, _, n_tiles = grid_dims(intr, tw, th)
    cargs = (tx_n, (tw, th), rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    print(f"{label} kernels: props {tuple(t_props.shape)}, entries {int(counts.sum())}, "
          f"max per tile {int(counts.max())}, tiles over 256 entries "
          f"{int((counts > 256).sum())}", flush=True)

    results = {}
    with torch.no_grad():
        k1 = B.blend_forward_cuda(t_props, counts, *cargs, emit_touch=False)
        k3 = B.blend_forward_cuda(t_props, counts, *cargs, emit_touch=True)
        ref = B.blend_tiles_reference(t_props, counts, *cargs, tile_group=rcfg.tile_group)
    torch.cuda.synchronize()
    for name, out in (("K1", k1), ("K3", k3)):
        errs = {}
        for key, x, y in zip(("color", "depth", "alpha"), out[:3], ref[:3]):
            errs[key] = float((x - y).abs().max())
            if not errs[key] <= TOL[key]:
                fail(f"{label} {name} {key} max |err| {errs[key]} > {TOL[key]}")
        results[name] = {"max_abs_err": max(errs.values()), "errs": errs}
    n_bad = int((k3[5] != ref[3]).sum())
    if n_bad:
        fail(f"{label} K3 touch counts differ from the plain version in {n_bad} entries")
    print(f"{label} K1 vs plain: {results['K1']['errs']} (tol {TOL}); "
          f"pixels past entry 256: {int((k1[4] > 256).sum())}", flush=True)
    print(f"{label} K3 vs plain: {results['K3']['errs']}, touch counts equal "
          f"({int((ref[3] > 0).sum())} touched entries)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    p = tw * th
    g_color = torch.randn((n_tiles, 3, p), generator=gen, device=dev)
    g_depth = 0.1 * torch.randn((n_tiles, p), generator=gen, device=dev)
    g_alpha = torch.randn((n_tiles, p), generator=gen, device=dev)
    pr = t_props.clone().requires_grad_(True)
    c_r, d_r, a_r, _ = B.blend_tiles_reference(pr, counts, *cargs, tile_group=rcfg.tile_group)
    plain_loss = (c_r * g_color).sum() + (d_r * g_depth).sum() + (a_r * g_alpha).sum()
    (g_ref,) = torch.autograd.grad(plain_loss, pr, retain_graph=True)
    t_final, n_done = k1[3], k1[4]
    bwd_args = (t_props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, (tw, th),
                rcfg.alpha_clamp, rcfg.alpha_min)
    g_k = B.blend_backward_cuda(*bwd_args)
    torch.cuda.synchronize()
    err = (g_k - g_ref).abs()
    bad = err > GRAD_ATOL + GRAD_RTOL * g_ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g_k).all()):
        fail(f"{label} K2 props gradient: {int(bad.sum())} of {bad.numel()} outside rtol "
             f"{GRAD_RTOL} atol {GRAD_ATOL} (max |err| {float(err.max())})")
    results["K2"] = {"max_abs_err": float(err.max())}
    print(f"{label} K2 vs plain autograd: max |err| {float(err.max())} "
          f"(max |grad| {float(g_ref.abs().max())}; rtol {GRAD_RTOL}, atol {GRAD_ATOL})",
          flush=True)

    with torch.no_grad():
        results["K1"]["ms"] = cuda_ms(lambda: B.blend_forward_cuda(t_props, counts, *cargs, False))
        results["K3"]["ms"] = cuda_ms(lambda: B.blend_forward_cuda(t_props, counts, *cargs, True))
        results["K2"]["ms"] = cuda_ms(lambda: B.blend_backward_cuda(*bwd_args))
        plain_fwd = cuda_ms(lambda: B.blend_tiles_reference(
            t_props, counts, *cargs, tile_group=rcfg.tile_group), reps=5)
    results["K1"]["plain_ms"] = plain_fwd
    results["K3"]["plain_ms"] = plain_fwd  # the plain forward always counts touches
    results["K2"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(plain_loss, pr, retain_graph=True), reps=5)
    for name in ("K1", "K3", "K2"):
        r = results[name]
        r["bound_ms"], r["bound_by"] = bound(name, counts, k1[4], p)
        print(f"{label} {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return results


def scene_kernel_phase(config, dev):
    """The kernels on the bench scene itself, seen from frame 0's pose."""
    import torch

    from monogs_dev_tpu_torch.core.system import raster_config_from
    from monogs_dev_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(config, dev)
    T0 = torch.as_tensor(ds.poses[0], dtype=torch.float32, device=dev)
    return check_kernels("scene", ds.scene_params, ds.scene_active, T0, ds.intr,
                         raster_config_from(config))


def snapshot_map(slam, kf):
    """A copy of the map and of keyframe `kf`'s pose, for `map_kernel_phase`."""
    import torch

    engine = slam.engine
    return (f"map(kf {kf}, frame {slam.frontend.cur_frame_idx})",
            engine.gmap.params.map(lambda x: x.detach().clone()),
            engine.gmap.aux.active.clone(),
            torch.as_tensor(engine.viewpoints[kf].T_w2c, dtype=torch.float32,
                            device=slam.device))


def map_kernel_phase(slam, snapshots):
    """The kernels on the slice's mapped maps, binned as the mapping loop
    bins them (tiles dilated by `mapping_rebin_dilation`): the density the
    mapping renders blend. Returns each kernel's largest error."""
    worst = {}
    for label, params, active, T in snapshots:
        res = check_kernels(label, params, active, T, slam.intr, slam.raster_cfg,
                            dilate=slam.step_cfg.mapping_rebin_dilation)
        for name in ("K1", "K2", "K3"):
            worst[name] = max(worst.get(name, 0.0), res[name]["max_abs_err"])
    return worst


def _map_fields(gmap):
    for group, fields in (("params", gmap.params), ("aux", gmap.aux),
                          ("adam_mu", gmap.moments.mu), ("adam_nu", gmap.moments.nu)):
        for f in dataclasses.fields(fields):
            yield f"{group}.{f.name}", getattr(fields, f.name)


def tier_phase(slam):
    """The map tiers on the card. The slice's window never fills, so its
    run neither compacts nor grows the map; this compacts the slice's final
    map to the smallest power-of-two tier that holds its alive rows and
    grows it back (`compact_map`, `resize_map`, as `BackendEngine`'s tiers
    call them). Every field must equal the same steps on a CPU copy, and
    the compacted map must render what the full map renders."""
    import torch

    from monogs_dev_tpu_torch.models.gaussians import compact_map, resize_map
    from monogs_dev_tpu_torch.ops.rasterize import render_tiled

    gmap, eng = slam.engine.gmap, slam.engine
    rows, alive = int(gmap.aux.active.shape[0]), int(gmap.aux.active.sum())
    tier = 1 << max(alive - 1, 1).bit_length()
    if tier >= rows:
        fail(f"tiers: {alive} alive rows leave no smaller tier than {rows}")
    small, perm = compact_map(gmap, tier)
    grown = resize_map(small, rows)
    small_cpu, perm_cpu = compact_map(gmap.rows(lambda x: x.cpu()), tier)
    grown_cpu = resize_map(small_cpu, rows)
    if not torch.equal(perm.cpu(), perm_cpu):
        fail("tiers: compact_map's row permutation differs from the CPU's")
    for label, card, cpu in (("compacted", small, small_cpu), ("grown", grown, grown_cpu)):
        for (name, a), (_, b) in zip(_map_fields(card), _map_fields(cpu)):
            if not torch.equal(a.cpu(), b):
                fail(f"tiers: {label} {name} differs from the CPU's")
    if int(small.aux.active.sum()) != alive or int(grown.aux.active[tier:].sum()) != 0:
        fail("tiers: alive rows lost or misplaced by compaction")

    kf = slam.frontend.kf_indices[-1]
    T = torch.as_tensor(eng.viewpoints[kf].T_w2c, dtype=torch.float32, device=slam.device)
    with torch.no_grad():
        full, comp = (render_tiled(m.params, m.aux.active, T, slam.intr, eng.cfg.sh_degree,
                                   config=slam.raster_cfg) for m in (gmap, small))
    errs = {k: float((getattr(full, k) - getattr(comp, k)).abs().max())
            for k in ("color", "depth", "alpha")}
    for k, v in errs.items():
        if not v <= TOL[k]:
            fail(f"tiers: the compacted map's {k} differs by {v} > {TOL[k]}")
    if not torch.equal(full.n_touched[perm[:tier]], comp.n_touched):
        fail("tiers: n_touched of the compacted map differs from the full map's")
    print(f"tiers: {rows} -> {tier} -> {rows} rows, {alive} alive, every field equal to "
          f"the CPU's; render of kf {kf} vs full map {errs}, n_touched equal "
          f"({int((comp.n_touched > 0).sum())} touched)", flush=True)


def check_lab(label, t_props, counts, tx_n, rcfg):
    """Every L1 variant against its plain version, and L2 against its plain
    version and against autograd through the plain blend (K2's tolerances),
    on these props; each timed beside its plain version with CUDA events."""
    import torch

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops import blend_lab as BL
    from monogs_dev_tpu_torch.ops.rasterize import tile_wh

    tw, th = tile_wh(rcfg)
    tile, p = (tw, th), tw * th
    cfg = (rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    res = {}
    with torch.no_grad():
        for v in BL.LAB_VARIANTS:
            out = BL.lab_forward_cuda(v, t_props, counts, tx_n, tile, *cfg)
            ref = BL.lab_blend_reference(v, t_props, counts, tx_n, tile, *cfg, rcfg.tile_group)
            torch.cuda.synchronize()
            errs = {k: float((a - b).abs().max()) for k, a, b in zip(("color", "depth", "alpha"),
                                                                    out, ref)}
            for k, e in errs.items():
                if not e <= TOL[k]:
                    fail(f"{label} L1/{v} {k} max |err| {e} > {TOL[k]}")
            r = res[f"L1/{v}"] = {"max_abs_err": max(errs.values()), "errs": errs}
            r["ms"] = cuda_ms(lambda v=v: BL.lab_forward_cuda(v, t_props, counts, tx_n, tile, *cfg))
            r["plain_ms"] = cuda_ms(lambda v=v: BL.lab_blend_reference(
                v, t_props, counts, tx_n, tile, *cfg, rcfg.tile_group), reps=3)
            r["bound_ms"], r["bound_by"] = bound(f"L1/{v}", counts, None, p)
            print(f"{label} L1/{v} vs plain: {errs}; {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
                  flush=True)

        t_final, n_done = BL.blend_residuals(t_props, counts, tx_n, tile, *cfg)
        gen = torch.Generator(device=t_props.device).manual_seed(1)
        cots = (torch.randn((t_props.shape[0], 3, p), generator=gen, device=t_props.device),
                0.1 * torch.randn((t_props.shape[0], p), generator=gen, device=t_props.device),
                torch.randn((t_props.shape[0], p), generator=gen, device=t_props.device))
        args = (t_props, t_final, n_done, *cots, tx_n, tile, *cfg[:2])
        got = BL.moments_backward_cuda(*args)
        plain = BL.moments_backward_reference(*args, rcfg.tile_group)
    # the gradient references: autograd through the plain blend in float32
    # (what K2 is held to) and, for scale, in float64
    refs = {}
    for dtype in (torch.float64, torch.float32):
        pr = t_props.to(dtype).requires_grad_(True)
        out = B.blend_tiles_reference(pr, counts, tx_n, tile, *cfg, tile_group=rcfg.tile_group)
        (g,) = torch.autograd.grad(sum((o * c.to(dtype)).sum() for o, c in zip(out[:3], cots)),
                                   pr)
        refs[dtype] = g.to(torch.float64)
        del pr, out
    with torch.no_grad():
        k2 = B.blend_backward_cuda(t_props, t_final, n_done, *cots, tx_n, tile, *cfg[:2])
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail(f"{label} L2: non-finite gradient")
    g32, g64 = refs[torch.float32], refs[torch.float64]
    errs, n_bad = {}, {}
    for what, x, ref in (("L2 vs plain", got, plain), ("L2 vs plain autograd", got, g32),
                         ("L2 vs float64 autograd", got, g64),
                         ("K2 vs float64 autograd", k2, g64),
                         ("float32 autograd vs float64 autograd", g32, g64)):
        x, ref = x.to(torch.float64), ref.to(torch.float64)
        err = (x - ref).abs()
        ratio = err / (GRAD_ATOL + GRAD_RTOL * ref.abs())
        atol = L2_ATOL_REL * float(ref.abs().max())
        n_bad[what] = int((err > atol + GRAD_RTOL * ref.abs()).sum())
        errs[what] = float(err.max())
        t_i, e_i, c_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
        print(f"{label} {what}: max |err| {errs[what]:.4g}; worst entry against K2's "
              f"tolerance (rtol {GRAD_RTOL}, atol {GRAD_ATOL}): tile {t_i} entry {e_i} column "
              f"{c_i}, err {float(err[t_i, e_i, c_i]):.4g} on {float(ref[t_i, e_i, c_i]):.6g} "
              f"({float(ratio.max()):.3g} x tol; mean {t_props[t_i, e_i, 0:2].tolist()}, conic "
              f"{t_props[t_i, e_i, 2:5].tolist()}), {int((ratio > 1.0).sum())} of "
              f"{ratio.numel()} outside it; outside rtol {GRAD_RTOL} atol {atol:.3g} "
              f"({L2_ATOL_REL} x max |grad| {float(ref.abs().max()):.4g}): {n_bad[what]}",
              flush=True)
    for what in ("L2 vs plain", "L2 vs plain autograd"):
        if n_bad[what]:
            fail(f"{label} {what}: {n_bad[what]} entries outside tolerance")
    errs = {k: errs[k] for k in ("L2 vs plain", "L2 vs plain autograd")}
    r = res["L2"] = {"max_abs_err": max(errs.values())}
    with torch.no_grad():
        r["ms"] = cuda_ms(lambda: BL.moments_backward_cuda(*args))
        r["plain_ms"] = cuda_ms(lambda: BL.moments_backward_reference(*args, rcfg.tile_group),
                                reps=3)
    r["bound_ms"], r["bound_by"] = bound("L2", counts, n_done, p)
    print(f"{label} L2: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return res


def lab_phase(dev, snapshot, intr, rcfg, dilate):
    """The lab's entry point on the lab scene (the launch counts of that
    run), then L1/L2 against their plain versions on the lab scene and on
    the slice's post-init map."""
    import torch

    from monogs_dev_tpu_torch.data.synthetic import load_lab_scene
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops import blend_lab as BL
    from monogs_dev_tpu_torch.tools import kernel_lab as KL

    B.reset_launch_counts()
    for v in BL.VARIANT_LAUNCHES:
        BL.VARIANT_LAUNCHES[v] = 0
    KL.run_lab(KL.ALL_VARIANTS, dev)
    torch.cuda.synchronize()
    launches = {f"L1/{v}": n for v, n in BL.VARIANT_LAUNCHES.items()}
    launches["L2"] = B.LAUNCHES["L2"]
    print(f"lab launches: {launches} (K1 {B.LAUNCHES['K1']}, K2 {B.LAUNCHES['K2']})", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the lab's run")

    params = load_lab_scene(dev)
    active = torch.ones(params.xyz.shape[0], dtype=torch.bool, device=dev)
    t_props, counts = KL.tile_props(params, active, torch.eye(4, device=dev), KL.LAB_INTR,
                                    KL.LAB_RASTER)
    tx_n = -(-KL.LAB_INTR.width // KL.LAB_RASTER.tile)
    print(f"lab scene: props {tuple(t_props.shape)}, entries {int(counts.sum())}, "
          f"max per tile {int(counts.max())}", flush=True)
    res = check_lab("lab", t_props, counts, tx_n, KL.LAB_RASTER)
    label, m_params, m_active, T = snapshot
    m_props, m_counts = KL.tile_props(m_params, m_active, T, intr, rcfg, dilate=dilate)
    print(f"{label} lab: props {tuple(m_props.shape)}, entries {int(m_counts.sum())}, max per "
          f"tile {int(m_counts.max())}, tiles over 256 entries {int((m_counts > 256).sum())}",
          flush=True)
    res_map = check_lab(label, m_props, m_counts, -(-intr.width // rcfg.tile), rcfg)
    for name, r in res.items():
        r["max_abs_err"] = max(r["max_abs_err"], res_map[name]["max_abs_err"])
        r["launches"] = launches[name]
    return res


def mono_phase(config, dev):
    """bench_torch.py's run: bench_vga forced monocular, warm-up until both
    halves are initialized (by frame MONO_FRAME_CAP), 25 timed frames."""
    import torch

    import bench_torch
    from monogs_dev_tpu_torch.ops import blend as B

    B.reset_launch_counts()
    slam, info = bench_torch.run_bench(config, dev)
    torch.cuda.synchronize()
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    slam.stop()
    fe = slam.frontend
    ate = slam.keyframe_ate()
    info.update(keyframes=list(fe.kf_indices), frames=len(fe.cameras),
                keyframe_ate_cm=100.0 * ate, alive=slam.n_alive(), launches=launches,
                timers=slam.timers.summary(), telemetry=slam.engine.telemetry)
    print("mono: " + json.dumps(info), flush=True)
    print(f"mono frames/s: {info['fps']:.4f} over frames [{info['warm_frames']}, "
          f"{info['warm_frames'] + bench_torch.N_MEAS})", flush=True)
    if not info["initialized"] or info["warm_frames"] > MONO_FRAME_CAP:
        fail(f"the monocular run did not initialize by frame {MONO_FRAME_CAP}")
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras):
        fail("non-finite pose in the monocular run")
    if len(fe.kf_indices) < fe.window_size:
        fail(f"{len(fe.kf_indices)} keyframes, fewer than the window's {fe.window_size}")
    if not (np.isfinite(ate) and ate < MONO_ATE_BAR):
        fail(f"monocular keyframe ATE {ate} m is not finite and under {MONO_ATE_BAR} m")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched in the monocular run")
    return info


def slice_phase(config, dev):
    """Frames 0..11 give the tracked frames/s; the run then goes on to the
    first keyframe after frame 0 (its insertion, kNN, windowed mapping and
    harvest) and tracks AFTER_KF frames against the grown map. Copies of
    the map after the init mapping and at the end are returned for
    `map_kernel_phase`."""
    import torch

    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.eval.ate import ate_rmse
    from monogs_dev_tpu_torch.ops import blend as B

    slam = SLAM(config, dev, seed=0)
    fe = slam.frontend
    B.reset_launch_counts()
    t0 = time.time()
    slam.run(max_frames=1)  # frame 0 and, as the run ends, its init mapping
    snapshots = [snapshot_map(slam, 0)]
    slam.run(max_frames=2)  # the first tracked frame
    torch.cuda.synchronize()
    t1 = time.time()
    slam.run(max_frames=N_FRAMES)
    torch.cuda.synchronize()
    t2 = time.time()
    launches_12 = dict(B.LAUNCHES)
    n = N_FRAMES
    while len(fe.kf_indices) < 2 and n < MAX_FRAMES:
        n += 1
        slam.run(max_frames=n)  # each run ends by pumping the keyframe it sent
    if len(fe.kf_indices) < 2:
        fail(f"no keyframe after frame 0 within {MAX_FRAMES} frames")
    n += AFTER_KF
    slam.run(max_frames=n)
    torch.cuda.synchronize()
    t3 = time.time()
    launches = dict(B.LAUNCHES)
    slam.stop()
    snapshots.append(snapshot_map(slam, fe.kf_indices[-1]))
    ate = slam.keyframe_ate()
    frames = sorted(fe.cameras)
    ate_all = ate_rmse([fe.cameras[i].T_est for i in frames], [fe.cameras[i].T_gt for i in frames])
    info = {
        "frames": n,
        "init_and_first_frame_s": round(t1 - t0, 3),
        "tracked_fps": (N_FRAMES - 2) / (t2 - t1),
        "launches_frames_0_11": launches_12,
        "frames_12_on_s": round(t3 - t2, 3),
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "capacity_tier": int(slam.engine.gmap.aux.active.shape[0]),
        "keyframe_ate_cm": 100.0 * ate,
        "all_frame_ate_cm": 100.0 * ate_all,
        "launches": launches,
        "timers": slam.timers.summary(),
        "telemetry": slam.engine.telemetry,
    }
    print("slice: " + json.dumps(info), flush=True)
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras):
        fail("non-finite pose in the slice")
    for name, v in (("keyframe", ate), ("all-frame", ate_all)):
        if not (np.isfinite(v) and v < 0.03):
            fail(f"{name} ATE {v} m is not finite and under 3 cm")
    for name in ("K1", "K2", "K3"):
        if launches_12[name] <= 0:
            fail(f"kernel {name} was not launched in frames 0..11 of the slice")
    return slam, launches, snapshots


def main() -> int:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    sys.path.insert(0, REPO)
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.utils.config import load_config

    path, secs = B.build(verbose=True)
    print(f"build: {os.path.relpath(path, REPO)} in {secs:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(CONFIG)
    kres = scene_kernel_phase(config, dev)
    slam, _, snapshots = slice_phase(config, dev)
    worst = map_kernel_phase(slam, snapshots)
    tier_phase(slam)
    lres = lab_phase(dev, snapshots[0], slam.intr, slam.raster_cfg,
                     slam.step_cfg.mapping_rebin_dilation)
    del slam
    mono = mono_phase(load_config(CONFIG), dev)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES["K"],
            "replaces": REPLACES[name],
            "launches": mono["launches"][name],
            "max_abs_err": max(kres[name]["max_abs_err"], worst[name]),
            "ms": kres[name]["ms"],
            "plain_ms": kres[name]["plain_ms"],
            "bound_ms": kres[name]["bound_ms"],
            "bound_by": kres[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the blend
        }
        for name in ("K1", "K2", "K3")
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES["L"],
            "replaces": REPLACES[name[:2]],
            "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for name, r in lres.items()
    ]
    # K1-K3: launches in the monocular run (phase 8), ms/plain_ms/bound_ms on
    # the bench scene's props (phase 3), max_abs_err over phases 3 and 5;
    # L1/L2: launches in the lab's run, ms/plain_ms/bound_ms on the lab
    # scene's props, max_abs_err over the lab scene and the post-init map
    print(f"wall time: {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

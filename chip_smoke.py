#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (fails without a CUDA device);
2. build: compiles the blend kernels (monogs_dev_tpu_torch/csrc) with nvcc;
3. kernels: K1, K3 and K2 at the bench shapes (VGA, 16x16 tiles, L = 512),
   on props from the port's projection, binning and gather of the bench
   scene at frame 0, each held against its plain torch version on the card
   and against the first version of the kernels (csrc/blend_v1.cu), and
   timed: kernel-only (the C entry point into preallocated outputs, 20
   launches back to back between two CUDA events, median of 21 such runs)
   in turns with the first version, through the wrapper, and the plain
   version; then every L1 variant and L2 of the kernel lab the same way
   against their plain versions and their first version
   (csrc/blend_lab_v1.cu) (`check_lab`);
4. slice: `configs/synthetic/bench_vga.yaml` (RGB-D, Gauss-Newton tracking)
   through `SLAM`, the code path of `slam_torch.py`: frames 0..11 for the
   tracked frames/s, with the kernel launch counts of that run;
5. parity: `configs/synthetic/bench_vga_parity.yaml` (RGB-D, the
   reference's Adam tracking loop: the pose gradient through K1/K2 at every
   iteration) through `SLAM`, the code path of `slam_torch.py --eval`:
   frames 0..11 for the tracked frames/s, on to the first keyframe after
   frame 0 within PARITY_BUDGET_S (else it stops and says so), the Adam
   iterations a frame, the launch counts and the ATE; PARITY_PROFILE_FRAMES
   profiled frames; the first iteration's loss and gradient at one frame of
   the run, kernels against the plain blend (`gradient_check`); the map
   tiers (`tier_phase`: the map after the first keyframe compacted to a
   smaller tier and grown back, against the same steps on the CPU and
   against its full render); then
   `SLAM.evaluate` (colour refinement, PSNR/SSIM/LPIPS before and after,
   the ATE, PSNR-json and PLY artifacts in a temporary directory);
6. lab: the kernel lab's entry point (`monogs_dev_tpu_torch/tools/
   kernel_lab.py`, every variant) on the lab scene at the lab's size, with
   the launch counts of that run; phase 3 on the lab scene. On the lab
   scene, the post-init map and the monocular init map L2 is also held to
   autograd through the plain blend, with no more entries outside
   tolerance against float64 autograd than its first version;
7. monocular: `configs/synthetic/bench_vga.yaml` forced monocular through
   `SLAM`, the code path of `bench_torch.py`: warm-up until the frontend and
   backend are initialized (by frame 162), 25 timed frames, and the checks
   (finite poses, a full window of keyframes, scale-corrected keyframe ATE
   under 8 cm, K1/K2/K3 launched in the run);
   then PROFILE_FRAMES more frames under `torch.profiler` (each K kernel's
   device ms per frame, the device's idle share);
8. map kernels: phase 3 again on the maps after the RGB-D init mapping,
   after the parity run's first keyframe, and at the monocular
   initialization, binned as the mapping loop bins them.

The line before the last lists every kernel with its launches, its largest
error against its plain version, its time, the plain version's time and
its bound on an H100 (`bound_ms`: the larger of the bytes it must move over
3.35 TB/s and the fp32 operations this run's data needs over 67 TFLOP/s);
each also with the first version's time (`ms_v1`), the wrapper's
(`wrapper_ms`) and all of these on every prop set (`sets`). The last line
is {"ok": true, "device": {...}}; any failed check exits non-zero before it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "synthetic", "bench_vga.yaml")
PARITY_CONFIG = os.path.join(REPO, "configs", "synthetic", "bench_vga_parity.yaml")
N_FRAMES = 12  # frames 2..11 give the tracked frames/s
MAX_FRAMES = 96  # the parity run's first keyframe after frame 0 by then
TOL = {"color": 3e-5, "alpha": 3e-5, "depth": 3e-4}
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5  # atol: fp32 sums of ~256 pixel terms in another order
# L2's absolute floor, relative to the largest gradient (as tests/test_torch_gpu.py
# holds K2): on the lab scene (max |grad| ~500) float32 autograd itself misses
# the absolute 1e-5 floor against float64 autograd (PERF.md, Findings)
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
# kernel-only timing (kernel_ms): median over ROUNDS rounds of BURST launches,
# each burst queued behind ~1 ms of device sleep
ROUNDS, BURST, SLEEP_CYCLES = 21, 20, 2_000_000
# monocular frames profiled after the timed window, fewer where the sequence
# ends first (20 until the parity phase took their time)
PROFILE_FRAMES = 8
# profiler kernel names of K1-K3
PROFILE_NAMES = {"K1": "blend_fwd_kernel_v2<false>", "K3": "blend_fwd_kernel_v2<true>",
                 "K2": "blend_bwd_kernel_v2"}
# parity phase: the run goes on past frame 11 to the first keyframe after
# frame 0 while its wall time stays under PARITY_BUDGET_S; the Adam tracker's
# first iteration at PARITY_GRAD_FRAME is checked kernels against the plain
# blend (gradient within GRAD_CHECK_REL x max|g|, loss within LOSS_CHECK_REL
# relative); PARITY_PROFILE_FRAMES more frames are profiled
PARITY_BUDGET_S = 200.0
PARITY_GRAD_FRAME = 6
GRAD_CHECK_REL, LOSS_CHECK_REL = 1e-3, 1e-5
PARITY_PROFILE_FRAMES = 2
RGBD_ATE_BAR = 0.03  # PERF.md section 2
# CUDA runtime calls in which the host waits for the device (device-to-host
# copies of the stop tests' values, synchronizations)
HOST_WAIT_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) op/s
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# fp32 ops per (entry, pixel) pair whose alpha the blend uses, counted from
# the sources (expf, log1pf and a division as one op each, compares counted;
# the gradients' pixel sums as one add per component): K1 29, K3 30 (+ the
# touch test), L1 32 (trimat 34, rank-6 31), K2 63 (an alpha at its clamp
# skips 22 of them), L2 61 (40 in the pixel pass, 11 moments FFMA)
OPS_PER_PAIR = {"K1": 29, "K3": 30, "K2": 63, "L2": 61, "L1": 32, "L1/trimat": 34,
                "L1/mxu": 31, "L1/lean": 31}
# finding those pairs (csrc/blend.cu): an entry's reach box (`entry_reach`,
# 27 ops), and the box against a warp's 32-pixel strip (`misses`, 6 ops)
REACH_OPS, STRIP_OPS = 27, 6


def bound(name, counts, n_done, touch, p):
    """(bound_ms, bound_by) of kernel `name` on one call: bytes over HBM_BPS
    against ops over FP32_OPS. Bytes count the blended entries' props
    (sum(counts) x 40 B) and the per-pixel tensors once. Ops count the work
    this run's data needs, the same for every kernel of one function:
    OPS_PER_PAIR for each pair of a pixel and an entry it multiplies in with
    alpha >= alpha_min (sum(touch), exact: the plain version's touch counts
    just those pairs); the other pairs have alpha 0 and add nothing. Finding
    them costs REACH_OPS per entry up to the last one its tile multiplies in
    and STRIP_OPS per (entry, 32-pixel strip) up to the strip's last."""
    entries = float(counts.sum())
    t = counts.shape[0]
    px_bytes = 4.0 * t * p
    if name.startswith("L1"):
        nbytes = 40 * entries + 4 * t + 5 * px_bytes
    elif name in ("K2", "L2"):
        nbytes = 40 * entries + 7 * px_bytes + 40 * entries  # props in, d_props out
    else:  # K1, K3: color, depth, alpha, t_final, n_done (+ touch)
        nbytes = 40 * entries + 4 * t + 7 * px_bytes + (4 * entries if name == "K3" else 0)
    strips = n_done.reshape(t, p // 32, 32).amax(dim=2)  # entries each strip multiplies in
    ops = (float(touch.sum()) * OPS_PER_PAIR.get(name, OPS_PER_PAIR[name[:2]])
           + REACH_OPS * float(strips.amax(dim=1).sum()) + STRIP_OPS * float(strips.sum()))
    t_bytes, t_ops = nbytes / HBM_BPS, ops / FP32_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of `fn` over `reps` calls, each between two CUDA
    events (for a wrapper: its host work included)."""
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


def timed(fn):
    """(fn's result, its milliseconds between two CUDA events), one call:
    the plain versions of the lab, ~0.1 s a call, are timed by the call
    that checks against them."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def kernel_ms(launchers) -> dict:
    """Kernel-only milliseconds per launch of each zero-argument launcher
    (a C entry point into preallocated outputs, ops/blend.py): the median
    over ROUNDS rounds of BURST back-to-back launches between two CUDA
    events, the launchers in turns (in reverse order in every other round).
    Each burst is queued behind a device sleep, so the host's launch cost
    stays out of the window."""
    import torch

    for fn in launchers.values():
        fn()
    torch.cuda.synchronize()
    names = list(launchers)
    times = {n: [] for n in names}
    for r in range(ROUNDS):
        for n in names if r % 2 == 0 else names[::-1]:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            s.record()
            for _ in range(BURST):
                launchers[n]()
            e.record()
            e.synchronize()
            times[n].append(s.elapsed_time(e) / BURST)
    return {n: statistics.median(v) for n, v in times.items()}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def check_kernels(label, t_props, counts, tx_n, rcfg):
    """K1/K3/K2 against the plain blend and against their first version
    (t_final, n_done and touch counts equal bit for bit) on these per-tile
    props, then each timed: kernel-only beside the first version, in turns
    (`kernel_ms`), through its wrapper, and the plain version."""
    import torch

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops.rasterize import tile_wh

    dev = t_props.device
    tw, th = tile_wh(rcfg)
    n_tiles = t_props.shape[0]
    cargs = (tx_n, (tw, th), rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    print(f"{label} kernels: props {tuple(t_props.shape)}, entries {int(counts.sum())}, "
          f"max per tile {int(counts.max())}, tiles over 256 entries "
          f"{int((counts > 256).sum())}", flush=True)

    results = {}
    with torch.no_grad():
        k1 = B.blend_forward_cuda(t_props, counts, *cargs, emit_touch=False)
        k3 = B.blend_forward_cuda(t_props, counts, *cargs, emit_touch=True)
        launch_v1, v1 = B.forward_launcher(t_props, counts, *cargs, True, version=1)
        launch_v1()
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
    for what, a, b in (("t_final", k1[3], v1[3]), ("n_done", k1[4], v1[4]),
                       ("touch", k3[5], v1[5])):
        if not torch.equal(a, b):
            fail(f"{label} {what} differs from the first version's in {int((a != b).sum())} "
                 "places")
    print(f"{label} K1 vs plain: {results['K1']['errs']} (tol {TOL}); "
          f"pixels past entry 256: {int((k1[4] > 256).sum())}", flush=True)
    print(f"{label} K3 vs plain: {results['K3']['errs']}, touch counts equal "
          f"({int((ref[3] > 0).sum())} touched entries); t_final, n_done and touch equal to "
          "the first version's", flush=True)
    n_mult, n_touch = int(k1[4].sum()), int(ref[3].sum())
    print(f"{label} pairs: {n_mult} (entry, pixel) pairs multiplied in, {n_touch} of them "
          f"({100.0 * n_touch / max(n_mult, 1):.2f}%) with alpha >= alpha_min", flush=True)

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
    launch_v1, g_v1 = B.backward_launcher(*bwd_args, version=1)
    launch_v1()
    torch.cuda.synchronize()
    err = (g_k - g_ref).abs()
    bad = err > GRAD_ATOL + GRAD_RTOL * g_ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g_k).all()):
        fail(f"{label} K2 props gradient: {int(bad.sum())} of {bad.numel()} outside rtol "
             f"{GRAD_RTOL} atol {GRAD_ATOL} (max |err| {float(err.max())})")
    results["K2"] = {"max_abs_err": float(err.max())}
    err_v1 = (g_v1 - g_ref).abs()
    print(f"{label} K2 vs plain autograd: max |err| {float(err.max())} "
          f"(max |grad| {float(g_ref.abs().max())}; rtol {GRAD_RTOL}, atol {GRAD_ATOL}); first "
          f"version vs plain autograd: max |err| {float(err_v1.max())}, outside the same "
          f"tolerance {int((err_v1 > GRAD_ATOL + GRAD_RTOL * g_ref.abs()).sum())}", flush=True)

    with torch.no_grad():
        for name, touch in (("K1", False), ("K3", True)):
            ms = kernel_ms({v: B.forward_launcher(t_props, counts, *cargs, touch, version=v)[0]
                            for v in (2, 1)})
            results[name]["ms"], results[name]["ms_v1"] = ms[2], ms[1]
            results[name]["wrapper_ms"] = cuda_ms(
                lambda touch=touch: B.blend_forward_cuda(t_props, counts, *cargs, touch))
        ms = kernel_ms({v: B.backward_launcher(*bwd_args, version=v)[0] for v in (2, 1)})
        results["K2"]["ms"], results["K2"]["ms_v1"] = ms[2], ms[1]
        results["K2"]["wrapper_ms"] = cuda_ms(lambda: B.blend_backward_cuda(*bwd_args))
        plain_fwd = cuda_ms(lambda: B.blend_tiles_reference(
            t_props, counts, *cargs, tile_group=rcfg.tile_group), reps=5)
    results["K1"]["plain_ms"] = plain_fwd
    results["K3"]["plain_ms"] = plain_fwd  # the plain forward always counts touches
    results["K2"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(plain_loss, pr, retain_graph=True), reps=5)
    for name in ("K1", "K3", "K2"):
        r = results[name]
        r["bound_ms"], r["bound_by"] = bound(name, counts, k1[4], ref[3], p)
        print(f"{label} {name}: {r['ms']:.4f} ms kernel-only (first version {r['ms_v1']:.4f} "
              f"ms, {r['ms_v1'] / r['ms']:.2f}x), wrapper {r['wrapper_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return results


def set_times(res) -> dict:
    """The numbers of one prop set for the `kernels` line."""
    return {k: res[k] for k in ("ms", "ms_v1", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}


def scene_kernel_phase(config, dev):
    """The kernels on the bench scene itself, seen from frame 0's pose."""
    import torch

    from monogs_dev_tpu_torch.core.system import raster_config_from
    from monogs_dev_tpu_torch.data.synthetic import SyntheticDataset
    from monogs_dev_tpu_torch.ops.rasterize import grid_dims, tile_wh
    from monogs_dev_tpu_torch.tools.kernel_lab import tile_props

    ds = SyntheticDataset(config, dev)
    T0 = torch.as_tensor(ds.poses[0], dtype=torch.float32, device=dev)
    rcfg = raster_config_from(config)
    t_props, counts = tile_props(ds.scene_params, ds.scene_active, T0, ds.intr, rcfg)
    return check_set("frame 0", t_props, counts, grid_dims(ds.intr, *tile_wh(rcfg))[0], rcfg,
                     lab_full=False)


def snapshot_map(slam, kf, name):
    """A copy of the map and of keyframe `kf`'s pose, for `map_kernel_phase`."""
    import torch

    engine = slam.engine
    return (f"{name} (kf {kf}, frame {slam.frontend.cur_frame_idx})",
            engine.gmap.params.map(lambda x: x.detach().clone()),
            engine.gmap.aux.active.clone(),
            torch.as_tensor(engine.viewpoints[kf].T_w2c, dtype=torch.float32,
                            device=slam.device))


def map_kernel_phase(snapshots, intr, rcfg, dilate):
    """The kernels on mapped maps, binned as the mapping loop bins them
    (tiles dilated by `mapping_rebin_dilation`): the density the mapping
    renders blend. L2 is held to autograd on every map but the end maps of
    the RGB-D and parity runs. Returns {label: check_set's results}."""
    from monogs_dev_tpu_torch.ops.rasterize import grid_dims, tile_wh
    from monogs_dev_tpu_torch.tools.kernel_lab import tile_props

    out = {}
    for label, params, active, T in snapshots:
        t_props, counts = tile_props(params, active, T, intr, rcfg, dilate=dilate)
        out[label] = check_set(label, t_props, counts, grid_dims(intr, *tile_wh(rcfg))[0], rcfg,
                               lab_full=" end map" not in label)
    return out


def _map_fields(gmap):
    for group, fields in (("params", gmap.params), ("aux", gmap.aux),
                          ("adam_mu", gmap.moments.mu), ("adam_nu", gmap.moments.nu)):
        for f in dataclasses.fields(fields):
            yield f"{group}.{f.name}", getattr(fields, f.name)


def tier_phase(slam):
    """The map tiers on the card. The parity run's window never fills, so
    it neither compacts nor grows the map; this compacts its map after the
    first keyframe's mapping and prune to the smallest power-of-two tier
    that holds its alive rows and grows it back (`compact_map`,
    `resize_map`, as `BackendEngine`'s tiers call them). Every field must
    equal the same steps on a CPU copy, and the compacted map must render
    what the full map renders."""
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


def check_lab(label, t_props, counts, tx_n, rcfg, full):
    """Every L1 variant and L2 against their plain versions on these props,
    and with `full` L2 also against autograd through the plain blend in
    float32 (K2's tolerances) and float64, where L2 may have no more entries
    outside tolerance than its first version (csrc/blend_lab_v1.cu). Each is
    timed: kernel-only beside its first version, in turns (`kernel_ms`),
    through its wrapper, and the plain version."""
    import torch

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops import blend_lab as BL
    from monogs_dev_tpu_torch.ops.rasterize import tile_wh

    tw, th = tile_wh(rcfg)
    tile, p = (tw, th), tw * th
    cfg = (rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    res = {}
    with torch.no_grad():
        t_final, n_done = BL.blend_residuals(t_props, counts, tx_n, tile, *cfg)
        touch = B.blend_tiles_reference(t_props, counts, tx_n, tile, *cfg,
                                        tile_group=rcfg.tile_group)[3]
        for v in BL.LAB_VARIANTS:
            out = BL.lab_forward_cuda(v, t_props, counts, tx_n, tile, *cfg)
            launch_v1, out_v1 = BL.lab_forward_launcher(v, t_props, counts, tx_n, tile, *cfg,
                                                        version=1)
            launch_v1()
            ref, plain_ms = timed(lambda v=v: BL.lab_blend_reference(
                v, t_props, counts, tx_n, tile, *cfg, rcfg.tile_group))
            errs, errs_v1 = ({k: float((a - b).abs().max()) for k, a, b in
                              zip(("color", "depth", "alpha"), o, ref)} for o in (out, out_v1))
            for k, e in errs.items():
                if not e <= TOL[k]:
                    fail(f"{label} L1/{v} {k} max |err| {e} > {TOL[k]}")
            r = res[f"L1/{v}"] = {"max_abs_err": max(errs.values()), "errs": errs}
            ms = kernel_ms({ver: BL.lab_forward_launcher(v, t_props, counts, tx_n, tile, *cfg,
                                                         version=ver)[0] for ver in (2, 1)})
            r["ms"], r["ms_v1"] = ms[2], ms[1]
            r["wrapper_ms"] = cuda_ms(
                lambda v=v: BL.lab_forward_cuda(v, t_props, counts, tx_n, tile, *cfg))
            r["plain_ms"] = plain_ms
            r["bound_ms"], r["bound_by"] = bound(f"L1/{v}", counts, n_done, touch, p)
            print(f"{label} L1/{v} vs plain: {errs} (first version {errs_v1}); {r['ms']:.4f} ms "
                  f"kernel-only (first version {r['ms_v1']:.4f} ms, "
                  f"{r['ms_v1'] / r['ms']:.2f}x), wrapper {r['wrapper_ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
                  flush=True)

        gen = torch.Generator(device=t_props.device).manual_seed(1)
        cots = (torch.randn((t_props.shape[0], 3, p), generator=gen, device=t_props.device),
                0.1 * torch.randn((t_props.shape[0], p), generator=gen, device=t_props.device),
                torch.randn((t_props.shape[0], p), generator=gen, device=t_props.device))
        args = (t_props, t_final, n_done, *cots, tx_n, tile, *cfg[:2])
        got = BL.moments_backward_cuda(*args)
        launch_v1, got_v1 = BL.moments_launcher(*args, version=1)
        launch_v1()
        plain, plain_ms = timed(lambda: BL.moments_backward_reference(*args, rcfg.tile_group))
    if not bool(torch.isfinite(got).all()):
        fail(f"{label} L2: non-finite gradient")
    refs = {"plain": plain}
    if full:
        # the gradient references: autograd through the plain blend in
        # float32 (what K2 is held to) and in float64
        for dtype in (torch.float64, torch.float32):
            pr = t_props.to(dtype).requires_grad_(True)
            out = B.blend_tiles_reference(pr, counts, tx_n, tile, *cfg,
                                          tile_group=rcfg.tile_group)
            (g,) = torch.autograd.grad(sum((o * c.to(dtype)).sum() for o, c in zip(out[:3], cots)),
                                       pr)
            refs[str(dtype)[6:] + " autograd"] = g
            del pr, out
        with torch.no_grad():
            k2 = B.blend_backward_cuda(t_props, t_final, n_done, *cots, tx_n, tile, *cfg[:2])
        torch.cuda.synchronize()
    errs, n_bad = {}, {}
    checks = [("L2", got, name, ref) for name, ref in refs.items()]
    if full:
        checks += [("L2 first version", got_v1, "float64 autograd", refs["float64 autograd"]),
                   ("K2", k2, "float64 autograd", refs["float64 autograd"]),
                   ("float32 autograd", refs["float32 autograd"], "float64 autograd",
                    refs["float64 autograd"])]
    for who, x, name, ref in checks:
        what = f"{who} vs {name}"
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
    held = ["L2 vs plain"] + (["L2 vs float32 autograd"] if full else [])
    for what in held:
        if n_bad[what]:
            fail(f"{label} {what}: {n_bad[what]} entries outside tolerance")
    if full and n_bad["L2 vs float64 autograd"] > n_bad["L2 first version vs float64 autograd"]:
        fail(f"{label} L2: {n_bad['L2 vs float64 autograd']} entries outside tolerance against "
             f"float64 autograd, more than the first version's "
             f"{n_bad['L2 first version vs float64 autograd']}")
    r = res["L2"] = {"max_abs_err": max(errs[k] for k in held)}
    with torch.no_grad():
        ms = kernel_ms({ver: BL.moments_launcher(*args, version=ver)[0] for ver in (2, 1)})
        r["ms"], r["ms_v1"] = ms[2], ms[1]
        r["wrapper_ms"] = cuda_ms(lambda: BL.moments_backward_cuda(*args))
        r["plain_ms"] = plain_ms
    r["bound_ms"], r["bound_by"] = bound("L2", counts, n_done, touch, p)
    print(f"{label} L2: {r['ms']:.4f} ms kernel-only (first version {r['ms_v1']:.4f} ms, "
          f"{r['ms_v1'] / r['ms']:.2f}x), wrapper {r['wrapper_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return res


def check_set(label, t_props, counts, tx_n, rcfg, lab_full):
    """K1-K3 (`check_kernels`) and L1/L2 (`check_lab`) on one prop set."""
    return (check_kernels(label, t_props, counts, tx_n, rcfg),
            check_lab(label, t_props, counts, tx_n, rcfg, lab_full))


def lab_phase(dev):
    """The lab's entry point on the lab scene (the launch counts of that
    run), then K1-K3 and L1/L2 (`check_set`) on the lab scene. Returns (L1/L2
    launches, the lab scene's check_set results)."""
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
    return launches, check_set("lab", t_props, counts, tx_n, KL.LAB_RASTER, lab_full=True)


def profile_frames(label, slam, start: int, n: int, frame_ms: float):
    """`torch.profiler` over frames [start, start + n) of the run, after its
    timed window: each K kernel's device ms per frame, the device's summed
    kernel time per frame and its idle share, of the profiled wall time (the
    profiler slows the host) and of `frame_ms`, the unprofiled frame time
    of the timed window, and the host's blocking reads of the device
    (HOST_WAIT_CALLS) per frame. None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam.frontend.run(max_frames=start + n)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0) / n
    # kernel rows only: the aten rows carry the same device time again
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    if busy_ms <= 0.0:
        print("profile: the trace holds no device time (not measured)", flush=True)
        return None
    # the host's reads of device values: CUDA runtime calls that block until
    # the device has drained its queue (under the profiler's slower host)
    waits = [e for e in prof.key_averages() if e.key in HOST_WAIT_CALLS]
    out = {
        "frames": [start, start + n],
        "kernel_ms_per_frame": {k: sum(e.self_device_time_total for e in rows if pat in e.key)
                                / 1e3 / n for k, pat in PROFILE_NAMES.items()},
        "host_wait_per_frame": {e.key: {"calls": e.count / n, "ms": e.cpu_time_total / 1e3 / n}
                                for e in waits},
        "device_ms_per_frame": busy_ms,
        "profiled_wall_ms_per_frame": wall_ms,
        "idle_share_profiled": 1.0 - busy_ms / wall_ms,
        "timed_window_ms_per_frame": frame_ms,
        "idle_share_of_timed_frame": 1.0 - busy_ms / frame_ms,
        "top": [(e.key[:80], e.self_device_time_total / 1e3 / n)
                for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]],
    }
    print(f"{label} profile: " + json.dumps(out), flush=True)
    return out


def mono_phase(config, dev):
    """bench_torch.py's run: bench_vga forced monocular, warm-up until both
    halves are initialized (by frame MONO_FRAME_CAP), 25 timed frames; a
    copy of the map at initialization (for `map_kernel_phase`); then
    PROFILE_FRAMES more frames under the profiler."""
    import torch

    import bench_torch
    from monogs_dev_tpu_torch.ops import blend as B

    snapshot = []

    def at_init(slam):
        snapshot.append(snapshot_map(slam, slam.frontend.kf_indices[-1], "mono init map"))

    B.reset_launch_counts()
    slam, info = bench_torch.run_bench(config, dev, at_init=at_init)
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
    start = info["warm_frames"] + bench_torch.N_MEAS
    n = min(PROFILE_FRAMES, len(slam.dataset) - start)
    info["profile"] = profile_frames("mono", slam, start, n, 1e3 / info["fps"]) if n > 0 else None
    return info, snapshot[0], slam.intr, slam.raster_cfg, slam.step_cfg.mapping_rebin_dilation


class TrackRecorder:
    """Stands in for the frontend's Adam tracker (`core/frontend.py`'s
    `track_frame`): records each frame's iteration count and convergence,
    and the inputs of frame `keep` (for `gradient_check`)."""

    def __init__(self, frontend, keep: int):
        from monogs_dev_tpu_torch.core import tracking

        self.track_frame = tracking.track_frame
        self.frontend, self.keep = frontend, keep
        self.iters, self.converged, self.inputs = {}, {}, None

    def __call__(self, *args, **kwargs):
        idx = self.frontend.cur_frame_idx
        if idx == self.keep:
            self.inputs = (args, kwargs)
        res = self.track_frame(*args, **kwargs)
        self.iters[idx], self.converged[idx] = res.n_iters, res.converged
        return res


def gradient_check(inputs):
    """The Adam tracker's first iteration on one frame of the run (its map,
    start pose, image and real edge mask): loss and (tau, exposure) gradient
    through K1/K2 against the same through the plain blend on the card."""
    import torch

    from monogs_dev_tpu_torch.core import tracking as tt
    from monogs_dev_tpu_torch.ops import rasterize as R
    from monogs_dev_tpu_torch.ops.blend import blend_tiles_reference
    from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

    (params, active, T_init, exp0, image, depth, _, bg, cfg, intr, rcfg), kw = inputs
    dev = image.device
    T = torch.as_tensor(T_init, dtype=torch.float32, device=dev)
    mask = compute_grad_mask(image, cfg.edge_threshold, cfg.per_block_mask)
    tile_mask = tt.tile_mask_of(mask, intr, rcfg)
    with torch.no_grad():
        proj = R.project_gaussians(params, active, T, intr, cfg.sh_degree)
        binning = R.build_binning(proj, intr, rcfg, dilate=cfg.rebin_dilation)
    args = (T, torch.as_tensor(exp0, dtype=torch.float32, device=dev), params, active, binning,
            image, depth, mask, tile_mask, bg, cfg, intr, rcfg, kw["use_depth"])
    loss_k, g_k = tt.pose_gradient(*args)
    kernel_blend = R.blend_tiles
    R.blend_tiles = lambda *a: blend_tiles_reference(*a)[:3]
    try:
        loss_p, g_p = tt.pose_gradient(*args)
    finally:
        R.blend_tiles = kernel_blend
    loss_k, loss_p = float(loss_k), float(loss_p)
    g_err = float((g_k - g_p).abs().max())
    g_max = float(g_p.abs().max())
    out = {"tiles_blended": int(tile_mask.sum()), "tiles": int(tile_mask.numel()),
           "loss_kernels": loss_k, "loss_plain": loss_p, "grad_kernels": g_k.tolist(),
           "grad_plain": g_p.tolist(), "grad_max_abs_err": g_err, "grad_max_abs": g_max}
    print("parity gradient check: " + json.dumps(out), flush=True)
    if not (tile_mask.any() and not tile_mask.all()):
        fail("parity gradient check: the edge mask leaves no tile masked out (or none in)")
    if not (np.isfinite(g_err) and g_err <= GRAD_CHECK_REL * g_max and g_max > 0.0):
        fail(f"parity gradient check: max |g_kernels - g_plain| {g_err} > {GRAD_CHECK_REL} x "
             f"max |g| {g_max}")
    if not abs(loss_k - loss_p) <= LOSS_CHECK_REL * abs(loss_p):
        fail(f"parity gradient check: loss {loss_k} (kernels) vs {loss_p} (plain)")
    return out


def parity_phase(dev):
    """`configs/synthetic/bench_vga_parity.yaml` (RGB-D, the reference's
    Adam tracking loop) through `SLAM`, the code path of `slam_torch.py
    --eval`: frame 0's init mapping and frames 1..11 (frames 2..11 give the
    tracked frames/s), then on to the first keyframe after frame 0 within
    PARITY_BUDGET_S, then PARITY_PROFILE_FRAMES profiled frames, then
    `SLAM.evaluate` (colour refinement, PSNR/SSIM/LPIPS before and after,
    ATE and PLY artifacts) into a temporary directory. Returns (info, map
    snapshots for `map_kernel_phase`)."""
    import tempfile

    import torch

    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.eval.ate import ate_rmse
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.utils.config import load_config

    t_phase = time.time()
    config = load_config(PARITY_CONFIG)
    save_dir = tempfile.mkdtemp(prefix="parity_eval_")
    slam = SLAM(config, dev, seed=0, save_dir=save_dir)
    fe = slam.frontend
    for i in range(min(MAX_FRAMES + PARITY_PROFILE_FRAMES, len(slam.dataset))):
        slam.dataset.render_frame(i)  # outside the counted run
    recorder = TrackRecorder(fe, PARITY_GRAD_FRAME)
    frontend_mod.track_frame = recorder
    try:
        torch.cuda.synchronize()
        B.reset_launch_counts()
        t0 = time.time()
        slam.run(max_frames=1)  # frame 0 and its init mapping
        slam.run(max_frames=2)
        torch.cuda.synchronize()
        t1 = time.time()
        slam.run(max_frames=N_FRAMES)
        torch.cuda.synchronize()
        t2 = time.time()
        n = N_FRAMES
        while len(fe.kf_indices) < 2 and n < MAX_FRAMES and time.time() - t0 < PARITY_BUDGET_S:
            n += 1
            slam.run(max_frames=n)
        torch.cuda.synchronize()
        t3 = time.time()
        launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
        reached_keyframe = len(fe.kf_indices) > 1  # before the profiled frames
        frame_ms = 1e3 * (t2 - t1) / (N_FRAMES - 2)
        profile = profile_frames("parity", slam, n, PARITY_PROFILE_FRAMES, frame_ms)
    finally:
        frontend_mod.track_frame = recorder.track_frame
    # the map after its first keyframe's mapping (the post-init map is the
    # RGB-D slice's: the same config up to the tracker)
    snapshots = ([snapshot_map(slam, fe.kf_indices[-1], "parity end map")]
                 if reached_keyframe else [])
    frames = sorted(fe.cameras)
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in frames):
        fail("non-finite pose in the parity run")
    ate = slam.keyframe_ate()
    ate_all = ate_rmse([fe.cameras[i].T_est for i in frames], [fe.cameras[i].T_gt for i in frames])
    iters = [recorder.iters[i] for i in sorted(recorder.iters) if i < n]  # the counted run
    info = {
        "frames_run": n,
        "reached_keyframe": reached_keyframe,
        "init_and_first_frame_s": t1 - t0,
        "tracked_fps": (N_FRAMES - 2) / (t2 - t1),
        "frames_12_on_s": t3 - t2,
        "adam_iters_mean": float(np.mean(iters)),
        "adam_iters_max": int(max(iters)),
        "frames_tracked": len(iters),
        "frames_converged": int(sum(recorder.converged[i] for i in recorder.converged if i < n)),
        "launches": launches,
        "k2_launches_per_tracked_frame": launches["K2"] / len(iters),
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "keyframe_ate_cm": 100.0 * ate,
        "all_frame_ate_cm": 100.0 * ate_all,
        "timers": slam.timers.summary(),
        "telemetry": slam.engine.telemetry,
        "profile": profile,
    }
    print("parity: " + json.dumps(info), flush=True)
    if not info["reached_keyframe"]:
        print(f"parity: no keyframe after frame 0 by frame {n} ({PARITY_BUDGET_S} s budget); "
              f"the run stopped there", flush=True)
    for name, v in (("keyframe", ate), ("all-frame", ate_all)):
        if not (np.isfinite(v) and v < RGBD_ATE_BAR):
            fail(f"parity {name} ATE {v} m is not finite and under {RGBD_ATE_BAR} m")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the parity run")

    info["gradient_check"] = gradient_check(recorder.inputs)
    if info["reached_keyframe"]:
        tier_phase(slam)
    else:
        print("tiers: not checked (the map before the first keyframe fills no smaller tier)",
              flush=True)

    B.reset_launch_counts()
    t4 = time.time()
    results = slam.evaluate()
    torch.cuda.synchronize()
    info["eval_s"] = time.time() - t4
    info["eval_launches"] = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    slam.stop()
    info["eval"] = results
    for tag in ("before_opt", "after_opt"):
        r = results[tag]
        print(f"parity eval {tag}: PSNR {r['mean_psnr']:.4f} dB, SSIM {r['mean_ssim']:.5f}, "
              f"LPIPS {r.get('mean_lpips_noncanonical', r['mean_lpips'])} "
              f"({r['lpips_backend']}) over {r['n_frames']} frames", flush=True)
        if not (np.isfinite(r["mean_psnr"]) and np.isfinite(r["mean_ssim"]) and r["n_frames"]):
            fail(f"parity eval {tag}: PSNR/SSIM not finite or no frame rendered")
    for rel in ("trj_final.json", "plot/stats_final.json", "psnr/before_opt/final_result.json",
                "psnr/after_opt/final_result.json", "point_cloud/final/point_cloud.ply",
                "metrics.jsonl"):
        if not os.path.exists(os.path.join(save_dir, rel)):
            fail(f"parity eval did not write {rel}")
    shutil.rmtree(save_dir)
    info["phase_s"] = time.time() - t_phase
    print(f"parity: tracked frames/s {info['tracked_fps']:.4f}; Adam iterations a frame mean "
          f"{info['adam_iters_mean']:.2f}, max {info['adam_iters_max']}, converged "
          f"{info['frames_converged']} of {info['frames_tracked']}; launches {launches} "
          f"(eval {info['eval_launches']}); keyframe ATE {info['keyframe_ate_cm']:.4f} cm, "
          f"all-frame ATE {info['all_frame_ate_cm']:.4f} cm; eval {info['eval_s']:.1f} s; "
          f"phase {info['phase_s']:.1f} s", flush=True)
    return info, snapshots


def slice_phase(config, dev):
    """Frames 0..11: the init mapping and the tracked frames/s (frames
    2..11). The keyframe path past frame 11 (insertion, kNN, windowed
    mapping, harvest) runs in the parity phase, RGB-D too. A copy of the
    map after the init mapping is returned for `map_kernel_phase`."""
    import torch

    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.eval.ate import ate_rmse
    from monogs_dev_tpu_torch.ops import blend as B

    slam = SLAM(config, dev, seed=0)
    fe = slam.frontend
    B.reset_launch_counts()
    t0 = time.time()
    slam.run(max_frames=1)  # frame 0 and, as the run ends, its init mapping
    snapshots = [snapshot_map(slam, 0, "RGB-D post-init map")]
    slam.run(max_frames=2)  # the first tracked frame
    torch.cuda.synchronize()
    t1 = time.time()
    slam.run(max_frames=N_FRAMES)
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    slam.stop()
    frames = sorted(fe.cameras)
    ate_all = ate_rmse([fe.cameras[i].T_est for i in frames], [fe.cameras[i].T_gt for i in frames])
    info = {
        "frames": N_FRAMES,
        "init_and_first_frame_s": round(t1 - t0, 3),
        "tracked_fps": (N_FRAMES - 2) / (t2 - t1),
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "capacity_tier": int(slam.engine.gmap.aux.active.shape[0]),
        "all_frame_ate_cm": 100.0 * ate_all,
        "launches": launches,
        "timers": slam.timers.summary(),
        "telemetry": slam.engine.telemetry,
    }
    print("slice: " + json.dumps(info), flush=True)
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras):
        fail("non-finite pose in the slice")
    if not (np.isfinite(ate_all) and ate_all < RGBD_ATE_BAR):
        fail(f"all-frame ATE {ate_all} m is not finite and under {RGBD_ATE_BAR} m")
    for name, n in launches.items():
        if n <= 0:
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
    sets = {"frame 0": scene_kernel_phase(config, dev)}
    slam, gn_launches, snapshots = slice_phase(config, dev)
    sets.update(map_kernel_phase(snapshots, slam.intr, slam.raster_cfg,
                                 slam.step_cfg.mapping_rebin_dilation))
    del slam
    parity, parity_snaps = parity_phase(dev)
    lab_launches, sets["lab"] = lab_phase(dev)
    mono, mono_snap, intr, rcfg, dilate = mono_phase(load_config(CONFIG), dev)
    sets.update(map_kernel_phase(parity_snaps + [mono_snap], intr, rcfg, dilate))
    profiled = {"mono": mono["profile"], "parity": parity["profile"]}
    paths = {"rgbd_gn": gn_launches, "parity_adam": parity["launches"],
             "parity_eval": parity["eval_launches"], "mono_gn": mono["launches"]}
    ksets = {label: k for label, (k, _) in sets.items()}
    lsets = {label: lab for label, (_, lab) in sets.items()}

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES["K"],
            "replaces": REPLACES[name],
            "launches": parity["launches"][name],
            "launches_by_path": {path: n[name] for path, n in paths.items()},
            "max_abs_err": max(res[name]["max_abs_err"] for res in ksets.values()),
            **set_times(ksets["frame 0"][name]),
            "library_ms": None,  # no single PyTorch call computes the blend
            "sets": {label: set_times(res[name]) for label, res in ksets.items()},
            **{f"{path}_device_ms_per_frame": (prof["kernel_ms_per_frame"][name]
                                                if prof else None)
               for path, prof in profiled.items()},
        }
        for name in ("K1", "K2", "K3")
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES["L"],
            "replaces": REPLACES[name[:2]],
            "launches": n,
            "max_abs_err": max(res[name]["max_abs_err"] for res in lsets.values()),
            **set_times(lsets["lab"][name]),
            "library_ms": None,
            "sets": {label: set_times(res[name]) for label, res in lsets.items()},
        }
        for name, n in lab_launches.items()
    ]
    # K1-K3: launches in the parity run (phase 5; every path's under
    # launches_by_path); ms (kernel-only), ms_v1
    # (the first version's, in turns with it), wrapper_ms, plain_ms and
    # bound_ms on the bench scene's frame-0 props (phase 3), and the same for
    # every prop set under "sets". L1/L2: launches in the lab's run, the same
    # numbers on the lab scene's props, and on every prop set under "sets".
    # max_abs_err over all sets.
    for label, (kres, lres) in sets.items():
        print(f"{label}: kernel-only speed-up over the first version: "
              + ", ".join(f"{k} {r['ms_v1'] / r['ms']:.2f}x"
                          for k, r in list(kres.items()) + list(lres.items())), flush=True)
        fastest = min((k for k in lres if k.startswith("L1/")), key=lambda k: lres[k]["ms"])
        print(f"{label}: lab answer, kernel-only: fastest L1 form {fastest} "
              f"{lres[fastest]['ms']:.4f} ms against K1 {kres['K1']['ms']:.4f} ms "
              f"({lres[fastest]['ms'] / kres['K1']['ms']:.2f}x; nocond "
              f"{lres['L1/nocond']['ms'] / kres['K1']['ms']:.2f}x); L2 {lres['L2']['ms']:.4f} ms "
              f"against K2 {kres['K2']['ms']:.4f} ms ({lres['L2']['ms'] / kres['K2']['ms']:.2f}x)",
              flush=True)
    print(f"wall time: {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
